"""Import hygiene of the PyTorch/CUDA port: it never imports jax, flax or the
JAX package, and no port source names the JAX package."""
import os
import pkgutil
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "paper_accurate_fast_cheap_tpu_torch"


def _port_modules():
    import paper_accurate_fast_cheap_tpu_torch as pkg

    names = [PKG]
    for info in pkgutil.walk_packages(pkg.__path__, PKG + "."):
        names.append(info.name)
    return names


def test_port_imports_no_jax():
    mods = _port_modules() + ["chip_smoke"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', "
        "'paper_accurate_fast_cheap_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(mods) >= 20
    # the training slice's modules and those of the attention decoder, the
    # short-form CLI, the crash-repro tool, the encoder's attention types,
    # the WeNet converter, Mamba-2, the streaming and serving surface, the
    # chunk masks, the scoring and load-bench tools, the training CLI, the
    # RTF harnesses, the searches' biasing and attention beam, the align,
    # fbank, CMVN and embedding tools, the codecs and their C++ shims, the
    # shard and data tools, the hub, the export tool, the recipe's drivers,
    # the encoder families and their registry, the subsamplings, the
    # predictors and LoRA, and the other model families and searches (the
    # n-gram and WFST scorers, the FST CLI, the ESPnet searches, joint
    # decoding, HLG, the bidirectional transducer, the context adaptor,
    # teacher-student, CTL, Paraformer, the SSL models, Whisper and JAX's
    # fixed-key draws), and the parallel forms (the collectives, meshes,
    # sequence parallelism, the pipeline, the pipelined encoder and the
    # dry run) are among those imported
    assert {f"{PKG}.{m}" for m in (
        "ops.ffn", "ops.rnnt", "train.schedulers", "train.train_step",
        "bin.train_bench", "ops.multi_product", "ops.losses",
        "models.attention", "models.decoder", "models.asr_model",
        "data.pipeline", "bin.recognize",
        "tools.repro_tpu_worker_crash", "models.lca", "models.conformer",
        "models.embedding", "tools.convert_checkpoint", "ops.ssd",
        "models.mamba", "decode.streaming", "streaming",
        "bin.streaming_bench", "api", "bin.serve", "bin.ws_client",
        "tools.latency_metrics", "utils.masks", "tools.wer",
        "bin.compute_wer", "bin.ws_bench", "frontend.augment",
        "data.augmentations", "train.checkpointing", "train.executor",
        "train.metrics_logger", "bin.train", "bin.average_model",
        "decode.context_graph", "decode.search", "utils.profiling",
        "tools.rtf_tables", "bin.encoder_rtf", "bin.decode_rtf",
        "bin.beam_bench", "bin.scan_op_bench", "ops.ctc_utils", "bin.align",
        "data.kaldi_io", "bin.compute_fbank_feats",
        "bin.compute_cmvn_stats", "bin.write_embeddings",
        "tools.vector_index", "native", "data.audio", "data.flac",
        "data.codecs", "hub", "bin.make_shard", "bin.data_tools",
        "tools.export_model", "examples.gigaspeech.local",
        "examples.gigaspeech.local.make_lf_fixture",
        "examples.gigaspeech.local.run_accuracy_loop",
        "examples.gigaspeech.local.run_impl_matrix",
        "examples.gigaspeech.local.run_lf_sweep",
        "examples.gigaspeech.local.run_rtf_sweep", "models.branchformer",
        "models.squeezeformer", "models.efficient_conformer",
        "models.encoder_registry", "models.subsampling", "models.predictor",
        "models.lora", "frontend.features", "decode.lm", "decode.wfst",
        "bin.fst_tools", "decode.transducer_espnet", "decode.joint_decoding",
        "models.k2_model", "models.bitransducer", "models.context_adaptor",
        "models.teacher_student", "models.ctl_model", "models.paraformer",
        "models.ssl_wav2vec2", "models.ssl_w2vbert", "models.ssl_bestrq",
        "models.whisper", "utils.jax_prng", "text.tokenizers",
        "parallel.collectives", "parallel.mesh", "parallel.sequence",
        "parallel.pipeline", "parallel.pp_encoder", "parallel.dryrun")} <= set(
            mods)


def test_port_sources_do_not_name_the_jax_package():
    """No port source (comments included; the C++ shims too) names the JAX
    package, and no port source or ``chip_smoke.py`` imports jax, flax or
    optax.  (The script names the TPU kernels' files in its report, so only
    its imports are checked.)"""
    pat = re.compile(r"paper_accurate_fast_cheap_tpu(?!_torch)")
    imp = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|orbax)\b",
                     re.M)
    offenders = []
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        if imp.search(f.read()):
            offenders.append("chip_smoke.py")
    for d, dirs, files in os.walk(os.path.join(ROOT, PKG)):
        # _build holds compiled kernels and unpacked checkouts, not sources
        dirs[:] = [x for x in dirs if x != "_build"]
        for name in files:
            if not name.endswith((".py", ".cu", ".cuh", ".cpp")):
                continue
            path = os.path.join(d, name)
            with open(path) as f:
                text = f.read()
            if imp.search(text) or pat.search(text):
                offenders.append(os.path.relpath(path, ROOT))
    assert not offenders, offenders


def test_port_sources_do_not_call_torch_compile():
    """A kernel of the port is hand-written: no port source or
    ``chip_smoke.py`` hands a function to ``torch.compile``."""
    pat = re.compile(r"torch\.compile\b|torch\._dynamo|\binductor\b")
    offenders = []
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, dirs, files in os.walk(os.path.join(ROOT, PKG)):
        dirs[:] = [x for x in dirs if x != "_build"]
        paths += [os.path.join(d, n) for n in files if n.endswith(".py")]
    for path in paths:
        with open(path) as f:
            if pat.search(f.read()):
                offenders.append(os.path.relpath(path, ROOT))
    assert not offenders, offenders


def test_entry_points_default_to_cuda():
    """Without a card, the entry points raise unless asked for the CPU."""
    import pytest
    import torch

    from paper_accurate_fast_cheap_tpu_torch import api, resolve_device
    from paper_accurate_fast_cheap_tpu_torch.bin import (
        recognize_wav, serve, streaming_bench, train, train_bench)
    from paper_accurate_fast_cheap_tpu_torch.frontend import pipeline
    from paper_accurate_fast_cheap_tpu_torch.models import factory

    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    conf = {"model": "transducer", "encoder_conf": {
        "output_size": 16, "attention_heads": 1, "linear_units": 16,
        "num_blocks": 1, "selfattention_layer_type": "rwkv_tmix60"},
        "predictor_conf": {"embed_size": 16, "hidden_size": 16,
                           "output_size": 16, "num_layers": 1},
        "joint_conf": {"join_dim": 16}}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        factory.init_model(conf, 40, 80)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipeline.make_feature_fn()
    # the CLI: without --device cpu it asks for the card before reading
    # anything (the paths need not exist)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        recognize_wav.main(["--config", "c.json", "--checkpoint", "m.pt",
                            "--wav", "x.wav", "--output_dir", "out"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_bench.main(["--config", "c.json"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--config", "c.json", "--train_data", "t.list",
                    "--model_dir", "run"])
    # the streaming bench, the API and the server (any directory: the
    # device is asked for before the model is read)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        streaming_bench.main(["--config", "c.json"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.load_model(ROOT)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--model_dir", ROOT])
    model, _ = factory.init_model(conf, 40, 80, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
