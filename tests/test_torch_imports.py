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
        "('jax', 'jaxlib', 'flax', 'optax', 'paper_accurate_fast_cheap_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(mods) >= 20
    # the training slice's modules and those of the attention decoder, the
    # short-form CLI and the crash-repro tool are among those imported
    assert {f"{PKG}.{m}" for m in (
        "ops.ffn", "ops.rnnt", "train.schedulers", "train.train_step",
        "bin.train_bench", "ops.multi_product", "ops.losses",
        "models.attention", "models.decoder", "models.asr_model",
        "data.pipeline", "bin.recognize",
        "tools.repro_tpu_worker_crash")} <= set(mods)


def test_port_sources_do_not_name_the_jax_package():
    """No port source (comments included) names the JAX package, and no
    port source or ``chip_smoke.py`` imports jax, flax or optax.  (The
    script names the TPU kernels' files in its report, so only its imports
    are checked.)"""
    pat = re.compile(r"paper_accurate_fast_cheap_tpu(?!_torch)")
    imp = re.compile(r"^\s*(import|from)\s+(jax|flax|optax)\b", re.M)
    offenders = []
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        if imp.search(f.read()):
            offenders.append("chip_smoke.py")
    for d, dirs, files in os.walk(os.path.join(ROOT, PKG)):
        # _build holds compiled kernels and unpacked checkouts, not sources
        dirs[:] = [x for x in dirs if x != "_build"]
        for name in files:
            if not name.endswith((".py", ".cu", ".cuh")):
                continue
            path = os.path.join(d, name)
            with open(path) as f:
                text = f.read()
            if imp.search(text) or pat.search(text):
                offenders.append(os.path.relpath(path, ROOT))
    assert not offenders, offenders


def test_entry_points_default_to_cuda():
    """Without a card, the entry points raise unless asked for the CPU."""
    import pytest
    import torch

    from paper_accurate_fast_cheap_tpu_torch import resolve_device
    from paper_accurate_fast_cheap_tpu_torch.bin import (
        recognize_wav, train_bench)
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
    model, _ = factory.init_model(conf, 40, 80, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
