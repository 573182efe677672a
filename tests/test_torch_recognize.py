"""The port's short-form ``recognize`` CLI against the JAX CLI, byte for byte.

One tiny transducer of the paper's configuration (a bi-RWKV-6 conformer
encoder, a 2-layer LSTM predictor, the bitransformer attention decoder with
1 + 1 blocks; weights 0.3 / 0.2 / 0.5, reverse 0.3) is initialised in JAX
with its CTC and transducer heads scaled x2 and blank-biased, so that the
searches emit varied tokens.  The JAX CLI reads its orbax checkpoint, the
port's CLI (``--device cpu``) the same weights through
``convert.state_dict_from_jax`` and ``torch.save``.  Both decode a raw list
of 3 WAVs (tone bursts over noise, 1.4-2.6 s, global JSON CMVN) in one
batch with all four modes, and must write identical ``<mode>/text`` files:
the same lines in the same order (the batch's descending length sort),
with the reverse decoder in the rescoring.  (One batch: each new padded
shape costs the JAX CLI's eager and jitted calls a compilation.)
"""
import io
import json
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paper_accurate_fast_cheap_tpu.bin import recognize as j_cli
from paper_accurate_fast_cheap_tpu.frontend.features import fbank as j_fbank
from paper_accurate_fast_cheap_tpu.models import factory as j_factory
from paper_accurate_fast_cheap_tpu.train import checkpointing
from paper_accurate_fast_cheap_tpu_torch.bin import recognize as t_cli
from paper_accurate_fast_cheap_tpu_torch.convert import state_dict_from_jax

VOCAB = 60
MODES = ["ctc_greedy_search", "ctc_prefix_beam_search", "attention_rescoring",
         "rnnt_beam_search"]


def _wav_bytes(wav):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((wav * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    import torch

    d = tmp_path_factory.mktemp("sf")
    units = d / "units.txt"
    units.write_text("<blank> 0\n<unk> 1\n" + "".join(
        f"{'▁w' if i % 3 == 0 else 'c'}{i} {i}\n" for i in range(2, VOCAB)))
    rng = np.random.RandomState(12)
    lines, waves = [], []
    for i, secs in enumerate((2.6, 1.4, 2.0)):
        t = np.arange(int(16000 * secs)) / 16000.0
        pitch = rng.uniform(150, 3000, t.size // 3200 + 1).repeat(3200)
        wav = (0.3 * np.sin(np.pi * (t * 5 % 1.0)) ** 2
               * np.sin(2 * np.pi * np.cumsum(pitch[:t.size]) / 16000)
               + rng.randn(t.size) * 0.01).astype(np.float32)
        path = d / f"utt{i}.wav"
        path.write_bytes(_wav_bytes(wav))
        waves.append(wav)
        lines.append(json.dumps({"key": f"utt{i}", "wav": str(path),
                                 "txt": "c4 ▁w6 c7"}))
    (d / "data.list").write_text("\n".join(lines) + "\n")
    feats = np.concatenate([np.asarray(j_fbank(jnp.asarray(w) * 32768.0),
                                       np.float64) for w in waves])
    cmvn = d / "cmvn.json"
    cmvn.write_text(json.dumps({"mean_stat": feats.sum(0).tolist(),
                                "var_stat": (feats ** 2).sum(0).tolist(),
                                "frame_num": len(feats)}))
    config = {
        "model": "transducer", "encoder": "conformer",
        "encoder_conf": dict(
            output_size=32, attention_heads=2, linear_units=64, num_blocks=2,
            cnn_module_kernel=15,
            selfattention_layer_type="rwkv_tmix60_bidirectional",
            rwkv_do_bfloat16=False),
        "decoder": "bitransformer",
        "decoder_conf": {"attention_heads": 2, "linear_units": 64,
                         "num_blocks": 1, "r_num_blocks": 1},
        "predictor": "rnn",
        "predictor_conf": {"embed_size": 32, "output_size": 32,
                           "hidden_size": 32, "num_layers": 2},
        "joint_conf": {"join_dim": 32},
        "model_conf": {"transducer_weight": 0.3, "ctc_weight": 0.2,
                       "attention_weight": 0.5, "reverse_weight": 0.3,
                       "lsm_weight": 0.1},
        "tokenizer": "whitespace",
        "tokenizer_conf": {"symbol_table_path": str(units)},
        "cmvn": "global_cmvn",
        "cmvn_conf": {"cmvn_file": str(cmvn), "is_json_cmvn": True},
        "dataset_conf": {
            "filter_conf": {"max_length": 2000, "min_length": 10},
            "fbank_conf": {"num_mel_bins": 80, "frame_shift": 10,
                           "frame_length": 25, "dither": 1.0},
            "sort_conf": {"sort_size": 1000},
        },
    }
    cfg = d / "conf.json"
    cfg.write_text(json.dumps(config))
    model, _ = j_factory.init_model(config, VOCAB, 80)
    params = jax.tree.map(np.array, model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 80)), jnp.asarray([64]),
        jnp.ones((1, 4), jnp.int32), jnp.asarray([4])))
    p = params["params"]
    p["ctc"]["ctc_lo"]["kernel"] *= 2.0
    p["ctc"]["ctc_lo"]["bias"][0] += 1.0
    p["joint"]["ffn_out"]["kernel"] *= 2.0
    p["joint"]["ffn_out"]["bias"][0] += 3.0
    p["decoder"]["left_decoder"]["output_layer"]["kernel"] *= 3.0
    ckpt = d / "ckpt"
    checkpointing.save_checkpoint(str(ckpt), jax.tree.map(jnp.asarray,
                                                          params))
    pt = d / "model.pt"
    torch.save(state_dict_from_jax(params), str(pt))
    return d, cfg, ckpt, pt


def test_recognize_matches_jax_cli(assets):
    d, cfg, ckpt, pt = assets
    common = ["--config", str(cfg), "--data_type", "raw", "--test_data",
              str(d / "data.list"), "--batch_size", "3", "--beam_size", "3",
              "--reverse_weight", "0.3", "--modes", *MODES]
    jdir, tdir = d / "jax", d / "torch"
    assert j_cli.main(common + ["--checkpoint", str(ckpt), "--result_dir",
                                str(jdir)]) == 0
    assert t_cli.main(common + ["--checkpoint", str(pt), "--result_dir",
                                str(tdir), "--device", "cpu"]) == 0
    texts = {}
    for mode in MODES:
        want = (jdir / mode / "text").read_bytes()
        assert (tdir / mode / "text").read_bytes() == want, mode
        texts[mode] = want.decode().splitlines()
    # the pipeline's order: one batch, in descending length
    for mode in MODES:
        assert [ln.split(" ", 1)[0] for ln in texts[mode]] == [
            "utt0", "utt2", "utt1"]
    # varied tokens, not a trivially equal empty decode
    words = [w for ln in texts["ctc_greedy_search"] for w in ln.split()[1:]]
    assert len(words) > 5 and len(set(words)) > 2
    assert any(ln.split()[1:] for ln in texts["rnnt_beam_search"])


def test_recognize_needs_a_card_unless_asked_for_the_cpu(assets):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    d, cfg, ckpt, pt = assets
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_cli.main(["--config", str(cfg), "--data_type", "raw",
                    "--test_data", str(d / "data.list"), "--checkpoint",
                    str(pt), "--result_dir", str(d / "nocard")])
