"""The port's parallel forms (``paper_accurate_fast_cheap_tpu_torch/parallel``)
on gloo CPU ranks, against the JAX package.

The ranks are ``torch.multiprocessing`` processes (``file://`` rendezvous
in ``tmp_path``) running ``tests/torch_parallel_ranks.py``, which imports
no JAX; one 4-rank spawn makes every check below and a 2-rank spawn runs
``bin/train.py --multichip``, each joined with a timeout.  The JAX
references are computed here on conftest's virtual CPU devices, at the
JAX tests' sizes (B = 2, T = 32 n, H = 2, N = 16; 2- and 4-block encoders
of width 16-64), with parameters from ``jax.eval_shape`` filled by numpy
(``test_torch_encoder_families.seeded_params``):

* ``wkv6_sequence_parallel`` (with and without a carried state, and the
  final state) and ``ssd_sequence_parallel`` against JAX's sharded runs
  on a 4-device mesh, within 2e-5; ``halo_exchange`` with a depthwise
  conv and ``flip_sharded``;
* the sequence-parallel bi-RWKV and bi-Mamba-2 layers against JAX's
  unsharded layers, and the sequence-parallel encoder from raw features
  (halo'd ds4, sp WKV, conv halo) against JAX's unsharded encoder on the
  window zero-padded by 6 frames with full lengths, within 3e-4;
* on a 4-block MHA ``ASRModel`` with an attention decoder and
  length-normalised loss (the token counts differ between shards): the dp
  step (loss, gradient norm, parameters after one Adam step) against
  JAX's one-device step on the global batch within 1e-5 relative, the
  dp x tp(2) loss within 1e-5, ``pp_encoder_forward`` within 1e-5 and the
  pipelined loss's gradients within 1e-3 relative of JAX's;
* ep (a 4-expert MoE over 4 ranks) within 1e-5, ``pipeline_apply`` forward
  within 1e-5 and its gradients within 1e-3 relative of JAX's;
* ``recognize_wav --seq_parallel 4 --chunk_size 160 --mode
  ctc_greedy_search``: the TXT equals the single-rank CLI's;
* ``bin/train.py --multichip`` on 2 ranks: the per-step losses of one
  process on the global batch.
"""
import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import torch_parallel_ranks as ranks
from paper_accurate_fast_cheap_tpu.models import factory as j_factory
from paper_accurate_fast_cheap_tpu.models.conformer import (
    ConformerEncoder as JEncoder)
from paper_accurate_fast_cheap_tpu.models.convolution import MoEFFNLayer
from paper_accurate_fast_cheap_tpu.models.mamba import (
    MambaAttention as JMamba)
from paper_accurate_fast_cheap_tpu.models.rwkv import RWKVAttention as JRWKV
from paper_accurate_fast_cheap_tpu.parallel import pipeline as j_pipeline
from paper_accurate_fast_cheap_tpu.parallel import sequence as j_sequence
from paper_accurate_fast_cheap_tpu.train import schedulers as j_sched
from paper_accurate_fast_cheap_tpu.train import train_step as j_ts
from paper_accurate_fast_cheap_tpu_torch.bin import recognize_wav
from paper_accurate_fast_cheap_tpu_torch.bin import train as t_train
from paper_accurate_fast_cheap_tpu_torch.convert import state_dict_from_jax
from paper_accurate_fast_cheap_tpu_torch.models import factory as t_factory
from paper_accurate_fast_cheap_tpu_torch.models.layers import init_default
from test_torch_encoder_families import seeded_params
from test_torch_train_cli import LETTERS, _shards, _wav_bytes

N_RANKS = 4
VOCAB, IDIM = 12, 8
TIGHT = dict(rtol=2e-5, atol=2e-5)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _sd(params) -> dict:
    return state_dict_from_jax(jax.tree.map(np.asarray, params))


def _sharded(fn, n_in: int, out=P(None, "seq")):
    mesh = Mesh(np.array(jax.devices()[:N_RANKS]), ("seq",))
    return jax.jit(jax.shard_map(fn, mesh=mesh,
                                 in_specs=(P(None, "seq"),) * n_in,
                                 out_specs=out))


ASR_CONFIG = {
    "model": "asr_model", "encoder": "conformer",
    "encoder_conf": {"output_size": 16, "attention_heads": 2,
                     "linear_units": 32, "num_blocks": 4,
                     "selfattention_layer_type": "selfattn",
                     "input_layer": "linear", "cnn_module_kernel": 3,
                     "dropout_rate": 0.0, "positional_dropout_rate": 0.0,
                     "attention_dropout_rate": 0.0},
    "decoder_conf": {"attention_heads": 2, "linear_units": 32,
                     "num_blocks": 1, "r_num_blocks": 0,
                     "dropout_rate": 0.0, "positional_dropout_rate": 0.0},
    "model_conf": {"ctc_weight": 0.5, "length_normalized_loss": True,
                   "lsm_weight": 0.1},
}
LR = (1e-3, 1000)


def _jax_refs(rng):
    """(the ranks' payload, the JAX references)."""
    pay, ref = {}, {}
    B, T, H, N = 2, 32 * N_RANKS, 2, 16
    mk = lambda s=1.0, sh=0.0: (rng.randn(B, T, H, N) * s + sh).astype(  # noqa
        np.float32)
    w = {"r": mk(), "k": mk(0.5), "v": mk(), "w": mk(1.0, -2.0),
         "u": (rng.randn(H, N) * 0.1).astype(np.float32),
         "S0": (rng.randn(B, H, N, N) * 0.2).astype(np.float32)}
    pay["wkv"] = {k: _t(v) for k, v in w.items()}
    mesh = Mesh(np.array(jax.devices()[:N_RANKS]), ("seq",))
    j = {k: jnp.asarray(v) for k, v in w.items()}
    # jitted: one compile costs less than the sharded program's eager ops
    wkv_sp = jax.jit(functools.partial(
        j_sequence.wkv6_sequence_parallel, mesh=mesh, chunk_size=32),
        static_argnames="return_state")
    ref["wkv_y"] = wkv_sp(j["r"], j["k"], j["v"], j["w"], j["u"])
    ref["wkv_y_s"], ref["wkv_S"] = wkv_sp(
        j["r"], j["k"], j["v"], j["w"], j["u"], state=j["S0"],
        return_state=True)

    x = rng.randn(2, 64, 8).astype(np.float32)
    wc = (rng.randn(7, 8) * 0.3).astype(np.float32)
    pay["halo"] = {"x": _t(x), "w": _t(wc)}

    def halo_conv(xs):
        xp = j_sequence.halo_exchange(xs, "seq", 3, 3)
        tl = xp.shape[1] - 6
        return sum(xp[:, k:k + tl] * wc[k] for k in range(7))

    ref["halo"] = _sharded(halo_conv, 1)(jnp.asarray(x))
    xf = rng.randn(2, 64, 4).astype(np.float32)
    pay["flip"], ref["flip"] = _t(xf), np.flip(xf, axis=1)

    Bt, Ts, Hs, Pd, G, Ns = 2, 32 * N_RANKS, 4, 16, 2, 8
    s = {"x": rng.randn(Bt, Ts, Hs, Pd), "dt": np.log1p(np.exp(
        rng.randn(Bt, Ts, Hs) - 1.0)), "A": -np.exp(rng.randn(Hs) * 0.3),
        "B": rng.randn(Bt, Ts, G, Ns) * 0.5,
        "C": rng.randn(Bt, Ts, G, Ns) * 0.5, "D": rng.randn(Hs) * 0.1}
    s = {k: v.astype(np.float32) for k, v in s.items()}
    pay["ssd"] = {k: _t(v) for k, v in s.items()}
    js = {k: jnp.asarray(v) for k, v in s.items()}
    ref["ssd"] = jax.jit(functools.partial(
        j_sequence.ssd_sequence_parallel, mesh=mesh, chunk_size=16))(
        js["x"], js["dt"], js["A"], js["B"], js["C"], js["D"])

    x = rng.randn(2, 32 * N_RANKS, 64).astype(np.float32)
    att = JRWKV(head_size=16, dim_att=64, n_layers=2, direction="bi",
                do_bfloat16=False, wkv_chunk_size=16)
    prm = seeded_params(att, rng, jnp.asarray(x))
    ref["rwkv_layer"] = jax.jit(att.apply)(prm, jnp.asarray(x))
    pay["rwkv_layer"] = {"state": _sd(prm), "x": _t(x), "kw": dict(
        head_size=16, dim_att=64, n_layers=2, direction="bi",
        do_bfloat16=False)}

    x = rng.randn(2, 32 * N_RANKS, 32).astype(np.float32)
    att = JMamba(head_size=16, d_model=32, n_layers=1, direction="bi",
                 d_state=16, chunk_size=16)
    prm = seeded_params(att, rng, jnp.asarray(x))
    ref["mamba_layer"] = jax.jit(att.apply)(prm, jnp.asarray(x))
    pay["mamba_layer"] = {"state": _sd(prm), "x": _t(x), "kw": dict(
        head_size=16, d_model=32, direction="bi", d_state=16,
        chunk_size=16)}

    conf = dict(input_size=23, output_size=32, attention_heads=2,
                linear_units=48, num_blocks=2, dropout_rate=0.0,
                positional_dropout_rate=0.0, cnn_module_kernel=7,
                input_layer="conv2d",
                selfattention_layer_type="rwkv_tmix60_bidirectional",
                rwkv_conf={"rwkv_do_bfloat16": False, "wkv_chunk_size": 16})
    T = 32 * N_RANKS
    x = rng.randn(2, T, 23).astype(np.float32)
    enc = JEncoder(**conf)
    prm = seeded_params(enc, rng, jnp.asarray(x), jnp.full((2,), T))
    ref["sp_full"] = jax.jit(enc.apply)(
        prm, jnp.pad(jnp.asarray(x), ((0, 0), (0, 6), (0, 0))),
        jnp.full((2,), T + 6))[0]
    pay["sp_full"] = {"state": _sd(prm), "x": _t(x), "conf": conf}

    x = rng.randn(2, 16, 32).astype(np.float32)
    moe = MoEFFNLayer(d_model=32, hidden=64, n_experts=N_RANKS,
                      n_expert_per_token=2)
    prm = seeded_params(moe, rng, jnp.asarray(x))
    ref["ep"] = moe.apply(prm, jnp.asarray(x))
    pay["moe"] = {"state": _sd(prm), "x": _t(x), "kw": dict(
        d_model=32, hidden=64, n_experts=N_RANKS, n_expert_per_token=2)}

    ref.update(_pipeline_refs(rng))
    pay["pipe"] = ref.pop("_pipe_payload")
    pay["asr"], asr_ref = _asr_refs(rng)
    ref.update(asr_ref)
    return pay, {k: np.asarray(v) if not isinstance(v, dict) else v
                 for k, v in ref.items()}


def _pipeline_refs(rng):
    import flax.linen as nn

    class Block(nn.Module):
        @nn.compact
        def __call__(self, x):
            return x + nn.Dense(x.shape[-1])(nn.relu(nn.Dense(24)(x)))

    blk = Block()
    x = jnp.asarray(rng.randn(2 * N_RANKS, 6, 12).astype(np.float32))
    plist = [seeded_params(blk, rng, x) for _ in range(N_RANKS)]
    stacked = j_pipeline.stack_stage_params(plist)
    mesh = Mesh(np.array(jax.devices()[:N_RANKS]), ("stage",))

    def loss(ps, x):
        y = j_pipeline.pipeline_apply(lambda p, a: blk.apply(p, a), ps, x,
                                      mesh, axis="stage",
                                      n_microbatches=N_RANKS)
        return jnp.sum(y ** 2), y

    (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(stacked, x)
    per_stage = [_sd(p) for p in plist]
    grads = [_sd(jax.tree.map(lambda a, i=i: a[i], g))
             for i in range(N_RANKS)]
    return {"pipe_y": y,
            "pipe_grads": {k: np.stack([np.asarray(gs[k]) for gs in grads])
                           for k in grads[0]},
            "_pipe_payload": {
                "stacked": {k: torch.stack([s[k] for s in per_stage])
                            for k in per_stage[0]},
                "x": _t(x), "M": N_RANKS}}


def _asr_refs(rng):
    model, _ = j_factory.init_model(ASR_CONFIG, VOCAB, IDIM)
    B, T = N_RANKS, 24
    batch = (jnp.asarray(rng.randn(B, T, IDIM).astype(np.float32)),
             jnp.asarray([24, 17, 24, 20], jnp.int32),
             jnp.asarray(rng.randint(1, VOCAB - 1, (B, 4)), jnp.int32),
             jnp.asarray([4, 3, 4, 2], jnp.int32))
    params = seeded_params(model, rng, *batch)

    def loss_fn(p, b):
        enc = model.apply(p, *b[:2], method=model.forward_encoder)
        out = model.apply(p, *enc, *b[2:], method=model.loss_from_encoder)
        return out["loss"], enc

    opt = j_ts.make_optimizer("adam", j_sched.warmup_lr(*LR), grad_clip=5.0)

    @jax.jit
    def step(p, b):
        # one program: the loss, its gradients and encoder output, the
        # global norm and one Adam step
        (loss, enc), g = jax.value_and_grad(loss_fn, has_aux=True)(p, b)
        upd, _ = opt.update(g, opt.init(p), p)
        gn = jnp.sqrt(sum(jnp.sum(a ** 2) for a in jax.tree.leaves(g)))
        return loss, g, enc, jax.tree.map(lambda a, u: a + u, p, upd), gn

    loss, grads, (enc, enc_lens), new, gn = step(params, batch)
    tb = (_t(batch[0]), torch.from_numpy(np.array(batch[1])).long(),
          torch.from_numpy(np.array(batch[2])).long(),
          torch.from_numpy(np.array(batch[3])).long())
    pay = {"config": ASR_CONFIG, "vocab": VOCAB, "idim": IDIM,
           "state": _sd(params), "batch": tb, "lr": LR}
    return pay, {"loss": float(loss), "grad_norm": float(gn),
                 "grads": ranks.as_numpy(_sd(grads)),
                 "params": ranks.as_numpy(_sd(new)), "enc": enc,
                 "enc_lens": enc_lens}


def _write_cli_inputs(d, rng):
    """A units file, CMVN, a CTC model's config and checkpoint (seeded
    weights, the blank held back so it emits) and a 4 s WAV."""
    units = os.path.join(d, "units.txt")
    with open(units, "w") as f:
        f.write("<blank> 0\n<unk> 1\n<sos/eos> 2\n▁ 3\n" + "".join(
            f"{c} {4 + i}\n" for i, c in enumerate(LETTERS)))
    cmvn = os.path.join(d, "cmvn.json")
    with open(cmvn, "w") as f:
        json.dump({"mean_stat": [8.0 * 100] * 80,
                   "var_stat": [70.0 * 100] * 80, "frame_num": 100}, f)
    config = {
        "model": "asr_model", "encoder": "conformer",
        "encoder_conf": dict(
            output_size=32, attention_heads=2, linear_units=48,
            num_blocks=2, input_layer="conv2d", cnn_module_kernel=7,
            selfattention_layer_type="rwkv_tmix60_bidirectional",
            rwkv_do_bfloat16=False),
        "decoder": None, "model_conf": {"ctc_weight": 1.0},
        "tokenizer": "char",
        "tokenizer_conf": {"symbol_table_path": units},
        "cmvn": "global_cmvn",
        "cmvn_conf": {"cmvn_file": cmvn, "is_json_cmvn": True},
        "dataset_conf": {"fbank_conf": {"num_mel_bins": 80}},
    }
    cfg = os.path.join(d, "config.json")
    with open(cfg, "w") as f:
        json.dump(config, f)
    model, _ = t_factory.init_model(config, 4 + len(LETTERS), 80,
                                    device="cpu")
    init_default(model, torch.Generator().manual_seed(3))
    with torch.no_grad():
        # the blank, <unk> and <sos/eos> held back, so letters are emitted
        model.ctc.ctc_lo.bias[:3] -= torch.tensor([1.0, 4.0, 4.0])
    ckpt = os.path.join(d, "model.pt")
    torch.save(model.state_dict(), ckpt)
    t = np.arange(16000 * 4) / 16000.0
    pcm = (np.sin(2 * np.pi * 3.0 * t) * rng.randn(t.size) * 6000).clip(
        -32768, 32767).astype(np.int16)
    wav = os.path.join(d, "sp.wav")
    with open(wav, "wb") as f:
        f.write(_wav_bytes(pcm))
    return ["--config", cfg, "--checkpoint", ckpt, "--wav", wav,
            "--mode", "ctc_greedy_search", "--chunk_size", "160",
            "--batch_size", "2", "--device", "cpu"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.RandomState(0)
    payload, ref = _jax_refs(rng)
    d = str(tmp_path_factory.mktemp("parallel"))
    cli = _write_cli_inputs(d, rng)
    payload["cli_argv"] = cli + ["--output_dir", os.path.join(d, "sp"),
                                 "--seq_parallel", str(N_RANKS)]
    assert recognize_wav.main(cli + ["--output_dir",
                                     os.path.join(d, "one")]) == 0
    got = ranks.spawn(ranks.sp_and_model_parallel, N_RANKS, d, payload)
    texts = {k: open(os.path.join(d, k, "sp.txt")).read()
             for k in ("one", "sp")}
    return ranks.as_numpy(got), ref, texts


@pytest.mark.parametrize("key", ["wkv_y", "wkv_y_s", "wkv_S", "ssd"])
def test_sequence_parallel_ops_match_jax_sharded(runs, key):
    got, ref, _ = runs
    np.testing.assert_allclose(got[key], ref[key], **TIGHT)


@pytest.mark.parametrize("key", ["halo", "flip"])
def test_halo_exchange_and_flip(runs, key):
    got, ref, _ = runs
    np.testing.assert_allclose(got[key], ref[key], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("key", ["rwkv_layer", "mamba_layer", "sp_full"])
def test_sequence_parallel_layers_and_encoder(runs, key):
    """The layers against JAX's unsharded layers; the encoder from raw
    features against JAX's unsharded encoder on the +6-padded window."""
    got, ref, _ = runs
    assert got[key].shape == ref[key].shape
    np.testing.assert_allclose(got[key], ref[key], rtol=3e-4, atol=3e-4)


def test_sequence_parallel_collectives_counted(runs):
    """The sp encoder's collectives: per bi-RWKV block two all-gathers of
    (A, B) per direction, and ppermutes for the halos and flips."""
    c = runs[0]["sp_full_counts"]
    assert c["all_gather"]["calls"] == 2 * 2 * 2
    # (A, B) at B=2, H=2, N=16: 2*2*16*4 + 2*2*16*16*4 bytes a direction
    assert c["all_gather"]["bytes"] == 2 * 2 * (256 + 4096)
    assert c["ppermute"]["calls"] > 0 and c["psum"]["calls"] == 0


def test_sequence_parallel_refusals(runs):
    """JAX's refusals on the ranks: T not divisible by the axis, lengths
    under sequence parallelism, a ds4 shard not divisible by 4."""
    msgs = runs[0]["refusals"]
    assert len(msgs) == 3, msgs
    assert "not divisible by mesh axis seq=4" in msgs[0]
    assert "full-length" in msgs[1]
    assert "divisible by 4" in msgs[2]


def test_parallel_flags_without_ranks_raise(tmp_path):
    """--seq_parallel, --multichip and --pp_stages without a process group
    of the right size raise, as JAX does with too few devices; pp refuses
    the direction-dropout attention."""
    from paper_accurate_fast_cheap_tpu_torch.parallel import mesh as t_mesh
    from paper_accurate_fast_cheap_tpu_torch.parallel import pp_encoder

    with pytest.raises(SystemExit, match="needs 2 ranks"):
        recognize_wav.main(["--config", "c.json", "--checkpoint", "m.pt",
                            "--wav", "x.wav", "--output_dir", "out",
                            "--seq_parallel", "2", "--chunk_size", "160",
                            "--device", "cpu"])
    with pytest.raises(SystemExit, match="divide by 4"):
        recognize_wav.main(["--config", "c.json", "--checkpoint", "m.pt",
                            "--wav", "x.wav", "--output_dir", "out",
                            "--seq_parallel", "2", "--chunk_size", "100",
                            "--device", "cpu"])
    base = ["--config", "c.json", "--train_data", "t.list", "--model_dir",
            str(tmp_path), "--device", "cpu"]
    with pytest.raises(ValueError, match="--multichip needs"):
        t_train.main(base + ["--multichip"])
    with pytest.raises(ValueError, match="--pp_stages 2 needs"):
        t_train.main(base + ["--pp_stages", "2"])
    conf = dict(ASR_CONFIG, encoder_conf=dict(
        ASR_CONFIG["encoder_conf"],
        selfattention_layer_type="rwkv_tmix60_dir_layer_drop"))
    model, _ = t_factory.init_model(conf, VOCAB, IDIM, device="cpu")
    with pytest.raises(ValueError, match="branches on layer id"):
        pp_encoder.pp_encoder_forward(
            model.encoder, torch.zeros(1, 8, IDIM), torch.tensor([8]),
            t_mesh.make_mesh(1, ("stage",)))


def test_dp_step_matches_jax_one_device(runs):
    got, ref, _ = runs
    assert abs(float(got["dp_loss"]) - ref["loss"]) <= 1e-5 * ref["loss"]
    assert abs(float(got["dp_grad_norm"]) - ref["grad_norm"]) <= (
        1e-5 * ref["grad_norm"])
    scale = max(np.abs(v).max() for v in ref["params"].values())
    err = max(np.abs(got["dp_params"][k] - ref["params"][k]).max()
              for k in ref["params"])
    assert err <= 1e-5 * scale, err


def test_dp_tp_forward_matches_jax(runs):
    got, ref, _ = runs
    assert abs(float(got["dp_tp_loss"]) - ref["loss"]) <= 1e-5 * ref["loss"]


def test_ep_forward_matches_jax(runs):
    got, ref, _ = runs
    np.testing.assert_allclose(got["ep"], ref["ep"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["ep_rep"], ref["ep"], rtol=1e-5,
                               atol=1e-5)


def test_pipeline_apply_matches_jax(runs):
    got, ref, _ = runs
    np.testing.assert_allclose(got["pipe_y"], ref["pipe_y"], rtol=1e-5,
                               atol=1e-5)
    for k, g in ref["pipe_grads"].items():
        assert np.abs(got["pipe_grads"][k] - g).max() <= (
            1e-3 * np.abs(g).max()), k


def test_pp_encoder_forward_matches_jax(runs):
    got, ref, _ = runs
    np.testing.assert_array_equal(got["pp_lens"], ref["enc_lens"])
    np.testing.assert_allclose(got["pp_enc"], ref["enc"], rtol=1e-5,
                               atol=1e-5)


def test_pp_loss_gradients_match_jax(runs):
    got, ref, _ = runs
    assert abs(float(got["pp_loss"]) - ref["loss"]) <= 1e-5 * ref["loss"]
    assert set(got["pp_grads"]) == set(ref["grads"])
    # a key bias's gradient is zero but for f32 noise (softmax ignores
    # it): each tensor's error is bounded by 1e-3 of its own scale plus
    # 1e-6 of the largest gradient's
    scale = max(np.abs(g).max() for g in ref["grads"].values())
    for k, g in ref["grads"].items():
        assert np.abs(got["pp_grads"][k] - g).max() <= (
            1e-3 * np.abs(g).max() + 1e-6 * scale), k


def test_recognize_wav_seq_parallel_matches_one_rank(runs):
    texts = runs[2]
    assert texts["sp"] == texts["one"]
    assert texts["one"].strip()


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dp_train"))
    # TensorBoard's import (seconds) is kept out of both runs: their
    # metrics.jsonl is what is compared (ranks.train_cli does the same)
    mp_ = pytest.MonkeyPatch()
    mp_.setitem(sys.modules, "torch.utils.tensorboard", None)
    rng = np.random.RandomState(11)
    units = os.path.join(d, "units.txt")
    with open(units, "w") as f:
        f.write("<blank> 0\n<unk> 1\n<sos/eos> 2\n▁ 3\n" + "".join(
            f"{c} {4 + i}\n" for i, c in enumerate(LETTERS)))
    shards = _shards(d, "tr", rng, 8, 0.5, 1.0, 4)
    config = {
        "model": "asr_model", "encoder": "conformer",
        "encoder_conf": dict(output_size=16, attention_heads=2,
                             linear_units=32, num_blocks=2,
                             input_layer="conv2d", cnn_module_kernel=3,
                             dropout_rate=0.0, positional_dropout_rate=0.0,
                             selfattention_layer_type="rwkv_tmix60_"
                             "bidirectional", rwkv_do_bfloat16=False),
        "decoder": None, "model_conf": {"ctc_weight": 1.0},
        "tokenizer": "char", "tokenizer_conf": {"symbol_table_path": units},
        "dataset_conf": {
            "fbank_conf": {"num_mel_bins": 80, "dither": 0.0},
            "spec_aug": False, "shuffle": True, "sort": False,
            "batch_conf": {"batch_type": "static", "batch_size": 4}},
        "grad_clip": 5.0, "optim": "adam", "optim_conf": {"lr": 0.002},
        "scheduler": "warmuplr", "scheduler_conf": {"warmup_steps": 10},
        "log_interval": 1, "max_epoch": 1,
    }
    cfg = os.path.join(d, "train.json")
    with open(cfg, "w") as f:
        json.dump(config, f)
    argv = ["--config", cfg, "--train_data", shards, "--data_type", "shard",
            "--seed", "5", "--device", "cpu"]
    one, dp = os.path.join(d, "one"), os.path.join(d, "dp")
    assert t_train.main(argv + ["--model_dir", one]) == 0
    mp_.undo()
    ranks.spawn(ranks.train_cli, 2, d,
                argv + ["--model_dir", dp, "--multichip"])
    return one, dp


def _losses(run_dir):
    with open(os.path.join(run_dir, "logs", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [(r["step"], r["train/loss"]) for r in recs if "train/loss" in r]


def test_train_multichip_matches_one_process(train_runs):
    one, dp = train_runs
    l1, l2 = _losses(one), _losses(dp)
    assert len(l1) == 2 and [s for s, _ in l1] == [s for s, _ in l2]
    for (_, a), (_, b) in zip(l1, l2):
        assert abs(a - b) <= 1e-5 * abs(a), (l1, l2)
    assert sorted(os.listdir(dp)) == sorted(os.listdir(one))


def test_tp_and_ep_specs_follow_jax():
    """``tp_param_spec`` and ``ep_param_spec`` shard what JAX's rules
    shard, in the port's names and (out, in) layout: a JAX kernel's
    P(None, 'model') is the port's ('model', None)."""
    from paper_accurate_fast_cheap_tpu.parallel import mesh as j_mesh
    from paper_accurate_fast_cheap_tpu_torch.parallel import mesh as t_mesh

    model, _ = j_factory.init_model(ASR_CONFIG, VOCAB, IDIM)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, IDIM)), jnp.asarray([8]),
                            jnp.ones((1, 2), jnp.int32), jnp.asarray([2]))
    moe = MoEFFNLayer(d_model=8, hidden=16, n_experts=4)
    shapes = {"asr": shapes, "moe": jax.eval_shape(
        moe.init, jax.random.PRNGKey(0), jnp.zeros((1, 2, 8)))}
    checked = {"tp": 0, "ep": 0}
    for path, leaf in jax.tree_util.tree_leaves_with_path(shapes):
        keys = [p.key for p in path][2:]               # drop tag, params
        shape = tuple(leaf.shape)
        name = ".".join(keys)
        if keys[-1] == "kernel":
            name = name[:-len("kernel")] + "weight"
            shape = shape[::-1]
        jpath = jax.tree_util.keystr(path)
        for rule, j_rule, t_rule in (
                ("tp", j_mesh.tp_param_spec, t_mesh.tp_param_spec),
                ("ep", j_mesh.ep_param_spec, t_mesh.ep_param_spec)):
            want = tuple(j_rule(jpath, leaf.shape))
            if keys[-1] == "kernel":
                want = want[::-1]
            assert t_rule(name, shape) == want, (rule, name)
            checked[rule] += bool(want)
    assert checked["tp"] > 4 and checked["ep"] == 2, checked


def test_split_merge_encoder_params_roundtrip():
    """``split_encoder_params`` stacks the blocks (S, L / S, ...) under
    ``layer.*`` and ``self_attn.*``; ``merge_encoder_params`` restores the
    encoder's state dict."""
    from paper_accurate_fast_cheap_tpu_torch.parallel import pp_encoder

    model, _ = t_factory.init_model(ASR_CONFIG, VOCAB, IDIM, device="cpu")
    enc = model.encoder.state_dict()
    rest, stacked = pp_encoder.split_encoder_params(enc, 4, 2)
    assert not any(k.startswith(("layer_", "MultiHeadedAttention_"))
                   for k in rest)
    some = next(k for k in stacked if k.startswith("self_attn."))
    assert stacked[some].shape[:2] == (2, 2)
    back = pp_encoder.merge_encoder_params(rest, stacked, 4, 2,
                                           attn_base="MultiHeadedAttention")
    assert set(back) == set(enc)
    for k, v in enc.items():
        assert torch.equal(back[k], v), k
    with pytest.raises(ValueError, match="not divisible"):
        pp_encoder.split_encoder_params(enc, 4, 3)
