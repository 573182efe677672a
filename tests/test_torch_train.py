"""The port's training step against the JAX package.

* A tiny transducer of the flagship family (2 bi-RWKV-6 conformer blocks of
  width 32, a 2-layer LSTM predictor, V = 50), f32 with
  ``rwkv_do_bfloat16: False``, in eval mode: the loss dict and every
  gradient against the JAX model's on the same weights (the port's seeded
  init carried into the flax tree by the inverse of
  ``convert.state_dict_from_jax``) and the same numpy batch.
* The optimizer against optax: parameters and counts after three steps of
  adam, adamw with weight decay, accumulation over two microbatches, and a
  step the skip rule discards; the three schedules at several steps.
* Mixed precision, dropout in ``.train()``, parameter freezing, and the
  ``train_bench`` CLI on the CPU.

Tolerances: f32 1e-5 relative on losses, 1e-4 on gradients and on
parameters (relative to each tensor's largest entry); schedules 1e-6 (JAX
computes them in f32, the port in f64).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paper_accurate_fast_cheap_tpu.models import factory as j_factory
from paper_accurate_fast_cheap_tpu.train import schedulers as j_sched
from paper_accurate_fast_cheap_tpu.train import train_step as j_ts
from paper_accurate_fast_cheap_tpu_torch.bin import train_bench
from paper_accurate_fast_cheap_tpu_torch.convert import state_dict_from_jax
from paper_accurate_fast_cheap_tpu_torch.models import factory as t_factory
from paper_accurate_fast_cheap_tpu_torch.train import schedulers as t_sched
from paper_accurate_fast_cheap_tpu_torch.train import train_step as t_ts

VOCAB = 50
CONFIG = {
    "model": "transducer",
    "encoder": "conformer",
    "encoder_conf": dict(
        output_size=32, attention_heads=2, linear_units=64, num_blocks=2,
        cnn_module_kernel=15, dropout_rate=0.1, positional_dropout_rate=0.1,
        selfattention_layer_type="rwkv_tmix60_bidirectional",
        rwkv_do_bfloat16=False),
    "predictor": "rnn",
    "predictor_conf": {"embed_size": 32, "output_size": 32,
                       "embed_dropout": 0.1, "hidden_size": 32,
                       "num_layers": 2, "dropout": 0.1},
    "joint_conf": {"join_dim": 32},
    "decoder": None,
    "model_conf": {"ctc_weight": 0.3, "transducer_weight": 0.7,
                   "attention_weight": 0.0},
}


def _batch():
    rng = np.random.RandomState(0)
    return (rng.randn(2, 120, 80).astype(np.float32),
            np.asarray([120, 100], np.int32),
            rng.randint(1, VOCAB, (2, 6)).astype(np.int32),
            np.asarray([6, 4], np.int32))


def _flax_params_from_port(shapes, sd):
    """The inverse of convert.state_dict_from_jax over the flax tree's
    shapes: the port's tensors in the flax layouts."""
    def leaf(path, s):
        names = [p.key for p in path][1:]            # drop "params"
        parent, name = ".".join(names[:-1]), names[-1]
        if name == "kernel":
            arr = sd[parent + ".weight"].numpy()
            arr = arr.transpose({2: (1, 0), 3: (2, 1, 0),
                                 4: (2, 3, 1, 0)}[arr.ndim])
        elif name in ("scale", "embedding"):
            arr = sd[parent + ".weight"].numpy()
        elif name == "hh":
            arr = sd[parent + ".hh"].numpy().T
        else:
            arr = sd[".".join(names)].numpy()
        assert arr.shape == s.shape, (names, arr.shape, s.shape)
        return jnp.asarray(np.ascontiguousarray(arr))

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def tiny():
    feats, flens, labels, llens = _batch()
    tmodel, _ = t_factory.init_model(CONFIG, VOCAB, 80, device="cpu")
    jmodel, _ = j_factory.init_model(CONFIG, VOCAB, 80)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 80)), jnp.asarray([64]),
                            jnp.ones((1, 4), jnp.int32), jnp.asarray([4]))
    params = _flax_params_from_port(shapes, tmodel.state_dict())

    def loss(p):
        out = jmodel.apply(p, *map(jnp.asarray, (feats, flens, labels,
                                                  llens)))
        return out["loss"], out

    (_, j_out), j_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    return {"tmodel": tmodel, "params": params, "j_out": j_out,
            "j_grads": state_dict_from_jax(jax.tree.map(np.asarray,
                                                        j_grads)),
            "batch": tuple(map(torch.from_numpy, (feats, flens, labels,
                                                  llens)))}


def _port_loss(tiny):
    m = tiny["tmodel"].eval()
    m.zero_grad()
    out = m(*tiny["batch"])
    out["loss"].backward()
    return out


def test_weights_round_trip(tiny):
    sd = tiny["tmodel"].state_dict()
    back = state_dict_from_jax(jax.tree.map(np.asarray, tiny["params"]))
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)


def test_loss_dict_matches_jax(tiny):
    out = _port_loss(tiny)
    assert set(out) == set(tiny["j_out"])
    for k in ("loss", "loss_rnnt", "loss_ctc"):
        np.testing.assert_allclose(float(out[k].detach()),
                                   float(tiny["j_out"][k]), rtol=1e-5)
    assert float(out["loss_att"]) == 0.0 == float(tiny["j_out"]["loss_att"])


def test_every_gradient_matches_jax(tiny):
    _port_loss(tiny)
    grads = dict(tiny["tmodel"].named_parameters())
    assert set(grads) == set(tiny["j_grads"])
    for name, p in grads.items():
        want = tiny["j_grads"][name].numpy()
        err = np.abs(p.grad.numpy() - want).max() / (np.abs(want).max()
                                                      + 1e-12)
        assert err < 1e-4, (name, err)


def test_dropout_follows_train_mode(tiny):
    """Dropout is active in .train(): one seed gives one loss, two seeds
    two; .eval() gives the deterministic loss again."""
    m = tiny["tmodel"]
    losses = []
    with torch.no_grad():
        m.train()
        for seed in (1, 1, 2):
            torch.manual_seed(seed)
            losses.append(float(m(*tiny["batch"])["loss"]))
        m.eval()
        det = float(m(*tiny["batch"])["loss"])
    assert losses[0] == losses[1] != losses[2]
    np.testing.assert_allclose(det, float(tiny["j_out"]["loss"]), rtol=1e-5)


def test_attention_decoder_loss_raises():
    """The attention decoder's loss is ported: a ``decoder:`` config with
    attention weight > 0 trains (its values are held to JAX in
    ``tests/test_torch_decoder.py``), on the conformer and on the other
    encoder families too (here the branchformer, whose values are held to
    JAX in ``tests/test_torch_encoder_families.py``).  As in JAX, a
    ``model:`` other than transducer builds the ``ASRModel``, and what
    raises is a transducer predictor outside rnn, embedding and conv."""
    conf = dict(CONFIG, decoder="bitransformer",
                decoder_conf={"attention_heads": 2, "linear_units": 32,
                              "num_blocks": 1, "r_num_blocks": 1},
                model_conf={"attention_weight": 0.5, "reverse_weight": 0.3})
    m, _ = t_factory.init_model(conf, VOCAB, 80, device="cpu")
    feats, flens, labels, llens = map(torch.from_numpy, _batch())
    out = m(feats, flens, labels, llens)
    assert float(out["loss_att"].detach()) > 0
    assert np.isfinite(float(out["loss"].detach()))
    bm, _ = t_factory.init_model(dict(conf, encoder="branchformer"), VOCAB,
                                 80, device="cpu")
    assert type(bm.encoder).__name__ == "BranchformerEncoder"
    out = bm(feats, flens, labels, llens)
    assert float(out["loss_att"].detach()) > 0
    assert np.isfinite(float(out["loss"].detach()))
    km, kind = t_factory.init_model(dict(conf, model="k2_model"), VOCAB, 80,
                                    device="cpu")
    jm, jkind = j_factory.init_model(dict(conf, model="k2_model"), VOCAB, 80)
    assert (type(km).__name__, kind) == (type(jm).__name__, jkind) == (
        "ASRModel", "asr_model")
    with pytest.raises(NotImplementedError, match="predictor 'lstm'"):
        t_factory.init_model(dict(CONFIG, predictor="lstm"), VOCAB, 80,
                             device="cpu")


# ---- optimizer, schedules and the step against optax ----

def _quadratic():
    rng = np.random.RandomState(1)
    params = {"a": rng.randn(3, 4).astype(np.float32),
              "b": rng.randn(4).astype(np.float32)}
    batches = [(rng.randn(4, 3).astype(np.float32),
                rng.randn(4, 4).astype(np.float32)) for _ in range(3)]
    return params, batches


def _j_loss(p, batch, rng):
    x, y = batch
    return jnp.mean((x @ p["a"] + p["b"] - y) ** 2), {}


def _t_loss(p, batch, seed):
    x, y = batch
    return torch.mean((x @ p["a"] + p["b"] - y) ** 2), {}


@pytest.mark.parametrize("optim,wd,accum,skip_step", [
    ("adam", 0.0, 1, None),
    ("adamw", 0.05, 1, None),
    ("adam", 0.0, 2, None),
    ("adam", 0.0, 1, 1),       # the second step's gradient spikes: skipped
])
def test_steps_match_optax(optim, wd, accum, skip_step):
    params, batches = _quadratic()
    if skip_step is not None:
        x, y = batches[skip_step]
        batches[skip_step] = (x, y * 1e4)
    if accum > 1:
        batches = [tuple(a.reshape((accum, -1) + a.shape[1:]) for a in b)
                   for b in batches]
    kw = dict(accum_steps=accum, clip_hard_maxvalue=50.0)
    j_opt = j_ts.make_optimizer(optim, j_sched.steady_lr(0.1, 2),
                                weight_decay=wd, grad_clip=1.0)
    j_step = jax.jit(j_ts.make_train_step(_j_loss, j_opt, **kw))
    j_state = j_ts.init_train_state(jax.tree.map(jnp.asarray, params), j_opt)
    t_opt = t_ts.make_optimizer(optim, t_sched.steady_lr(0.1, 2),
                                weight_decay=wd, grad_clip=1.0)
    t_step = t_ts.make_train_step(_t_loss, t_opt, **kw)
    t_state = t_ts.init_train_state(
        {k: torch.from_numpy(v) for k, v in params.items()}, t_opt)
    for i, b in enumerate(batches):
        j_state, j_l, j_m = j_step(j_state, tuple(map(jnp.asarray, b)),
                                   jax.random.PRNGKey(i))
        t_state, t_l, t_m = t_step(t_state, tuple(map(torch.from_numpy, b)),
                                   i)
        np.testing.assert_allclose(float(t_l), float(j_l), rtol=1e-5)
        np.testing.assert_allclose(float(t_m["grad_norm"]),
                                   float(j_m["grad_norm"]), rtol=1e-5)
        assert float(t_m["skipped"]) == float(j_m["skipped"]) == float(
            i == skip_step)
        for k in params:
            want = np.asarray(j_state.params[k])
            np.testing.assert_allclose(t_state.params[k].numpy(), want,
                                       rtol=0, atol=1e-4 * np.abs(want).max())
    adam = j_state.opt_state[1]
    # optax keeps a count in scale_by_adam and one in the schedule's state;
    # the port's one count must equal both
    assert t_state.opt_state["count"] == int(adam.count) == int(
        j_state.opt_state[-1].count)
    assert t_state.step == int(j_state.step) == 3
    for k in params:
        np.testing.assert_allclose(t_state.opt_state["nu"][k].numpy(),
                                   np.asarray(adam.nu[k]), rtol=1e-4,
                                   atol=1e-8)


@pytest.mark.parametrize("name,args", [
    ("warmup_lr", (1e-3, 25000)),
    ("steady_lr", (2e-3, 100)),
    ("noam_hold_annealing", (1e-3, 100, 50, 400, 0.5, 1e-5)),
])
def test_schedules_match_jax(name, args):
    j, t = getattr(j_sched, name)(*args), getattr(t_sched, name)(*args)
    for step in (0, 1, 7, 99, 100, 149, 150, 300, 25000, 40000):
        np.testing.assert_allclose(t(step), float(j(jnp.asarray(step))),
                                   rtol=1e-6)


def test_mixed_precision_keeps_f32_masters(tiny):
    """The forward sees bf16 copies; the gradients come back in f32 through
    the cast and the updated masters stay f32."""
    m = tiny["tmodel"].eval()
    seen = []

    def loss_fn(p, batch, seed):
        seen.append({v.dtype for v in p.values()})
        return torch.func.functional_call(m, p, batch)["loss"], {}

    params = {n: p.detach().clone() for n, p in m.named_parameters()}
    leaves = [p.clone().requires_grad_() for p in params.values()]
    loss, _ = t_ts.wrap_mixed_precision(loss_fn)(
        dict(zip(params, leaves)), tiny["batch"], 0)
    grads = torch.autograd.grad(loss, leaves)
    assert {g.dtype for g in grads} == {torch.float32}
    opt = t_ts.make_optimizer("adam", 1e-3)
    step = t_ts.make_train_step(t_ts.wrap_mixed_precision(loss_fn), opt)
    state, loss, met = step(t_ts.init_train_state(params, opt),
                            tiny["batch"], 0)
    assert seen == [{torch.bfloat16}] * 2
    assert loss.dtype == torch.float32 and np.isfinite(float(loss))
    assert {p.dtype for p in state.params.values()} == {torch.float32}
    assert {p.dtype for p in state.opt_state["mu"].values()} == {
        torch.float32}
    assert any(not torch.equal(state.params[n], params[n]) for n in params)


def test_learning_mask_freezes_matching_params():
    params, batches = _quadratic()
    mask = t_ts.restrict_learning_mask(params, exclude="^a$")
    assert mask == {"a": False, "b": True}
    assert t_ts.restrict_learning_mask(params, exclude=".", include="b") == \
        {"a": False, "b": True}
    opt = t_ts.make_optimizer("adam", 0.1)
    step = t_ts.make_train_step(_t_loss, opt, trainable_mask=mask)
    p0 = {k: torch.from_numpy(v) for k, v in params.items()}
    state, _, _ = step(t_ts.init_train_state(p0, opt),
                       tuple(map(torch.from_numpy, batches[0])), 0)
    assert torch.equal(state.params["a"], p0["a"])
    assert not torch.equal(state.params["b"], p0["b"])


# ---- the CLI ----

# the report keys of the JAX CLI (bin/train_bench.py:192-206, with
# --profile), in order
REPORT_KEYS = ["model", "step_time_ms", "steps_per_sec",
               "audio_hours_per_compute_hour", "frames_per_sec", "batch",
               "precision", "final_loss", "warmup_plus_compile_s", "device",
               "profile_forward_ms", "profile_backward_ms",
               "profile_fwd_plus_bwd_ms", "profile_optimizer_clip_accum_ms",
               "profile_note"]


def test_train_bench_cli_on_cpu(tmp_path, capsys):
    cfg = {
        "model": "transducer", "encoder": "conformer",
        "encoder_conf": {"output_size": 32, "attention_heads": 2,
                         "linear_units": 48, "num_blocks": 1,
                         "selfattention_layer_type":
                             "rwkv_tmix60_bidirectional"},
        "predictor": "rnn",
        "predictor_conf": {"embed_size": 32, "hidden_size": 32,
                           "output_size": 32, "num_layers": 1},
        "joint_conf": {"join_dim": 32},
        "model_conf": {"ctc_weight": 0.3, "transducer_weight": 0.7,
                       "attention_weight": 0.0},
        "vocab_size_for_bench": 40, "accum_grad": 2, "grad_clip": 5.0,
    }
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(cfg))
    out = tmp_path / "train.bench"
    argv = ["--config", str(path), "--batch_size", "2", "--frames", "120",
            "--label_len", "6", "--warmup", "1", "--iters", "2",
            "--output", str(out), "--mixed_precision", "--profile",
            "--platform", "cpu", "--set", "grad_clip=1.5"]
    assert train_bench.main(argv + ["--device", "cpu"]) == 0
    lines = out.read_text().splitlines()
    assert [ln.split()[0] for ln in lines] == REPORT_KEYS
    assert capsys.readouterr().out.splitlines() == lines
    rep = {ln.split()[0]: ln.split(None, 1)[1] for ln in lines}
    assert rep["batch"] == "2 frames 120 labels 6 accum 2"
    assert rep["precision"] == "mixed_bf16" and rep["device"] == "cpu"
    assert np.isfinite(float(rep["final_loss"]))
    assert train_bench.get_args(argv).overrides == ["grad_clip=1.5"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_bench.main(argv)
