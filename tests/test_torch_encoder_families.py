"""The port's encoder families (``models/encoder_registry.py``) against the
JAX package's, on the same weights.

Every family and block layout the JAX registry builds, at a tiny size
(input 16, d 32, 2 heads, 2-6 blocks), f32, ``.eval()``, ragged lengths
(45 and 29 frames) so the masks matter: the transformer encoder (with and
without ``after_norm``), the conformer without the macaron FFN, without
the conv module, without ``after_norm`` (``normalize_before=False``) and
with ``batch_norm`` at eval (running statistics carried from flax's
``batch_stats``), the branchformer's three merges and its single-branch
blocks, the E-Branchformer, the squeezeformer's one- and two-level time
U-Nets (the shapes of the JAX package's own test) and the efficient
conformer's stride and group configurations.  Each encoder's output and
lengths match JAX's within 1e-5 (absolute and relative).

JAX's parameters are not initialised by flax: ``jax.eval_shape`` gives the
tree and numpy fills it from a seed (scales near 1, variances positive,
biases and kernels random), which skips flax's eager init and makes every
leaf's layout matter.  One jitted apply per case.  Training draws
(stochastic depth, attention-branch drop) cannot match flax's bit for bit:
they are checked by their rates.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paper_accurate_fast_cheap_tpu.models import encoder_registry as j_reg
from paper_accurate_fast_cheap_tpu_torch.convert import state_dict_from_jax
from paper_accurate_fast_cheap_tpu_torch.models import encoder_registry as t_reg
from paper_accurate_fast_cheap_tpu_torch.models.branchformer import (
    BranchformerLayer)

TOL = dict(rtol=1e-5, atol=1e-5)
BASE = dict(input_size=16, output_size=32, attention_heads=2,
            linear_units=64, num_blocks=2, input_layer="linear",
            dropout_rate=0.1)


def seeded_params(module, rng, *args, **kw):
    """The flax variables of ``module`` (params and any batch_stats) for
    ``args`` (and static ``kw``), filled from ``rng`` (numpy)."""
    shapes = jax.eval_shape(functools.partial(module.init, **kw),
                            jax.random.PRNGKey(0), *args)

    def fill(path, sd):
        leaf, sh = path[-1].key, sd.shape
        if leaf in ("scale", "var"):
            return (1.0 + 0.2 * np.abs(rng.randn(*sh))).astype(np.float32)
        if len(sh) >= 2:
            return (rng.randn(*sh) / np.sqrt(np.prod(sh[:-1]))).astype(
                np.float32)
        return (0.2 * rng.randn(*sh)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _inputs(seed, T=45, lens=(45, 29), idim=16):
    rng = np.random.RandomState(seed)
    return (rng.randn(len(lens), T, idim).astype(np.float32),
            np.asarray(lens, np.int32))


def run_both(family, conf, seed=0):
    """(JAX output, JAX lengths, port output, port lengths, port encoder)
    for one encoder family and conf on seeded inputs and weights."""
    x, lens = _inputs(seed)
    jx = jnp.asarray(x), jnp.asarray(lens)
    jenc = j_reg.build_encoder(family, conf)
    params = seeded_params(jenc, np.random.RandomState(seed + 100), *jx)
    want, wl = jax.jit(jenc.apply)(params, *jx)[:2]
    tenc = t_reg.build_encoder(family, conf)
    tenc.load_state_dict(state_dict_from_jax(params))
    tenc.eval()
    with torch.no_grad():
        got, gl = tenc(torch.from_numpy(x), torch.from_numpy(lens))[:2]
    return (np.asarray(want), np.asarray(wl), got.numpy(), gl.numpy(),
            tenc)


CASES = {
    "transformer": ("transformer", {}),
    "transformer_no_after_norm": ("transformer",
                                  dict(normalize_before=False)),
    "conformer_no_macaron": ("conformer", dict(macaron_style=False)),
    "conformer_no_cnn": ("conformer", dict(use_cnn_module=False)),
    "conformer_no_after_norm": ("conformer", dict(normalize_before=False)),
    "conformer_batch_norm": ("conformer", dict(cnn_module_norm="batch_norm")),
    "branchformer_concat": ("branchformer", dict(cgmlp_linear_units=48)),
    "e_branchformer": ("e_branchformer", dict(cgmlp_linear_units=48)),
    "squeezeformer_one_level": ("squeezeformer",
                                dict(num_blocks=4, reduce_idx=1,
                                     recover_idx=3)),
    "squeezeformer_two_levels": ("squeezeformer",
                                 dict(num_blocks=6, reduce_idx=[1, 2],
                                      recover_idx=[3, 5])),
    "efficient_stride3_groups": ("efficient_conformer",
                                 dict(num_blocks=4, stride_layers=(1,),
                                      strides=(3,), group_layers=(0, 2))),
    "efficient_default_groups": ("efficient_conformer",
                                 dict(num_blocks=3, stride_layers=(1,),
                                      group_size=4)),
}
# lengths after the encoder (45 and 29 frames in)
LENGTHS = {"efficient_stride3_groups": [15, 10],
           "efficient_default_groups": [23, 15]}


@pytest.mark.parametrize("case", list(CASES))
def test_family_matches_jax(case):
    family, kw = CASES[case]
    want, wl, got, gl, tenc = run_both(family, dict(BASE, **kw))
    assert got.shape == want.shape
    np.testing.assert_array_equal(gl, wl)
    assert gl.tolist() == LENGTHS.get(case, [45, 29])
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("merge", [
    dict(merge_method="learned_ave"),
    dict(merge_method="fixed_ave", cgmlp_weight=[0.3, 0.7]),
    dict(use_attn=False), dict(use_cgmlp=False)],
    ids=["learned_ave", "fixed_ave", "cgmlp_only", "attn_only"])
def test_branchformer_merges_match_jax(merge):
    """The merges and single-branch blocks (keys the YAML route drops, so
    the encoders are built directly)."""
    from paper_accurate_fast_cheap_tpu.models.branchformer import (
        BranchformerEncoder as JB)
    from paper_accurate_fast_cheap_tpu_torch.models.branchformer import (
        BranchformerEncoder as TB)

    conf = dict(input_size=16, output_size=32, attention_heads=2,
                cgmlp_linear_units=48, num_blocks=2, input_layer="linear",
                **merge)
    x, lens = _inputs(3)
    jx = jnp.asarray(x), jnp.asarray(lens)
    jenc = JB(**conf)
    params = seeded_params(jenc, np.random.RandomState(4), *jx)
    want, _ = jax.jit(jenc.apply)(params, *jx)
    tenc = TB(**conf)
    tenc.load_state_dict(state_dict_from_jax(params))
    with torch.no_grad():
        got, _ = tenc.eval()(torch.from_numpy(x), torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_registry_keeps_jax_key_sets():
    """A YAML's keys of another family are dropped as JAX drops them:
    ``merge_method`` never reaches a branchformer through the registry,
    the E-Branchformer defaults its macaron FFNs and merge conv, and
    ``is_chunkable`` holds for the conformer only."""
    conf = dict(BASE, cgmlp_linear_units=48, merge_method="fixed_ave",
                macaron_style=False, reduce_idx=3)
    b = t_reg.build_encoder("branchformer", conf)
    assert b.layer_0.merge_method == "concat"
    assert not hasattr(b.layer_0, "feed_forward")
    e = t_reg.build_encoder("e_branchformer", conf)
    assert hasattr(e.layer_0, "feed_forward")
    assert e.layer_0.merge_conv.kernel_size == (3,)
    lora = t_reg.build_encoder("lora_conformer", conf)
    assert not hasattr(lora.layer_0, "feed_forward_macaron")
    assert t_reg.is_chunkable(lora)
    assert not t_reg.is_chunkable(b)
    with pytest.raises(NotImplementedError, match="whisper"):
        t_reg.build_encoder("whisper", conf)


def test_batch_norm_does_not_train():
    """The conv module's batch_norm runs at eval only: a training forward
    (the train step's) refuses it, naming the missing batch_stats."""
    enc = t_reg.build_encoder("conformer", dict(
        BASE, cnn_module_norm="batch_norm"))
    x, lens = map(torch.from_numpy, _inputs(5))
    with pytest.raises(NotImplementedError, match="batch_stats"):
        enc.train()(x, lens)
    with torch.no_grad():
        assert torch.isfinite(enc.eval()(x, lens)[0]).all()


def test_stochastic_depth_and_branch_drop_rates():
    """Training draws by rate: stochastic depth 0.5 returns the block's
    input on about half the calls (and never in ``.eval()``), and an
    attention-branch drop of 1 gives the cgMLP-only merge."""
    torch.manual_seed(0)
    layer = BranchformerLayer(32, 2, 48, dropout_rate=0.0,
                              stochastic_depth_rate=0.5)
    x = torch.randn(2, 9, 32)
    mask = torch.ones(2, 9, dtype=torch.bool)
    pos = torch.randn(1, 9, 32)
    layer.train()
    skipped = sum(bool(torch.equal(layer(x, mask[:, None], pos, mask), x))
                  for _ in range(400))
    assert 160 <= skipped <= 240, skipped
    layer.eval()
    assert not torch.equal(layer(x, mask[:, None], pos, mask), x)

    ave = BranchformerLayer(32, 2, 48, dropout_rate=0.0,
                            merge_method="learned_ave",
                            attn_branch_drop_rate=1.0)
    with torch.no_grad():
        ave.train()
        got = ave(x, mask[:, None], pos, mask)
        ave.eval()
        y1 = ave.attn(*(2 * (ave.norm_mha(x),)), mask[:, None], pos)
        y2 = ave.cgmlp(ave.norm_mlp(x), mask)
        want = ave.norm_final(x + ave.merge_proj(0.0 * y1 + 1.0 * y2))
    torch.testing.assert_close(got, want)
