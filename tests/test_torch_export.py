"""The port's encoder + CTC export (``tools/export_model.py``) against eager
and the JAX package's.

The bi-RWKV bench YAML narrowed to 2 blocks of width 32 (f32 WKV; the JAX
side on its chunked WKV, the plain reference of its Pallas kernel) is
initialised in JAX; its weights reach the port through
``convert.state_dict_from_jax``.  ``torch.export`` traces encoder +
``ctc_logprobs`` at static (1, 131, 80); the bytes of ``torch.export.save``
load back through ``load_exported``.  The graph holds K1 as its registered
operator ``pafc_torch::wkv6_fwd`` (one node a direction a block), the
loaded program equals eager exactly on the CPU, and both are within 1e-5
of JAX's ``export_encoder_ctc`` + ``load_exported`` on the same inputs."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paper_accurate_fast_cheap_tpu.models import factory as j_factory
from paper_accurate_fast_cheap_tpu.tools import export_model as j_export
from paper_accurate_fast_cheap_tpu.utils.config import load_config
from paper_accurate_fast_cheap_tpu_torch.convert import state_dict_from_jax
from paper_accurate_fast_cheap_tpu_torch.models import factory as t_factory
from paper_accurate_fast_cheap_tpu_torch.tools import export_model as t_export

VOCAB = 50
FRAMES = 131
YAML = "examples/gigaspeech/conf/bench_rwkvbi_ds4k31nc_12le.yaml"


@pytest.fixture(scope="module")
def exported():
    conf = load_config(YAML)
    conf["encoder_conf"].update(output_size=32, attention_heads=2,
                                linear_units=64, num_blocks=2,
                                rwkv_do_bfloat16=False)
    j_conf = copy.deepcopy(conf)
    j_conf["encoder_conf"]["wkv_impl"] = "chunked"
    model, _ = j_factory.init_model(j_conf, VOCAB, 80)
    # jitted: one compile costs less on the CPU than the eager op stream
    params = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 80)), jnp.asarray([64]),
        jnp.ones((1, 4), jnp.int32), jnp.asarray([4]))
    tmodel, _ = t_factory.init_model(conf, VOCAB, 80, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, params)))
    tmodel.eval()
    rng = np.random.RandomState(0)
    feats = rng.randn(1, FRAMES, 80).astype(np.float32)
    lens = np.asarray([FRAMES], np.int32)
    blob = t_export.export_encoder_ctc(tmodel, frames=FRAMES)
    j_blob = j_export.export_encoder_ctc(model, params, frames=FRAMES)
    j_out = j_export.load_exported(j_blob)(params, jnp.asarray(feats),
                                           jnp.asarray(lens))
    return dict(tmodel=tmodel, blob=blob, feats=feats, lens=lens,
                j_logp=np.asarray(j_out[0]), j_lens=np.asarray(j_out[1]))


def test_graph_holds_the_wkv6_operator(exported):
    ops = t_export.graph_ops(t_export.load_exported(exported["blob"]))
    # 2 blocks x 2 directions, and the CPU's plain version is not traced
    assert ops.count("pafc_torch.wkv6_fwd.default") == 4
    assert not any("wkv6_chunked" in o for o in ops)


def test_loaded_program_equals_eager_and_jax(exported, tmp_path):
    path = tmp_path / "enc_ctc.pt2"
    t_export.save_exported(str(path), exported["blob"])
    fn = t_export.load_exported(path.read_bytes())
    feats = torch.from_numpy(exported["feats"])
    lens = torch.from_numpy(exported["lens"])
    with torch.no_grad():
        logp, elens = fn(feats, lens)
        m = exported["tmodel"]
        enc, e_lens = m.forward_encoder(feats, lens)
        eager = m.ctc_logprobs(enc)
    assert logp.shape == (1, (FRAMES - 3) // 4, VOCAB)
    torch.testing.assert_close(logp, eager, rtol=0, atol=0)
    assert torch.equal(elens, e_lens)
    np.testing.assert_array_equal(elens.numpy(), exported["j_lens"])
    np.testing.assert_allclose(logp.numpy(), exported["j_logp"], atol=1e-5)


def test_export_smoke_test():
    # one block of width 16: the smoke test exports its own 128 frames
    conf = load_config(YAML)
    conf["encoder_conf"].update(output_size=16, attention_heads=1,
                                linear_units=16, num_blocks=1)
    model, _ = t_factory.init_model(conf, VOCAB, 80, device="cpu")
    assert t_export.export_smoke_test(model)
