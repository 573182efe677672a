"""The port's predictor step (K3's plain version) against the JAX package:
the Pallas kernel in interpret mode and ``RNNPredictor.forward_step``.
f32 throughout; tolerance 1e-5 (same f32 gate arithmetic, summation order
aside)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from paper_accurate_fast_cheap_tpu.models.predictor import (
    RNNPredictor as JRNNPredictor)
from paper_accurate_fast_cheap_tpu.ops import lstm_pallas
from paper_accurate_fast_cheap_tpu_torch.convert import state_dict_from_jax
from paper_accurate_fast_cheap_tpu_torch.models.predictor import (
    RNNPredictor as TRNNPredictor)
from paper_accurate_fast_cheap_tpu_torch.ops.lstm_step import (
    lstm_predictor_step, lstm_step_plain)

VOCAB, E, H, O, L, R = 80, 128, 128, 128, 2, 16


def _weights(seed):
    rng = np.random.RandomState(seed)
    layers = [((rng.randn(E if i == 0 else H, 4 * H) * 0.1).astype(np.float32),
               (rng.randn(4 * H) * 0.1).astype(np.float32),
               (rng.randn(H, 4 * H) * 0.1).astype(np.float32))
              for i in range(L)]
    wp = (rng.randn(H, O) * 0.1).astype(np.float32)
    bp = (rng.randn(O) * 0.1).astype(np.float32)
    x = rng.randn(R, E).astype(np.float32)
    hs = np.tanh(rng.randn(L, R, H)).astype(np.float32)
    cs = rng.randn(L, R, H).astype(np.float32)
    return layers, wp, bp, x, hs, cs


def test_step_matches_jax_pallas_interpret():
    layers, wp, bp, x, hs, cs = _weights(0)
    jo, jh, jc = lstm_pallas.lstm_predictor_step(
        jnp.asarray(x), jnp.asarray(hs), jnp.asarray(cs),
        tuple(tuple(jnp.asarray(a) for a in lay) for lay in layers),
        jnp.asarray(wp), jnp.asarray(bp))
    t_layers = [(torch.from_numpy(wih.T.copy()), torch.from_numpy(bih),
                 torch.from_numpy(whh.T.copy())) for wih, bih, whh in layers]
    args = (torch.from_numpy(x), torch.from_numpy(hs), torch.from_numpy(cs),
            t_layers, torch.from_numpy(wp.T.copy()), torch.from_numpy(bp))
    to, th, tc = lstm_step_plain(*args)
    for a, b in ((to, jo), (th, jh), (tc, jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    # the K3 wrapper on CPU tensors is the plain version
    for a, b in zip(lstm_predictor_step(*args), (to, th, tc)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_predictor_forward_step_matches_jax():
    """Two AR steps of the converted predictor from the zero state."""
    jp = JRNNPredictor(vocab_size=VOCAB, embed_size=E, hidden_size=H,
                       output_size=O, num_layers=L)
    tok = jnp.asarray(np.random.RandomState(1).randint(1, VOCAB, R),
                      jnp.int32)
    st = jp.init_state(R)
    params = jp.init(jax.random.PRNGKey(0), tok, st,
                     method=JRNNPredictor.forward_step)
    tp = TRNNPredictor(VOCAB, E, H, O, L)
    tp.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)))
    tstate = tp.init_state(R)
    assert tstate[0].dtype == torch.float32
    ttok = torch.from_numpy(np.asarray(tok))
    for _ in range(2):
        jo, st = jp.apply(params, tok, st, method=JRNNPredictor.forward_step)
        with torch.no_grad():
            to, tstate = tp.forward_step(ttok, tstate)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
        for a, b in zip(tstate, st):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
        tok = (tok * 7 + 3) % VOCAB
        ttok = torch.from_numpy(np.asarray(tok))
