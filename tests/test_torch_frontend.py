"""The port's fbank + CMVN against the JAX package's
``make_feature_fn(train=False)``: about 1e-3 on log-mel (two FFT
implementations on int16-scale frames)."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paper_accurate_fast_cheap_tpu.frontend import cmvn as j_cmvn
from paper_accurate_fast_cheap_tpu.frontend import features as j_features
from paper_accurate_fast_cheap_tpu.frontend import pipeline as j_pipeline
from paper_accurate_fast_cheap_tpu_torch.frontend import cmvn as t_cmvn
from paper_accurate_fast_cheap_tpu_torch.frontend import features as t_features
from paper_accurate_fast_cheap_tpu_torch.frontend import pipeline as t_pipeline


@pytest.mark.parametrize("with_cmvn", [False, True])
def test_feature_fn_matches_jax(with_cmvn):
    rng = np.random.RandomState(0)
    lens = np.asarray([8000, 6321, 390], np.int32)   # ragged, one < 1 frame
    wavs = (rng.randn(3, 8000) * 0.1).astype(np.float32)
    for i, n in enumerate(lens):
        wavs[i, n:] = 0.0
    stats = None
    if with_cmvn:
        stats = ((rng.randn(80) + 8.0).astype(np.float32),
                 (0.3 + 0.05 * rng.rand(80)).astype(np.float32))
    conf = {"fbank_conf": {"num_mel_bins": 80, "frame_length": 25,
                           "frame_shift": 10}}
    jf, jl = j_pipeline.make_feature_fn(conf, stats)(jnp.asarray(wavs),
                                                     jnp.asarray(lens))
    tf, tl = t_pipeline.make_feature_fn(conf, stats, device="cpu")(
        torch.from_numpy(wavs), torch.from_numpy(lens))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tf.shape == jf.shape and tf.dtype == torch.float32
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-3)


def test_helpers_match_jax(tmp_path):
    np.testing.assert_array_equal(t_features.kaldi_mel_banks(80, 512, 16000.),
                                  j_features.kaldi_mel_banks(80, 512, 16000.))
    for n in (0, 399, 400, 16000, 16161):
        assert t_features.num_frames(n) == j_features.num_frames(n)
    rng = np.random.RandomState(1)
    stats = {"mean_stat": (rng.rand(80) * 1e3).tolist(),
             "var_stat": (rng.rand(80) * 1e5 + 1e4).tolist(),
             "frame_num": 100}
    path = tmp_path / "cmvn.json"
    path.write_text(json.dumps(stats))
    for a, b in zip(t_cmvn.load_cmvn_json(str(path)),
                    j_cmvn.load_cmvn_json(str(path))):
        np.testing.assert_array_equal(a, b)


def test_single_fbank_matches_batch():
    wav = torch.from_numpy(
        (np.random.RandomState(2).randn(4000) * 3000).astype(np.float32))
    one = t_features.fbank(wav)
    batch, lens = t_features.fbank_batch(wav[None], torch.tensor([4000]))
    np.testing.assert_array_equal(one.numpy(), batch[0].numpy())
    assert int(lens[0]) == one.shape[0] == t_features.num_frames(4000)
