"""Feature pipeline: waveform batch -> model features (port of the
``train=False`` path of the JAX ``frontend/pipeline.py``: int16 scaling,
fbank, global CMVN)."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from paper_accurate_fast_cheap_tpu_torch import resolve_device
from paper_accurate_fast_cheap_tpu_torch.frontend import features
from paper_accurate_fast_cheap_tpu_torch.frontend.cmvn import apply_cmvn


def make_feature_fn(conf: Optional[Dict[str, Any]] = None,
                    cmvn_stats: Optional[Tuple] = None, device=None):
    """Build featurize(wavs (B, S) float in [-1, 1], wav_lens (B,),
    train=False) -> (feats (B, F, M) f32, feat_lens (B,) int32), on
    ``device`` (``cuda`` unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    conf = conf or {}
    fb = conf.get("fbank_conf", {})
    num_mel = fb.get("num_mel_bins", 80)
    frame_len = fb.get("frame_length", 25) * 16  # ms -> samples at 16 kHz
    frame_shift = fb.get("frame_shift", 10) * 16

    def featurize(wavs, wav_lens, train: bool = False):
        if train:
            raise NotImplementedError(
                "train-time dither/SpecAugment wait for the training slice")
        wavs = torch.as_tensor(wavs, device=dev) * 32768.0  # int16 scale
        feats, feat_lens = features.fbank_batch(
            wavs, torch.as_tensor(wav_lens, device=dev),
            num_mel_bins=num_mel, frame_length=frame_len,
            frame_shift=frame_shift)
        if cmvn_stats is not None:
            feats = apply_cmvn(feats, cmvn_stats[0], cmvn_stats[1])
        return feats, feat_lens

    return featurize
