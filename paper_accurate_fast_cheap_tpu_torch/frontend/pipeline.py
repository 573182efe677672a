"""Feature pipeline: waveform batch -> model features (port of the JAX
``frontend/pipeline.py``): int16 scaling, fbank (with dither in training),
global CMVN, then in training spec_sub and SpecAugment, in JAX's order.
Training draws come from the caller's ``torch.Generator`` on the device;
``train=False`` draws nothing."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from paper_accurate_fast_cheap_tpu_torch import resolve_device
from paper_accurate_fast_cheap_tpu_torch.frontend import augment, features
from paper_accurate_fast_cheap_tpu_torch.frontend.cmvn import apply_cmvn


def make_feature_fn(conf: Optional[Dict[str, Any]] = None,
                    cmvn_stats: Optional[Tuple] = None, device=None):
    """Build featurize(wavs (B, S) float in [-1, 1], wav_lens (B,),
    train=False, generator=None) -> (feats (B, F, M) f32, feat_lens (B,)
    int32), on ``device`` (``cuda`` unless the caller asks for the CPU).
    With ``train=True`` the config's dither, spec_sub and spec_aug draw from
    ``generator`` (on ``device``)."""
    dev = resolve_device(device)
    conf = conf or {}
    fb = conf.get("fbank_conf", {})
    num_mel = fb.get("num_mel_bins", 80)
    frame_len = fb.get("frame_length", 25) * 16  # ms -> samples at 16 kHz
    frame_shift = fb.get("frame_shift", 10) * 16
    dither = float(fb.get("dither", 0.0))
    spec_aug_on = conf.get("spec_aug", False)
    sa = conf.get("spec_aug_conf", {})
    spec_sub_on = conf.get("spec_sub", False)
    ss = conf.get("spec_sub_conf", {})

    def featurize(wavs, wav_lens, train: bool = False,
                  generator: Optional[torch.Generator] = None):
        augmenting = train and (dither > 0.0 or spec_aug_on or spec_sub_on)
        if augmenting and generator is None:
            raise ValueError("train-time features need a generator")
        wavs = torch.as_tensor(wavs, device=dev) * 32768.0  # int16 scale
        feats, feat_lens = features.fbank_batch(
            wavs, torch.as_tensor(wav_lens, device=dev),
            num_mel_bins=num_mel, frame_length=frame_len,
            frame_shift=frame_shift, dither=dither if train else 0.0,
            generator=generator)
        if cmvn_stats is not None:
            feats = apply_cmvn(feats, cmvn_stats[0], cmvn_stats[1])
        if train and spec_sub_on:
            feats = augment.spec_sub(
                feats, feat_lens, generator, max_t=ss.get("max_t", 20),
                num_t_sub=ss.get("num_t_sub", 3))
        if train and spec_aug_on:
            feats = augment.spec_aug(
                feats, feat_lens, generator,
                num_t_mask=sa.get("num_t_mask", 2),
                num_f_mask=sa.get("num_f_mask", 2),
                max_t=sa.get("max_t", 50), max_f=sa.get("max_f", 10))
        return feats, feat_lens

    return featurize
