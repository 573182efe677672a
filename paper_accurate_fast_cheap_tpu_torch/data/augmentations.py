"""Waveform-level augmentations on the host (port of the JAX
``data/augmentations.py``): convolutional RIR reverb, a telephony channel
(3.4 kHz lowpass, mu-law companding round trip, 8 kHz round trip, with
scipy) and the amplitude / phase distortion family.  The same random
sources as JAX: ``random.Random`` (or the ``random`` module) for the
choices, numpy's global ``np.random`` for the distortions, so one seed
gives JAX's waveforms.  Generators over sample dicts, composable into the
data pipeline.
"""
from __future__ import annotations

import logging
import random
from typing import Iterable, Iterator, List, Optional

import numpy as np

log = logging.getLogger(__name__)


class RIREngine:
    """Convolutional reverb from a set of room impulse responses."""

    def __init__(self, rirs: List[np.ndarray], prob: float = 0.5,
                 rng: Optional[random.Random] = None):
        self.rirs = [np.asarray(r, np.float32) for r in rirs]
        self.prob = prob
        self.rng = rng or random

    def __call__(self, samples: Iterable[dict]) -> Iterator[dict]:
        from scipy.signal import fftconvolve

        for s in samples:
            if self.rirs and self.rng.random() < self.prob:
                rir = self.rng.choice(self.rirs)
                rir = rir / (np.abs(rir).max() + 1e-8)
                wet = fftconvolve(s["wav"], rir)[: len(s["wav"])]
                peak = np.abs(s["wav"]).max() + 1e-8
                wet = wet * (peak / (np.abs(wet).max() + 1e-8))
                s = dict(s, wav=wet.astype(np.float32))
            yield s


def apply_telephony(samples: Iterable[dict], prob: float = 0.5,
                    rng: Optional[random.Random] = None) -> Iterator[dict]:
    """Telephony channel: lowpass ~3.4 kHz, mu-law-like companding round
    trip, 8 kHz round trip."""
    from scipy.signal import butter, resample_poly, sosfilt

    rng = rng or random
    sos = None
    for s in samples:
        if rng.random() < prob:
            sr = s["sample_rate"]
            if sos is None:
                sos = butter(6, 3400, btype="low", fs=sr, output="sos")
            wav = sosfilt(sos, s["wav"]).astype(np.float32)
            # simple compander: mu-law-ish soft compression round trip
            mu = 255.0
            comp = np.sign(wav) * np.log1p(mu * np.abs(wav)) / np.log1p(mu)
            wav = (np.sign(comp) * (np.power(1 + mu, np.abs(comp)) - 1)
                   / mu).astype(np.float32)
            g = np.gcd(sr, 8000)
            down = resample_poly(wav, 8000 // g, sr // g)
            wav = resample_poly(down, sr // g, 8000 // g).astype(np.float32)
            wav = wav[: len(s["wav"])]
            if len(wav) < len(s["wav"]):
                wav = np.pad(wav, (0, len(s["wav"]) - len(wav)))
            s = dict(s, wav=wav)
        yield s


def _amp_clip(wav, rate=0.3, threshold=0.6):
    out = wav.copy()
    mask = np.random.rand(len(wav)) < rate
    out[mask] = np.clip(out[mask], -threshold, threshold)
    return out


def _amp_jitter(wav, scale=0.15):
    return wav * (1.0 + np.random.uniform(-scale, scale, len(wav))
                  ).astype(np.float32)


def _phase_jitter(wav, scale=0.1):
    spec = np.fft.rfft(wav)
    phase = np.random.uniform(-scale * np.pi, scale * np.pi, len(spec))
    return np.fft.irfft(spec * np.exp(1j * phase), len(wav)).astype(
        np.float32)


DISTORTIONS = {
    "amp_clip": _amp_clip,
    "amp_jitter": _amp_jitter,
    "phase_jitter": _phase_jitter,
}


def distort_wav(samples: Iterable[dict], distort_types: List[str] = None,
                prob: float = 0.3,
                rng: Optional[random.Random] = None) -> Iterator[dict]:
    """Random amplitude / phase distortions, each with probability
    ``prob``."""
    rng = rng or random
    types = distort_types or list(DISTORTIONS)
    for s in samples:
        if rng.random() < prob:
            fn = DISTORTIONS[rng.choice(types)]
            s = dict(s, wav=fn(s["wav"]).astype(np.float32))
        yield s
