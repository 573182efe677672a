"""Kaldi-compatible log-mel filterbank (port of the JAX
``frontend/features.py``: snip_edges framing, DC removal, preemphasis 0.97,
povey window, power spectrum over a 512-point FFT, Kaldi mel banks from
20 Hz to nyquist, natural log with a float-epsilon floor).  Written with
``torch.fft.rfft``.  ``dither`` adds ``dither * N(0, 1)`` noise to each
frame before the DC removal, from the caller's ``torch.Generator``.
``mfcc`` is Kaldi's: fbank, an orthonormal DCT-II, cepstral liftering."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

_KALDI_EPS = 1.1920928955078125e-07  # float32 machine epsilon, Kaldi's floor


def mel_scale(freq):
    return 1127.0 * np.log1p(np.asarray(freq, np.float64) / 700.0)


def kaldi_mel_banks(num_bins: int, fft_size: int, sample_rate: float,
                    low_freq: float = 20.0,
                    high_freq: float = 0.0) -> np.ndarray:
    """Kaldi triangular mel filterbank (num_bins, fft_size // 2 + 1), with a
    zero nyquist column; high_freq <= 0 means nyquist + high_freq."""
    nyquist = 0.5 * sample_rate
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq
    num_fft_bins = fft_size // 2
    fft_bin_width = sample_rate / fft_size
    mel_low = mel_scale(low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    mel_of_bin = mel_scale(fft_bin_width * np.arange(num_fft_bins))
    banks = np.zeros((num_bins, num_fft_bins + 1), np.float64)
    for b in range(num_bins):
        left = mel_low + b * mel_delta
        center = mel_low + (b + 1) * mel_delta
        right = mel_low + (b + 2) * mel_delta
        up = (mel_of_bin - left) / (center - left)
        down = (right - mel_of_bin) / (right - center)
        banks[b, :num_fft_bins] = np.clip(np.minimum(up, down), 0.0, None)
    return banks.astype(np.float32)


def _povey_window(n: int) -> np.ndarray:
    a = 2.0 * math.pi / (n - 1)
    return (0.5 - 0.5 * np.cos(a * np.arange(n))) ** 0.85


def num_frames(num_samples: int, frame_length: int = 400,
               frame_shift: int = 160) -> int:
    """snip_edges=True frame count."""
    if num_samples < frame_length:
        return 0
    return 1 + (num_samples - frame_length) // frame_shift


def fbank_batch(waveforms: torch.Tensor, lengths: torch.Tensor,
                num_mel_bins: int = 80, frame_length: int = 400,
                frame_shift: int = 160, sample_rate: int = 16000,
                preemphasis: float = 0.97, round_to_power_of_two: bool = True,
                use_power: bool = True, remove_dc_offset: bool = True,
                dither: float = 0.0, generator=None):
    """Batched Kaldi fbank over padded int16-scaled waveforms (B, S) ->
    ((B, F, bins) f32, frame_lens (B,) int32).  Padded samples only reach
    the trailing frames, which callers mask with ``frame_lens``."""
    B, S = waveforms.shape
    nf = num_frames(S, frame_length, frame_shift)
    fft_size = frame_length
    if round_to_power_of_two:
        fft_size = 1 << (frame_length - 1).bit_length()
    dev = waveforms.device
    frames = waveforms.float().unfold(1, frame_length, frame_shift)[:, :nf]
    if dither != 0.0:
        if generator is None:
            raise ValueError("dither > 0 needs a generator")
        frames = frames + dither * torch.randn(
            frames.shape, generator=generator, device=dev)
    if remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if preemphasis != 0.0:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - preemphasis * prev
    frames = frames * torch.tensor(_povey_window(frame_length),
                                   dtype=torch.float32, device=dev)
    if fft_size > frame_length:
        frames = F.pad(frames, (0, fft_size - frame_length))
    power = torch.fft.rfft(frames, n=fft_size).abs()
    if use_power:
        power = power * power
    banks = torch.tensor(kaldi_mel_banks(num_mel_bins, fft_size,
                                         float(sample_rate)), device=dev)
    mel = power @ banks.T
    feats = torch.log(torch.clamp(mel, min=_KALDI_EPS))
    lengths = lengths.to(dev)
    frame_lens = torch.where(
        lengths < frame_length, torch.zeros_like(lengths),
        1 + torch.div(lengths - frame_length, frame_shift,
                      rounding_mode="floor")).to(torch.int32)
    return feats, frame_lens


def fbank(waveform: torch.Tensor, **kw) -> torch.Tensor:
    """Kaldi fbank of one waveform (num_samples,) -> (frames, bins)."""
    lens = torch.tensor([waveform.shape[0]], device=waveform.device)
    return fbank_batch(waveform[None], lens, **kw)[0][0]


def mfcc(waveform: torch.Tensor, num_mel_bins: int = 23, num_ceps: int = 13,
         frame_length: int = 400, frame_shift: int = 160,
         sample_rate: int = 16000, dither: float = 0.0, generator=None,
         cepstral_lifter: float = 22.0, low_freq: float = 20.0,
         high_freq: float = 0.0) -> torch.Tensor:
    """Kaldi MFCC of one waveform (num_samples,) -> (frames, num_ceps):
    the fbank's log-mel rows times the first ``num_ceps`` rows of the
    orthonormal DCT-II, then scaled by 1 + (L / 2) sin(pi i / L) when the
    lifter L > 0.  ``low_freq`` and ``high_freq`` are accepted and unused,
    as in the JAX function (the fbank's banks span 20 Hz to nyquist)."""
    lens = torch.tensor([waveform.shape[0]], device=waveform.device)
    fb = fbank_batch(waveform[None], lens, num_mel_bins=num_mel_bins,
                     frame_length=frame_length, frame_shift=frame_shift,
                     sample_rate=sample_rate, dither=dither,
                     generator=generator)[0][0]
    n = num_mel_bins
    j = np.arange(n)
    dct = np.cos(np.pi / n * (j[None, :] + 0.5)
                 * np.arange(num_ceps)[:, None]) * np.sqrt(2.0 / n)
    dct[0] *= np.sqrt(0.5)
    ceps = fb @ torch.tensor(dct.astype(np.float32), device=fb.device).T
    if cepstral_lifter > 0:
        i = np.arange(num_ceps)
        lifter = 1.0 + 0.5 * cepstral_lifter * np.sin(
            np.pi * i / cepstral_lifter)
        ceps = ceps * torch.tensor(lifter.astype(np.float32),
                                   device=fb.device)
    return ceps


def whisper_log_mel(waveform: torch.Tensor, n_fft: int = 400,
                    hop_length: int = 160, num_mel_bins: int = 80,
                    sample_rate: int = 16000) -> torch.Tensor:
    """Whisper's log-mel spectrogram of one [-1, 1] waveform (not int16
    scaled): a centred Hann STFT (reflect padding), its last frame dropped,
    Slaney mel banks, log10 over a 1e-10 floor, clamped at the maximum
    minus 8, then (x + 4) / 4.  Returns (frames, num_mel_bins) f32 on the
    waveform's device.  ``torch.fft.rfft`` and JAX's FFT differ in quiet
    bins (as the fbank's)."""
    pad = n_fft // 2
    w = F.pad(waveform.to(torch.float32)[None, None], (pad, pad),
              mode="reflect")[0, 0]
    n = torch.arange(n_fft, device=w.device, dtype=torch.float32)
    window = 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / n_fft)
    frames = w.unfold(0, n_fft, hop_length) * window
    mag = torch.fft.rfft(frames, n=n_fft).abs() ** 2
    banks = torch.from_numpy(slaney_mel_banks(num_mel_bins, n_fft,
                                              sample_rate)).to(w.device)
    mel = mag[:-1] @ banks.T
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    return (log_spec + 4.0) / 4.0


def slaney_mel_banks(n_mels: int, n_fft: int, sr: int) -> np.ndarray:
    """librosa.filters.mel's defaults: the Slaney scale and area norm,
    (n_mels, n_fft // 2 + 1) f32."""
    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(f >= 1000.0, 15.0 + np.log(
            np.maximum(f, 1e-10) / 1000.0) / np.log(6.4) * 27.0,
            f / (200.0 / 3.0))

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0
                                                   * (m - 15.0)),
                        m * (200.0 / 3.0))

    fmax = sr / 2.0
    hzs = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(fmax), n_mels + 2))
    fft_freqs = np.linspace(0, fmax, 1 + n_fft // 2)
    fdiff = np.diff(hzs)
    ramps = hzs[:, None] - fft_freqs[None, :]
    weights = np.zeros((n_mels, len(fft_freqs)))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    weights *= (2.0 / (hzs[2:n_mels + 2] - hzs[:n_mels]))[:, None]
    return weights.astype(np.float32)
