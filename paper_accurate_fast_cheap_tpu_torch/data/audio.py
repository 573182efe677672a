"""Audio file reading for the long-form CLI (port of the RIFF/WAV part of
the JAX ``data/pipeline.py`` readers, with the ``resample_poly`` step of its
``bin/recognize_wav.py``).

Only RIFF/WAV is read, by the standard library's ``wave`` parser; FLAC,
Ogg/Opus, MP3 and m4a are not ported yet (ROADMAP Queue 1, item 15) and
raise.
"""
from __future__ import annotations

import io
import wave

import numpy as np


def read_wav_bytes(data: bytes):
    """RIFF/WAV bytes -> (mono float32 samples in [-1, 1], sample rate)."""
    with wave.open(io.BytesIO(data)) as w:
        sr = w.getframerate()
        n = w.getnframes()
        sw = w.getsampwidth()
        ch = w.getnchannels()
        raw = w.readframes(n)
    if sw == 2:
        arr = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif sw == 4:
        arr = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif sw == 1:
        arr = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128) / 128.0
    else:
        raise ValueError(f"unsupported sample width {sw}")
    if ch > 1:
        arr = arr.reshape(-1, ch).mean(axis=1)
    return arr, sr


def read_audio_bytes(data: bytes):
    """Sniff the container and decode to (mono float32, sample rate)."""
    if data[:4] == b"RIFF":
        return read_wav_bytes(data)
    raise NotImplementedError(
        "the port reads RIFF/WAV only; FLAC, Ogg/Opus, MP3 and m4a are not "
        "ported yet (ROADMAP Queue 1, item 15)")


def resample_to(wav: np.ndarray, sr: int, target: int = 16000):
    """Polyphase resampling to ``target`` Hz (a no-op at that rate)."""
    if sr == target:
        return wav, sr
    from scipy.signal import resample_poly

    g = np.gcd(sr, target)
    return resample_poly(wav, target // g, sr // g).astype(np.float32), target
