"""Audio file reading (port of the JAX ``data/pipeline.py`` readers, with the
``resample_poly`` step of its ``bin/recognize_wav.py``).

``read_audio_bytes`` sniffs the container as the JAX package does: FLAC
(``data/flac.py``, the native decoder), RIFF/WAV (native ``parse_wav``;
the standard library's ``wave`` for what it refuses), Ogg/Opus and MP3
(``data/codecs.py``, the system libraries) and m4a (the libav shim).  Mono
is the channel mean.  Another container raises ``ValueError``.
"""
from __future__ import annotations

import io
import wave

import numpy as np


def read_wav_bytes(data: bytes):
    """RIFF/WAV bytes -> (mono float32 samples in [-1, 1], sample rate),
    through the native RIFF parser (PCM8/16/32)."""
    from paper_accurate_fast_cheap_tpu_torch import native

    out = native.parse_wav(data)
    if out is not None:
        return out
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


def read_audio_bytes(data: bytes, ext=None):
    """Sniff the container and decode to (mono float32, sample rate)."""
    if data[:4] == b"fLaC":
        from paper_accurate_fast_cheap_tpu_torch.data import flac

        out = flac.decode_flac(data)
        if out is None:
            raise ValueError("flac decode failed")
        x, sr = out
        if x.ndim == 2:
            x = x.mean(axis=1)
        return x, sr
    if data[:4] == b"RIFF":
        return read_wav_bytes(data)
    from paper_accurate_fast_cheap_tpu_torch.data import codecs

    if data[:4] == b"OggS":
        return codecs.decode_ogg_opus(data)
    if codecs.sniff_mp3(data):
        return codecs.decode_mp3(data)
    if codecs.sniff_mp4(data):
        return codecs.decode_m4a(data)
    raise ValueError(
        f"unsupported audio format (ext={ext!r}); supported: wav, flac, "
        "ogg/opus, mp3, m4a"
    )


def resample_to(wav: np.ndarray, sr: int, target: int = 16000):
    """Polyphase resampling to ``target`` Hz (a no-op at that rate)."""
    if sr == target:
        return wav, sr
    from scipy.signal import resample_poly

    g = np.gcd(sr, target)
    return resample_poly(wav, target // g, sr // g).astype(np.float32), target
