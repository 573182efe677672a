"""Host C++ helpers, loaded with ctypes and built at first use.

Two shared libraries, each from its own source beside this file:

- ``pafc_native.cpp`` (``lib()``): ``parse_wav`` (RIFF PCM8/16/32 to mono
  float32), ``flac_decode``, ``levenshtein_counts`` and ``resample_linear``;
  no link dependency.
- ``pafc_av.cpp`` (``av_lib()``): m4a/AAC decode and encode over the system
  libavformat/libavcodec 59, linked with ``-lavformat -lavcodec -lavutil
  -lswresample``.  The runtime libavformat must report major 59, the ABI
  the shim's headers describe: a mismatched ABI corrupts memory silently
  rather than erroring, so another major raises.

Each builds with ``g++ -O3 -march=native -std=c++17 -shared -fPIC`` into the
package's git-ignored ``_build/``, never into the source tree, as
``lib<name>-<hash>.so``; the hash covers the source, the flags and the
host's CPU (``-march=native`` code is the host's own).  A failed build or
load raises: there is no silent fallback, and the Python versions of the
callers (``data/flac._decode_python``, ``tools/wer.align_words_python``)
are the tests' references.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")
AV_LINK = ("-lavformat", "-lavcodec", "-lavutil", "-lswresample")
# the libavformat major the shim's headers describe (FFmpeg 5.1)
AV_MAJOR = 59

_lock = threading.Lock()
_libs: dict = {}


class NativeError(RuntimeError):
    pass


def _cpu_key() -> bytes:
    """The host CPU's model and flags: ``-march=native`` code built on one
    machine may not run on another."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))]
        return "".join(sorted(set(lines))).encode()
    except OSError:
        return b""


def lib_path(name: str, link=()) -> str:
    h = hashlib.sha256()
    with open(os.path.join(_DIR, f"{name}.cpp"), "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS + tuple(link)).encode())
    h.update(_cpu_key())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build(name: str, link=()) -> str:
    """Compile ``<name>.cpp`` into ``_build/`` unless built; returns the
    library's path.  Raises :class:`NativeError` with g++'s output."""
    out = lib_path(name, link)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *CXX_FLAGS, os.path.join(_DIR, f"{name}.cpp"), "-o", tmp,
           *link]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeError(f"g++ could not build {name}.cpp: {e}") from e
    if r.returncode != 0:
        raise NativeError(f"g++ failed for {name}.cpp (rc {r.returncode}):\n"
                          f"{r.stderr[-4000:]}")
    os.replace(tmp, out)   # atomic: a concurrent build never sees a part
    return out


def _load(name: str, link=()) -> ctypes.CDLL:
    path = build(name, link)
    try:
        return ctypes.CDLL(path)
    except OSError as e:
        raise NativeError(f"loading {path} failed: {e}") from e


_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def lib() -> ctypes.CDLL:
    """``pafc_native``, built and typed at first use."""
    with _lock:
        L = _libs.get("native")
        if L is not None:
            return L
        L = _load("pafc_native")
        L.levenshtein_counts.restype = ctypes.c_int
        L.levenshtein_counts.argtypes = [_i32p, ctypes.c_int32, _i32p,
                                         ctypes.c_int32, _i32p]
        L.parse_wav.restype = ctypes.c_int64
        L.parse_wav.argtypes = [_u8p, ctypes.c_int64, _f32p, ctypes.c_int64,
                                _i32p]
        L.resample_linear.restype = None
        L.resample_linear.argtypes = [_f32p, ctypes.c_int64, _f32p,
                                      ctypes.c_int64]
        L.flac_decode.restype = ctypes.c_int64
        L.flac_decode.argtypes = [_u8p, ctypes.c_int64, _i32p,
                                  ctypes.c_int64, _i32p, _i32p, _i32p]
        _libs["native"] = L
        return L


def av_lib() -> ctypes.CDLL:
    """``pafc_av``, built, version-checked and typed at first use."""
    with _lock:
        L = _libs.get("av")
        if L is not None:
            return L
        L = _load("pafc_av", AV_LINK)
        L.pafc_av_version.restype = ctypes.c_uint32
        L.pafc_av_version.argtypes = []
        run_major = int(L.pafc_av_version()) >> 16
        if run_major != AV_MAJOR:
            raise NativeError(
                f"libavformat major {run_major} at run time, the shim is "
                f"written against {AV_MAJOR}: refusing a mismatched ABI")
        L.pafc_av_decode.restype = ctypes.c_int64
        L.pafc_av_decode.argtypes = [_u8p, ctypes.c_int64,
                                     ctypes.POINTER(_f32p), _i32p]
        L.pafc_av_free.restype = None
        L.pafc_av_free.argtypes = [_f32p]
        L.pafc_av_encode_m4a.restype = ctypes.c_int64
        L.pafc_av_encode_m4a.argtypes = [_f32p, ctypes.c_int64,
                                         ctypes.c_int32,
                                         ctypes.POINTER(_u8p)]
        L.pafc_av_free_u8.restype = None
        L.pafc_av_free_u8.argtypes = [_u8p]
        _libs["av"] = L
        return L


def _bytes_arg(data: bytes):
    return (ctypes.c_uint8 * len(data)).from_buffer_copy(data)


def levenshtein_counts(ref: np.ndarray,
                       hyp: np.ndarray) -> Tuple[int, int, int]:
    """(substitutions, deletions, insertions) of the uniform-cost alignment
    of two int sequences; on a cost tie a cell takes the diagonal, then
    the deletion, then the insertion."""
    ref = np.ascontiguousarray(ref, np.int32)
    hyp = np.ascontiguousarray(hyp, np.int32)
    out = np.zeros(3, np.int32)
    lib().levenshtein_counts(ref.ctypes.data_as(_i32p), len(ref),
                             hyp.ctypes.data_as(_i32p), len(hyp),
                             out.ctypes.data_as(_i32p))
    return int(out[0]), int(out[1]), int(out[2])


def parse_wav(data: bytes) -> Optional[Tuple[np.ndarray, int]]:
    """(mono float32 samples, sample rate) of RIFF PCM8/16/32 bytes, or None
    when the bytes are not such a file."""
    out = np.empty(len(data), np.float32)   # samples <= bytes
    sr = ctypes.c_int32(0)
    n = lib().parse_wav(_bytes_arg(data), len(data), out.ctypes.data_as(_f32p),
                        len(out), ctypes.byref(sr))
    if n < 0:
        return None
    return out[:n].copy(), int(sr.value)


def flac_decode(data: bytes, capacity: int):
    """(interleaved int32 samples (frames, channels), sample rate, bits per
    sample) of a FLAC stream, ``capacity`` samples at most, or None when
    the stream does not decode."""
    out = np.empty(capacity, np.int32)
    sr, ch, bps = ctypes.c_int32(0), ctypes.c_int32(0), ctypes.c_int32(0)
    n = lib().flac_decode(_bytes_arg(data), len(data), out.ctypes.data_as(_i32p),
                          capacity, ctypes.byref(sr), ctypes.byref(ch),
                          ctypes.byref(bps))
    if n <= 0:
        return None
    c = int(ch.value)
    return out[: n * c].reshape(-1, c).copy(), int(sr.value), int(bps.value)


def av_decode(data: bytes) -> Optional[Tuple[np.ndarray, int]]:
    """(mono float32, native sample rate) through libavformat, or None when
    the payload does not decode."""
    L = av_lib()
    out = _f32p()
    sr = ctypes.c_int32(0)
    n = L.pafc_av_decode(_bytes_arg(data), len(data), ctypes.byref(out),
                         ctypes.byref(sr))
    if n <= 0 or not out:
        return None
    try:
        x = np.ctypeslib.as_array(out, shape=(int(n),)).copy()
    finally:
        L.pafc_av_free(out)
    return x, int(sr.value)


def av_encode_m4a(pcm: np.ndarray, sample_rate: int) -> Optional[bytes]:
    """Mono float32 -> AAC .m4a bytes (a test-fixture helper), or None when
    the encoder fails."""
    L = av_lib()
    x = np.ascontiguousarray(pcm, np.float32)
    out = _u8p()
    n = L.pafc_av_encode_m4a(x.ctypes.data_as(_f32p), len(x),
                             int(sample_rate), ctypes.byref(out))
    if n <= 0 or not out:
        return None
    try:
        return bytes(np.ctypeslib.as_array(out, shape=(int(n),)))
    finally:
        L.pafc_av_free_u8(out)
