"""JAX's threefry2x32 draws for fixed keys, in numpy.

Some models draw constants from fixed keys on every call and store them
nowhere: BestRQ's frozen projection and codebooks (``PRNGKey(0)`` and
``PRNGKey(100 + i)``) and CTL's evaluation negatives (``PRNGKey(0)``).
Those draws are part of the model: an encoder trained in JAX against one
set of targets needs the same targets here.  This module repeats
``jax.random.normal``, ``jax.random.uniform`` and ``jax.random.randint``
for such keys, with the bit layout of ``jax_threefry_partitionable = True``
(the default since JAX 0.5): the counter of element i of a draw is the
64-bit i split into (high, low) 32-bit words, and the 32 random bits are
the XOR of threefry's two output words.  ``split`` is the fold-like split
of that mode.  Float32 ``erfinv`` is XLA's polynomial (Giles' single
precision approximation) over XLA's CPU ``log1p`` and ``log`` (Cephes),
with its fused multiply-adds: normals agree with JAX's CPU draws within an
ulp.

A key is a pair of uint32 words; ``key(seed)`` is ``PRNGKey(seed)`` for a
seed below 2**32.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: (seed >> 32, seed & 0xFFFFFFFF)."""
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    np.uint32)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k: np.ndarray, x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds (Random123), elementwise over the
    counter words ``x0``, ``x1`` (uint32 arrays)."""
    ks = (np.uint32(k[0]), np.uint32(k[1]),
          np.uint32(k[0]) ^ np.uint32(k[1]) ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = x0.astype(np.uint32) + ks[0]
        x1 = x1.astype(np.uint32) + ks[1]
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _counters(shape) -> Tuple[np.ndarray, np.ndarray]:
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64).reshape(shape)
    return ((idx >> np.uint64(32)).astype(np.uint32),
            (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(k, num)``: (num, 2) keys."""
    b1, b2 = threefry2x32(k, *_counters((num,)))
    return np.stack([b1, b2], axis=-1)


def random_bits(k: np.ndarray, shape) -> np.ndarray:
    """32 random bits a element, uint32 of ``shape``."""
    b1, b2 = threefry2x32(k, *_counters(tuple(shape)))
    return b1 ^ b2


def _fma(a, b, c) -> np.ndarray:
    """float32 a * b + c with one rounding, as XLA's CPU code contracts it
    (the float64 product of two float32 values is exact)."""
    return (np.asarray(a, np.float32).astype(np.float64)
            * np.asarray(b, np.float32).astype(np.float64)
            + np.asarray(c, np.float32).astype(np.float64)).astype(np.float32)


def uniform(k: np.ndarray, shape, minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform`` in float32: the 23 mantissa bits under the
    exponent of 1.0, minus 1, scaled to [minval, maxval)."""
    bits = (random_bits(k, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, _fma(floats, hi - lo, lo))


def _horner(x: np.ndarray, coeffs) -> np.ndarray:
    r = np.full_like(x, np.float32(coeffs[0]))
    for c in coeffs[1:]:
        r = _fma(r, x, np.float32(c))
    return r


# XLA's CPU log1p: a Cephes rational for |x| < sqrt(2) - 1, else log(1 + x)
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
# and its log: Cephes logf on the mantissa in [sqrt(1/2), sqrt(2))
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
          -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
          2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)


def _log_f32(v: np.ndarray) -> np.ndarray:
    f = np.float32
    v = np.maximum(v, f(1.17549435e-38))
    bits = v.view(np.uint32)
    e = (f(1) + ((bits >> np.uint32(23)).astype(np.int32) - 0x7F)
         .astype(f)).astype(f)
    m = ((bits & np.uint32(0x807FFFFF)) | np.uint32(0x3F000000)).view(f)
    small = m < f(0.707106781186547524)
    e = (e - np.where(small, f(1), f(0))).astype(f)
    t = ((m - f(1)) + np.where(small, m, f(0))).astype(f)
    x2 = (t * t).astype(f)
    x3 = (x2 * t).astype(f)
    y = _fma(_fma(t, f(_LOG_P[0]), f(_LOG_P[1])), t, f(_LOG_P[2]))
    y1 = _fma(_fma(t, f(_LOG_P[3]), f(_LOG_P[4])), t, f(_LOG_P[5]))
    y2 = _fma(_fma(t, f(_LOG_P[6]), f(_LOG_P[7])), t, f(_LOG_P[8]))
    y = (_fma(_fma(y, x3, y1), x3, y2) * x3).astype(f)
    y = (y + (f(-2.12194440e-4) * e).astype(f)).astype(f)
    t = (t - (f(0.5) * x2).astype(f)).astype(f)
    t = (t + y).astype(f)
    return (t + (f(0.693359375) * e).astype(f)).astype(f)


def _log1p_f32(x: np.ndarray) -> np.ndarray:
    f = np.float32
    x2 = (x * x).astype(f)
    r = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    small = (x + _fma(f(-0.5), x2, ((x * x2).astype(f) * r).astype(f))
             ).astype(f)
    large = _log_f32((f(1) + x).astype(f))
    return np.where(np.abs(x) < f(0.41421356237309504880), small, large)


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``ErfInv``: w = -log1p(-x^2), a degree-8 polynomial in
    w - 2.5 (w < 5) or sqrt(w) - 3, times x; +-inf at +-1."""
    x = x.astype(np.float32)
    w = -_log1p_f32((-x * x).astype(np.float32))
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, np.where(lt, np.float32(a), np.float32(b)))
    out = (p * x).astype(np.float32)
    return np.where(np.abs(x) == 1.0, x * np.float32(np.inf), out)


def normal(k: np.ndarray, shape) -> np.ndarray:
    """``jax.random.normal`` in float32: sqrt(2) erfinv(u), u uniform in
    (-1, 1)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(k, shape, lo, 1.0)
    return (np.float32(np.sqrt(2)) * erfinv_f32(u)).astype(np.float32)


def randint(k: np.ndarray, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint`` in int32: two 32-bit draws from the split key
    folded into [minval, maxval) by uint32 modular arithmetic."""
    k1, k2 = split(k, 2)
    hi, lo = random_bits(k1, shape), random_bits(k2, shape)
    span = np.uint32(max(maxval - minval, 1))
    with np.errstate(over="ignore"):
        mult = np.uint32(2 ** 16) % span
        mult = (mult * mult) % span
        off = ((hi % span) * mult + (lo % span)) % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)
