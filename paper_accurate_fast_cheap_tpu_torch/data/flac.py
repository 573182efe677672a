"""FLAC codec for the data loader (port of the JAX ``data/flac.py``).

The reference decodes shard audio with torchaudio/sox, which accepts flac
among others (`wenet/dataset/processor.py:178-211`,
`tools/make_shard.py:36` AUDIO_FORMAT_SETS).  Here:

* decode: the native C++ decoder (``native/pafc_native.cpp: flac_decode``,
  spec-complete for the common stream surface); ``_decode_python``, its
  transliteration, is the plain version the tests hold it to;
* encode: a writer (fixed-order-2 + rice residuals, correct CRC-8 /
  CRC-16), byte for byte the JAX package's, used by
  ``bin/make_shard.py --audio_format flac`` and the round-trip tests; its
  subframes are packed as numpy bit fields and its CRC-16 is table
  driven (180 s of 16 kHz audio in ~3 s on one core, the JAX writer's
  per-bit loops ~14 s).
"""
from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

from paper_accurate_fast_cheap_tpu_torch import native


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def decode_flac(data: bytes) -> Optional[Tuple[np.ndarray, int]]:
    """bytes -> (float32 samples in [-1, 1], shape (T,) mono or (T, C);
    sample_rate).  Returns None if the payload is not FLAC or does not
    decode."""
    if len(data) < 42 or data[:4] != b"fLaC":
        return None
    out = _decode_native(data)
    if out is None:
        return None
    return _to_float(*out)


def _to_float(pcm: np.ndarray, sr: int, bps: int):
    x = pcm.astype(np.float32) / float(1 << (bps - 1))
    if x.ndim == 2 and x.shape[1] == 1:
        x = x[:, 0]
    return x, sr


def _decode_native(data: bytes):
    # exact capacity from STREAMINFO (mandatory first metadata block);
    # generous bound if total_samples is unset
    info = struct.unpack(">Q", data[18:26])[0]
    total = info & ((1 << 36) - 1)
    nch = ((info >> 41) & 0x7) + 1
    cap = max(int(total) * nch if total else len(data) * 8, 65536)
    return native.flac_decode(data, cap)


class _BitReader:
    def __init__(self, data: bytes):
        self.d = data
        self.pos = 0  # bit position

    def bits(self, n: int) -> int:
        v = 0
        d, pos = self.d, self.pos
        end = pos + n
        if end > len(d) * 8:
            raise EOFError
        while n > 0:
            avail = 8 - (pos & 7)
            take = min(n, avail)
            byte = d[pos >> 3]
            v = (v << take) | ((byte >> (avail - take)) & ((1 << take) - 1))
            pos += take
            n -= take
        self.pos = pos
        return v

    def sbits(self, n: int) -> int:
        v = self.bits(n)
        return v - (1 << n) if n and (v >> (n - 1)) & 1 else v

    def unary(self) -> int:
        q = 0
        while self.bits(1) == 0:
            q += 1
            if q > 1 << 24:
                raise EOFError
        return q

    def align(self):
        self.pos = (self.pos + 7) & ~7


_FIXED_COEF = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}
_BLOCK_SIZES = [0, 192, 576, 1152, 2304, 4608, 0, 0, 256, 512, 1024, 2048,
                4096, 8192, 16384, 32768]
_BPS_CODES = [0, 8, 12, 0, 16, 20, 24, 32]


def _read_utf8(br: _BitReader) -> int:
    b0 = br.bits(8)
    if b0 < 0x80:
        return b0
    lead = 0
    while lead < 8 and (b0 << lead) & 0x80:
        lead += 1
    if lead < 2 or lead > 7:
        raise ValueError("bad utf8 number")
    v = b0 & (0x7F >> lead)
    for _ in range(lead - 1):
        b = br.bits(8)
        if (b & 0xC0) != 0x80:
            raise ValueError("bad utf8 continuation")
        v = (v << 6) | (b & 0x3F)
    return v


def _read_residual(br: _BitReader, order: int, bs: int) -> np.ndarray:
    method = br.bits(2)
    if method > 1:
        raise ValueError("bad residual method")
    plen = 4 if method == 0 else 5
    escape = 0xF if method == 0 else 0x1F
    po = br.bits(4)
    nparts = 1 << po
    res = np.empty(bs - order, np.int64)
    idx = 0
    for part in range(nparts):
        n = (bs >> po) - (order if part == 0 else 0)
        param = br.bits(plen)
        if param == escape:
            raw = br.bits(5)
            for i in range(n):
                res[idx] = br.sbits(raw)
                idx += 1
        else:
            for i in range(n):
                q = br.unary()
                u = (q << param) | br.bits(param)
                res[idx] = (u >> 1) ^ -(u & 1)
                idx += 1
    return res


def _decode_subframe(br: _BitReader, bs: int, bps: int) -> np.ndarray:
    if br.bits(1) != 0:
        raise ValueError("bad subframe padding")
    stype = br.bits(6)
    wasted = 0
    if br.bits(1):
        wasted = 1 + br.unary()
    bps -= wasted
    out = np.empty(bs, np.int64)
    if stype == 0:
        out[:] = br.sbits(bps)
    elif stype == 1:
        for i in range(bs):
            out[i] = br.sbits(bps)
    elif (stype & 0x38) == 0x08 and (stype & 7) <= 4:
        order = stype & 7
        for i in range(order):
            out[i] = br.sbits(bps)
        res = _read_residual(br, order, bs)
        coef = _FIXED_COEF[order]
        for i in range(order, bs):
            p = sum(c * out[i - 1 - j] for j, c in enumerate(coef))
            out[i] = p + res[i - order]
    elif stype & 0x20:
        order = (stype & 0x1F) + 1
        for i in range(order):
            out[i] = br.sbits(bps)
        precision = br.bits(4) + 1
        shift = br.sbits(5)
        coef = [br.sbits(precision) for _ in range(order)]
        res = _read_residual(br, order, bs)
        for i in range(order, bs):
            acc = sum(c * out[i - 1 - j] for j, c in enumerate(coef))
            out[i] = (acc >> shift) + res[i - order]
    else:
        raise ValueError(f"bad subframe type {stype}")
    if wasted:
        out <<= wasted
    return out


def _decode_python(data: bytes):
    try:
        br = _BitReader(data)
        br.pos = 32
        sr = ch = bps = 0
        while True:
            last = br.bits(1)
            btype = br.bits(7)
            blen = br.bits(24)
            if btype == 0:
                br.bits(16 + 16 + 24 + 24)
                sr = br.bits(20)
                ch = br.bits(3) + 1
                bps = br.bits(5) + 1
                br.bits(36)
                br.pos += (blen - 18) * 8
            else:
                br.pos += blen * 8
            if last:
                break
        chans = []
        while br.pos + 16 <= len(data) * 8:
            if br.bits(14) != 0x3FFE:
                break
            br.bits(2)
            bs_code = br.bits(4)
            sr_code = br.bits(4)
            ch_code = br.bits(4)
            ss_code = br.bits(3)
            br.bits(1)
            _read_utf8(br)
            if bs_code == 6:
                bs = br.bits(8) + 1
            elif bs_code == 7:
                bs = br.bits(16) + 1
            else:
                bs = _BLOCK_SIZES[bs_code]
            if sr_code == 12:
                br.bits(8)
            elif sr_code in (13, 14):
                br.bits(16)
            fbps = _BPS_CODES[ss_code] or bps
            br.bits(8)  # crc8
            if ch_code <= 7:
                nch, assign = ch_code + 1, None
            else:
                nch, assign = 2, ch_code - 8   # 0 l/s, 1 r/s, 2 m/s
            subs = []
            for c in range(nch):
                sb = fbps
                if assign == 0 and c == 1:
                    sb += 1
                if assign == 1 and c == 0:
                    sb += 1
                if assign == 2 and c == 1:
                    sb += 1
                subs.append(_decode_subframe(br, bs, sb))
            br.align()
            br.bits(16)  # crc16
            if assign == 0:
                L, S = subs
                subs = [L, L - S]
            elif assign == 1:
                S, R = subs
                subs = [S + R, R]
            elif assign == 2:
                M, S = subs
                m2 = (M << 1) | (S & 1)
                subs = [(m2 + S) >> 1, (m2 - S) >> 1]
            chans.append(np.stack(subs, axis=1))
        if not chans:
            return None
        return np.concatenate(chans, axis=0).astype(np.int32), sr, bps
    except (EOFError, ValueError, IndexError):
        return None


# --------------------------------------------------------------------------
# encode
# --------------------------------------------------------------------------

def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16_table():
    tab = []
    for i in range(256):
        crc = i << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 \
                else (crc << 1) & 0xFFFF
        tab.append(crc)
    return tab


_CRC16 = _crc16_table()


def _crc16(data: bytes) -> int:
    """FLAC's frame CRC-16 (poly 0x8005, init 0, MSB first), a byte a
    step from a table."""
    crc, tab = 0, _CRC16
    for b in data:
        crc = ((crc << 8) & 0xFFFF) ^ tab[(crc >> 8) ^ b]
    return crc


class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def bits(self, v: int, n: int):
        self.acc = (self.acc << n) | (v & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def align(self):
        if self.nbits:
            self.bits(0, 8 - self.nbits)

    def bytes(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.buf)


def _utf8_number(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    for nbytes, bits in ((2, 11), (3, 16), (4, 21), (5, 26), (6, 31),
                         (7, 36)):
        if n < (1 << bits):
            break
    shift = 6 * (nbytes - 1)
    lead = (0xFF << (8 - nbytes)) & 0xFF
    out = [lead | (n >> shift)]
    for _ in range(nbytes - 1):
        shift -= 6
        out.append(0x80 | ((n >> shift) & 0x3F))
    return bytes(out)


def _subframe_fields(x: np.ndarray, bps: int):
    """One subframe as (values, widths) bit fields, MSB first: a
    fixed-order-2 predictor + single-partition rice residuals, or verbatim
    when rice would be larger.  A rice residual u is a field of q = u >>
    param zero bits, then (1 << param) | (u's low param bits) in param + 1
    bits."""
    bs = len(x)
    x = x.astype(np.int64)
    mask = (1 << bps) - 1
    if bs > 2:
        res = x[2:] - (2 * x[1:-1] - x[:-2])
        zig = (res << 1) ^ (res >> 63)
        mean = max(1, int(zig.mean()))
        param = min(14, max(0, int(mean).bit_length() - 1))
        cost = int((zig >> param).sum()) + len(zig) * (param + 1)
        if cost < bs * bps:
            head_v = [0, 0x08 | 2, 0, int(x[0]) & mask, int(x[1]) & mask,
                      0, 0, param]          # FIXED order 2, no wasted bits,
            head_w = [1, 6, 1, bps, bps, 2, 4, 4]   # method 0, order 0
            n = len(zig)
            vals = np.zeros(2 * n, np.int64)
            wids = np.empty(2 * n, np.int64)
            wids[0::2] = zig >> param
            vals[1::2] = (1 << param) | (zig & ((1 << param) - 1))
            wids[1::2] = param + 1
            return (np.concatenate([head_v, vals]),
                    np.concatenate([head_w, wids]))
    return (np.concatenate([[0, 1, 0], x & mask]),       # VERBATIM
            np.concatenate([[1, 6, 1], np.full(bs, bps)]))


def _pack_fields(values: np.ndarray, widths: np.ndarray) -> bytes:
    """Concatenate (value, width) bit fields MSB first, zero-padded to a
    whole byte.  Values fit their widths and non-zero ones are <= 16 bits
    wide (samples of at most 16 bits, rice fields of at most 15)."""
    ends = np.cumsum(widths)
    bits = np.zeros((int(ends[-1]) + 7) // 8 * 8, np.uint8)
    for b in range(16):
        on = ((values >> b) & 1).astype(bool)
        bits[ends[on] - 1 - b] = 1
    return np.packbits(bits).tobytes()


def encode_flac(pcm: np.ndarray, sample_rate: int,
                block_size: int = 4096) -> bytes:
    """float [-1,1] or int16 samples, shape (T,) or (T, C) -> FLAC bytes
    (16-bit, independent channels)."""
    if pcm.dtype.kind == "f":
        pcm = np.clip(np.round(pcm * 32768.0), -32768, 32767).astype(np.int16)
    pcm = np.asarray(pcm, np.int16)
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    T, C = pcm.shape
    bps = 16

    header = bytearray(b"fLaC")
    si = _BitWriter()
    si.bits(block_size, 16)
    si.bits(block_size, 16)
    si.bits(0, 24)
    si.bits(0, 24)
    si.bits(sample_rate, 20)
    si.bits(C - 1, 3)
    si.bits(bps - 1, 5)
    si.bits(T, 36)
    for _ in range(16):
        si.bits(0, 8)              # md5 unset
    payload = si.bytes()
    header += bytes([0x80]) + struct.pack(">I", len(payload))[1:] + payload

    out = bytearray(header)
    fnum = 0
    for start in range(0, T, block_size):
        blk = pcm[start : start + block_size]
        bs = len(blk)
        hw = _BitWriter()
        hw.bits(0x3FFE, 14)
        hw.bits(0, 1)
        hw.bits(0, 1)              # fixed blocksize stream
        hw.bits(7, 4)              # blocksize: 16-bit at end of header
        hw.bits(0, 4)              # sample rate: from STREAMINFO
        hw.bits(C - 1, 4)          # independent channels
        hw.bits(4, 3)              # 16-bit
        hw.bits(0, 1)
        hw.align()
        hdr = bytearray(hw.bytes())
        hdr += _utf8_number(fnum)
        hdr += struct.pack(">H", bs - 1)
        hdr.append(_crc8(bytes(hdr)))
        fields = [_subframe_fields(blk[:, c], bps) for c in range(C)]
        frame = bytes(hdr) + _pack_fields(
            np.concatenate([v for v, _ in fields]),
            np.concatenate([w for _, w in fields]))
        frame += struct.pack(">H", _crc16(frame))
        out += frame
        fnum += 1
    return bytes(out)
