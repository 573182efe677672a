"""Compressed-audio ingestion (port of the JAX ``data/codecs.py``): Ogg/Opus
and MP3 decoders, m4a through the libav shim, and the test encoders.

The reference decodes any torchaudio-supported codec in
`wenet/dataset/processor.py:178-211` and its shard writer whitelists
``flac mp3 m4a ogg opus wav`` (`tools/make_shard.py:36`).  GigaSpeech's
source distribution ships **opus**; podcasts commonly ship mp3.  The system
codec *libraries* -- ``libopus.so.0``, ``libmpg123.so.0``,
``libmp3lame.so.0`` -- are bound directly with ctypes:

- **Ogg/Opus**: own Ogg page demuxer (RFC 3533: capture pattern, lacing,
  continued packets, CRC-32 poly 0x04C11DB7, zero-segment pages) +
  OpusHead/OpusTags parsing (RFC 7845: pre-skip, output gain, channel
  count) + packet decode through ``opus_decode_float`` at 48 kHz, pre-skip
  and end-trim applied from the granule position.
- **MP3**: libmpg123 feed API (``mpg123_open_feed``/``mpg123_read``)
  forced to float32 output.
- **m4a/AAC**: the C++ shim ``native/pafc_av.cpp`` over libavformat /
  libavcodec 59 (a strict major-version gate) decodes ISO-BMFF containers
  to mono float32 -- ``decode_m4a``/``encode_m4a`` below.

The encoders (``encode_ogg_opus``, ``encode_mp3``, ``encode_m4a``) let
tests and ``bin/make_shard.py`` do lossy round trips without binary
fixtures, through the same system libraries.  A missing library raises
with the re-pack guidance.

Everything returns mono float32 (channel mean, as the FLAC path in
``data/audio.read_audio_bytes``) at the stream's native rate -- the
pipeline's ``resample`` stage converts, as `processor.py:294` does.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

# ------------------------------------------------------------------ lib setup


def _load(*names):
    """The first of ``names`` that loads; None names (``find_library``
    found nothing) are skipped: ``ctypes.CDLL(None)`` would hand back the
    running program, whose missing symbols fail later and elsewhere."""
    for n in names:
        if not n:
            continue
        try:
            return ctypes.CDLL(n)
        except OSError:
            continue
    return None


_OPUS = None
_MPG123 = None
_LAME = None


def _opus():
    global _OPUS
    if _OPUS is None:
        lib = _load("libopus.so.0", "libopus.so",
                    ctypes.util.find_library("opus"))
        if lib is None:
            raise RuntimeError(
                "libopus not found — opus decode unavailable; re-pack "
                "shards as wav/flac with bin/make_shard.py")
        lib.opus_decoder_create.restype = ctypes.c_void_p
        lib.opus_decoder_create.argtypes = [
            ctypes.c_int32, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.opus_decode_float.restype = ctypes.c_int
        lib.opus_decode_float.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int]
        lib.opus_decoder_destroy.argtypes = [ctypes.c_void_p]
        lib.opus_encoder_create.restype = ctypes.c_void_p
        lib.opus_encoder_create.argtypes = [
            ctypes.c_int32, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        lib.opus_encode_float.restype = ctypes.c_int32
        lib.opus_encode_float.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int32]
        lib.opus_encoder_destroy.argtypes = [ctypes.c_void_p]
        _OPUS = lib
    return _OPUS


# ------------------------------------------------------------- Ogg container

# Ogg CRC: CRC-32, polynomial 0x04C11DB7, init 0, no reflection/final xor.
_OGG_CRC_TABLE = None


def _ogg_crc_table():
    global _OGG_CRC_TABLE
    if _OGG_CRC_TABLE is None:
        tab = np.zeros(256, np.uint32)
        for i in range(256):
            r = i << 24
            for _ in range(8):
                r = ((r << 1) ^ 0x04C11DB7) if r & 0x80000000 else (r << 1)
                r &= 0xFFFFFFFF
            tab[i] = r
        _OGG_CRC_TABLE = tab
    return _OGG_CRC_TABLE


def _ogg_crc(data: bytes) -> int:
    tab = _ogg_crc_table()
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ int(tab[((crc >> 24) & 0xFF) ^ b])
    return crc


def ogg_pages(data: bytes) -> Iterator[Tuple[int, int, int, List[bytes],
                                             List[bool]]]:
    """Parse Ogg pages -> (serial, header_type, granule, segments, complete).

    ``segments`` is the list of packet chunks on this page; ``complete[i]``
    is False when chunk i continues onto the next page (last lacing value
    was 255).  RFC 3533 framing; CRC is not enforced (tolerant reader, like
    libogg's default streaming path).
    """
    pos, n = 0, len(data)
    while pos + 27 <= n:
        idx = data.find(b"OggS", pos)
        if idx < 0:
            return
        pos = idx
        if pos + 27 > n:
            return
        (_, _ver, htype, granule, serial, _seq, _crc, nsegs) = struct.unpack(
            "<4sBBqIIIB", data[pos:pos + 27])
        lacing = data[pos + 27:pos + 27 + nsegs]
        if len(lacing) < nsegs:
            return
        body_start = pos + 27 + nsegs
        body_len = int(sum(lacing))
        if body_start + body_len > n:
            return
        segs, complete = [], []
        off = body_start
        cur = b""
        for i, lv in enumerate(lacing):
            cur += data[off:off + lv]
            off += lv
            if lv < 255:
                segs.append(cur)
                complete.append(True)
                cur = b""
        if cur:
            segs.append(cur)
            complete.append(False)
        yield serial, htype, granule, segs, complete
        pos = body_start + body_len


def ogg_packets(data: bytes) -> Iterator[Tuple[int, int, bytes]]:
    """Reassemble packets across pages -> (serial, page_granule, packet)."""
    partial = {}  # serial -> bytes
    for serial, htype, granule, segs, complete in ogg_pages(data):
        if not segs:
            # zero-segment page (legal per RFC 3533, e.g. granule-only):
            # a packet continuing across it must keep its carry
            continue
        carry = partial.pop(serial, b"")
        for i, seg in enumerate(segs):
            pkt = carry + seg if i == 0 else seg
            if i == 0:
                carry = b""
            if complete[i]:
                yield serial, granule, pkt
            else:
                partial[serial] = pkt


def _write_ogg_page(serial: int, seq: int, htype: int, granule: int,
                    packets: List[bytes]) -> bytes:
    lacing = bytearray()
    body = bytearray()
    for pkt in packets:
        q, r = divmod(len(pkt), 255)
        lacing += b"\xff" * q + bytes([r])
        body += pkt
    header = struct.pack("<4sBBqIIIB", b"OggS", 0, htype, granule, serial,
                         seq, 0, len(lacing)) + bytes(lacing)
    crc = _ogg_crc(header + bytes(body))
    header = header[:22] + struct.pack("<I", crc) + header[26:]
    return header + bytes(body)


# ---------------------------------------------------------------- Ogg/Opus


def decode_ogg_opus(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode an Ogg/Opus stream to (mono float32, 48000).

    RFC 7845 semantics: pre-skip samples are dropped from the head, the
    final page's granule position bounds the total output length, and the
    OpusHead output gain (Q7.8 dB) is applied.
    """
    lib = _opus()
    channels = None
    preskip = 0
    gain_db = 0.0
    opus_serial = None
    dec = None
    chunks: List[np.ndarray] = []
    last_granule = None
    try:
        for serial, granule, pkt in ogg_packets(data):
            if opus_serial is None:
                if pkt[:8] == b"OpusHead":
                    opus_serial = serial
                else:
                    continue
            if serial != opus_serial:
                continue
            if pkt[:8] == b"OpusHead":
                if len(pkt) < 19:
                    raise ValueError("short OpusHead")
                channels = pkt[9]
                preskip = struct.unpack("<H", pkt[10:12])[0]
                gain_q8 = struct.unpack("<h", pkt[16:18])[0]
                gain_db = gain_q8 / 256.0
                err = ctypes.c_int(0)
                dec = lib.opus_decoder_create(48000, channels,
                                              ctypes.byref(err))
                if err.value != 0:
                    raise ValueError(f"opus_decoder_create: {err.value}")
                continue
            if pkt[:8] == b"OpusTags":
                continue
            if dec is None:
                raise ValueError("opus audio packet before OpusHead")
            max_frame = 5760  # 120 ms @ 48 kHz
            out = np.empty(max_frame * channels, np.float32)
            nret = lib.opus_decode_float(
                dec, pkt, len(pkt),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                max_frame, 0)
            if nret < 0:
                raise ValueError(f"opus_decode_float error {nret}")
            chunks.append(out[: nret * channels].reshape(nret, channels))
            if granule >= 0:
                last_granule = granule
    finally:
        if dec is not None:
            lib.opus_decoder_destroy(dec)
    if channels is None:
        raise ValueError("no Opus stream found in Ogg container")
    pcm = (np.concatenate(chunks, axis=0) if chunks
           else np.zeros((0, channels), np.float32))
    total = pcm.shape[0]
    end = total
    if last_granule is not None:
        end = min(total, int(last_granule))
    pcm = pcm[preskip:end]
    if gain_db:
        pcm = pcm * np.float32(10.0 ** (gain_db / 20.0))
    return np.ascontiguousarray(pcm.mean(axis=1), np.float32), 48000


def encode_ogg_opus(pcm: np.ndarray, sample_rate: int = 48000,
                    bitrate: int = 64000) -> bytes:
    """Encode mono float32 -> Ogg/Opus bytes (for tests / make_shard)."""
    if sample_rate not in (8000, 12000, 16000, 24000, 48000):
        raise ValueError(f"opus encoder needs 8/12/16/24/48 kHz, "
                         f"got {sample_rate}")
    lib = _opus()
    err = ctypes.c_int(0)
    OPUS_APPLICATION_AUDIO = 2049
    enc = lib.opus_encoder_create(sample_rate, 1, OPUS_APPLICATION_AUDIO,
                                  ctypes.byref(err))
    if err.value != 0:
        raise ValueError(f"opus_encoder_create: {err.value}")
    try:
        frame = sample_rate // 50  # 20 ms
        pcm = np.asarray(pcm, np.float32).reshape(-1)
        npad = (-len(pcm)) % frame
        padded = np.concatenate([pcm, np.zeros(npad, np.float32)])
        preskip_48k = 312  # typical encoder delay (6.5 ms)
        packets = []
        buf = ctypes.create_string_buffer(4000)
        for i in range(0, len(padded), frame):
            chunk = np.ascontiguousarray(padded[i:i + frame])
            nb = lib.opus_encode_float(
                enc, chunk.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                frame, buf, 4000)
            if nb < 0:
                raise ValueError(f"opus_encode_float error {nb}")
            packets.append(buf.raw[:nb])
    finally:
        lib.opus_encoder_destroy(enc)

    head = (b"OpusHead" + bytes([1, 1])
            + struct.pack("<H", preskip_48k)
            + struct.pack("<I", sample_rate)
            + struct.pack("<h", 0) + bytes([0]))
    tags = b"OpusTags" + struct.pack("<I", 4) + b"pafc" + struct.pack("<I", 0)
    serial = 0x70616663
    out = [_write_ogg_page(serial, 0, 0x02, 0, [head]),
           _write_ogg_page(serial, 1, 0x00, 0, [tags])]
    frame_48k = 960  # every 20 ms packet advances granule by 960 @48k
    total_48k = preskip_48k + int(len(pcm) * 48000 / sample_rate)
    granule = preskip_48k
    seq = 2
    # one page per 50 packets (~1 s)
    for i in range(0, len(packets), 50):
        group = packets[i:i + 50]
        granule += frame_48k * len(group)
        last = i + 50 >= len(packets)
        out.append(_write_ogg_page(
            serial, seq, 0x04 if last else 0x00,
            min(granule, total_48k) if last else granule, group))
        seq += 1
    return b"".join(out)


# --------------------------------------------------------------------- MP3

_MPG123_OK = 0
_MPG123_NEED_MORE = -10
_MPG123_NEW_FORMAT = -11
_MPG123_DONE = -12
_MPG123_ENC_FLOAT_32 = 0x200


def _mpg123():
    global _MPG123
    if _MPG123 is None:
        lib = _load("libmpg123.so.0", "libmpg123.so",
                    ctypes.util.find_library("mpg123"))
        if lib is None:
            raise RuntimeError("libmpg123 not found — mp3 decode "
                               "unavailable; re-pack shards as wav/flac")
        lib.mpg123_init()
        lib.mpg123_new.restype = ctypes.c_void_p
        lib.mpg123_new.argtypes = [ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_int)]
        lib.mpg123_open_feed.argtypes = [ctypes.c_void_p]
        lib.mpg123_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_size_t]
        lib.mpg123_read.restype = ctypes.c_int
        lib.mpg123_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_size_t,
                                    ctypes.POINTER(ctypes.c_size_t)]
        lib.mpg123_getformat.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
        lib.mpg123_format.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                      ctypes.c_int, ctypes.c_int]
        lib.mpg123_delete.argtypes = [ctypes.c_void_p]
        _MPG123 = lib
    return _MPG123


def decode_mp3(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode MP3 bytes -> (mono float32, native sample rate)."""
    lib = _mpg123()
    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise ValueError(f"mpg123_new: {err.value}")
    rate_out: Optional[int] = None
    channels_out = 1
    chunks: List[bytes] = []
    try:
        lib.mpg123_open_feed(h)
        # restrict output to float32 BEFORE feeding — re-forcing the format
        # after the first NEW_FORMAT would silently drop the frames already
        # decoded in the default s16 format
        lib.mpg123_format_none(h)
        for rate in (8000, 11025, 12000, 16000, 22050, 24000, 32000,
                     44100, 48000):
            for ch in (1, 2):
                lib.mpg123_format(h, rate, ch, _MPG123_ENC_FLOAT_32)
        lib.mpg123_feed(h, data, len(data))
        out = ctypes.create_string_buffer(65536)
        done = ctypes.c_size_t(0)
        while True:
            ret = lib.mpg123_read(h, out, len(out), ctypes.byref(done))
            if done.value:
                chunks.append(out.raw[:done.value])
            if ret == _MPG123_NEW_FORMAT:
                rate = ctypes.c_long(0)
                ch = ctypes.c_int(0)
                enc = ctypes.c_int(0)
                lib.mpg123_getformat(h, ctypes.byref(rate),
                                     ctypes.byref(ch), ctypes.byref(enc))
                rate_out, channels_out = int(rate.value), int(ch.value)
            elif ret in (_MPG123_NEED_MORE, _MPG123_DONE):
                break
            elif ret != _MPG123_OK:
                raise ValueError(f"mpg123_read error {ret}")
    finally:
        lib.mpg123_delete(h)
    if rate_out is None:
        raise ValueError("no MP3 stream recognized")
    pcm = np.frombuffer(b"".join(chunks), np.float32)
    if channels_out > 1:
        pcm = pcm.reshape(-1, channels_out).mean(axis=1)
    return np.ascontiguousarray(pcm, np.float32), rate_out


def encode_mp3(pcm: np.ndarray, sample_rate: int,
               bitrate_kbps: int = 128) -> bytes:
    """Encode mono float32 -> MP3 bytes via libmp3lame (for tests)."""
    global _LAME
    if _LAME is None:
        lib = _load("libmp3lame.so.0", "libmp3lame.so",
                    ctypes.util.find_library("mp3lame"))
        if lib is None:
            raise RuntimeError("libmp3lame not found")
        lib.lame_init.restype = ctypes.c_void_p
        for fn in ("lame_set_in_samplerate", "lame_set_num_channels",
                   "lame_set_brate", "lame_set_mode"):
            getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.lame_init_params.argtypes = [ctypes.c_void_p]
        lib.lame_encode_buffer.restype = ctypes.c_int
        lib.lame_encode_buffer.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_short),
            ctypes.POINTER(ctypes.c_short), ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int]
        lib.lame_encode_flush.restype = ctypes.c_int
        lib.lame_encode_flush.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                          ctypes.c_int]
        lib.lame_close.argtypes = [ctypes.c_void_p]
        _LAME = lib
    lib = _LAME
    h = lib.lame_init()
    try:
        lib.lame_set_in_samplerate(h, sample_rate)
        lib.lame_set_num_channels(h, 1)
        lib.lame_set_brate(h, bitrate_kbps)
        lib.lame_set_mode(h, 3)  # MONO
        if lib.lame_init_params(h) < 0:
            raise ValueError("lame_init_params failed")
        x16 = np.clip(np.asarray(pcm, np.float32) * 32767.0,
                      -32768, 32767).astype(np.int16)
        x16 = np.ascontiguousarray(x16)
        nbuf = len(x16) + len(x16) // 4 + 7200
        buf = ctypes.create_string_buffer(nbuf)
        ptr = x16.ctypes.data_as(ctypes.POINTER(ctypes.c_short))
        n = lib.lame_encode_buffer(h, ptr, ptr, len(x16), buf, nbuf)
        if n < 0:
            raise ValueError(f"lame_encode_buffer error {n}")
        out = buf.raw[:n]
        n = lib.lame_encode_flush(h, buf, nbuf)
        out += buf.raw[:max(n, 0)]
        return out
    finally:
        lib.lame_close(h)


def sniff_mp3(data: bytes) -> bool:
    """True for ID3-tagged or bare MPEG-audio sync streams."""
    if data[:3] == b"ID3":
        return True
    if len(data) >= 2 and data[0] == 0xFF and (data[1] & 0xE0) == 0xE0:
        # frame sync; require a sane MPEG layer (not reserved)
        return (data[1] & 0x06) != 0
    return False


# ------------------------------------------------------------------ m4a/mp4


def sniff_mp4(data: bytes) -> bool:
    """True for ISO-BMFF containers (m4a/mp4): box size + 'ftyp' brand."""
    return len(data) >= 12 and data[4:8] == b"ftyp"


_M4A_UNAVAILABLE = ("m4a decode unavailable (libav shim failed to build/load "
                    "or payload undecodable) — re-pack m4a with "
                    "bin/make_shard.py")


def decode_m4a(data: bytes) -> Tuple[np.ndarray, int]:
    """m4a/AAC -> (mono float32, native rate) through the libav shim.

    The reference ingests m4a through torchaudio/ffmpeg
    (`wenet/dataset/processor.py:178-211`).  A shim that does not build or
    load, and a payload that does not decode, raise with the re-pack
    guidance."""
    from paper_accurate_fast_cheap_tpu_torch import native

    try:
        out = native.av_decode(data)
    except native.NativeError as e:
        raise RuntimeError(_M4A_UNAVAILABLE) from e
    if out is None:
        raise RuntimeError(_M4A_UNAVAILABLE)
    return out


def encode_m4a(pcm: np.ndarray, sample_rate: int) -> bytes:
    """Mono float32 -> AAC .m4a bytes (test-fixture helper; native 'aac'
    encoder + ipod muxer, all in memory)."""
    from paper_accurate_fast_cheap_tpu_torch import native

    try:
        out = native.av_encode_m4a(pcm, sample_rate)
    except native.NativeError as e:
        raise RuntimeError("m4a encode unavailable (libav shim missing)") \
            from e
    if out is None:
        raise RuntimeError("m4a encode unavailable (libav shim missing)")
    return out
