"""The port's audio codecs against the JAX package's: FLAC (native and its
Python plain version), Ogg/Opus, MP3 and m4a, the Ogg container, and the
reader's container sniffing.  Every fixture is synthesised from a seed."""
import numpy as np
import pytest

from paper_accurate_fast_cheap_tpu.data import codecs as j_codecs
from paper_accurate_fast_cheap_tpu.data import flac as j_flac
from paper_accurate_fast_cheap_tpu.data import pipeline as j_pipeline
from paper_accurate_fast_cheap_tpu_torch.data import audio as t_audio
from paper_accurate_fast_cheap_tpu_torch.data import codecs as t_codecs
from paper_accurate_fast_cheap_tpu_torch.data import flac as t_flac


def _signal(n, channels=1, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    x = 0.3 * np.sin(2 * np.pi * 440.0 * t) + 0.05 * rng.randn(n)
    if channels == 2:
        x = np.stack([x, 0.5 * x[::-1] + 0.02 * rng.randn(n)], axis=1)
    return x.astype(np.float32)


# (samples, channels): mono, stereo (independent channels), a last block
# of 17 samples after one full 4096-sample block, and full-scale noise
# (rice costs more than verbatim: the encoder's verbatim subframes)
FLAC_CASES = {"mono": (9000, 1), "stereo": (6000, 2),
              "short_last_block": (4096 + 17, 1), "verbatim": (5000, 0)}


@pytest.mark.parametrize("case", sorted(FLAC_CASES))
def test_flac_matches_jax(case):
    n, ch = FLAC_CASES[case]
    x = (_signal(n, ch, seed=n) if ch else
         np.random.RandomState(n).uniform(-1, 1, n).astype(np.float32))
    data = j_flac.encode_flac(x, 16000)
    # the port's encoder writes JAX's bytes
    assert t_flac.encode_flac(x, 16000) == data
    yt, srt = t_flac.decode_flac(data)
    yj, srj = j_flac.decode_flac(data)
    assert srt == srj == 16000
    np.testing.assert_array_equal(yt, yj)
    # native against the plain version, and lossless from int16
    np.testing.assert_array_equal(
        yt, t_flac._to_float(*t_flac._decode_python(data))[0])
    i16 = np.clip(np.round(x * 32768.0), -32768, 32767)
    np.testing.assert_array_equal(yt, (i16 / 32768.0).astype(np.float32))
    # the reader: mono is the channel mean, as JAX's
    at, _ = t_audio.read_audio_bytes(data)
    aj, _ = j_pipeline._read_audio_bytes(data)
    np.testing.assert_array_equal(at, aj)
    assert at.ndim == 1 and len(at) == n


@pytest.mark.parametrize("sr", [48000, 16000])
def test_opus_matches_jax(sr):
    x = _signal(sr // 2, seed=sr)
    data = j_codecs.encode_ogg_opus(x, sr)
    assert t_codecs.encode_ogg_opus(x, sr) == data
    yt, srt = t_codecs.decode_ogg_opus(data)
    yj, srj = j_codecs.decode_ogg_opus(data)
    assert srt == srj == 48000
    np.testing.assert_array_equal(yt, yj)
    # pre-skip and the end trim leave the input's length at 48 kHz
    assert abs(len(yt) - len(x) * 48000 // sr) <= 960
    np.testing.assert_array_equal(t_audio.read_audio_bytes(data)[0], yt)


def test_mp3_matches_jax():
    x = _signal(8000, seed=3)
    data = j_codecs.encode_mp3(x, 16000)
    assert t_codecs.encode_mp3(x, 16000) == data
    yt, srt = t_codecs.decode_mp3(data)
    yj, srj = j_codecs.decode_mp3(data)
    assert srt == srj == 16000
    np.testing.assert_array_equal(yt, yj)
    assert t_codecs.sniff_mp3(data) and not t_codecs.sniff_mp3(b"RIFF0000")
    np.testing.assert_array_equal(t_audio.read_audio_bytes(data)[0], yt)


def test_m4a_matches_jax():
    x = _signal(16000, seed=4)
    data = j_codecs.encode_m4a(x, 16000)
    assert t_codecs.encode_m4a(x, 16000) == data
    assert t_codecs.sniff_mp4(data) and not t_codecs.sniff_mp4(b"fLaC" * 4)
    yt, srt = t_codecs.decode_m4a(data)
    yj, srj = j_codecs.decode_m4a(data)
    assert srt == srj == 16000
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_array_equal(t_audio.read_audio_bytes(data)[0], yt)


def test_ogg_crc_and_packet_reassembly():
    # a packet of 600 bytes spans lacing values 255, 255, 90; the CRC is
    # JAX's (CRC-32, poly 0x04C11DB7, no reflection)
    pkts = [b"x" * 600, b"short", b""]
    page = t_codecs._write_ogg_page(5, 0, 0x02, 77, pkts)
    assert page == j_codecs._write_ogg_page(5, 0, 0x02, 77, pkts)
    assert t_codecs._ogg_crc(page[:22] + b"\0" * 4 + page[26:]) == \
        int.from_bytes(page[22:26], "little")
    assert t_codecs._ogg_crc(b"123456789") == j_codecs._ogg_crc(b"123456789")
    assert list(t_codecs.ogg_packets(page)) == [(5, 77, p) for p in pkts]


def test_ogg_zero_segment_page_keeps_continuation():
    """RFC 3533 allows pages with zero lacing values (e.g. granule-only);
    a packet spanning such a page keeps its continuation carry."""
    import struct

    def page(serial, seq, htype, granule, lacing, body):
        hdr = struct.pack("<4sBBqIIIB", b"OggS", 0, htype, granule,
                          serial, seq, 0, len(lacing)) + bytes(lacing)
        return hdr + bytes(body)

    pkt = bytes(range(256)) + b"tail-bytes" * 5  # 306 bytes, spans pages
    first, rest = pkt[:255], pkt[255:]
    stream = (page(7, 0, 0, -1, [255], first)
              + page(7, 1, 1, 1234, [], b"")
              + page(7, 2, 1, 5678, [len(rest)], rest))
    got = list(t_codecs.ogg_packets(stream))
    assert got == [(7, 5678, pkt)] == list(j_codecs.ogg_packets(stream))


def test_unknown_container_raises_jax_message():
    data = b"\x00\x01junk" * 10
    with pytest.raises(ValueError) as jt:
        j_pipeline._read_audio_bytes(data, "xyz")
    with pytest.raises(ValueError) as tt:
        t_audio.read_audio_bytes(data, "xyz")
    assert str(tt.value) == str(jt.value)


def test_missing_library_raises_the_repack_message(monkeypatch):
    """Where no libopus loads, decoding raises JAX's re-pack guidance; a
    name find_library did not find is skipped, never loaded as None (the
    running program)."""
    import ctypes

    def cdll(name, *a, **k):
        assert name is not None, "CDLL(None) loads the running program"
        raise OSError(f"{name}: not here")

    monkeypatch.setattr(t_codecs, "_OPUS", None)
    monkeypatch.setattr(ctypes, "CDLL", cdll)
    monkeypatch.setattr(ctypes.util, "find_library", lambda name: None)
    with pytest.raises(RuntimeError, match="re-pack shards as wav/flac"):
        t_codecs.decode_ogg_opus(b"OggS")
