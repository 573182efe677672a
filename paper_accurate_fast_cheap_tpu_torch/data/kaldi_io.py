"""Kaldi ark/scp IO (port of the JAX ``data/kaldi_io.py``, numpy only):
float and double matrices in binary ark format ('BFM '/'BDM ' headers,
\\4-prefixed int32 dims, the '\\0B' binary marker), ASCII matrices,
compressed 'CM ' matrices, int and float vectors, and scp indirection
('key ark_path:offset').  ``bin/compute_fbank_feats.py`` writes its
features with ``write_ark_scp``.
"""
from __future__ import annotations

import struct
from typing import Dict, Iterator, Tuple

import numpy as np


def _expect_size_marker(f) -> None:
    """Each int32 of a binary header follows a \\4 byte."""
    if f.read(1) != b"\x04":
        raise ValueError("malformed kaldi binary header: no \\4 size marker")


def write_mat(f, mat: np.ndarray, key: str = None) -> int:
    """Write one matrix in binary ark format; returns the byte offset of the
    data start (for scp files)."""
    mat = np.asarray(mat)
    if key is not None:
        f.write((key + " ").encode("utf-8"))
    offset = f.tell()
    f.write(b"\0B")
    if mat.dtype == np.float64:
        f.write(b"DM ")
    else:
        mat = mat.astype(np.float32)
        f.write(b"FM ")
    rows, cols = mat.shape
    f.write(b"\x04" + struct.pack("<i", rows))
    f.write(b"\x04" + struct.pack("<i", cols))
    f.write(mat.tobytes())
    return offset


def read_mat(f) -> np.ndarray:
    """Read one matrix at the current position (after any key); handles
    binary FM/DM, compressed CM, and ascii text matrices."""
    binary = f.read(2)
    if binary != b"\0B":
        # ascii matrix: '[' then rows
        rest = binary + f.readline()
        txt = rest.decode("utf-8", "replace").strip()
        if txt.startswith("["):
            # the content after '[' plus the following lines
            first = txt[1:].strip()
            rows = []
            if first:
                if first.endswith("]"):
                    return np.asarray([first[:-1].split()], np.float32)
                rows.append(np.asarray(first.split(), np.float32))
            m = _read_mat_ascii(f)
            return np.vstack(rows + [m]) if rows else m
        raise ValueError("only binary/ascii kaldi matrices supported here")
    dtype_tag = f.read(3)
    if dtype_tag == b"CM ":
        return read_compressed_mat(f)
    if dtype_tag == b"FM ":
        dt, size = np.float32, 4
    elif dtype_tag == b"DM ":
        dt, size = np.float64, 8
    else:
        raise ValueError(f"unknown matrix type {dtype_tag!r}")
    _expect_size_marker(f)
    rows = struct.unpack("<i", f.read(4))[0]
    _expect_size_marker(f)
    cols = struct.unpack("<i", f.read(4))[0]
    data = f.read(rows * cols * size)
    return np.frombuffer(data, dt).reshape(rows, cols).copy()


def read_ark(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Iterate (key, matrix) from an ark file."""
    yield from _iter_ark(path, read_mat)


def write_ark_scp(ark_path: str, mats: Dict[str, np.ndarray],
                  scp_path: str = None) -> None:
    """Write {key: matrix} to ark (+ optional scp index)."""
    scp_lines = []
    with open(ark_path, "wb") as f:
        for key, mat in mats.items():
            offset = write_mat(f, mat, key)
            scp_lines.append(f"{key} {ark_path}:{offset}")
    if scp_path:
        with open(scp_path, "w") as f:
            f.write("\n".join(scp_lines) + "\n")


def read_scp(scp_path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Iterate (key, matrix) through an scp index 'key ark_path:offset'."""
    with open(scp_path) as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) != 2:
                continue
            key, loc = parts
            path, offset = loc.rsplit(":", 1)
            with open(path, "rb") as a:
                a.seek(int(offset))
                yield key, read_mat(a)


# -- vectors, ASCII and compressed matrices, alignment arks ---------------

def write_vec_int(f, v: np.ndarray, key: str = None) -> int:
    """Binary int32 vector."""
    v = np.asarray(v, np.int32)
    if key is not None:
        f.write((key + " ").encode("utf-8"))
    offset = f.tell()
    f.write(b"\0B")
    f.write(b"\x04" + struct.pack("<i", len(v)))
    for x in v:
        f.write(b"\x04" + struct.pack("<i", int(x)))
    return offset


def read_vec_int(f) -> np.ndarray:
    """Binary int32 vector."""
    binary = f.read(2)
    if binary != b"\0B":
        raise ValueError("only binary kaldi vectors supported here")
    _expect_size_marker(f)
    n = struct.unpack("<i", f.read(4))[0]
    data = f.read(5 * n)
    arr = np.frombuffer(data, dtype=[("sz", "u1"), ("v", "<i4")], count=n)
    return arr["v"].copy()


def write_vec_flt(f, v: np.ndarray, key: str = None) -> int:
    """Binary float vector 'FV '/'DV '."""
    v = np.asarray(v)
    if key is not None:
        f.write((key + " ").encode("utf-8"))
    offset = f.tell()
    f.write(b"\0B")
    if v.dtype == np.float64:
        f.write(b"DV ")
    else:
        v = v.astype(np.float32)
        f.write(b"FV ")
    f.write(b"\x04" + struct.pack("<i", len(v)))
    f.write(v.tobytes())
    return offset


def read_vec_flt(f) -> np.ndarray:
    """Binary float vector."""
    binary = f.read(2)
    if binary != b"\0B":
        raise ValueError("only binary kaldi vectors supported here")
    tag = f.read(3)
    if tag == b"FV ":
        dt, size = np.float32, 4
    elif tag == b"DV ":
        dt, size = np.float64, 8
    else:
        raise ValueError(f"unknown vector type {tag!r}")
    _expect_size_marker(f)
    n = struct.unpack("<i", f.read(4))[0]
    return np.frombuffer(f.read(n * size), dt).copy()


def _iter_ark(path: str, reader):
    with open(path, "rb") as f:
        while True:
            key_bytes = b""
            while True:
                c = f.read(1)
                if not c:
                    return
                if c == b" ":
                    break
                key_bytes += c
            yield key_bytes.decode("utf-8"), reader(f)


def read_vec_int_ark(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    yield from _iter_ark(path, read_vec_int)


read_ali_ark = read_vec_int_ark  # alignment arks are int vectors


def read_vec_flt_ark(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    yield from _iter_ark(path, read_vec_flt)


def _read_mat_ascii(f) -> np.ndarray:
    """Text matrix '... [ rows ]'."""
    rows = []
    while True:
        line = f.readline()
        if isinstance(line, bytes):
            line = line.decode("utf-8")
        if not line:
            raise ValueError("eof inside ascii matrix")
        arr = line.strip().split()
        if not arr:
            continue
        if arr[-1] == "]":
            rows.append(np.asarray(arr[:-1], np.float32))
            return np.vstack(rows)
        rows.append(np.asarray(arr, np.float32))


def read_compressed_mat(f) -> np.ndarray:
    """Kaldi 'CM ' compressed matrix: global
    min/range + per-column uint16 percentiles + uint8 data, col-major."""
    globmin, globrange = struct.unpack("<ff", f.read(8))
    rows, cols = struct.unpack("<ii", f.read(8))
    col_headers = np.frombuffer(f.read(cols * 8), "<u2").reshape(cols, 4)
    data = np.frombuffer(f.read(cols * rows), np.uint8).reshape(cols, rows)
    pct = (globmin + globrange * 1.52590218966964e-05
           * col_headers.astype(np.float32))       # (cols, 4)
    p0, p25, p75, p100 = (pct[:, i : i + 1] for i in range(4))
    v = data.astype(np.float32)
    mat = np.where(
        data <= 64, p0 + (p25 - p0) / 64.0 * v,
        np.where(data > 192, p75 + (p100 - p75) / 63.0 * (v - 192.0),
                 p25 + (p75 - p25) / 128.0 * (v - 64.0)))
    return mat.T.copy()


def write_compressed_mat(f, mat: np.ndarray, key: str = None) -> int:
    """Write a 'CM ' compressed matrix (CompressedMatrix format 1) so
    Kaldi/the reference reader can consume our arks at 1 byte/element."""
    mat = np.asarray(mat, np.float32)
    rows, cols = mat.shape
    if key is not None:
        f.write((key + " ").encode("utf-8"))
    offset = f.tell()
    f.write(b"\0BCM ")
    globmin = float(mat.min())
    globrange = float(max(mat.max() - globmin, 1e-20))
    f.write(struct.pack("<ffii", globmin, globrange, rows, cols))

    def to_u16(x):
        return np.clip(np.round((x - globmin) / globrange / 1.52590218966964e-05),
                       0, 65535).astype("<u2")

    def to_f(u):
        return globmin + globrange * 1.52590218966964e-05 * \
            u.astype(np.float32)

    cm = mat.T  # col-major
    p = np.percentile(cm, [0, 25, 75, 100], axis=1).T  # (cols, 4)
    pu = to_u16(p)
    # make percentiles strictly ordered the way Kaldi does (avoid zero
    # ranges in the piecewise map)
    pu[:, 1] = np.maximum(pu[:, 1], pu[:, 0] + 1)
    pu[:, 2] = np.maximum(pu[:, 2], pu[:, 1] + 1)
    pu[:, 3] = np.maximum(pu[:, 3], pu[:, 2] + 1)
    f.write(pu.astype("<u2").tobytes())
    pf = to_f(pu)
    p0, p25, p75, p100 = (pf[:, i : i + 1] for i in range(4))
    low = np.clip(np.round((cm - p0) / np.maximum(p25 - p0, 1e-20) * 64.0),
                  0, 64)
    mid = np.clip(np.round((cm - p25) / np.maximum(p75 - p25, 1e-20)
                           * 128.0) + 64, 65, 192)
    high = np.clip(np.round((cm - p75) / np.maximum(p100 - p75, 1e-20)
                            * 63.0) + 192, 193, 255)
    enc = np.where(cm < p25, low, np.where(cm <= p75, mid, high))
    f.write(enc.astype(np.uint8).tobytes())
    return offset
