"""WebSocket batch-decode client (port of the JAX ``bin/ws_client.py``),
standard library only: streams WAV files to the server in 4096-byte frames
with the start/end JSON protocol and prints the final results.
``--streaming`` asks for an incremental session (``"streaming": true``).

Usage:
  python -m paper_accurate_fast_cheap_tpu_torch.bin.ws_client \\
      --host 127.0.0.1 --port 10086 [--streaming] a.wav b.wav
"""
from __future__ import annotations

import argparse
import base64
import json
import os
import socket
import struct
import sys

import numpy as np


def _handshake(sock, host, port):
    key = base64.b64encode(os.urandom(16)).decode()
    sock.sendall((
        f"GET / HTTP/1.1\r\nHost: {host}:{port}\r\n"
        "Upgrade: websocket\r\nConnection: Upgrade\r\n"
        f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n"
    ).encode())
    data = b""
    while b"\r\n\r\n" not in data:
        chunk = sock.recv(4096)
        if not chunk:
            raise ConnectionError("no handshake response")
        data += chunk
    if b"101" not in data.split(b"\r\n")[0]:
        raise ConnectionError(f"handshake rejected: {data[:100]!r}")


def _send(sock, payload: bytes, opcode: int):
    # client frames are masked
    mask = os.urandom(4)
    n = len(payload)
    masked = (np.frombuffer(payload, np.uint8)
              ^ np.resize(np.frombuffer(mask, np.uint8), n)).tobytes()
    header = bytes([0x80 | opcode])
    if n < 126:
        header += bytes([0x80 | n])
    elif n < 65536:
        header += bytes([0x80 | 126]) + struct.pack(">H", n)
    else:
        header += bytes([0x80 | 127]) + struct.pack(">Q", n)
    sock.sendall(header + mask + masked)


def _recv(sock):
    def rexact(n):
        buf = b""
        while len(buf) < n:
            c = sock.recv(n - len(buf))
            if not c:
                raise ConnectionError("server closed")
            buf += c
        return buf

    hdr = rexact(2)
    opcode = hdr[0] & 0x0F
    length = hdr[1] & 0x7F
    if length == 126:
        length = struct.unpack(">H", rexact(2))[0]
    elif length == 127:
        length = struct.unpack(">Q", rexact(8))[0]
    return opcode, rexact(length) if length else b""


def pcm16(wav: np.ndarray) -> bytes:
    """Float samples in [-1, 1] as little-endian 16-bit PCM bytes."""
    return np.clip(np.asarray(wav) * 32767, -32768, 32767).astype(
        "<i2").tobytes()


def transcribe_pcm(host: str, port: int, pcm: bytes,
                   chunk_bytes: int = 4096, streaming: bool = False):
    """Send ``pcm`` (16 kHz 16-bit mono) and return (final text, the
    partial texts received)."""
    start = {"signal": "start", "nbest": 1, "continuous_decoding": True}
    if streaming:
        start["streaming"] = True
    sock = socket.create_connection((host, port))
    try:
        _handshake(sock, host, port)
        _send(sock, json.dumps(start).encode(), 1)
        for i in range(0, len(pcm), chunk_bytes):
            _send(sock, pcm[i:i + chunk_bytes], 2)
        _send(sock, json.dumps({"signal": "end"}).encode(), 1)
        final, partials = "", []
        while True:
            opcode, payload = _recv(sock)
            if opcode == 8:
                break
            msg = json.loads(payload.decode("utf-8"))
            if msg.get("status") == "failed":
                raise RuntimeError(f"server: {msg.get('message')}")
            if msg.get("type") == "partial_result":
                partials.append(msg.get("nbest", ""))
            if msg.get("type") == "final_result":
                final = msg.get("nbest", "")
                break
        return final, partials
    finally:
        sock.close()


def transcribe_file(host: str, port: int, wav_path: str,
                    chunk_bytes: int = 4096, streaming: bool = False) -> str:
    from paper_accurate_fast_cheap_tpu_torch.data.audio import (
        read_audio_bytes, resample_to)

    with open(wav_path, "rb") as f:
        wav, sr = read_audio_bytes(f.read())
    wav, _ = resample_to(wav, sr)
    return transcribe_pcm(host, port, pcm16(wav), chunk_bytes, streaming)[0]


def main(argv=None):
    p = argparse.ArgumentParser(description="websocket decode client")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=10086)
    p.add_argument("--streaming", action="store_true",
                   help="an incremental session (causal encoders)")
    p.add_argument("wavs", nargs="+")
    args = p.parse_args(argv)
    for wav in args.wavs:
        text = transcribe_file(args.host, args.port, wav,
                               streaming=args.streaming)
        print(f"{os.path.basename(wav)}\t{text}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
