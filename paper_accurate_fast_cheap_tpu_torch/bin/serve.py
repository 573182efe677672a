"""WebSocket ASR server, WeNet's wire protocol (port of the JAX
``bin/serve.py``): a standard-library RFC 6455 handshake and frame codec,
one thread per connection.

  client -> {"signal": "start", "nbest": 1, "continuous_decoding": true}
            (+ "streaming": true for an incremental session,
             + "decode_mode": "<mode>" for the whole-buffer decodes)
  client -> binary pcm16 frames (16 kHz mono)
  client -> {"signal": "end"}
  server -> {"status": "ok", "type": "partial_result"|"final_result",
             "nbest": "<text>"}

Without ``streaming`` the audio is buffered and decoded whole
(``api.Model.transcribe_batch``), with a partial every
``--partial_interval`` seconds of audio; the decodes of concurrent
connections are micro-batched by mode (up to ``--max_batch``).  With
``streaming`` a ``streaming.StreamingSession`` (causal encoders) decodes
window by window, or with ``--streaming_batch N`` a slot of one
``StreamingBatch`` shared by N connections (recurrent causal encoders).

One worker thread owns the card (``DecodeWorker``): the batched decodes, the
sessions' windows and the batch's steps all run on it; connection threads
parse frames and buffer audio on the host.

Usage:
  python -m paper_accurate_fast_cheap_tpu_torch.bin.serve \\
      --model_dir exp/model --port 10086 [--streaming_batch 8] \\
      [--device cpu]
"""
from __future__ import annotations

import argparse
import base64
import collections
import concurrent.futures
import hashlib
import json
import logging
import queue
import socketserver
import struct
import sys
import threading

import numpy as np

_WS_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
log = logging.getLogger("serve")


def _recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("client closed")
        buf += chunk
    return buf


def read_frame(sock):
    """Returns (opcode, payload bytes)."""
    hdr = _recv_exact(sock, 2)
    opcode = hdr[0] & 0x0F
    masked = hdr[1] & 0x80
    length = hdr[1] & 0x7F
    if length == 126:
        length = struct.unpack(">H", _recv_exact(sock, 2))[0]
    elif length == 127:
        length = struct.unpack(">Q", _recv_exact(sock, 8))[0]
    mask = _recv_exact(sock, 4) if masked else None
    payload = _recv_exact(sock, length) if length else b""
    if mask:
        payload = (np.frombuffer(payload, np.uint8)
                   ^ np.resize(np.frombuffer(mask, np.uint8), length)
                   ).tobytes()
    return opcode, payload


def write_frame(sock, payload: bytes, opcode: int = 1):
    header = bytes([0x80 | opcode])
    n = len(payload)
    if n < 126:
        header += bytes([n])
    elif n < 65536:
        header += bytes([126]) + struct.pack(">H", n)
    else:
        header += bytes([127]) + struct.pack(">Q", n)
    sock.sendall(header + payload)


def websocket_handshake(sock) -> bool:
    data = b""
    while b"\r\n\r\n" not in data:
        chunk = sock.recv(4096)
        if not chunk:
            return False
        data += chunk
    headers = {}
    for line in data.decode("latin1").split("\r\n")[1:]:
        if ": " in line:
            k, v = line.split(": ", 1)
            headers[k.lower()] = v
    key = headers.get("sec-websocket-key")
    if not key:
        return False
    accept = base64.b64encode(
        hashlib.sha1((key + _WS_MAGIC).encode()).digest()).decode()
    sock.sendall((
        "HTTP/1.1 101 Switching Protocols\r\n"
        "Upgrade: websocket\r\nConnection: Upgrade\r\n"
        f"Sec-WebSocket-Accept: {accept}\r\n\r\n").encode())
    return True


class DecodeWorker:
    """The one thread that owns the card.  It micro-batches whole-buffer
    decode requests of one mode and runs the calls other threads hand it
    (:meth:`call`: the streaming sessions' windows, the batch's steps)."""

    def __init__(self, model, max_batch: int = 8, max_wait_s: float = 0.01):
        self.model = model
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.q: "queue.Queue" = queue.Queue()
        self._held = collections.deque()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="decode-worker")
        self._thread.start()

    def _submit(self, kind, payload):
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self.q.put((kind, payload, fut))
        return fut.result()

    def decode(self, pcm: bytes, mode: str) -> str:
        return self._submit("decode", (pcm, mode))

    def call(self, fn, *args):
        """Run ``fn(*args)`` on the worker thread; returns its result."""
        return self._submit("call", (fn, args))

    def stop(self) -> None:
        self.q.put(None)
        self._thread.join()

    def _next(self, timeout=None):
        if self._held:
            return self._held.popleft()
        return self.q.get(timeout=timeout)

    def _run(self):
        while True:
            item = self._next()
            if item is None:
                return
            kind, payload, fut = item
            if kind == "call":
                fn, args = payload
                try:
                    fut.set_result(fn(*args))
                except Exception as e:  # noqa: BLE001 - to the caller
                    fut.set_exception(e)
                continue
            mode = payload[1]
            group = [item]
            while len(group) < self.max_batch:
                try:
                    nxt = self._next(timeout=self.max_wait_s)
                except queue.Empty:
                    break
                if nxt is None or nxt[0] != "decode" or nxt[1][1] != mode:
                    self._held.append(nxt)     # next round
                    break
                group.append(nxt)
            wavs = [np.frombuffer(g[1][0], np.int16).astype(np.float32)
                    / 32768.0 for g in group]
            try:
                texts = self.model.transcribe_batch(wavs, mode=mode)
                for g, text in zip(group, texts):
                    g[2].set_result(text)
            except Exception as e:  # noqa: BLE001 - to the callers
                for g in group:
                    if not g[2].done():
                        g[2].set_exception(e)


class _WorkerSession:
    """A per-connection StreamingSession whose windows run on the
    worker thread."""

    def __init__(self, session, worker: DecodeWorker):
        self._s, self._w = session, worker

    def accept_waveform(self, wav):
        return self._w.call(self._s.accept_waveform, wav)

    def finalize(self):
        return self._w.call(self._s.finalize)

    def abort(self):
        self._s.abort()


class _BatchSessionAdapter:
    """Session-shaped view of one BatchStreamWorker slot (the handler's
    code is the same for batched and per-connection sessions)."""

    def __init__(self, worker):
        self._w = worker
        self._sid = worker.open()
        self._closed = False

    def accept_waveform(self, wav):
        self._w.accept_waveform(self._sid, wav)
        return self._w.partial(self._sid)

    def finalize(self):
        self._closed = True
        return self._w.finalize(self._sid)

    def abort(self):
        if not self._closed:          # free the slot on a dropped connection
            self._closed = True
            self._w.finalize(self._sid)


class ASRHandler(socketserver.BaseRequestHandler):
    def handle(self):
        worker = self.server.decode_worker
        partial_interval = self.server.partial_interval
        sock = self.request
        if not websocket_handshake(sock):
            return
        pcm = b""
        last_partial_samples = 0
        mode = "ctc_greedy_search"
        session = None
        last_partial_text = None
        try:
            while True:
                opcode, payload = read_frame(sock)
                if opcode == 8:  # close
                    break
                if opcode == 1:  # text
                    msg = json.loads(payload.decode("utf-8"))
                    if msg.get("signal") == "start":
                        pcm = b""
                        last_partial_samples = 0
                        mode = msg.get("decode_mode", mode)
                        if session is not None:
                            session.abort()
                        session = None
                        last_partial_text = None
                        if msg.get("streaming"):
                            session = self._open_session()
                        write_frame(sock, json.dumps(
                            {"status": "ok",
                             "type": "server_ready"}).encode())
                    elif msg.get("signal") == "end":
                        if session is not None:
                            text = session.finalize().text
                            session = None
                        else:
                            text = self._decode(worker, pcm, mode)
                        write_frame(sock, json.dumps(
                            {"status": "ok", "type": "final_result",
                             "nbest": text}).encode())
                        break
                elif opcode == 2:  # binary pcm16
                    if session is not None:
                        wav = np.frombuffer(payload, np.int16).astype(
                            np.float32) / 32768.0
                        part = session.accept_waveform(wav)
                        if part.text != last_partial_text:
                            last_partial_text = part.text
                            write_frame(sock, json.dumps(
                                {"status": "ok", "type": "partial_result",
                                 "nbest": part.text}).encode())
                        continue
                    pcm += payload
                    n = len(pcm) // 2
                    if n - last_partial_samples >= int(partial_interval
                                                       * 16000):
                        last_partial_samples = n
                        text = self._decode(worker, pcm, mode)
                        write_frame(sock, json.dumps(
                            {"status": "ok", "type": "partial_result",
                             "nbest": text}).encode())
        except ConnectionError:
            pass
        except Exception as e:  # noqa: BLE001 - report decode errors
            log.exception("handler error")
            try:
                write_frame(sock, json.dumps(
                    {"status": "failed", "message": str(e)}).encode())
            except OSError:
                pass
        finally:
            if session is not None:   # dropped connection: free the slot
                try:
                    session.abort()
                except Exception:     # noqa: BLE001
                    log.exception("session abort failed")

    def _open_session(self):
        """A slot of the batched worker when configured and free, else a
        per-connection session."""
        stream_worker = self.server.stream_worker
        if stream_worker is not None:
            try:
                return _BatchSessionAdapter(stream_worker)
            except RuntimeError:      # all slots busy: degrade, don't drop
                log.warning("streaming_batch slots full; dedicated session")
        return _WorkerSession(self.server.session_factory(),
                              self.server.decode_worker)

    @staticmethod
    def _decode(worker, pcm: bytes, mode: str) -> str:
        if len(pcm) < 2 * 400:
            return ""
        return worker.decode(pcm, mode)


class ASRServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def stop(self) -> None:
        """Stop serving (after ``serve_forever``), then the workers."""
        self.shutdown()
        self.server_close()
        if self.stream_worker is not None:
            self.stream_worker.shutdown()
        self.decode_worker.stop()


def serve(model, host: str = "0.0.0.0", port: int = 10086,
          partial_interval: float = 2.0, max_batch: int = 8,
          streaming_chunk: int = 16, streaming_batch: int = 0):
    """The server (not yet serving: call ``serve_forever``) over ``model``,
    an ``api.Model`` (``.model``, ``.tokenizer``, ``.featurize``,
    ``.transcribe_batch``)."""
    from paper_accurate_fast_cheap_tpu_torch.streaming import (
        BatchStreamWorker, StreamingBatch, make_session_factory)

    srv = ASRServer((host, port), ASRHandler)
    srv.asr_model = model
    srv.decode_worker = DecodeWorker(model, max_batch=max_batch)
    srv.partial_interval = partial_interval
    srv.session_factory = make_session_factory(
        model.model, model.tokenizer, model.featurize,
        decoding_chunk_size=streaming_chunk)
    srv.stream_worker = None
    if streaming_batch > 0:
        try:
            srv.stream_worker = BatchStreamWorker(
                StreamingBatch(model.model, model.tokenizer, model.featurize,
                               max_sessions=streaming_batch,
                               decoding_chunk_size=streaming_chunk),
                run=srv.decode_worker.call)
        except ValueError as e:
            log.warning("--streaming_batch unavailable (%s); using "
                        "per-connection sessions", e)
    log.info("serving on ws://%s:%d", host, srv.server_address[1])
    return srv


def main(argv=None):
    p = argparse.ArgumentParser(description="websocket ASR server")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=10086)
    p.add_argument("--partial_interval", type=float, default=2.0)
    p.add_argument("--max_batch", type=int, default=8,
                   help="micro-batch cap across concurrent connections")
    p.add_argument("--streaming_chunk", type=int, default=16,
                   help="encoder frames per window of a streaming session")
    p.add_argument("--streaming_batch", type=int, default=0,
                   help="batch up to N streaming connections into one step "
                        "(recurrent-attention causal encoders only)")
    p.add_argument("--precision", default="fp32", choices=["fp32", "bf16"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from paper_accurate_fast_cheap_tpu_torch.api import load_model

    model = load_model(args.model_dir, args.checkpoint,
                       precision=args.precision, device=args.device)
    srv = serve(model, args.host, args.port, args.partial_interval,
                max_batch=args.max_batch,
                streaming_chunk=args.streaming_chunk,
                streaming_batch=args.streaming_batch)
    try:
        srv.serve_forever()
    finally:
        srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
