"""Incremental (true-streaming) recognition sessions (port of the JAX
``streaming.py``).

A session accepts waveform pieces of any size, featurizes exactly the frames
the whole-file fbank gives (sample-domain windows of ``(chunk - 1) * 4 + 7``
feature frames, advanced by ``4 * chunk``), runs the causal encoder window
by window with its state carried (``decode/streaming.py`` semantics: the
uni RWKV's token shift and WKV state through K1, the uni Mamba's conv and
SSD state, the causal conv caches, the MHA KV cache) and emits CTC-greedy
partial hypotheses, the blank and duplicate collapse carried across
windows; token times come from the encoder frame that emitted them.

:class:`StreamingBatch` advances up to ``max_sessions`` sessions one window
each per :meth:`StreamingBatch.step`, in one batched encoder call: a slot
that joins has its state rows zeroed (the initial state is all zeros) and a
slot without work keeps its rows.  It takes recurrent encoders only (their
step does not depend on the absolute position); MHA streaming needs
per-slot key positions, so it runs in :class:`StreamingSession`.

The port runs eagerly: the model's weights live on its device (``cuda``
unless it was built on the CPU), and each window is one encoder call.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class PartialResult:
    text: str
    tokens: List[int]
    # per token, the audio time (s) of the encoder frame that emitted it
    # (the greedy CTC peak, the offline CTM's timing)
    times: List[float] = dataclasses.field(default_factory=list)
    final: bool = False


class _Geometry:
    """The window geometry shared by the session and the batch."""

    def __init__(self, decoding_chunk_size, subsampling, context,
                 frame_shift, frame_length):
        self._c = decoding_chunk_size
        self._sub = subsampling
        self._ctx = context
        self._shift = frame_shift
        self._flen = frame_length
        self._win_frames = (decoding_chunk_size - 1) * subsampling + context
        self._stride_frames = subsampling * decoding_chunk_size
        self._win_samples = ((self._win_frames - 1) * frame_shift
                             + frame_length)
        # encoder frame -> seconds (subsampling x the fbank shift)
        self._frame_sec = subsampling * frame_shift / 16000.0

    def _tail_frames(self, have: int) -> int:
        """Whole fbank frames in ``have`` buffered samples."""
        return max(0, (have - self._flen) // self._shift + 1)


def _model_dtype(model) -> torch.dtype:
    return next(model.parameters()).dtype


@torch.no_grad()
def _encode_chunk(model, featurize, wave: np.ndarray, wlens: np.ndarray,
                  state, offset: int):
    """Featurize a window batch and run one streaming encoder step and the
    CTC head.  Returns (greedy ids (B, T') on the host, encoder lengths on
    the host, the new state)."""
    feats, flens = featurize(torch.from_numpy(wave),
                             torch.from_numpy(wlens))
    enc, el, st = model.encoder(feats.to(_model_dtype(model)), flens,
                                streaming_state=state, return_state=True,
                                offset=offset)
    best = model.ctc_logprobs(enc).argmax(dim=-1)
    return best.cpu().numpy(), el.cpu().numpy(), st


def _collapse(best, n: int, blank: int, prev: int, offset: int,
              tokens: List[int], frames: List[int]) -> int:
    """Greedy CTC over ``best[:n]`` with the blank and duplicate collapse
    carried from ``prev``; appends to ``tokens``/``frames`` and returns the
    last id."""
    for i in range(n):
        t = int(best[i])
        if t != blank and t != prev:
            tokens.append(t)
            frames.append(offset + i)
        prev = t
    return prev


class StreamingSession(_Geometry):
    """One utterance's incremental decode (causal encoders only)."""

    def __init__(self, model, tokenizer, featurize,
                 decoding_chunk_size: int = 16, subsampling: int = 4,
                 context: int = 7, frame_shift: int = 160,
                 frame_length: int = 400, blank_id: int = 0):
        super().__init__(decoding_chunk_size, subsampling, context,
                         frame_shift, frame_length)
        self._model = model
        self._tokenizer = tokenizer
        self._featurize = featurize
        self._blank = blank_id
        self._samples = np.zeros((0,), np.float32)
        self._state = None
        self._offset = 0
        self._prev_tok = blank_id
        self._tokens: List[int] = []
        self._token_frames: List[int] = []
        self._done = False

    def accept_waveform(self, samples: np.ndarray) -> PartialResult:
        """Feed float32 samples in [-1, 1]; returns the partial so far."""
        if self._done:
            raise RuntimeError("session already finalized")
        self._samples = np.concatenate(
            [self._samples, np.asarray(samples, np.float32)])
        while self._try_chunk(flush=False):
            pass
        return self.partial()

    def finalize(self) -> PartialResult:
        """Flush the (zero-padded) tail window and close the session."""
        if not self._done:
            while self._try_chunk(flush=False):
                pass
            self._try_chunk(flush=True)
            self._done = True
        out = self.partial()
        out.final = True
        return out

    def partial(self) -> PartialResult:
        text, _ = self._tokenizer.detokenize(self._tokens)
        return PartialResult(
            text=text, tokens=list(self._tokens),
            times=[f * self._frame_sec for f in self._token_frames])

    def abort(self) -> None:
        """Discard the session."""
        self._done = True

    def _try_chunk(self, flush: bool) -> bool:
        have = len(self._samples)
        if not flush and have < self._win_samples:
            return False
        if flush:
            frames = self._tail_frames(have)
            if frames < self._ctx:
                return False
            window = np.zeros((self._win_samples,), np.float32)
            window[:have] = self._samples
            valid = min(frames, self._win_frames)
        else:
            window = self._samples[:self._win_samples]
            valid = self._win_frames
        best, el, self._state = _encode_chunk(
            self._model, self._featurize, window[None],
            np.asarray([(valid - 1) * self._shift + self._flen]),
            self._state, self._offset)
        n = int(el[0])
        self._prev_tok = _collapse(best[0], n, self._blank, self._prev_tok,
                                   self._offset, self._tokens,
                                   self._token_frames)
        self._offset += n
        # advance by the stride; keep the overlap
        self._samples = self._samples[self._stride_frames * self._shift:]
        return not flush


def make_session_factory(model, tokenizer, featurize, **kw):
    """Returns ``() -> StreamingSession`` over one model (serving: many
    connections, one set of weights)."""

    def factory():
        return StreamingSession(model, tokenizer, featurize, **kw)

    return factory


def _tree_map(fn, *trees):
    """``fn`` over the tensors of nested dicts, lists and tuples."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _rows(mask: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``mask`` (B,) shaped to broadcast over ``s``'s rows."""
    return mask.reshape((-1,) + (1,) * (s.ndim - 1))


class _Slot:
    __slots__ = ("samples", "tokens", "token_frames", "prev_tok", "offset",
                 "flushing", "done", "fresh")

    def __init__(self, blank_id: int):
        self.samples = np.zeros((0,), np.float32)
        self.tokens: List[int] = []
        self.token_frames: List[int] = []
        self.prev_tok = blank_id
        self.offset = 0
        self.flushing = False
        self.done = False
        self.fresh = True      # its state rows need zeroing


class StreamingBatch(_Geometry):
    """Lockstep multi-session streaming: every ready slot advances one
    window per :meth:`step`, in one batched call (fbank, the causal
    encoder, the CTC head, the per-slot state reset and merge).

    Recurrent-attention causal encoders only (uni RWKV, uni Mamba): their
    step does not depend on the absolute position, since all cross-window
    context rides in the carried state, so slots at different audio
    positions share one call with ``offset=0``.  The initial state is all
    zeros (the token shift's lead row, the conv caches, the WKV and SSD
    states), so a joining slot reuses a freed row by zeroing it in the
    step."""

    def __init__(self, model, tokenizer, featurize, max_sessions: int = 8,
                 decoding_chunk_size: int = 16, subsampling: int = 4,
                 context: int = 7, frame_shift: int = 160,
                 frame_length: int = 400, blank_id: int = 0):
        att = model.encoder.attention_type
        if att in ("selfattn", "rel_selfattn"):
            raise ValueError(
                "StreamingBatch requires a recurrent-attention encoder "
                "(rwkv/mamba); MHA streaming state is offset-dependent "
                f"- got selfattention_layer_type={att!r}")
        super().__init__(decoding_chunk_size, subsampling, context,
                         frame_shift, frame_length)
        self._model = model
        self._tokenizer = tokenizer
        self._featurize = featurize
        self._blank = blank_id
        self._B = max_sessions
        self._slots: List[Optional[_Slot]] = [None] * max_sessions
        # None until the first step: the zero state, made by the encoder
        self._state = None

    # -- session management ---------------------------------------------
    def open(self) -> int:
        """Allocate a session slot; returns its id.  Raises if full."""
        for i, s in enumerate(self._slots):
            if s is None:
                self._slots[i] = _Slot(self._blank)
                return i
        raise RuntimeError(f"all {self._B} session slots busy")

    def accept_waveform(self, sid: int, samples: np.ndarray) -> None:
        """Buffer float32 samples in [-1, 1] for slot ``sid`` (host only;
        the device work happens in :meth:`step`)."""
        slot = self._require(sid)
        if slot.flushing or slot.done:
            raise RuntimeError("session already finalizing")
        slot.samples = np.concatenate(
            [slot.samples, np.asarray(samples, np.float32)])

    def _is_ready(self, slot: Optional[_Slot]) -> bool:
        return (slot is not None and not slot.done
                and (len(slot.samples) >= self._win_samples
                     or slot.flushing))

    def any_ready(self) -> bool:
        return any(self._is_ready(s) for s in self._slots)

    def ready(self, sid: int) -> bool:
        """Whether slot ``sid`` holds a window the next step would take."""
        return self._is_ready(self._require(sid))

    def partial(self, sid: int) -> PartialResult:
        slot = self._require(sid)
        text, _ = self._tokenizer.detokenize(slot.tokens)
        return PartialResult(
            text=text, tokens=list(slot.tokens),
            times=[f * self._frame_sec for f in slot.token_frames],
            final=slot.done)

    def flush(self, sid: int) -> None:
        """Mark the end of the utterance; the rest of its audio drains
        through the next steps (the padded tail window last)."""
        self._require(sid).flushing = True

    def is_done(self, sid: int) -> bool:
        return self._require(sid).done

    def close(self, sid: int) -> PartialResult:
        """Free the slot and return its final result (it must be done)."""
        slot = self._require(sid)
        if not slot.done:
            raise RuntimeError("close() before the flush drained; use "
                               "finalize() or step until is_done()")
        out = self.partial(sid)
        self._slots[sid] = None
        return out

    def finalize(self, sid: int) -> PartialResult:
        """Drain the rest and the padded tail, close the slot and return
        its final result (one caller; a server's stepper thread uses
        flush/is_done/close)."""
        slot = self._require(sid)
        if not slot.done:
            slot.flushing = True
            while not slot.done:
                self.step()
        return self.close(sid)

    # -- the batched step -------------------------------------------------
    def step(self) -> dict:
        """Advance every ready slot by one window in one encoder call.
        Returns {sid: PartialResult} for the slots that emitted tokens or
        finished."""
        B, W = self._B, self._win_samples
        wave = np.zeros((B, W), np.float32)
        wlens = np.full((B,), W, np.int64)
        active = np.zeros((B,), bool)
        fresh = np.zeros((B,), bool)
        closing: List[int] = []
        for i, slot in enumerate(self._slots):
            if slot is None or slot.done:
                continue
            have = len(slot.samples)
            if have >= W:
                wave[i] = slot.samples[:W]
            elif slot.flushing:
                frames = self._tail_frames(have)
                if frames < self._ctx:
                    slot.done = True
                    continue
                wave[i, :have] = slot.samples
                wlens[i] = ((min(frames, self._win_frames) - 1)
                            * self._shift + self._flen)
                closing.append(i)
            else:
                continue
            active[i] = True
            fresh[i] = slot.fresh
        if not active.any():
            return {}

        state = self._state
        if state is not None:
            f = torch.from_numpy(fresh)
            state = _tree_map(lambda s: torch.where(
                _rows(f.to(s.device), s), torch.zeros((), dtype=s.dtype,
                                                      device=s.device), s),
                state)
        best, el, new = _encode_chunk(self._model, self._featurize, wave,
                                      wlens, state, 0)
        a = torch.from_numpy(active)
        old = state if state is not None else _tree_map(torch.zeros_like,
                                                        new)
        self._state = _tree_map(lambda n, o: torch.where(
            _rows(a.to(n.device), n), n, o), new, old)

        out = {}
        for i, slot in enumerate(self._slots):
            if slot is None or not active[i]:
                continue
            slot.fresh = False
            n_before = len(slot.tokens)
            slot.prev_tok = _collapse(best[i], int(el[i]), self._blank,
                                      slot.prev_tok, slot.offset,
                                      slot.tokens, slot.token_frames)
            slot.offset += int(el[i])
            slot.samples = slot.samples[self._stride_frames * self._shift:]
            if i in closing:
                slot.done = True
            if len(slot.tokens) > n_before or slot.done:
                out[i] = self.partial(i)
        return out

    def _require(self, sid: int) -> _Slot:
        slot = self._slots[sid]
        if slot is None:
            raise KeyError(f"no open session {sid}")
        return slot


class BatchStreamWorker:
    """Thread-safe facade over :class:`StreamingBatch` for the websocket
    server: connection handlers buffer audio and poll partials; one stepper
    thread drives the steps, each through ``run`` (``run(fn)`` calls ``fn``
    on the thread that owns the card; by default the stepper itself), so N
    connections cost one batched step per window.  :meth:`finalize` blocks
    until the stepper drains the flush."""

    def __init__(self, batch: StreamingBatch,
                 run: Optional[Callable] = None):
        self._b = batch
        self._device_run = run or (lambda fn: fn())
        self._cv = threading.Condition()
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="stream-stepper")
        self._thread.start()

    def open(self) -> int:
        with self._cv:
            return self._b.open()

    def accept_waveform(self, sid: int, wav: np.ndarray) -> None:
        with self._cv:
            self._b.accept_waveform(sid, wav)
            self._cv.notify_all()

    def partial(self, sid: int) -> PartialResult:
        """The slot's partial once the stepper has taken every full window
        it holds, as a per-connection session's ``accept_waveform``
        returns it (a partial read before would lag the audio by the
        steps still queued, and under load the last one could miss the
        utterance's words)."""
        with self._cv:
            self._cv.wait_for(lambda: self._stop or not self._b.ready(sid))
            return self._b.partial(sid)

    def finalize(self, sid: int) -> PartialResult:
        with self._cv:
            self._b.flush(sid)
            self._cv.notify_all()
            self._cv.wait_for(lambda: self._b.is_done(sid))
            return self._b.close(sid)

    def shutdown(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join()

    def _run(self) -> None:
        while True:
            with self._cv:
                self._cv.wait_for(lambda: self._stop or self._b.any_ready())
                if self._stop:
                    return
                self._device_run(self._b.step)
                # wake finalize() waiters whose flush just drained
                self._cv.notify_all()
