"""Python inference API (port of the JAX ``api.py``): ``load_model(dir)`` and
``Model.transcribe(audio) -> {text, ...}`` over a local model directory.

A model directory (a ``bin/train.py`` run directory) holds ``train.yaml``,
the files its ``tokenizer_conf`` (and ``cmvn_conf``) name, and the port's
``state_dict`` checkpoints (``train/checkpointing.py``: ``epoch_0003.pt``,
``snapshot.pt``, ...; ``tools/convert_checkpoint.py`` makes one from a
WeNet checkpoint).  The checkpoint is the one given, else the last of
``checkpointing.list_checkpoints`` in name order, as JAX picks.  Paths in
``train.yaml`` that do not exist as given are looked up in the directory.
The model runs on ``cuda`` unless the caller passes ``device="cpu"``.  A
registered hub name or an archive URL resolves to a cached model directory
through ``hub.resolve`` (the port's cache root: ``~/.pafc_torch``, or
``$PAFC_HOME``).
"""
from __future__ import annotations

import os
import types
from typing import Dict, Optional, Union

import numpy as np
import torch

from paper_accurate_fast_cheap_tpu_torch import resolve_device


def _in_dir(config: dict, model_dir: str) -> dict:
    """``config`` with each missing relative file path of its tokenizer and
    CMVN confs taken from ``model_dir`` when it is there."""
    out = dict(config)
    for conf in ("tokenizer_conf", "cmvn_conf"):
        sub = dict(out.get(conf) or {})
        for k, v in sub.items():
            if (isinstance(v, str) and k.endswith(("_path", "_file"))
                    and not os.path.exists(v)):
                cand = os.path.join(model_dir, v)
                if not os.path.exists(cand):
                    cand = os.path.join(model_dir, os.path.basename(v))
                if os.path.exists(cand):
                    sub[k] = cand
        if sub:
            out[conf] = sub
    return out


def _last_checkpoint(model_dir: str) -> str:
    from paper_accurate_fast_cheap_tpu_torch.train import checkpointing

    cks = checkpointing.list_checkpoints(model_dir)
    if not cks:
        raise FileNotFoundError(f"no checkpoints in {model_dir}")
    return cks[-1]


class Model:
    """A loaded model, its tokenizer and its feature function."""

    def __init__(self, config, tokenizer, model, model_type, featurize,
                 precision: str = "fp32"):
        if precision not in ("fp32", "bf16"):
            raise ValueError(f"precision {precision!r} not in fp32/bf16")
        self.config = config
        self.tokenizer = tokenizer
        self.model = model.to(torch.bfloat16) if precision == "bf16" \
            else model
        self.model_type = model_type
        self.precision = precision
        self.featurize = featurize
        special = config.get("tokenizer_conf", {}).get("special_tokens", {})
        self.sos = special.get("<sos>", tokenizer.vocab_size() - 1)
        self.eos = special.get("<eos>", tokenizer.vocab_size() - 1)

    @classmethod
    def from_dir(cls, model_dir: str, checkpoint: Optional[str] = None,
                 precision: str = "fp32", device=None):
        """Load from a model directory (``train.yaml`` and its last
        checkpoint unless ``checkpoint`` names one), a registered hub name
        or an archive URL (``hub.resolve``)."""
        from paper_accurate_fast_cheap_tpu_torch import hub
        from paper_accurate_fast_cheap_tpu_torch.bin.recognize import (
            build_decode_assets)
        from paper_accurate_fast_cheap_tpu_torch.utils.config import (
            load_config)

        dev = resolve_device(device)
        model_dir = hub.resolve(model_dir)
        config = _in_dir(load_config(os.path.join(model_dir, "train.yaml")),
                         model_dir)
        checkpoint = checkpoint or _last_checkpoint(model_dir)
        tokenizer, model, model_type, featurize, _ = build_decode_assets(
            config, checkpoint, device=dev)
        return cls(config, tokenizer, model, model_type, featurize,
                   precision=precision)

    @torch.no_grad()
    def _decode(self, wavs, mode: str, beam_size: int):
        """One featurize + encoder + search over the padded batch; returns
        the decode results (``tokens``, ``times``, ...) per waveform."""
        from paper_accurate_fast_cheap_tpu_torch.bin.recognize import (
            SUPPORTED_MODES, decode_batch)

        if mode not in SUPPORTED_MODES:
            raise ValueError(f"unknown mode {mode!r}")
        S = max(len(w) for w in wavs)
        batch = np.zeros((len(wavs), S), np.float32)
        lens = np.zeros((len(wavs),), np.int64)
        for i, w in enumerate(wavs):
            batch[i, :len(w)] = w
            lens[i] = len(w)
        feats, feat_lens = self.featurize(torch.from_numpy(batch),
                                          torch.from_numpy(lens))
        feats = feats.to(next(self.model.parameters()).dtype)
        args = types.SimpleNamespace(
            modes=[mode], beam_size=beam_size, ctc_weight=0.3,
            transducer_weight=0.7, rescore_ctc_weight=0.3,
            reverse_weight=0.0)
        return decode_batch(self.model, self.model_type, feats, feat_lens,
                            args, self.sos, self.eos)[mode]

    def transcribe_batch(self, wavs, mode: str = "ctc_greedy_search",
                         beam_size: int = 8):
        """Batched decode of float waveforms (16 kHz, [-1, 1]): the
        serving micro-batcher's entry (``bin/serve.py``).  Returns the
        texts."""
        return [self.tokenizer.detokenize(r.tokens)[0]
                for r in self._decode(wavs, mode, beam_size)]

    def transcribe(self, audio: Union[str, np.ndarray],
                   sample_rate: int = 16000,
                   mode: str = "ctc_greedy_search", beam_size: int = 8,
                   tokens_info: bool = False) -> Dict:
        """audio: a WAV path or a float waveform in [-1, 1]."""
        from paper_accurate_fast_cheap_tpu_torch.data.audio import (
            read_audio_bytes, resample_to)

        if isinstance(audio, str):
            with open(audio, "rb") as f:
                wav, sample_rate = read_audio_bytes(f.read())
        else:
            wav = np.asarray(audio, np.float32)
        wav, _ = resample_to(wav, int(sample_rate))
        res = self._decode([wav], mode, beam_size)[0]
        text, tokens = self.tokenizer.detokenize(res.tokens)
        out = {"text": text}
        if tokens_info:
            out["tokens"] = tokens
            out["token_ids"] = list(res.tokens)
            out["times"] = [t * 0.04 for t in res.times]
            out["confidence"] = res.confidence
        return out


def load_model(model_dir: str, checkpoint: Optional[str] = None,
               precision: str = "fp32", device=None) -> Model:
    """A local model directory, a registered hub name, or a direct archive
    URL (`wenet/cli/model.py:load_model` + `cli/hub.py`)."""
    return Model.from_dir(model_dir, checkpoint, precision=precision,
                          device=device)
