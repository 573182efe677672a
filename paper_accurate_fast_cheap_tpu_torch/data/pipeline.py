"""Data pipeline of the decode CLI: shard/raw sources -> processor chain ->
padded numpy batches (port of the ``mode="test"`` chain of the JAX
``data/pipeline.py``).

Stages, in the JAX package's order: the source (``raw`` JSON lines,
``shard`` tar lists, ``zip_shard`` zip lists), ``decode_wav`` (RIFF/WAV
through ``data/audio.py``; other containers raise as there), ``resample``,
``tokenize``, ``filter_samples``, ``sort_by_length`` (kept in test mode: it
sets the output order), ``static_batch`` and ``collate`` (descending length
within a batch, lengths padded to ``bucket_pad_length``).  The stages that
only training runs (shuffle, speed perturbation, dynamic and distributed
batching, utterance merging, the speaker, language, category-embedding,
special-token, word-filter and deep-biasing stages) raise
``NotImplementedError`` naming ROADMAP Queue 1 item 10.  Decoding is
sequential (``num_workers`` and ``prefetch`` only overlap work in the JAX
package; the order is the same).
"""
from __future__ import annotations

import json
import logging
import tarfile
import zipfile
from typing import Any, Dict, Iterable, Iterator, List, Optional

import numpy as np

from paper_accurate_fast_cheap_tpu_torch.data.audio import (
    read_audio_bytes, resample_to)

log = logging.getLogger(__name__)

AUDIO_EXTS = {"wav", "flac", "mp3", "m4a", "ogg", "opus"}


def _training_only(what: str):
    return NotImplementedError(
        f"{what} belongs to the training pipeline, which waits for ROADMAP "
        "Queue 1 item 10")


# ------------------------------------------------------------------ sources

def raw_source(list_file: str) -> Iterator[Dict]:
    """Each line of list_file is a JSON dict {key, wav, txt, [start, end]}."""
    with open(list_file, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            obj.setdefault("job", list_file)
            yield obj


def shard_list_source(list_file: str) -> Iterator[str]:
    with open(list_file, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                yield line


def tar_shard_source(paths: Iterable[str]) -> Iterator[Dict]:
    """WeNet tar shards: entries '{key}.txt' + '{key}.{audio_ext}' grouped
    per key; a shard that cannot be opened is skipped with a warning."""
    for path in paths:
        try:
            tf = tarfile.open(path, "r:*")
        except (tarfile.TarError, OSError) as e:
            log.warning("skipping bad shard %s: %s", path, e)
            continue
        with tf:
            sample: Dict[str, Any] = {}
            prev_key = None
            for member in tf:
                if not member.isfile():
                    continue
                name = member.name
                if "." not in name:
                    continue
                key, ext = name.rsplit(".", 1)
                if prev_key is not None and key != prev_key:
                    if "txt" in sample and "audio_bytes" in sample:
                        yield dict(sample, key=prev_key, job=path)
                    sample = {}
                data = tf.extractfile(member).read()
                if ext == "txt":
                    sample["txt"] = data.decode("utf-8").strip()
                elif ext in AUDIO_EXTS:
                    sample["audio_bytes"] = data
                    sample["audio_ext"] = ext
                prev_key = key
            if prev_key is not None and "txt" in sample \
                    and "audio_bytes" in sample:
                yield dict(sample, key=prev_key, job=path)


def zip_shard_source(paths: Iterable[str]) -> Iterator[Dict]:
    """Zip shards, grouped per key in the archive's name order."""
    for path in paths:
        try:
            zf = zipfile.ZipFile(path)
        except (zipfile.BadZipFile, OSError) as e:
            log.warning("skipping bad zip shard %s: %s", path, e)
            continue
        with zf:
            groups: Dict[str, Dict] = {}
            for name in zf.namelist():
                if "." not in name:
                    continue
                key, ext = name.rsplit(".", 1)
                g = groups.setdefault(key, {})
                if ext == "txt":
                    g["txt"] = zf.read(name).decode("utf-8").strip()
                elif ext in AUDIO_EXTS:
                    g["audio_bytes"] = zf.read(name)
                    g["audio_ext"] = ext
            for key, g in groups.items():
                if "txt" in g and "audio_bytes" in g:
                    yield dict(g, key=key, job=path)


# ---------------------------------------------------------------- processors

def _decode_one(s: Dict) -> Dict:
    if "audio_bytes" in s:
        data = s.pop("audio_bytes")
    else:
        with open(s["wav"], "rb") as f:
            data = f.read()
    wav, sr = read_audio_bytes(data)
    if "start" in s:
        start = int(float(s["start"]) * sr)
        end = int(float(s.get("end", len(wav) / sr)) * sr)
        wav = wav[start:end]
    s = dict(s, wav=wav, sample_rate=sr)
    s.pop("audio_ext", None)
    return s


def decode_wav(samples: Iterable[Dict]) -> Iterator[Dict]:
    """Audio to mono float32 in [-1, 1], with optional [start, end] second
    segments.  A sample that fails to decode is skipped with a warning, as
    in the JAX package; a container the port does not read raises."""
    for s in samples:
        try:
            yield _decode_one(s)
        except NotImplementedError:
            raise
        except Exception as e:
            log.warning("decode_wav failed for %s: %s", s.get("key"), e)


def resample(samples, resample_rate: int = 16000):
    for s in samples:
        wav, sr = resample_to(s["wav"], int(s["sample_rate"]), resample_rate)
        yield dict(s, wav=wav, sample_rate=sr)


def tokenize(samples, tokenizer):
    for s in samples:
        tokens, ids = tokenizer.tokenize(s["txt"])
        yield dict(s, tokens=tokens, label=np.asarray(ids, np.int32))


def compute_num_frames(num_samples: int, sample_rate: int = 16000,
                       frame_shift_ms: int = 10) -> int:
    return num_samples // (sample_rate * frame_shift_ms // 1000)


def filter_samples(samples, max_length: int = 10240, min_length: int = 10,
                   token_max_length: int = 200, token_min_length: int = 1,
                   min_output_input_ratio: float = 5e-4,
                   max_output_input_ratio: float = 1.0):
    """Length and token-count filters on fbank-frame counts."""
    kept = dropped = 0
    for s in samples:
        frames = compute_num_frames(len(s["wav"]), s["sample_rate"])
        toks = len(s["label"])
        if (min_length <= frames <= max_length
                and token_min_length <= toks <= token_max_length
                and frames > 0
                and min_output_input_ratio <= toks / max(frames, 1)
                <= max_output_input_ratio):
            kept += 1
            yield s
        else:
            dropped += 1
    log.info("filter: kept=%d dropped=%d", kept, dropped)


def sort_by_length(samples, sort_size: int = 500):
    """Buffered sort by duration (stable within a buffer)."""
    buf = []
    for s in samples:
        buf.append(s)
        if len(buf) >= sort_size:
            buf.sort(key=lambda x: len(x["wav"]))
            yield from buf
            buf = []
    buf.sort(key=lambda x: len(x["wav"]))
    yield from buf


# ---------------------------------------------------------------- batching

def static_batch(samples, batch_size: int = 16):
    buf = []
    for s in samples:
        buf.append(s)
        if len(buf) >= batch_size:
            yield buf
            buf = []
    if buf:
        yield buf


def bucket_pad_length(n: int, buckets: Optional[List[int]] = None,
                      quantum: int = 16000) -> int:
    """The padded length: the first bucket that holds n, else n rounded up
    to a multiple of ``quantum`` (at least one quantum)."""
    if buckets:
        for b in buckets:
            if n <= b:
                return b
        return buckets[-1]
    return max(quantum, ((n + quantum - 1) // quantum) * quantum)


def collate(batch: List[Dict], wav_quantum: int = 16000,
            label_quantum: int = 16) -> Dict[str, np.ndarray]:
    """Pad a list of samples into arrays, sorted by descending length."""
    batch = sorted(batch, key=lambda s: len(s["wav"]), reverse=True)
    B = len(batch)
    S = bucket_pad_length(max(len(s["wav"]) for s in batch), None,
                          wav_quantum)
    U = bucket_pad_length(max(len(s["label"]) for s in batch), None,
                          label_quantum)
    wavs = np.zeros((B, S), np.float32)
    wav_lens = np.zeros((B,), np.int32)
    labels = np.zeros((B, U), np.int32)
    label_lens = np.zeros((B,), np.int32)
    for i, s in enumerate(batch):
        n = len(s["wav"])
        wavs[i, :n] = s["wav"]
        wav_lens[i] = n
        u = len(s["label"])
        labels[i, :u] = s["label"]
        label_lens[i] = u
    return {"keys": [s["key"] for s in batch],
            "txts": [s.get("txt", "") for s in batch],
            "wavs": wavs, "wav_lens": wav_lens,
            "labels": labels, "label_lens": label_lens}


# ---------------------------------------------------------------- assembly

def build_dataset(data_type: str, list_file: str, tokenizer,
                  conf: Dict[str, Any],
                  mode: str = "test") -> Iterator[Dict[str, np.ndarray]]:
    """The processor chain of ``conf`` in the JAX package's order; yields
    collated numpy batches.  One process reads every item (the JAX
    package's rank partitioning is not ported)."""
    if data_type == "raw":
        stream = raw_source(list_file)
    elif data_type == "shard":
        stream = tar_shard_source(shard_list_source(list_file))
    elif data_type == "zip_shard":
        stream = zip_shard_source(shard_list_source(list_file))
    else:
        raise ValueError(f"unknown data_type {data_type!r}")
    merge = conf.get("merge_utterances", False)
    if isinstance(merge, dict):   # the legacy schema
        merge = merge.get("enabled", False)
    if merge:
        raise _training_only("utterance merging")
    for key, what in (("speaker_conf", "the speaker stage"),
                      ("language_conf", "the language stage"),
                      ("filter_long_yeah_okay", "the yeah/okay filter"),
                      ("filter_wordy", "the wordy filter"),
                      ("exclude_keys_fn", "the key exclusion"),
                      ("pass_cat_emb", "the category embedding"),
                      ("add_cat_emb", "the category embedding")):
        if conf.get(key):
            raise _training_only(what)
    if conf.get("deep_bias_conf", {}).get("deep_biasing", False):
        raise _training_only("deep biasing")
    if mode == "train":
        if conf.get("handle_special_token", False):
            raise _training_only("special-token handling")
        if conf.get("speed_perturb", False):
            raise _training_only("speed perturbation")
        if conf.get("shuffle", True):
            raise _training_only("shuffle")
    stream = decode_wav(stream)
    if "resample_conf" in conf:
        stream = resample(stream,
                          conf["resample_conf"].get("resample_rate", 16000))
    stream = tokenize(stream, tokenizer)
    stream = filter_samples(stream, **conf.get("filter_conf", {}))
    if conf.get("sort", True):
        stream = sort_by_length(
            stream, conf.get("sort_conf", {}).get("sort_size", 500))
    bc = conf.get("batch_conf", {})
    btype = bc.get("batch_type", "static")
    if btype in ("dynamic", "distribute"):
        raise _training_only(f"{btype} batching")
    if btype != "static":
        raise ValueError(f"unknown batch_type {btype!r}")
    for b in static_batch(stream, bc.get("batch_size", 16)):
        yield collate(b)
