"""Data pipeline: shard/raw sources -> processor chain -> padded numpy
batches (port of the JAX ``data/pipeline.py``, every stage).

Stages in the JAX package's order (``build_dataset``): the source (``raw``
JSON lines, ``shard`` tar lists, ``zip_shard`` zip lists, partitioned by
rank), ``decode_wav`` (WAV, FLAC, Ogg/Opus, MP3 and m4a through
``data/audio.py``; a sample that does not decode is skipped with a
warning), utterance merging, the
speaker, deep-biasing, language, special-token, yeah/okay, wordy and
key-exclusion stages, ``resample``, ``speed_perturb`` (scipy's
``resample_poly``, as JAX), ``tokenize``, ``filter_samples``, the category
embedding, ``shuffle``, ``sort_by_length``, static, dynamic or distributed
batching, ``collate`` (descending length within a batch, lengths padded to
``bucket_pad_length``) and ``prefetch``.  Every random stage draws from one
``random.Random(seed)``, so one list file and seed give JAX's batches, key
for key.  The host pipeline stops at waveforms and token ids; features are
made on the device (``frontend/pipeline.py``).
"""
from __future__ import annotations

import json
import logging
import random
import tarfile
import zipfile
from typing import Any, Dict, Iterable, Iterator, List, Optional

import numpy as np

from paper_accurate_fast_cheap_tpu_torch.data.audio import (
    read_audio_bytes, resample_to)

log = logging.getLogger(__name__)

AUDIO_EXTS = {"wav", "flac", "mp3", "m4a", "ogg", "opus"}


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
    """Read WeNet tar shards: entries '{key}.txt' + '{key}.{audio_ext}'
    grouped per key (`datapipes.py:705-769` semantics)."""
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
    """Zip shards (`datapipes.py:539-627`)."""
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


def shard_by_rank(items: Iterable, rank: int = 0, world_size: int = 1,
                  partition: bool = True) -> Iterator:
    """Rank partitioning (`datapipes.py:414-438`); partition=False
    replicates (CV behavior)."""
    for i, item in enumerate(items):
        if not partition or i % world_size == rank:
            yield item


# ---------------------------------------------------------------- processors

def _decode_one(s: Dict) -> Dict:
    """Decode one sample's audio, with an optional [start, end] segment."""
    if "audio_bytes" in s:
        data = s.pop("audio_bytes")
    else:
        with open(s["wav"], "rb") as f:
            data = f.read()
    wav, sr = read_audio_bytes(data, s.get("audio_ext"))
    if "start" in s:
        start = int(float(s["start"]) * sr)
        end = int(float(s.get("end", len(wav) / sr)) * sr)
        wav = wav[start:end]
    s = dict(s, wav=wav, sample_rate=sr)
    s.pop("audio_ext", None)
    return s


def decode_wav(samples: Iterable[Dict],
               num_workers: int = 0) -> Iterator[Dict]:
    """Audio to mono float32 in [-1, 1], with optional [start, end] second
    segments; ``num_workers > 0`` decodes on an order-keeping thread pool.
    A sample that fails to decode (an unknown container among them) is
    skipped with a warning, as in the JAX package."""
    if num_workers > 0:
        yield from parallel_map(_decode_one, samples, num_workers,
                                on_error="skip")
        return
    for s in samples:
        try:
            yield _decode_one(s)
        except Exception as e:
            log.warning("decode_wav failed for %s: %s", s.get("key"), e)


def parallel_map(fn, stream: Iterable, workers: int,
                 on_error: str = "raise") -> Iterator:
    """Order-preserving thread-pool map with a bounded in-flight window
    (the analog of the reference's prefetching worker DataLoader)."""
    import collections
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=workers) as ex:
        pending = collections.deque()
        it = iter(stream)
        try:
            for item in it:
                pending.append(ex.submit(fn, item))
                if len(pending) >= workers * 2:
                    yield from _drain_one(pending, on_error)
            while pending:
                yield from _drain_one(pending, on_error)
        except GeneratorExit:
            for f in pending:
                f.cancel()
            raise


def _drain_one(pending, on_error):
    f = pending.popleft()
    try:
        yield f.result()
    except Exception as e:
        if on_error == "raise":
            raise
        log.warning("parallel_map item failed: %s", e)


def prefetch(stream: Iterable, buffer_size: int = 4) -> Iterator:
    """Run the upstream pipeline in a background thread with a bounded
    queue so host data preparation overlaps the device's steps."""
    import queue as queue_mod
    import threading

    q: "queue_mod.Queue" = queue_mod.Queue(maxsize=buffer_size)
    _END = object()

    def worker():
        try:
            for item in stream:
                q.put(item)
            q.put(_END)
        except BaseException as e:  # surface upstream errors in the consumer
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            break
        if isinstance(item, BaseException):
            raise item
        yield item


def resample(samples, resample_rate: int = 16000):
    for s in samples:
        wav, sr = resample_to(s["wav"], int(s["sample_rate"]), resample_rate)
        yield dict(s, wav=wav, sample_rate=sr)


def speed_perturb(samples, speeds=(0.9, 1.0, 1.1), rng: random.Random = None):
    """Random tempo change via polyphase resampling (the reference shells out
    to sox speed, `processor.py:316`)."""
    from scipy.signal import resample_poly

    rng = rng or random
    for s in samples:
        speed = rng.choice(speeds)
        if speed != 1.0:
            num = 100
            den = int(round(speed * 100))
            wav = resample_poly(s["wav"], num, den).astype(np.float32)
            s = dict(s, wav=wav)
        yield s


def filter_wordy(samples, stats: Optional[Dict] = None):
    """Reject implausibly wordy utterances by words-per-second bands
    (`rev_processor_ex.py:312-348`): dur<=1s: wps>5; <=2s: wps>8;
    <=5s: wps>6; else wps>5.  ``<sw>`` tags don't count as words."""
    stats = stats if stats is not None else {}
    for s in samples:
        dur = len(s["wav"]) / s["sample_rate"]
        nwds = len(s["txt"].replace("<sw> ", " ").split())
        wps = nwds / dur if dur > 0 else float("inf")
        if dur <= 1:
            reject, bucket = wps > 5, "reject_1"
        elif dur <= 2:
            reject, bucket = wps > 8, "reject_2"
        elif dur <= 5:
            reject, bucket = wps > 6, "reject_5"
        else:
            reject, bucket = wps > 5, "reject_9"
        if reject:
            stats[bucket] = stats.get(bucket, 0) + 1
            continue
        stats["ok"] = stats.get("ok", 0) + 1
        yield s


def exclude_keys(samples, exclude_fn: str, stats: Optional[Dict] = None):
    """Drop utterances whose key appears in the exclusion-list file
    (`rev_processor_ex.py:350-365`)."""
    stats = stats if stats is not None else {}
    with open(exclude_fn) as reader:
        to_exclude = {line.strip() for line in reader if line.strip()}
    for s in samples:
        if s["key"] in to_exclude:
            stats["excluded_by_key"] = stats.get("excluded_by_key", 0) + 1
            continue
        yield s


def merge_utterances(samples, config: Optional[Dict] = None,
                     epoch: int = 1):
    """Long-form training synthesis — reference-exact agglomeration
    (`rev_processor.py:295-392` generate_speaker_switch_utterances, wired
    as `merge_utterances`/`merge_utterances_conf` in `dataset.py:75-78`):
    an accumulating utterance absorbs its successor unless it is too short
    to compose (``min_audio_len_acceptable_secs``), already long enough
    (``min_audio_len_secs``), at the combine cap (``max_utt_combined``),
    or the merge would exceed ``max_audio_len_secs``; ``<sw>`` separates
    only speaker *changes* when ``add_sw_tag`` (speaker = key up to its
    last '-'), and ``enable_after_epoch`` gates the whole stage."""
    config = config or {}
    sampling_rate = 16000
    min_ok = config.get("min_audio_len_acceptable_secs", 1)
    min_len = config.get("min_audio_len_secs", 30)
    max_len = config.get("max_audio_len_secs", 40)
    max_utt = config.get("max_utt_combined", 7)
    add_sw = config.get("add_sw_tag", False)
    if config.get("enable_after_epoch", -1) >= epoch:
        yield from samples
        return

    def spk_of(key: str) -> str:
        return key[: key.rindex("-")] if "-" in key else key

    curr: Optional[Dict] = None
    curr_spk = None
    n = 0
    for s in samples:
        spk = spk_of(s["key"])
        if curr is None:
            curr, curr_spk, n = dict(s), spk, 1
            continue
        cw = len(curr["wav"])
        if (cw < sampling_rate * min_ok
                or cw > sampling_rate * min_len
                or n >= max_utt
                or cw + len(s["wav"]) > sampling_rate * max_len):
            yield curr
            curr, curr_spk, n = dict(s), spk, 1
            continue
        n += 1
        curr["wav"] = np.concatenate([curr["wav"], s["wav"]])
        sep = " " if (not add_sw) or (curr_spk == spk) else " <sw> "
        curr["txt"] = (curr["txt"] + sep + s["txt"]).replace(
            "<sw> <sw>", "<sw>")
        curr_spk = spk
    if curr is not None:
        yield curr


def tokenize(samples, tokenizer):
    for s in samples:
        tokens, ids = tokenizer.tokenize(s["txt"])
        yield dict(s, tokens=tokens, label=np.asarray(ids, np.int32))


class SpecialTokensHandler:
    """Reject / remove / relabel special tokens in transcripts
    (`rev_processor.py:161-229`).  Deviation from the reference: applied
    BEFORE tokenization so `label` reflects the cleaned text (the
    reference runs it after `tokenize`, leaving labels computed from the
    raw text — an upstream quirk, not a contract)."""

    def __init__(self, config: Dict[str, Any]):
        self.reject_set = set(config.get("reject_on", []))
        self.remove_set = set(config.get("remove", []))
        self.relabel_map = dict(config.get("relabel", []))
        self.remove_trailing_dash = config.get("remove_trailing_dash", False)
        self.stats: Dict[str, int] = {}

    def transform(self, sample: Optional[Dict]) -> Optional[Dict]:
        if sample is None or "txt" not in sample:
            return sample
        words = sample["txt"].split()
        new_words = []
        for w in words:
            if self.remove_trailing_dash and w.endswith("-"):
                w = w[:-1]
            if w in self.reject_set:
                self.stats[w] = self.stats.get(w, 0) + 1
                return None
            if w in self.remove_set:
                self.stats[w] = self.stats.get(w, 0) + 1
                continue
            if w in self.relabel_map:
                self.stats[w] = self.stats.get(w, 0) + 1
                new_words.append(self.relabel_map[w])
            else:
                new_words.append(w)
        if not new_words:
            return None
        out = dict(sample)
        out["otxt"] = sample["txt"]
        out["txt"] = " ".join(new_words)
        return out

    def __call__(self, samples: Iterable[Dict]) -> Iterator[Dict]:
        for s in samples:
            t = self.transform(s)
            if t is not None:
                yield t


def filter_long_yeah_okay(samples, too_long_duration: float = 1.5,
                          word_subset=None, stats: Optional[Dict] = None):
    """Drop single-word utterances longer than `too_long_duration` seconds
    (`rev_processor.py:549-596`; port of remove_long_yeah_okay_segments.pl).
    """
    if stats is None:
        stats = {}
    stats.setdefault("##total_utterances_filtered##", 0)
    stats.setdefault("##total_duration_filtered##", 0.0)
    subset = set(word_subset) if word_subset else None
    for s in samples:
        if "sample_rate" not in s or "wav" not in s or "txt" not in s:
            yield s
            continue
        dur = len(s["wav"]) / s["sample_rate"]
        words = s["txt"].split()
        if len(words) == 1 and dur >= too_long_duration and (
                subset is None or s["txt"] in subset):
            stats[s["txt"]] = stats.get(s["txt"], 0) + 1
            stats["##total_utterances_filtered##"] += 1
            stats["##total_duration_filtered##"] += dur
            continue
        yield s


def pass_one_hot(samples, emb_len: int = 1, field: str = "lang",
                 one_hot_ids: Optional[Dict[str, int]] = None,
                 multi_hot: bool = False, force_hot=None,
                 defaults_vals: Optional[Dict[str, str]] = None,
                 rng: random.Random = None):
    """Attach a normalized one/multi-hot category vector as
    sample['cat_emb'] (`rev_processor.py:116-159`) — consumed by the
    language-specific (LSL) encoder layers via the batch's `cat_embs`."""
    rng = rng or random
    defaults_vals = defaults_vals or {"lang": "en", "style": "nv"}
    one_hot_ids = one_hot_ids or {}
    for s in samples:
        onehot = np.zeros((emb_len,), np.float32)
        val = s.get(field)
        if val is None:
            val = s.get("tk_lang") if field == "lang" else None
        if val is None:
            val = defaults_vals.get(field, "")
        if isinstance(val, bytes):
            val = val.decode("utf8").strip()
        for f in str(val).split():
            if f in one_hot_ids:
                onehot[one_hot_ids[f]] = 1.0
        for f in force_hot or []:
            onehot[int(f)] = 1.0
        if multi_hot and rng.random() > 0.75:
            samp = rng.randint(0, emb_len)
            if samp == emb_len:
                onehot[:] = 1.0
            else:
                onehot[samp] = 1.0
        total = onehot.sum()
        if total > 0:
            onehot = onehot / total
        yield dict(s, cat_emb=onehot)


def parse_speaker(samples, speaker_dict: Dict[str, int]):
    """Map speaker names to ids (`processor.py:88-92`)."""
    for s in samples:
        if "speaker" in s:
            s = dict(s, speaker=speaker_dict.get(s["speaker"], 0))
        yield s


def detect_language(samples, limited_langs=("zh", "en"),
                    default: str = "en"):
    """`processor.py:95-106` uses the `langid` package (not in this
    image); gated: use it when importable, else a cheap script heuristic
    restricted to the same limited_langs set."""
    try:
        import langid as lid

        lid.set_languages(list(limited_langs))
        classify = lambda txt: lid.classify(txt)[0]
    except ImportError:
        def classify(txt):
            if "zh" in limited_langs and any(
                    "一" <= ch <= "鿿" for ch in txt):
                return "zh"
            return default if default in limited_langs \
                else list(limited_langs)[0]
    for s in samples:
        yield dict(s, lang=s.get("lang", classify(s.get("txt", ""))))


def detect_task(samples):
    """`processor.py:108-115`: hard-coded 'transcribe'."""
    for s in samples:
        yield dict(s, task=s.get("task", "transcribe"))


def get_rare_words(deep_bias_conf: Dict) -> set:
    """`processor.py:118-129`: alphabetic words at/below freq_threshold."""
    with open(deep_bias_conf["word_freqs"]) as f:
        word_freqs = json.load(f)
    thr = deep_bias_conf.get("freq_threshold", 20)
    return {w for w, freq in word_freqs.items()
            if w.isalpha() and freq <= thr}


def rare_utt_filter(samples, rare_words: set, deep_bias_conf: Dict,
                    rng: random.Random = None):
    """Deep-biasing data stage (`processor.py:132-178`): keep only
    utterances containing rare words; attach per-utt cv phrases (rare
    word + up to n_order-1 left-context words) and distractor phrases."""
    rng = rng or random
    p_keep = deep_bias_conf.get("p_keep", 1)
    n_order = deep_bias_conf.get("n_order", 3)
    rare_list = sorted(rare_words)
    for s in samples:
        txt_list = s.get("txt", "").split()
        cv_terms, dist_terms = [], []
        for word in txt_list:
            if word not in rare_words:
                continue
            word_index = txt_list.index(word)
            n = rng.choice(list(range(n_order)))
            if n >= len(txt_list):
                n = 1
            if n > word_index:
                cv_phrase = txt_list[: word_index + 1]
            else:
                cv_phrase = txt_list[word_index - n : word_index + 1]
            cv_terms.append(" ".join(cv_phrase))
            dist_phrase = rng.sample(txt_list, n)
            if word in dist_phrase:
                dist_phrase.remove(word)
            dist_phrase.append(rng.choice(rare_list))
            rng.shuffle(dist_phrase)
            dist_terms.append(" ".join(dist_phrase))
        if not cv_terms:
            continue
        out = dict(s)
        out["cv_list"] = cv_terms if rng.random() < p_keep else []
        out["cv_distractors"] = dist_terms
        yield out


def tokenize_cv_list(samples, tokenizer):
    """Tokenize biasing phrases (`processor.py:480-511`)."""
    for s in samples:
        if "cv_list" not in s:
            yield s
            continue
        out = dict(s)
        out["cv_tokens_list"], out["cv_label_list"] = [], []
        out["dist_tokens_list"], out["dist_label_list"] = [], []
        for word in s["cv_list"]:
            toks, label = tokenizer.tokenize(word)
            out["cv_tokens_list"].append(toks)
            out["cv_label_list"].append(label)
        for dist in s.get("cv_distractors", []):
            toks, label = tokenizer.tokenize(dist)
            out["dist_tokens_list"].append(toks)
            out["dist_label_list"].append(label)
        yield out


def compute_num_frames(num_samples: int, sample_rate: int = 16000,
                       frame_shift_ms: int = 10) -> int:
    return num_samples // (sample_rate * frame_shift_ms // 1000)


def filter_samples(samples, max_length: int = 10240, min_length: int = 10,
                   token_max_length: int = 200, token_min_length: int = 1,
                   min_output_input_ratio: float = 5e-4,
                   max_output_input_ratio: float = 1.0):
    """Length/token filters on fbank-frame counts (`processor.py:213-291`)."""
    stats = {"kept": 0, "dropped": 0}
    for s in samples:
        frames = compute_num_frames(len(s["wav"]), s["sample_rate"])
        toks = len(s["label"])
        ok = (
            min_length <= frames <= max_length
            and token_min_length <= toks <= token_max_length
            and frames > 0
            and min_output_input_ratio <= toks / max(frames, 1)
            <= max_output_input_ratio
        )
        if ok:
            stats["kept"] += 1
            yield s
        else:
            stats["dropped"] += 1
    log.info("filter: kept=%d dropped=%d", stats["kept"], stats["dropped"])


def shuffle(samples, buffer_size: int = 10000, rng: random.Random = None):
    rng = rng or random
    buf = []
    for s in samples:
        buf.append(s)
        if len(buf) >= buffer_size:
            rng.shuffle(buf)
            yield from buf
            buf = []
    rng.shuffle(buf)
    yield from buf


def sort_by_length(samples, sort_size: int = 500):
    """Buffered sort by duration (`datapipes.py:168`)."""
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


def dynamic_batch(samples, max_frames_in_batch: int = 12000,
                  max_words_in_batch: int = 0,
                  one_utt_per_job: bool = False):
    """Frame-budget batching (`processor.py:767-783` DynamicBatchWindow) with
    the optional word cap and one-utt-per-job dedup of the `distribute`
    batch type (`datapipes.py:207-331`)."""
    buf = []
    longest = 0
    words = 0
    jobs = set()
    for s in samples:
        frames = compute_num_frames(len(s["wav"]), s["sample_rate"])
        w = len(s.get("txt", "").split())
        longest_new = max(longest, frames)
        over_frames = longest_new * (len(buf) + 1) > max_frames_in_batch
        over_words = max_words_in_batch > 0 and \
            (words + w) > max_words_in_batch
        dup_job = one_utt_per_job and s.get("job") in jobs
        if buf and (over_frames or over_words or dup_job):
            yield buf
            buf, longest, words = [s], frames, w
            jobs = {s.get("job")}
        else:
            buf.append(s)
            longest = longest_new
            words += w
            jobs.add(s.get("job"))
    if buf:
        yield buf


def _job_id(key: str) -> Optional[str]:
    """`datapipes.py:241-245`: rev job id = first two dot-separated
    fields of the utterance key."""
    parts = key.split(".")
    if len(parts) >= 3:
        return parts[0] + "." + parts[1]
    return None


def distribute_batch(samples, max_frames_in_batch: int = 12000,
                     one_utt_per_job: bool = True,
                     max_words_per_epoch: int = -1,
                     max_words_per_batch: int = -1,
                     stats: Optional[Dict] = None):
    """The `batch_type: distribute` load balancer
    (`DistributeBatchDataPipe`, `datapipes.py:207-331`), exact semantics:

    * one utterance per rev job *per batch* (``_send_utt`` resets at each
      batch boundary);
    * per-WORD occurrence caps: an utterance is accepted iff ANY of its
      words is still under the cap; accepted utterances bump every word's
      count.  ``batch_words`` resets per batch, ``epoch_words`` persists
      for the whole pass;
    * violations DROP the utterance (the reference counts drop_utts /
      drop_frames; exposed here via ``stats``);
    * frame window = DynamicBatchWindow (`processor.py:767-783`).

    Deliberate deviation: the reference discards the element that trips
    the frame window (`datapipes.py:313-325` never re-appends it) — one
    lost utterance per batch boundary.  We start the next batch with it.
    """
    if stats is None:
        stats = {}
    stats.setdefault("drop_utts", 0)
    stats.setdefault("drop_frames", 0)
    buf: List[Dict] = []
    longest = 0
    send_utt = set()
    epoch_words: Dict[str, int] = {}
    batch_words: Dict[str, int] = {}
    for s in samples:
        frames = compute_num_frames(len(s["wav"]), s["sample_rate"])
        wds = s.get("txt", "").split(" ")
        job = _job_id(s.get("key", ""))
        if one_utt_per_job and job is not None and job in send_utt:
            stats["drop_utts"] += 1
            stats["drop_frames"] += frames
            continue
        if max_words_per_epoch > 0 and not any(
                epoch_words.get(w, 0) < max_words_per_epoch for w in wds):
            stats["drop_utts"] += 1
            stats["drop_frames"] += frames
            continue
        if max_words_per_batch > 0 and not any(
                batch_words.get(w, 0) < max_words_per_batch for w in wds):
            stats["drop_utts"] += 1
            stats["drop_frames"] += frames
            continue
        if one_utt_per_job and job is not None:
            send_utt.add(job)
        if max_words_per_epoch > 0:
            for w in wds:
                epoch_words[w] = epoch_words.get(w, 0) + 1
        if max_words_per_batch > 0:
            for w in wds:
                batch_words[w] = batch_words.get(w, 0) + 1
        longest_new = max(longest, frames)
        if buf and longest_new * (len(buf) + 1) > max_frames_in_batch:
            yield buf
            buf, longest = [s], frames
            batch_words = {}
            send_utt = {job} if (one_utt_per_job and job is not None) \
                else set()
            if max_words_per_batch > 0:
                for w in wds:
                    batch_words[w] = batch_words.get(w, 0) + 1
        else:
            buf.append(s)
            longest = longest_new
    if buf:
        yield buf


def bucket_pad_length(n: int, buckets: Optional[List[int]] = None,
                      quantum: int = 16000) -> int:
    """The padded length: the first bucket that holds n, else n rounded up
    to a multiple of ``quantum`` (at least one quantum), as in JAX, so the
    port's batches have JAX's shapes."""
    if buckets:
        for b in buckets:
            if n <= b:
                return b
        return buckets[-1]
    return max(quantum, ((n + quantum - 1) // quantum) * quantum)


def collate(batch: List[Dict], wav_quantum: int = 16000,
            label_quantum: int = 16) -> Dict[str, np.ndarray]:
    """Pad a list of samples into arrays (sorted desc by length like
    `processor.py:684-764`)."""
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
    out = {
        "keys": [s["key"] for s in batch],
        "txts": [s.get("txt", "") for s in batch],
        "wavs": wavs, "wav_lens": wav_lens,
        "labels": labels, "label_lens": label_lens,
    }
    if all("cat_emb" in s for s in batch):
        out["cat_embs"] = np.stack([s["cat_emb"] for s in batch])
    return out


# ---------------------------------------------------------------- assembly

def build_dataset(
    data_type: str,
    list_file: str,
    tokenizer,
    conf: Dict[str, Any],
    partition: bool = True,
    mode: str = "train",
    rank: int = 0,
    world_size: int = 1,
    seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Assemble the processor chain per config (order follows
    `dataset/dataset.py:28-228`).  Yields collated numpy batches."""
    rng = random.Random(seed)
    if data_type == "raw":
        stream = shard_by_rank(raw_source(list_file), rank, world_size,
                               partition)
    elif data_type == "shard":
        shards = shard_by_rank(shard_list_source(list_file), rank,
                               world_size, partition)
        stream = tar_shard_source(shards)
    elif data_type == "zip_shard":
        shards = shard_by_rank(shard_list_source(list_file), rank,
                               world_size, partition)
        stream = zip_shard_source(shards)
    else:
        raise ValueError(f"unknown data_type {data_type!r}")

    stream = decode_wav(stream, num_workers=conf.get("num_workers", 0))
    mu_on = conf.get("merge_utterances", False)
    mu_conf = dict(conf.get("merge_utterances_conf", {}))
    if isinstance(mu_on, dict):   # legacy round-1 schema
        mu_conf.setdefault("min_audio_len_secs", mu_on.get("min_sec", 30))
        mu_conf.setdefault("max_audio_len_secs", mu_on.get("max_sec", 40))
        mu_conf.setdefault("add_sw_tag", mu_on.get("add_sw_token", False))
        mu_on = mu_on.get("enabled", False)
    if mu_on:
        stream = merge_utterances(stream, mu_conf)
    if "speaker_conf" in conf:
        from paper_accurate_fast_cheap_tpu_torch.text.tokenizers import (
            read_symbol_table)

        stable = read_symbol_table(
            conf["speaker_conf"]["speaker_table_path"])
        stream = parse_speaker(stream, stable)
    if conf.get("deep_bias_conf", {}).get("deep_biasing", False):
        db = conf["deep_bias_conf"]
        rare = get_rare_words(db)
        stream = rare_utt_filter(stream, rare, db, rng=rng)
        stream = tokenize_cv_list(stream, tokenizer)
    if "language_conf" in conf:
        stream = detect_language(
            stream, conf["language_conf"].get("limited_langs",
                                              ("zh", "en")))
        stream = detect_task(stream)
    if conf.get("handle_special_token", False) and mode == "train":
        stream = SpecialTokensHandler(
            conf.get("handle_special_token_conf", {}))(stream)
    if conf.get("filter_long_yeah_okay", False):
        fc = conf.get("filter_long_yeah_okay_conf", {})
        stream = filter_long_yeah_okay(
            stream, fc.get("too_long_duration", 1.5),
            fc.get("word_subset"))
    if conf.get("filter_wordy", False):
        stream = filter_wordy(stream)
    if conf.get("exclude_keys_fn"):
        stream = exclude_keys(stream, conf["exclude_keys_fn"])
    if "resample_conf" in conf:
        stream = resample(stream,
                          conf["resample_conf"].get("resample_rate", 16000))
    if mode == "train" and conf.get("speed_perturb", False):
        stream = speed_perturb(stream, rng=rng)
    stream = tokenize(stream, tokenizer)
    stream = filter_samples(stream, **conf.get("filter_conf", {}))
    if conf.get("pass_cat_emb", False) or conf.get("add_cat_emb", False):
        stream = pass_one_hot(stream, rng=rng,
                              **conf.get("cat_emb_conf", {}))
    if mode == "train" and conf.get("shuffle", True):
        stream = shuffle(
            stream, conf.get("shuffle_conf", {}).get("shuffle_size", 10000),
            rng,
        )
    if conf.get("sort", True):
        stream = sort_by_length(
            stream, conf.get("sort_conf", {}).get("sort_size", 500)
        )
    bc = conf.get("batch_conf", {})
    btype = bc.get("batch_type", "static")
    if btype == "static":
        batches = static_batch(stream, bc.get("batch_size", 16))
    elif btype == "distribute":
        batches = distribute_batch(
            stream, bc.get("max_frames_in_batch", 12000),
            one_utt_per_job=bc.get("one_utt_per_job", True),
            max_words_per_epoch=bc.get("max_words_per_epoch", -1),
            max_words_per_batch=bc.get("max_words_per_batch", -1))
    elif btype == "dynamic":
        batches = dynamic_batch(
            stream, bc.get("max_frames_in_batch", 12000),
            bc.get("max_words_in_batch", 0))
    else:
        raise ValueError(f"unknown batch_type {btype!r}")
    gen = (collate(b) for b in batches)
    if conf.get("prefetch", True):
        gen = prefetch(
            gen, conf.get("prefetch_conf", {}).get("buffer_size", 4))
    yield from gen
