"""Small data-prep utilities in one CLI (port of the JAX
``bin/data_tools.py``; host only, on the port's own readers).

Parity targets: `tools/make_raw_list.py`, `tools/wav2dur.py`,
`tools/segment.py`, `tools/wavscp2cmds.py`, `tools/analyze_dataset.py`,
`local/segments_to_files.py`, `local/extract_meta.py`,
`tools/validate_data_dir.sh`.

Usage: python -m paper_accurate_fast_cheap_tpu_torch.bin.data_tools <cmd> ...
  (make_raw_list, wav2dur, analyze, segments_to_files, segment_scp,
  gigaspeech_meta, validate)
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def make_raw_list(args):
    """wav.scp + text (+ optional segments) -> jsonl raw list."""
    wavs = dict(
        line.strip().split(maxsplit=1)
        for line in open(args.wav_scp, encoding="utf-8") if line.strip()
    )
    texts = dict(
        line.strip().split(maxsplit=1) if len(line.strip().split()) > 1
        else (line.strip(), "")
        for line in open(args.text, encoding="utf-8") if line.strip()
    )
    out = open(args.output, "w", encoding="utf-8")
    if args.segments:
        for line in open(args.segments, encoding="utf-8"):
            utt, wav_key, start, end = line.strip().split()
            if wav_key in wavs and utt in texts:
                out.write(json.dumps({
                    "key": utt, "wav": wavs[wav_key], "txt": texts[utt],
                    "start": float(start), "end": float(end),
                }) + "\n")
    else:
        for key, path in wavs.items():
            if key in texts:
                out.write(json.dumps({"key": key, "wav": path,
                                      "txt": texts[key]}) + "\n")
    out.close()
    return 0


def wav2dur(args):
    """Print 'key duration_seconds' for a wav.scp."""
    from paper_accurate_fast_cheap_tpu_torch.data.audio import read_wav_bytes

    total = 0.0
    for line in open(args.wav_scp, encoding="utf-8"):
        parts = line.strip().split(maxsplit=1)
        if len(parts) != 2:
            continue
        key, path = parts
        with open(path, "rb") as f:
            wav, sr = read_wav_bytes(f.read())
        dur = len(wav) / sr
        total += dur
        print(f"{key} {dur:.3f}")
    print(f"# total_hours {total/3600:.3f}", file=sys.stderr)
    return 0


def analyze(args):
    """Dataset statistics: durations, token counts, ratios."""
    from paper_accurate_fast_cheap_tpu_torch.data import pipeline as dp

    if args.data_type == "raw":
        stream = dp.decode_wav(dp.raw_source(args.data))
    else:
        stream = dp.decode_wav(
            dp.tar_shard_source(dp.shard_list_source(args.data)))
    durs, toks = [], []
    for s in stream:
        durs.append(len(s["wav"]) / s["sample_rate"])
        toks.append(len(s.get("txt", "").split()))
    durs, toks = np.asarray(durs), np.asarray(toks)
    if len(durs) == 0:
        print("no utterances found")
        return 1
    print(f"utts {len(durs)}  hours {durs.sum()/3600:.2f}")
    for name, arr in (("duration_s", durs), ("words", toks)):
        print(f"{name}: mean {arr.mean():.2f} p50 {np.percentile(arr,50):.2f} "
              f"p95 {np.percentile(arr,95):.2f} max {arr.max():.2f}")
    return 0


def segments_to_files(args):
    """Merge per-segment transcriptions into one text file per source
    recording for long-form scoring (`local/segments_to_files.py`: file id
    = utt id up to its last '_'; reads 'utt text...' lines from stdin or
    --input, writes <out_dir>/<file_id>.txt).  The reference script's
    stale-handle bug (writing before opening) is not reproduced."""
    import os

    src = open(args.input, encoding="utf8") if args.input else sys.stdin
    files: dict = {}
    for line in src:
        parts = line.split()
        if not parts:
            continue
        utt_id = parts[0]
        file_id = "_".join(utt_id.split("_")[:-1]) or utt_id
        files[file_id] = files.get(file_id, "") + " ".join(parts[1:]) + " "
    if args.input:
        src.close()
    os.makedirs(args.out_dir, exist_ok=True)
    ext = args.ext if args.ext.startswith(".") else "." + args.ext
    for file_id, text in files.items():
        with open(os.path.join(args.out_dir, file_id + ext), "w",
                  encoding="utf8") as f:
            f.write(text)
    print(f"wrote {len(files)} files to {args.out_dir}", file=sys.stderr)
    return 0


def segment_scp(args):
    """Produce a segmented wav.scp: 'utt path,start,end'
    (`tools/segment.py:25-36`)."""
    wav_dic = {}
    with open(args.input, encoding="utf8") as ori:
        for line in ori:
            item = line.strip().split()
            if item:
                wav_dic[item[0]] = item[1]
    n = 0
    with open(args.output, "w", encoding="utf8") as f, \
            open(args.segments, encoding="utf8") as seg:
        for line in seg:
            item = line.strip().split()
            if item and item[1] in wav_dic:
                f.write(f"{item[0]} {wav_dic[item[1]]},{item[2]},"
                        f"{item[3]}\n")
                n += 1
    print(f"wrote {n} segmented entries", file=sys.stderr)
    return 0


def gigaspeech_meta(args):
    """GigaSpeech.json -> kaldi-style metadata files (text, segments,
    utt2dur, wav.scp, utt2subsets, reco2dur)
    (`local/extract_meta.py:24-86`)."""
    import json
    import os

    input_dir = os.path.dirname(os.path.abspath(args.input_json))
    os.makedirs(args.output_dir, exist_ok=True)
    with open(args.input_json, encoding="utf8") as injson:
        json_data = json.load(injson)
    out = {name: open(os.path.join(args.output_dir, name), "w",
                      encoding="utf8")
           for name in ("text", "segments", "utt2dur", "wav.scp",
                        "utt2subsets", "reco2dur")}
    try:
        for audio in json_data.get("audios") or []:
            aid = audio.get("aid", "?")
            path = os.path.realpath(
                os.path.join(input_dir, audio.get("path", "")))
            if not os.path.exists(path) or \
                    audio.get("sample_rate") != 16000:
                print(f"Warning: {aid} missing file or bad rate, skipped",
                      file=sys.stderr)
                continue
            out["wav.scp"].write(f"{aid}\t{path}\n")
            out["reco2dur"].write(f"{aid}\t{audio['duration']}\n")
            for seg in audio.get("segments", []):
                sid = seg["sid"]
                start, end = seg["begin_time"], seg["end_time"]
                out["text"].write(f"{sid}\t{seg['text_tn']}\n")
                out["segments"].write(f"{sid}\t{aid}\t{start}\t{end}\n")
                out["utt2dur"].write(f"{sid}\t{end - start}\n")
                out["utt2subsets"].write(
                    f"{sid}\t{' '.join(seg.get('subsets', []))}\n")
    finally:
        for f in out.values():
            f.close()
    return 0


def validate(args):
    """Data-dir / raw-list sanity validation (the reference's
    `tools/validate_data_dir.sh` / `validate_text.pl` role).

    Kaldi-dir mode (--dir): wav.scp/text[/segments] key consistency,
    duplicate keys, empty transcripts, missing/unreadable audio.
    Raw-list mode (--data): per-line JSON with key/wav/txt, same checks.
    Exit 1 on any error; prints a summary either way.
    """
    import os

    errors, warns = [], []

    def check_audio(path, key):
        if not os.path.exists(path):
            errors.append(f"{key}: missing audio {path}")
            return
        try:
            with open(path, "rb") as f:
                head = f.read(4)
            if head not in (b"RIFF", b"fLaC"):
                warns.append(f"{key}: unknown audio magic {head!r} ({path})")
        except OSError as e:
            errors.append(f"{key}: unreadable audio {path}: {e}")

    n = 0
    if args.dir:
        def read_kv(name, required=True):
            path = os.path.join(args.dir, name)
            if not os.path.exists(path):
                if required:
                    errors.append(f"missing {name}")
                return {}
            out = {}
            for i, line in enumerate(open(path, encoding="utf-8")):
                parts = line.rstrip("\n").split(None, 1)
                if not parts:
                    continue
                k = parts[0]
                v = parts[1] if len(parts) > 1 else ""
                if k in out:
                    errors.append(f"{name}:{i + 1}: duplicate key {k}")
                out[k] = v
            return out

        wav = read_kv("wav.scp")
        text = read_kv("text")
        segs = read_kv("segments", required=False)
        n = len(text)
        utt_audio = {}
        if segs:
            for sid, v in segs.items():
                f = v.split()
                if len(f) != 3:
                    errors.append(f"segments: bad line for {sid}")
                    continue
                aid, st, en = f[0], float(f[1]), float(f[2])
                if aid not in wav:
                    errors.append(f"segments: {sid} references missing "
                                  f"recording {aid}")
                if en <= st:
                    errors.append(f"segments: {sid} non-positive duration")
                utt_audio[sid] = wav.get(aid)
        else:
            utt_audio = dict(wav)
        for k, t in text.items():
            if not t.strip():
                warns.append(f"text: empty transcript for {k}")
            if k not in utt_audio:
                errors.append(f"text: {k} has no audio entry")
        for k in utt_audio:
            if k not in text:
                warns.append(f"audio: {k} has no transcript")
        if args.check_audio:
            for k, path in utt_audio.items():
                if path and " " not in path:
                    check_audio(path, k)
    elif args.data:
        seen = set()
        for i, line in enumerate(open(args.data, encoding="utf-8")):
            line = line.strip()
            if not line:
                continue
            n += 1
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                errors.append(f"line {i + 1}: bad json: {e}")
                continue
            for field in ("key", "wav", "txt"):
                if field not in obj:
                    errors.append(f"line {i + 1}: missing '{field}'")
            k = obj.get("key")
            if k in seen:
                errors.append(f"line {i + 1}: duplicate key {k}")
            seen.add(k)
            if not str(obj.get("txt", "")).strip():
                warns.append(f"{k}: empty transcript")
            if args.check_audio and obj.get("wav"):
                check_audio(obj["wav"], k)
    else:
        raise SystemExit("validate: pass --dir or --data")

    for w in warns[:20]:
        print(f"WARNING: {w}")
    for e in errors[:50]:
        print(f"ERROR: {e}")
    print(f"validate: {n} utterances, {len(errors)} errors, "
          f"{len(warns)} warnings")
    return 1 if errors else 0


def main(argv=None):
    p = argparse.ArgumentParser(description="data utilities")
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("make_raw_list")
    r.add_argument("--wav_scp", required=True)
    r.add_argument("--text", required=True)
    r.add_argument("--segments", default=None)
    r.add_argument("--output", required=True)
    d = sub.add_parser("wav2dur")
    d.add_argument("--wav_scp", required=True)
    a = sub.add_parser("analyze")
    a.add_argument("--data", required=True)
    a.add_argument("--data_type", default="shard",
                   choices=["raw", "shard"])
    s = sub.add_parser("segments_to_files")
    s.add_argument("--input", default=None,
                   help="'utt text...' lines (default: stdin)")
    s.add_argument("--out_dir", required=True)
    s.add_argument("--ext", default=".ref_txt")
    g = sub.add_parser("segment_scp")
    g.add_argument("--segments", required=True)
    g.add_argument("--input", required=True, help="unsegmented wav.scp")
    g.add_argument("--output", required=True)
    m = sub.add_parser("gigaspeech_meta")
    m.add_argument("--input_json", required=True)
    m.add_argument("--output_dir", required=True)
    v = sub.add_parser("validate")
    v.add_argument("--dir", default=None,
                   help="kaldi-style data dir (wav.scp/text[/segments])")
    v.add_argument("--data", default=None, help="raw jsonl list")
    v.add_argument("--check_audio", action="store_true",
                   help="also stat + sniff every audio file")
    args = p.parse_args(argv)
    return {"make_raw_list": make_raw_list, "wav2dur": wav2dur,
            "analyze": analyze, "segments_to_files": segments_to_files,
            "segment_scp": segment_scp,
            "gigaspeech_meta": gigaspeech_meta,
            "validate": validate}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
