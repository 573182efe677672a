"""Accuracy loop: train -> checkpoint -> recognize_wav -> WER (port of the
recipe's ``local/run_accuracy_loop.py``).

The reference's QA is empirical (SURVEY.md §4): a model is trusted when
the train->decode->score pipeline (`run-pipeline-v3.sh` +
`go-SF-dev-one-model-paper.sh:10-41` / `go-LF-dev-one-model-paper.sh`)
shows WER moving.  With no GigaSpeech data or released checkpoint at hand,
this builds the strongest available substitute: a LEARNABLE synthetic task
decoded through the port's own CLIs, asserting that WER falls from init.

Task: 8 "words" a..h, each a distinct pure-tone burst (300..2050 Hz,
250 ms + 50 ms gap) -- fbank separates them trivially, so a small model
learns the mapping in about a hundred steps.  The pipeline is the real one
end to end:

  make_shard -> compute_cmvn_stats -> [init ckpt] recognize_wav +
  compute_wer -> bin/train (N epochs) -> recognize_wav + compute_wer ->
  assert WER(trained) < WER(init), and by default WER <= --target_wer
  (0.1).

Decode is ``rnnt_beam_search`` (beam 8) through ``bin/recognize_wav`` --
the LF product path (20 s windows -> encoder -> device beam).  The CLIs
run in this process on ``--device`` (``cuda`` unless ``cpu`` is asked
for).  Prints one JSON summary line; returns 1 unless WER improved and
reached the target.

Two defaults differ from the JAX driver's, each from a measurement (the
port's CPU and H100 runs agree; PERF.md §6):

- ``--merge_secs 20`` (JAX: 0), with ``--train_utts 384 --batch_size 8
  --epochs 20`` (on the H100 WER 0.065 after 14 epochs, 0.01-0.025 after
  20): trained on 1.5-3 s utterances only, the transducer drops
  words in 20 s windows (WER 0.55 transducer-only, 0.04 in 3 s windows);
  trained on ~20 s merged utterances it drops none.
- ``--ctc_weight 0.1 --transducer_weight 0.9`` (the paper's: 0.3 / 0.7):
  the device beam fuses the CTC head's frame posteriors into each frame's
  scores, not a CTC prefix score, and a stationary tone holds its CTC
  label over all of its frames, so at 0.3 every word comes out twice
  (WER 0.92-0.97, all insertions, in short and long windows alike; CTC
  greedy decodes the same model at 0.0).

Usage:
  python -m paper_accurate_fast_cheap_tpu_torch.examples.gigaspeech.local.run_accuracy_loop \\
      --out acc_loop [--epochs 20] [--device cpu]
"""
import argparse
import json
import os
import sys
import time
import wave

import numpy as np

from paper_accurate_fast_cheap_tpu_torch.examples.gigaspeech.local import (
    run_cli)

WORDS = "abcdefgh"
SR = 16000


def word_wave(i, rng, sr=SR):
    """250 ms tone burst for word i + 50 ms silence, mild noise/jitter."""
    f = 300.0 + 250.0 * i
    n = int(0.25 * sr)
    t = np.arange(n) / sr
    x = 0.35 * np.sin(2 * np.pi * f * t * (1.0 + rng.uniform(-.01, .01)))
    # 10 ms fade in/out so window edges don't ring
    r = int(0.01 * sr)
    env = np.ones(n)
    env[:r] = np.linspace(0, 1, r)
    env[-r:] = np.linspace(1, 0, r)
    x = x * env + rng.standard_normal(n) * 0.01
    return np.concatenate([x, np.zeros(int(0.05 * sr))])


def write_wav(path, x, sr=SR):
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype(np.int16)
                      .tobytes())


def synth_split(out, n_utts, min_w, max_w, seed):
    rng = np.random.default_rng(seed)
    os.makedirs(out, exist_ok=True)
    scp, txt = [], []
    for u in range(n_utts):
        k = int(rng.integers(min_w, max_w + 1))
        ws = rng.integers(0, len(WORDS), size=k)
        x = np.concatenate([word_wave(int(i), rng) for i in ws])
        key = f"utt{u:04d}"
        p = os.path.join(out, key + ".wav")
        write_wav(p, x)
        scp.append(f"{key} {p}\n")
        txt.append(f"{key} {' '.join(WORDS[i] for i in ws)}\n")
    with open(os.path.join(out, "wav.scp"), "w") as f:
        f.writelines(scp)
    with open(os.path.join(out, "text"), "w") as f:
        f.writelines(txt)


def synth_longform(out, n_files, n_words, seed):
    """Long word streams for the recognize_wav LF path (one ref per file,
    the `.ref_txt` convention of `segments_to_files.py`)."""
    rng = np.random.default_rng(seed)
    os.makedirs(out, exist_ok=True)
    names = []
    for u in range(n_files):
        ws = rng.integers(0, len(WORDS), size=n_words)
        x = np.concatenate([word_wave(int(i), rng) for i in ws])
        name = f"ep{u}"
        write_wav(os.path.join(out, name + ".wav"), x)
        with open(os.path.join(out, name + ".ref_txt"), "w") as f:
            f.write(" ".join(WORDS[i] for i in ws) + "\n")
        names.append(name)
    return names


def wer_of(ref_file, hyp_file):
    from paper_accurate_fast_cheap_tpu_torch.tools.wer import (
        compute_wer, read_trn)

    total, _ = compute_wer(read_trn(ref_file), read_trn(hyp_file))
    return total.wer


def decode_and_score(tag, out_root, lf_dir, names, cfg, ckpt, args):
    out = os.path.join(out_root, f"decode_{tag}")
    if os.path.exists(os.path.join(out, "hyp.text")):
        # reuse a previous run's decode (e.g. the init point when only
        # --epochs changed) -- delete the decode_<tag> dir to force
        w = wer_of(os.path.join(out, "ref.text"),
                   os.path.join(out, "hyp.text"))
        print(f"# [{tag}] WER={w:.4f} (reused {out})", file=sys.stderr)
        return w, 0.0
    os.makedirs(out, exist_ok=True)
    t0 = time.time()
    for name in names:
        run_cli("recognize_wav", [
            "--config", cfg, "--checkpoint", ckpt,
            "--wav", os.path.join(lf_dir, name + ".wav"),
            "--output_dir", out, "--mode", "rnnt_beam_search",
            "--chunk_size", args.chunk_size,
            "--batch_size", args.decode_batch,
            "--beam_size", 8, "--ctc_weight", args.ctc_weight,
            "--transducer_weight", args.transducer_weight,
            "--device", args.device])
    dt = time.time() - t0
    ref = os.path.join(out, "ref.text")
    hyp = os.path.join(out, "hyp.text")
    with open(ref, "w") as fr, open(hyp, "w") as fh:
        for name in names:
            with open(os.path.join(lf_dir, name + ".ref_txt")) as f:
                fr.write(name + " " + f.read().strip() + "\n")
            path = os.path.join(out, name + ".txt")
            h = open(path).read().strip() if os.path.exists(path) else ""
            fh.write(name + " " + h + "\n")
    w = wer_of(ref, hyp)
    print(f"# [{tag}] WER={w:.4f} decode_s={dt:.1f}", file=sys.stderr)
    return w, dt


def loop_config(args, units, cmvn, sos):
    """The flagship's structure (bi-RWKV conformer, LSTM predictor,
    CTC + transducer) at toy scale."""
    return {
        "encoder": "conformer",
        "encoder_conf": {
            "output_size": args.dim, "attention_heads": 2,
            "linear_units": 4 * args.dim, "num_blocks": args.blocks,
            "dropout_rate": 0.1, "input_layer": "conv2d",
            "selfattention_layer_type": "rwkv_tmix60_bidirectional",
        },
        "tokenizer": "whitespace",
        "tokenizer_conf": {"symbol_table_path": units,
                           "special_tokens": {"<sos>": sos,
                                              "<eos>": sos}},
        "model": "transducer",
        "predictor": "rnn",
        "predictor_conf": {"embed_size": args.dim,
                           "output_size": args.dim,
                           "embed_dropout": 0.1,
                           "hidden_size": args.dim, "num_layers": 1,
                           "dropout": 0.1},
        "joint_conf": {"join_dim": args.dim},
        "decoder": None,
        "model_conf": {"ctc_weight": 0.3, "transducer_weight": 0.7,
                       "attention_weight": 0.0},
        "cmvn": "global_cmvn",
        "cmvn_conf": {"cmvn_file": cmvn, "is_json_cmvn": True},
        "dataset_conf": {
            "fbank_conf": {"num_mel_bins": 80, "dither": 0.0},
            "filter_conf": {"max_length": 4000, "min_length": 1},
            "batch_conf": {"batch_type": "static",
                           "batch_size": args.batch_size},
            "shuffle": True, "shuffle_conf": {"shuffle_size": 256},
            **({"merge_utterances": True,
                "merge_utterances_conf": {
                    "min_audio_len_acceptable_secs": 1,
                    "min_audio_len_secs": args.merge_secs,
                    "max_audio_len_secs": args.merge_secs + 7,
                    "max_utt_combined": 12,
                }} if args.merge_secs > 0 else {}),
        },
        "grad_clip": 5.0, "optim": "adamw",
        "optim_conf": {"lr": args.lr, "weight_decay": 1e-6},
        "scheduler": "warmuplr", "scheduler_conf": {"warmup_steps": 50},
        "max_epoch": args.epochs, "log_interval": 10,
    }


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--train_utts", type=int, default=384)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--merge_secs", type=int, default=20,
                   help="merge_utterances long-form synthesis target "
                        "(secs; 0 = off): match the training length to "
                        "the decode window")
    p.add_argument("--lf_files", type=int, default=2)
    p.add_argument("--lf_words", type=int, default=100)
    p.add_argument("--chunk_size", type=int, default=2000)
    p.add_argument("--decode_batch", type=int, default=4)
    p.add_argument("--blocks", type=int, default=2)
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--ctc_weight", type=float, default=0.1,
                   help="the device beam's CTC frame-posterior weight")
    p.add_argument("--transducer_weight", type=float, default=0.9)
    p.add_argument("--seed", type=int, default=0,
                   help="the init checkpoint's weights")
    p.add_argument("--target_wer", type=float, default=0.1,
                   help="trained-model WER the loop must reach "
                        "(<=0 disables the threshold assert)")
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    os.makedirs(args.out, exist_ok=True)

    # ---- data ----
    train_dir = os.path.join(args.out, "train")
    if not os.path.exists(os.path.join(train_dir, "text")):
        synth_split(train_dir, args.train_utts, 5, 10, seed=11)
    lf_dir = os.path.join(args.out, "longform")
    names = synth_longform(lf_dir, args.lf_files, args.lf_words, seed=21)

    t0 = time.time()
    run_cli("make_shard", [
        "--wav_scp", os.path.join(train_dir, "wav.scp"),
        "--text", os.path.join(train_dir, "text"),
        "--output_dir", os.path.join(train_dir, "shards"),
        "--num_utts_per_shard", 32])
    shards = os.path.join(train_dir, "shards", "shards.txt")
    cmvn = os.path.join(args.out, "global_cmvn")
    run_cli("compute_cmvn_stats", [
        "--data", shards, "--data_type", "shard",
        "--num_mel_bins", 80, "--out_cmvn", cmvn, "--device", args.device])
    prep_s = time.time() - t0

    # ---- config: flagship structure at toy scale ----
    units = os.path.join(args.out, "units.txt")
    with open(units, "w") as f:
        f.write("<blank> 0\n<unk> 1\n")
        for i, w in enumerate(WORDS):
            f.write(f"{w} {i + 2}\n")
        f.write(f"<sos> {len(WORDS) + 2}\n")
    sos = len(WORDS) + 2
    config = loop_config(args, units, cmvn, sos)
    import torch
    import yaml

    cfg = os.path.join(args.out, "config.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump(config, f)

    # ---- init checkpoint (the WER-from-init reference point) ----
    from paper_accurate_fast_cheap_tpu_torch import resolve_device
    from paper_accurate_fast_cheap_tpu_torch.models import factory
    from paper_accurate_fast_cheap_tpu_torch.train import checkpointing

    model, _ = factory.init_model(
        dict(config), sos + 1, 80, device=resolve_device(args.device),
        generator=torch.Generator().manual_seed(args.seed))
    init_ckpt = checkpointing.save_checkpoint(
        os.path.join(args.out, "ckpt_init"), model.state_dict(),
        info={"note": "accuracy-loop init"})
    del model
    exp = os.path.join(args.out, "exp")

    # ---- decode at init ----
    wer_init, dt_init = decode_and_score(
        "init", args.out, lf_dir, names, cfg, init_ckpt, args)

    # ---- train ----
    t0 = time.time()
    run_cli("train", [
        "--config", cfg, "--train_data", shards, "--data_type", "shard",
        "--model_dir", exp, "--checkpoint", init_ckpt,
        "--num_epochs", args.epochs, "--device", args.device])
    train_s = time.time() - t0
    # the newest epoch checkpoint
    ckpts = sorted(d for d in os.listdir(exp) if d.startswith("epoch_")
                   and d.endswith(".pt") and not d.endswith(".opt.pt"))
    assert ckpts, os.listdir(exp)
    trained = os.path.join(exp, ckpts[-1])

    # ---- decode trained ----
    wer_trained, dt_tr = decode_and_score(
        "trained", args.out, lf_dir, names, cfg, trained, args)

    ok = wer_trained < wer_init
    reached = args.target_wer <= 0 or wer_trained <= args.target_wer
    print(json.dumps({
        "metric": "accuracy_loop_wer",
        "wer_init": round(wer_init, 4),
        "wer_trained": round(wer_trained, 4),
        "improved": bool(ok), "reached_target": bool(reached),
        "target_wer": args.target_wer,
        "prep_s": round(prep_s, 1),
        "train_s": round(train_s, 1),
        "decode_s": [round(dt_init, 1), round(dt_tr, 1)],
        "epochs": args.epochs, "train_utts": args.train_utts,
        "checkpoint": trained,
        "device": args.device,
        "mode": f"rnnt_beam_search beam8 ctc{args.ctc_weight:g}/"
                f"tw{args.transducer_weight:g} via recognize_wav",
        "merge_secs": args.merge_secs,
    }))
    return 0 if ok and reached else 1


if __name__ == "__main__":
    sys.exit(main())
