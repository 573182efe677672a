"""Make the long-form bench fixture: config, checkpoint and episode WAVs
(port of the recipe's ``local/make_lf_fixture.py``).

The reference's LF protocol decodes real GigaSpeech episodes with a
trained model (`go-LF-dev-one-model-paper.sh:90-124`); for RTF (not WER)
measurement all that matters is the compute shape, so this builds:

  <out>/config.yaml    the flagship conformer12x512-rwkv6-bi transducer with
                       a self-contained char tokenizer + identity CMVN
  <out>/ckpt.pt        seeded random weights (the port's state_dict) with
                       blank-dominant output heads (joint/ctc blank bias
                       +2.5 -> ~3-5 emitted tokens/s, speech-realistic;
                       random init degenerates to ~25/s)
  <out>/episode.wav    60 min of speech-band noise, 16 kHz mono PCM16
  <out>/episode3h.wav  180 min (other lengths: episode<N>m.wav)

The weights are made on ``--device`` (``cuda`` unless ``cpu`` is asked
for) from ``--seed``.

Usage:
  python -m paper_accurate_fast_cheap_tpu_torch.examples.gigaspeech.local.make_lf_fixture \\
      --out lf --minutes 60,180 [--device cpu]
"""
import argparse
import json
import os
import sys
import wave

import numpy as np

from paper_accurate_fast_cheap_tpu_torch.examples.gigaspeech.local import (
    CONF_DIR)


def synth_wav(path, seconds, seed, sr=16000):
    """Speech-band (100-4000 Hz) noise with a slow amplitude envelope --
    enough spectral structure that fbank features are non-degenerate."""
    from scipy.signal import butter, sosfilt

    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    chunks = []
    sos = butter(4, [100, 4000], btype="band", fs=sr, output="sos")
    for i in range(0, n, 60 * sr):  # bound peak memory
        m = min(60 * sr, n - i)
        x = sosfilt(sos, rng.standard_normal(m).astype(np.float32))
        t = np.arange(m, dtype=np.float32) / sr
        env = 0.55 + 0.45 * np.sin(2 * np.pi * 0.31 * (t + i / sr))
        chunks.append((x * env).astype(np.float32))
    x = np.concatenate(chunks)
    x = x / (np.abs(x).max() + 1e-9) * 0.5
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((x * 32767).astype(np.int16).tobytes())


def episode_name(minutes: float) -> str:
    return {60: "episode.wav", 180: "episode3h.wav"}.get(
        minutes, f"episode{minutes:g}m.wav")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--vocab", type=int, default=5002)
    p.add_argument("--minutes", default="60,180",
                   help="episode lengths to synthesize")
    p.add_argument("--config", default=os.path.join(
        CONF_DIR, "rwkvbi_ds4k31nc_12le_trans_shortform.yaml"))
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    import torch
    import yaml

    from paper_accurate_fast_cheap_tpu_torch import resolve_device
    from paper_accurate_fast_cheap_tpu_torch.models import factory
    from paper_accurate_fast_cheap_tpu_torch.train import checkpointing
    from paper_accurate_fast_cheap_tpu_torch.utils.config import load_config

    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)

    # self-contained char tokenizer at the flagship's vocab size
    units = os.path.join(args.out, "units.txt")
    with open(units, "w") as f:
        f.write("<blank> 0\n<unk> 1\n<sos/eos> 2\n")
        for i in range(3, args.vocab):
            f.write(f"tok{i} {i}\n")

    cmvn = os.path.join(args.out, "global_cmvn")
    with open(cmvn, "w") as f:
        json.dump({"mean_stat": [0.0] * 80,
                   "var_stat": [100.0] * 80, "frame_num": 100}, f)

    config = load_config(args.config)
    config["tokenizer"] = "char"
    config["tokenizer_conf"] = {"symbol_table_path": units}
    config["cmvn_conf"] = {"cmvn_file": cmvn, "is_json_cmvn": True}
    with open(os.path.join(args.out, "config.yaml"), "w") as f:
        yaml.safe_dump(config, f)

    model, _ = factory.init_model(
        dict(config), args.vocab, 80, device=dev,
        generator=torch.Generator().manual_seed(args.seed))
    # blank-dominant heads => speech-realistic emission rate
    with torch.no_grad():
        model.joint.ffn_out.bias[0] += 2.5
        model.ctc.ctc_lo.bias[0] += 2.5
    checkpointing.save_checkpoint(
        os.path.join(args.out, "ckpt"), model.state_dict(),
        info={"note": "LF bench fixture, random init + blank bias 2.5",
              "seed": args.seed})

    for m in [float(x) for x in args.minutes.split(",")]:
        name = episode_name(m)
        synth_wav(os.path.join(args.out, name), m * 60, seed=int(m))
        print("wrote", name)
    print("fixture ready:", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
