"""Long-form WER chunk-size sweep (port of the recipe's
``local/run_lf_sweep.py``), the shape of the reference harness
`examples/gigaspeech/s0/local/go-LF-dev-one-model-paper.sh:90-124` +
`gigaspeech_scoring_longform.py`:

  per chunk size in {2000,4000,9000,15000,20000,40000} fbank frames:
    every *.wav / *.flac in --wav_dir -> bin/recognize_wav (windows ->
    CTM/.txt + .rtf/.vram logs)
  then score each file's hypothesis against <name>.ref_txt in --ref_dir
  (GigaSpeech text filtering) and write a summary.txt per chunk size
  plus a top-level sweep table.

The CLI runs in this process on ``--device`` (``cuda`` unless ``cpu``).

Usage:
  python -m paper_accurate_fast_cheap_tpu_torch.examples.gigaspeech.local.run_lf_sweep \\
      --config c.yaml --checkpoint m.pt --wav_dir eps --out_dir sweep \\
      [--chunk_sizes 2000,9000] [--device cpu]
"""
import argparse
import glob
import os
import sys

from paper_accurate_fast_cheap_tpu_torch.examples.gigaspeech.local import (
    run_cli)

PAPER_CHUNKS = "2000,4000,9000,15000,20000,40000"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--wav_dir", required=True,
                   help="directory of .wav/.flac episode files")
    p.add_argument("--ref_dir", default=None,
                   help="directory of <name>.ref_txt references "
                        "(default: --wav_dir)")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--chunk_sizes", default=PAPER_CHUNKS)
    p.add_argument("--mode", default="rnnt_beam_search")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--beam_size", type=int, default=8)
    p.add_argument("--ctc_weight", type=float, default=0.3)
    p.add_argument("--transducer_weight", type=float, default=0.7)
    p.add_argument("--rwkv_r", type=int, default=0)
    p.add_argument("--verbatimicity", type=float, default=None)
    p.add_argument("--fuse", default=None, choices=["on", "off"],
                   help="forwarded to recognize_wav (accepted, ignored)")
    p.add_argument("--wkv_impl", default=None,
                   choices=["pallas", "chunked"],
                   help="forwarded to recognize_wav (accepted, ignored)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    from paper_accurate_fast_cheap_tpu_torch.tools import wer as wer_lib

    wavs = sorted(glob.glob(os.path.join(args.wav_dir, "*.wav"))
                  + glob.glob(os.path.join(args.wav_dir, "*.flac")))
    if not wavs:
        print(f"no wav/flac files in {args.wav_dir}", file=sys.stderr)
        return 1
    ref_dir = args.ref_dir or args.wav_dir

    table = []
    for chunk in [int(c) for c in args.chunk_sizes.split(",")]:
        cdir = os.path.join(args.out_dir, f"chunk{chunk}")
        os.makedirs(cdir, exist_ok=True)
        for wav in wavs:
            argv_one = [
                "--config", args.config, "--checkpoint", args.checkpoint,
                "--wav", wav, "--output_dir", cdir,
                "--mode", args.mode, "--chunk_size", chunk,
                "--batch_size", args.batch_size,
                "--beam_size", args.beam_size,
                "--ctc_weight", args.ctc_weight,
                "--transducer_weight", args.transducer_weight,
                "--device", args.device,
            ]
            if args.rwkv_r:
                argv_one += ["--rwkv_r", args.rwkv_r]
            if args.verbatimicity is not None:
                argv_one += ["--verbatimicity", args.verbatimicity]
            if args.fuse is not None:
                argv_one += ["--fuse", args.fuse]
            if args.wkv_impl is not None:
                argv_one += ["--wkv_impl", args.wkv_impl]
            run_cli("recognize_wav", argv_one)
        # score: per-file hypothesis text vs .ref_txt, gigaspeech filtering
        per_file = {}
        rtfs = []
        for wav in wavs:
            name = os.path.splitext(os.path.basename(wav))[0]
            hyp_path = os.path.join(cdir, name + ".txt")
            ref_path = os.path.join(ref_dir, name + ".ref_txt")
            if not os.path.exists(ref_path):
                continue
            hyp = open(hyp_path).read().strip() \
                if os.path.exists(hyp_path) else ""
            ref = open(ref_path).read().strip()
            _, per = wer_lib.compute_wer({name: ref}, {name: hyp},
                                         gigaspeech_filter=True)
            per_file[name] = per[name]
            rtf_path = os.path.join(cdir, name + ".rtf")
            if os.path.exists(rtf_path):
                parts = open(rtf_path).read().split()
                if len(parts) >= 2 and parts[0] == "final_rtf":
                    rtfs.append(float(parts[1]))
        summ = wer_lib.longform_summary(per_file)
        if rtfs:
            summ["rtf_mean"] = sum(rtfs) / len(rtfs)
        with open(os.path.join(cdir, "summary.txt"), "w") as f:
            for k, v in summ.items():
                f.write(f"{k} {v}\n")
        table.append((chunk, summ))
        print(f"chunk {chunk}: WER {summ['wer']:.4f} "
              f"(+/- {summ['wer_stdev']:.4f}) over {summ['num_files']} "
              f"files", flush=True)

    with open(os.path.join(args.out_dir, "summary.txt"), "w") as f:
        f.write("chunk_frames wer wer_stdev ins del sub files rtf\n")
        for chunk, s in table:
            f.write(f"{chunk} {s['wer']:.4f} {s['wer_stdev']:.4f} "
                    f"{s['ins_rate']:.4f} {s['del_rate']:.4f} "
                    f"{s['sub_rate']:.4f} {s['num_files']} "
                    f"{s.get('rtf_mean', 0):.4f}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
