"""WER scoring CLI (port of the JAX ``bin/compute_wer.py``): reference and
hypothesis trn files ('key text...'), optional GigaSpeech filtering
(``--giga``), uppercasing, character units (``--char``), per-utterance
lines (``-v``) and the long-form macro summary (``--longform``).

Usage:
  python -m paper_accurate_fast_cheap_tpu_torch.bin.compute_wer ref.trn \\
      hyp.trn [--char] [-v]
"""
from __future__ import annotations

import argparse
import sys


def get_args(argv=None):
    p = argparse.ArgumentParser(description="compute WER")
    p.add_argument("ref", help="reference trn file: 'key text...'")
    p.add_argument("hyp", help="hypothesis trn file")
    p.add_argument("--giga", action="store_true",
                   help="GigaSpeech filtering")
    p.add_argument("--upper", action="store_true", help="uppercase both")
    p.add_argument("--char", action="store_true",
                   help="character error rate")
    p.add_argument("--verbose", "-v", action="store_true")
    p.add_argument("--longform", action="store_true",
                   help="treat each key as a file; print macro summary")
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    from paper_accurate_fast_cheap_tpu_torch.tools import wer as wer_lib

    refs = wer_lib.read_trn(args.ref)
    hyps = wer_lib.read_trn(args.hyp)
    total, per_utt = wer_lib.compute_wer(
        refs, hyps, gigaspeech_filter=args.giga, to_upper=args.upper,
        to_char=args.char)
    if args.verbose:
        for key, st in per_utt.items():
            print(f"{key} wer {st.wer*100:.2f}% "
                  f"(ins {st.ins} del {st.dele} sub {st.sub} / "
                  f"{st.ref_len})")
    if args.longform:
        s = wer_lib.longform_summary(per_utt)
        print(f"files {s['num_files']} ref_words {s['ref_words']}")
        print(f"WER {s['wer']*100:.2f}% (stdev {s['wer_stdev']*100:.2f}) "
              f"ins {s['ins_rate']*100:.2f}% del {s['del_rate']*100:.2f}% "
              f"sub {s['sub_rate']*100:.2f}%")
    else:
        print(f"Overall -> {total.wer*100:.2f} % N={total.ref_len} "
              f"C={total.ref_len - total.sub - total.dele} "
              f"S={total.sub} D={total.dele} I={total.ins}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
