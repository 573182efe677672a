"""FST graph-prep CLI (port of the JAX ``bin/fst_tools.py``): lexicon ->
L and ARPA -> G, both in OpenFst AT&T text (``fstcompile``-able where
OpenFst is installed, and read back by ``decode.wfst.read_fst_text`` for the
on-the-fly ``LGScorer``).  Host code; the files are byte for byte the JAX
tool's.

Usage:
  python -m paper_accurate_fast_cheap_tpu_torch.bin.fst_tools \
      compile_lexicon --lexicon lexicon.txt --units units.txt --out L.fst.txt
      (lexicon.txt: "word tok1 tok2 ..." a line, the tokens mapped through
      units.txt's "token id" table; also writes words.txt, ids from 1)
  python -m paper_accurate_fast_cheap_tpu_torch.bin.fst_tools \
      arpa_to_g --arpa lm.arpa --words words.txt --out G.fst.txt
      (a word-level ARPA -> the grammar acceptor over word ids)
"""
from __future__ import annotations

import argparse
import logging
import os
import sys


def get_args(argv=None):
    p = argparse.ArgumentParser(description="FST graph prep")
    sub = p.add_subparsers(dest="cmd", required=True)

    cl = sub.add_parser("compile_lexicon")
    cl.add_argument("--lexicon", required=True,
                    help="'word tok1 tok2 ...' per line")
    cl.add_argument("--units", required=True, help="'token id' per line")
    cl.add_argument("--out", required=True, help="L.fst.txt path")
    cl.add_argument("--words_out", default=None,
                    help="words.txt path (default: alongside --out)")

    ag = sub.add_parser("arpa_to_g")
    ag.add_argument("--arpa", required=True)
    ag.add_argument("--words", required=True, help="'word id' per line")
    ag.add_argument("--out", required=True, help="G.fst.txt path")

    return p.parse_args(argv)


def _read_table(path):
    table = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                table[parts[0]] = int(parts[1])
            elif len(parts) == 1:
                table[parts[0]] = len(table)
    return table


def main(argv=None):
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO)
    from paper_accurate_fast_cheap_tpu_torch.decode import wfst

    if args.cmd == "compile_lexicon":
        units = _read_table(args.units)
        lex = {}
        words = {}
        with open(args.lexicon, encoding="utf-8") as f:
            for line in f:
                parts = line.split()
                if len(parts) < 2:
                    continue
                word, toks = parts[0], parts[1:]
                ids = [units.get(t) for t in toks]
                if any(i is None for i in ids):
                    logging.warning("skip %s: token not in units", word)
                    continue
                if word not in words:
                    words[word] = len(words) + 1  # 0 = eps
                lex[words[word]] = ids
        L = wfst.lexicon_to_l(lex)
        wfst.write_fst_text(L, args.out)
        wpath = args.words_out or os.path.join(
            os.path.dirname(args.out) or ".", "words.txt")
        with open(wpath, "w", encoding="utf-8") as f:
            f.write("<eps> 0\n")
            for w, i in sorted(words.items(), key=lambda kv: kv[1]):
                f.write(f"{w} {i}\n")
        logging.info("L: %d states %d arcs -> %s (+%s)",
                     L.num_states, L.num_arcs, args.out, wpath)
    elif args.cmd == "arpa_to_g":
        from paper_accurate_fast_cheap_tpu_torch.decode.lm import NGramLM

        words = _read_table(args.words)
        vocab = max(words.values()) + 1
        lm = NGramLM.from_arpa(args.arpa, symbol_table=words,
                               vocab_size=vocab)
        G = wfst.arpa_to_g(lm)
        wfst.write_fst_text(G, args.out)
        logging.info("G: order %d, %d states %d arcs -> %s",
                     lm.order, G.num_states, G.num_arcs, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
