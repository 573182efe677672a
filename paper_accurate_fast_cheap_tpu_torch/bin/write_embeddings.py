"""Per-layer utterance embeddings, and a local vector index (port of the
JAX ``bin/write_embeddings.py``).

The encoder runs over a dataset in static batches of the test-mode
pipeline (no filtering, no augmentation, file order kept) on the device
(``cuda`` unless ``--device cpu``).  Each block's output (before the final
norm, ``ConformerEncoder(return_layers=True)``) is mean-pooled per
utterance in float32 over its valid frames (the encoder's output lengths;
the reference pools over the padding too, JAX fixed that and so does the
port).  Writes ``<output_name>/sample_names`` and one
``embeddings_layer_i`` text matrix per kept layer, and with
``--build_index`` a cosine ``tools/vector_index.VectorIndex`` per layer as
``index_layer_i.npz``.  ``--cat_embs`` (comma floats, one per language)
conditions the language-specific blocks of an LSL encoder, every row
alike (a plain encoder ignores it).  The checkpoint is the port's
state_dict file.

Usage:
  python -m paper_accurate_fast_cheap_tpu_torch.bin.write_embeddings \\
      --config conf.yaml --checkpoint model.pt --test_data data.list \\
      --data_type raw --output_name emb [--build_index] [--device cpu]
"""
from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np
import torch

from paper_accurate_fast_cheap_tpu_torch import resolve_device


def get_args(argv=None):
    p = argparse.ArgumentParser(description="write encoder embeddings")
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", required=True,
                   help="the port's state_dict file (torch.save)")
    p.add_argument("--test_data", required=True)
    p.add_argument("--data_type", default="raw",
                   choices=["raw", "shard", "zip_shard"])
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--output_name", required=True,
                   help="output directory for sample_names + "
                        "embeddings_layer_i")
    p.add_argument("--cat_embs", default="",
                   help="comma floats for the language-specific layers' "
                        "conditioning")
    p.add_argument("--layers", default=None,
                   help="comma layer ids to keep (default: all)")
    p.add_argument("--build_index", action="store_true",
                   help="also write index_layer_i.npz cosine indexes")
    p.add_argument("--index_nlist", type=int, default=128,
                   help="IVF coarse lists")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def layer_embeddings(model, feats, feat_lens,
                     cat_embs: torch.Tensor = None) -> torch.Tensor:
    """(B, layers, D) float32: each block's output averaged over the
    utterance's valid encoder frames; ``cat_embs`` (1, K) is given to every
    row."""
    if cat_embs is not None:
        cat_embs = cat_embs.to(feats.device).expand(feats.shape[0], -1)
    out, enc_lens, layers = model.encoder(feats, feat_lens,
                                          return_layers=True,
                                          cat_embs=cat_embs)
    mask = (torch.arange(out.shape[1], device=out.device)[None, :]
            < enc_lens[:, None]).float()
    denom = torch.clamp(enc_lens.float(), min=1.0)[:, None]
    return torch.stack([torch.einsum("btd,bt->bd", x.float(), mask) / denom
                        for x in layers], dim=1)


def main(argv=None):
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO)
    dev = resolve_device(args.device)
    cat_embs = None
    if args.cat_embs:
        cat_embs = torch.tensor([[float(x)
                                  for x in args.cat_embs.split(",")]])
    from paper_accurate_fast_cheap_tpu_torch.bin.recognize import (
        build_decode_assets)
    from paper_accurate_fast_cheap_tpu_torch.data import pipeline as dp
    from paper_accurate_fast_cheap_tpu_torch.utils.config import load_config

    config = load_config(args.config)
    tokenizer, model, _, featurize, dataset_conf = build_decode_assets(
        config, args.checkpoint, device=dev)
    dataset_conf = dict(dataset_conf)
    # test-conf surgery: no filtering, no augmentation, static batches, the
    # list's order
    dataset_conf["filter_conf"] = {
        "max_length": 102400, "min_length": 0,
        "token_max_length": 102400, "token_min_length": 0,
    }
    for k in ("speed_perturb", "spec_aug", "spec_sub", "spec_trim",
              "apply_rir", "apply_telephony", "shuffle", "sort"):
        dataset_conf[k] = False
    dataset_conf["batch_conf"] = {"batch_type": "static",
                                  "batch_size": args.batch_size}

    os.makedirs(args.output_name, exist_ok=True)
    names = []
    per_layer = None
    for batch in dp.build_dataset(args.data_type, args.test_data,
                                  tokenizer, dataset_conf,
                                  partition=False, mode="test"):
        with torch.no_grad():
            feats, feat_lens = featurize(torch.from_numpy(batch["wavs"]),
                                         torch.from_numpy(batch["wav_lens"]))
            embs = layer_embeddings(model, feats, feat_lens,
                                    cat_embs).cpu().numpy()
        if per_layer is None:
            per_layer = [[] for _ in range(embs.shape[1])]
        for i in range(embs.shape[1]):
            per_layer[i].append(embs[:, i])
        names.extend(batch["keys"])

    if per_layer is None:
        logging.warning("no utterances read from %s", args.test_data)
        return 1
    keep = (set(int(x) for x in args.layers.split(","))
            if args.layers else None)
    with open(os.path.join(args.output_name, "sample_names"), "w") as f:
        f.write("\n".join(names) + "\n")
    for i, chunks in enumerate(per_layer):
        if keep is not None and i not in keep:
            continue
        mat = np.concatenate(chunks, axis=0)
        np.savetxt(os.path.join(args.output_name,
                                f"embeddings_layer_{i}"), mat)
        if args.build_index:
            from paper_accurate_fast_cheap_tpu_torch.tools.vector_index \
                import VectorIndex

            idx = VectorIndex(mat.shape[1], nlist=args.index_nlist)
            idx.add(names, mat)
            idx.save(os.path.join(args.output_name, f"index_layer_{i}.npz"))
    logging.info("wrote %d utterances x %d layers to %s", len(names),
                 len(per_layer), args.output_name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
