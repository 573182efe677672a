"""Long-form single-wav decoding CLI -> TXT + CTM (+ .rtf and .vram logs).

Port of the JAX ``bin/recognize_wav.py`` (unfused path): the waveform is
cut into ``--chunk_size``-frame windows in the sample domain,
``--batch_size`` windows at a time (the tail batch padded to full rows),
and each batch runs fbank + CMVN -> encoder -> CTC -> search on the
device; CTM word times come from a CTC Viterbi alignment of each
window's best hypothesis on the device.  On the ``rnnt_beam_search`` path
the beam aligns its top hypothesis's first ``--align_max_tokens`` tokens
(default ``max(64, chunk_size // 16)``) itself and packs beam, path, ok
flags and lengths into one buffer, which reaches the host in one copy
(JAX's fused form); a row whose hypothesis is longer (ok false) goes
through the batched aligner, as the other modes do.  Batch i+1 is
dispatched before batch i is finalized, so the host's TXT/CTM work
overlaps the device.

Same flags and defaults as the JAX CLI, plus ``--device`` (``cuda`` unless
``cpu`` is asked for).  ``--fuse``, ``--beam_unroll``, ``--wkv_impl`` and
``--rwkv_r`` choose how the JAX package dispatches to its TPU; they are
accepted, logged and do nothing here.  ``--beam_merge`` picks the device
beam's duplicate merge (``pairwise`` or ``sort``).
``--encoder_context_size`` N > 0 switches the encoder's self-attention to
LCA with context (N, N) and ``--encoder_global_tokens`` global tokens, as
the JAX CLI does; a rel-pos MHA checkpoint loads into it (the same
parameters).  ``--verbatimicity`` v gives every window ``cat_embs = [v,
1 - v]``, which mixes the language-specific blocks of an LSL encoder (as in
JAX, a YAML builds no LSL blocks, so a model from a YAML ignores it).  Every
encoder family of the factory decodes; the CTM's frame rate is 40 ms
whatever the subsampling, as in the JAX CLI.

``--seq_parallel n`` runs under ``torchrun --nproc_per_node n`` (the
process group from its environment; ``nccl`` when each rank has a card of
its own, ``gloo`` when the ranks share one or run on the CPU): each rank
runs the encoder on its 1/n of every window's frames (``rwkv_conf
spmd_axis``: the halo'd ds4 subsampling, the sequence-parallel WKV through
K1's carried state, the conv module's halo), the encoder output is
gathered, and rank 0 runs CTC and the search and writes the TXT, CTM and
logs.  Each window decodes with full-length semantics, as if zero-padded
by the ds4's 6 frames of right context (``parallel/sequence.py``); its
lengths are the window's.  As in JAX: ``--chunk_size`` must divide by
4 n, and ``--verbatimicity`` is refused.  Each rank logs its kernel
launches and its collectives' calls and bytes, rank 0 each window's best
score.

Usage:
  python -m paper_accurate_fast_cheap_tpu_torch.bin.recognize_wav \\
      --config conf.yaml --checkpoint model.pt --wav episode.wav \\
      --output_dir out --mode rnnt_beam_search [--device cpu]
  torchrun --nproc_per_node 2 -m \\
      paper_accurate_fast_cheap_tpu_torch.bin.recognize_wav ... \\
      --seq_parallel 2 [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

import numpy as np
import torch

_IGNORED = {"fuse": "auto", "beam_unroll": 1, "wkv_impl": None,
            "rwkv_r": 0}


def get_args(argv=None):
    p = argparse.ArgumentParser(description="long-form wav decode")
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", required=True,
                   help="the port's state_dict file (torch.save)")
    p.add_argument("--wav", required=True, help="input wav file")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--mode", default="ctc_greedy_search",
                   choices=["ctc_greedy_search", "ctc_prefix_beam_search",
                            "rnnt_beam_search"])
    p.add_argument("--chunk_size", type=int, default=2051,
                   help="window length in fbank frames")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--beam_size", type=int, default=8)
    p.add_argument("--ctc_weight", type=float, default=0.3)
    p.add_argument("--transducer_weight", type=float, default=0.7)
    p.add_argument("--rwkv_r", type=int, default=0,
                   help="accepted, does nothing (the WKV kernel takes any "
                        "length)")
    p.add_argument("--verbatimicity", type=float, default=None,
                   help="cat_embs = [v, 1-v] conditioning (LSL encoders)")
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"],
                   help="decode dtype of the weights and features")
    p.add_argument("--wkv_impl", default=None, choices=["pallas", "chunked"],
                   help="accepted, does nothing")
    p.add_argument("--encoder_context_size", type=int, default=0,
                   help="switch self-attention to LCA with this context")
    p.add_argument("--encoder_global_tokens", type=int, default=0)
    p.add_argument("--encoder_global_tokens_spacing", type=int, default=1)
    p.add_argument("--fuse", default="auto",
                   choices=["auto", "on", "split", "off"],
                   help="accepted, does nothing")
    p.add_argument("--beam_unroll", type=int, default=1,
                   help="accepted, does nothing")
    p.add_argument("--beam_merge", default="pairwise",
                   choices=["sort", "pairwise"],
                   help="device-beam duplicate merge")
    p.add_argument("--align_max_tokens", type=int, default=0,
                   help="tokens of the top hypothesis the beam aligns "
                        "itself (0: max(64, chunk_size // 16))")
    p.add_argument("--seq_parallel", type=int, default=0,
                   help="shard each window's time axis over this many "
                        "ranks (under torchrun); chunk_size must divide by "
                        "4*N")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def window_batches(wav_len: int, chunk: int, batch: int,
                   frame_shift: int = 160, frame_length: int = 400):
    """Waveform -> batches of sample window offsets, one per ``chunk``-frame
    fbank window, with their valid sample lengths.

    Frame ``i`` of window ``s`` covers samples ``[(s+i)*shift,
    (s+i)*shift + length)``, exactly the frames the whole-file fbank would
    produce.  The last group is padded to ``batch`` rows of length 0
    (masked downstream).  ``group`` holds the real windows' start frames.
    """
    total_frames = max(0, (wav_len - frame_length) // frame_shift + 1)
    win_samples = (chunk - 1) * frame_shift + frame_length
    starts = list(range(0, max(total_frames, 1), chunk))
    for i in range(0, len(starts), batch):
        group = starts[i: i + batch]
        s0 = np.zeros((batch,), np.int32)
        lens = np.zeros((batch,), np.int32)
        for j, s in enumerate(group):
            s0[j] = s * frame_shift
            lens[j] = max(0, min(win_samples, wav_len - s0[j]))
        yield group, s0, lens


def make_window_slicer(wav: np.ndarray, win_samples: int, device):
    """Put the waveform on ``device`` once; return starts (B,) ->
    (B, win_samples) windows (zero past the end)."""
    wav_dev = torch.from_numpy(
        np.pad(wav, (0, win_samples)).astype(np.float32)).to(device)

    def slice_fn(starts):
        return torch.stack([wav_dev[s: s + win_samples]
                            for s in np.asarray(starts).tolist()])

    return slice_fn


def _check_flags(args) -> None:
    given = [f"--{k}" for k, d in _IGNORED.items() if getattr(args, k) != d]
    if given:
        logging.info("%s: TPU dispatch choices of the JAX CLI; accepted "
                     "and ignored", ", ".join(given))


def main(argv=None):
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO)
    _check_flags(args)
    from paper_accurate_fast_cheap_tpu_torch import resolve_device
    from paper_accurate_fast_cheap_tpu_torch.bin.recognize import (
        build_decode_assets)
    from paper_accurate_fast_cheap_tpu_torch.data.audio import (
        read_audio_bytes, resample_to)
    from paper_accurate_fast_cheap_tpu_torch.decode import (
        rnnt_search, search)
    from paper_accurate_fast_cheap_tpu_torch.ops import ctc_utils
    from paper_accurate_fast_cheap_tpu_torch.parallel import (
        collectives, mesh as mesh_lib)
    from paper_accurate_fast_cheap_tpu_torch.utils.config import load_config

    n_sp = args.seq_parallel if args.seq_parallel > 1 else 0
    rank, mesh = 0, None
    if n_sp:
        if args.verbatimicity is not None:
            raise SystemExit("--seq_parallel with cat_embs not supported")
        if args.chunk_size % (4 * n_sp):
            raise SystemExit(f"--chunk_size must divide by 4*{n_sp}")
        dev = (mesh_lib.init_distributed(args.device)
               if "RANK" in os.environ and not
               torch.distributed.is_initialized() else
               resolve_device(args.device))
        rank, world, _ = mesh_lib.world()
        if world != n_sp:
            raise SystemExit(f"--seq_parallel {n_sp} needs {n_sp} ranks "
                             f"(have {world}; run under torchrun "
                             f"--nproc_per_node {n_sp})")
        mesh = mesh_lib.make_mesh(n_sp, ("seq",))
        logging.info("sequence-parallel decode: T sharded over %d ranks "
                     "(this is rank %d)", n_sp, rank)
    else:
        dev = resolve_device(args.device)
    config = load_config(args.config)
    if n_sp:
        # the factory routes encoder_conf's spmd_axis into rwkv_conf (the
        # JAX CLI nests an rwkv_conf that its factory drops)
        config = dict(config, encoder_conf=dict(
            config.get("encoder_conf", {}), spmd_axis="seq"))
    if args.encoder_context_size > 0:
        n = args.encoder_context_size
        config = dict(config, encoder_conf=dict(
            config.get("encoder_conf", {}),
            selfattention_layer_type="limited_rel_selfattn",
            att_context_size=[n, n],
            global_tokens=args.encoder_global_tokens,
            global_tokens_spacing=args.encoder_global_tokens_spacing))
    tokenizer, model, model_type, featurize, dataset_conf = \
        build_decode_assets(config, args.checkpoint, device=dev)
    if args.precision == "bf16":
        model = model.to(torch.bfloat16)
    cat_embs = None
    if args.verbatimicity is not None:
        v = args.verbatimicity
        cat_embs = torch.tensor([[v, 1.0 - v]], device=dev)

    with open(args.wav, "rb") as f:
        wav, sr = read_audio_bytes(f.read())
    wav, sr = resample_to(wav, sr, 16000)
    audio_seconds = len(wav) / sr

    fb = dataset_conf.get("fbank_conf", {})
    frame_shift = int(fb.get("frame_shift", 10)) * (16000 // 1000)
    frame_length = int(fb.get("frame_length", 25)) * (16000 // 1000)
    t_start = time.perf_counter()

    name = os.path.splitext(os.path.basename(args.wav))[0]
    if not rank:
        os.makedirs(args.output_dir, exist_ok=True)
    # conv2d ds4's frame rate, 0.04 s, for every subsampling (the JAX CLI's
    # rule)
    subsample = 4

    beam = model_type == "transducer" and args.mode == "rnnt_beam_search"
    if args.mode == "rnnt_beam_search" and not beam:
        raise ValueError("rnnt_beam_search needs a transducer model")
    if beam:
        step_fns = rnnt_search.make_transducer_step_fns(model)
        align_lmax = args.align_max_tokens or max(64, args.chunk_size // 16)

    ctm_lines = []
    all_text = []
    best_scores = []      # each window's best hypothesis score
    batch_done = []       # wall clock when each batch's results landed
    batch_audio = []      # decoded audio seconds per batch
    win_samples = (args.chunk_size - 1) * frame_shift + frame_length
    window_slice = make_window_slicer(wav, win_samples, dev)

    def encode(feats, feat_lens):
        if not n_sp:
            return model.forward_encoder(
                feats, feat_lens, cat_embs=None if cat_embs is None
                else cat_embs.expand(feats.shape[0], -1))
        t_loc = feats.shape[1] // n_sp
        with mesh:
            enc, enc_lens = model.forward_encoder(
                feats[:, rank * t_loc:(rank + 1) * t_loc], feat_lens)
            return (collectives.all_gather(enc, "seq", dim=1, tiled=True),
                    enc_lens)

    def dispatch(s0, slens):
        """Enqueue one batch's device work; nothing is read back.  Under
        ``--seq_parallel`` only rank 0 goes past the encoder."""
        feats, feat_lens = featurize(window_slice(s0), slens)
        if args.precision == "bf16":
            feats = feats.to(torch.bfloat16)
        enc, enc_lens = encode(feats, feat_lens)
        if rank:
            return None
        logp = model.ctc_logprobs(enc)
        payload = None
        if beam:
            payload = rnnt_search.rnnt_beam_search(
                *step_fns, enc, enc_lens, logp, beam_size=args.beam_size,
                ctc_weight=args.ctc_weight,
                transducer_weight=args.transducer_weight, defer=True,
                merge=args.beam_merge, align_pack=align_lmax)
        return enc_lens, logp, payload

    def finalize(entry):
        """Materialize one dispatched batch: search results, alignment,
        TXT and CTM lines."""
        group, slens, enc_lens, logp, payload = entry
        if beam:
            # beam + Viterbi path + ok + lengths in one copy
            res, path_np, ok_np, lens_np = \
                rnnt_search.finalize_device_beam_aligned(
                    payload, beam=args.beam_size)
        else:
            lens_np = enc_lens.cpu().numpy()
            if args.mode == "ctc_greedy_search":
                res = search.ctc_greedy_search(logp, lens_np)
            else:
                res = search.ctc_prefix_beam_search(
                    logp, lens_np, beam_size=args.beam_size)
        # token timing: one batched Viterbi on the device per window batch
        need_align = [b for b, r in enumerate(res)
                      if r.tokens and not (r.times
                                           and len(r.times)
                                           == len(r.tokens))]
        alis = {}
        if need_align and beam:
            # the beam aligned its rows' top hypotheses already
            for b in need_align:
                if ok_np[b]:
                    alis[b] = [int(x) for x in path_np[b, : lens_np[b]]]
            need_align = [b for b in need_align if not ok_np[b]]
        if need_align:
            batch_ali = ctc_utils.force_align_batch_device(
                logp, lens_np, [res[b].tokens if b in need_align else []
                                for b in range(len(res))])
            alis.update({b: batch_ali[b] for b in need_align})
        best_scores.extend(float(r.score) for r in res[:len(group)])
        for start_frame, r, b in zip(group, res, range(len(res))):
            if not r.tokens:
                continue
            if r.times and len(r.times) == len(r.tokens):
                peaks = r.times
            else:
                spans = ctc_utils.alignment_to_token_spans(alis[b])
                peaks = [s[1] for s in spans]
            offset_sec = start_frame * 0.01
            times = ctc_utils.gen_timestamps_from_peak(
                peaks, max_duration=lens_np[b] * subsample * 0.01,
                frame_rate=subsample * 0.01)
            toks = tokenizer.ids2tokens(r.tokens)
            # merge subword pieces into words at '▁' boundaries for CTM
            words, word_times = _pieces_to_words(toks, times)
            for w, (ts, te) in zip(words, word_times):
                ctm_lines.append(
                    f"{name} 1 {offset_sec + ts:.2f} {te - ts:.2f} {w}")
            text, _ = tokenizer.detokenize(r.tokens)
            all_text.append(text)
        batch_done.append(time.perf_counter())
        batch_audio.append(float(np.sum(slens)) / 16000.0)

    # two-deep pipeline: enqueue batch i+1's device work BEFORE finalizing
    # batch i, so the host's search/CTM work overlaps the device
    pending = None
    with torch.no_grad():
        for group, s0, slens in window_batches(len(wav), args.chunk_size,
                                               args.batch_size,
                                               frame_shift, frame_length):
            out = dispatch(s0, slens)
            if rank:
                continue
            entry = (group, slens) + out
            if pending is not None:
                finalize(pending)
            pending = entry
        if pending is not None:
            finalize(pending)
    if n_sp:
        log_rank_counts(rank, n_sp, best_scores)
        torch.distributed.destroy_process_group()
        if rank:
            return 0

    elapsed = time.perf_counter() - t_start
    rtf = elapsed / max(audio_seconds, 1e-9)
    # steady-state RTF over the batches after the first (which carries the
    # kernels' first-use build and the allocator's warm-up); per-batch wall
    # times are the gaps between successive result landings
    batch_times = [batch_done[0] - t_start] + [
        batch_done[i] - batch_done[i - 1]
        for i in range(1, len(batch_done))]
    if len(batch_done) > 1:
        steady_rtf = ((batch_done[-1] - batch_done[0])
                      / max(sum(batch_audio[1:]), 1e-9))
        per_batch = sorted(t / max(a, 1e-9) for t, a in
                           zip(batch_times[1:], batch_audio[1:]))
        median_rtf = per_batch[len(per_batch) // 2]
    else:
        steady_rtf = rtf
        median_rtf = rtf
    with open(os.path.join(args.output_dir, name + ".ctm"), "w") as f:
        f.write("\n".join(ctm_lines) + ("\n" if ctm_lines else ""))
    with open(os.path.join(args.output_dir, name + ".txt"), "w") as f:
        f.write(" ".join(all_text) + "\n")
    with open(os.path.join(args.output_dir, name + ".rtf"), "w") as f:
        f.write(f"final_rtf {rtf:.6f} elapsed {elapsed:.3f} "
                f"audio_seconds {audio_seconds:.2f}\n")
        f.write(f"steady_rtf {steady_rtf:.6f}\n")
        f.write(f"median_rtf {median_rtf:.6f}\n")
        f.write("batch_times " +
                " ".join(f"{t:.3f}" for t in batch_times) + "\n")
        f.write("batch_audio " +
                " ".join(f"{a:.1f}" for a in batch_audio) + "\n")
    with open(os.path.join(args.output_dir, name + ".vram"), "w") as f:
        for k2, v2 in device_memory_stats(dev).items():
            f.write(f"{k2} {v2:.1f}\n")
    logging.info("decoded %s: %.1fs audio in %.2fs (RTF %.4f, steady "
                 "%.4f = %.0fx realtime)", name, audio_seconds, elapsed,
                 rtf, steady_rtf, 1.0 / max(steady_rtf, 1e-9))
    return 0


def log_rank_counts(rank: int, n: int, best_scores) -> None:
    """This rank's kernel launches, collectives (calls, bytes) and, on rank
    0, each window's best score, as one JSON object in the log."""
    from paper_accurate_fast_cheap_tpu_torch.ops import (
        joint_topk, lstm_step, wkv6_cuda)
    from paper_accurate_fast_cheap_tpu_torch.parallel import collectives

    counts = {"wkv6_fwd": wkv6_cuda.wkv6_cuda.launches,
              "joint_topk": joint_topk.joint_top_k_vocab.launches,
              "lstm_step": lstm_step.lstm_predictor_step.launches}
    logging.info("seq_parallel rank %d of %d: %s", rank, n, json.dumps(
        {"launches": counts, "collectives": collectives.read_counts(),
         "best_scores": best_scores}))


def device_memory_stats(device) -> dict:
    """Device memory in MB from ``torch.cuda.memory_stats`` (empty on the
    CPU)."""
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    mb = 1024 * 1024
    return {
        "bytes_in_use_mb": stats.get("allocated_bytes.all.current", 0) / mb,
        "peak_bytes_in_use_mb": stats.get("allocated_bytes.all.peak", 0) / mb,
        "bytes_limit_mb": torch.cuda.get_device_properties(
            device).total_memory / mb,
    }


def _pieces_to_words(pieces, times):
    """Merge sentencepiece pieces into words with merged time spans."""
    words, spans = [], []
    cur, ts, te = "", None, None
    for p, (a, b) in zip(pieces, times):
        starts_word = p.startswith("▁")
        text = p.replace("▁", "")
        if starts_word and cur:
            words.append(cur)
            spans.append((ts, te))
            cur, ts = "", None
        if not cur:
            ts = a
        cur += text
        te = b
    if cur:
        words.append(cur)
        spans.append((ts, te))
    # drop empties (pure '▁' pieces)
    out = [(w, s) for w, s in zip(words, spans) if w]
    if not out:
        return [], []
    ws, ss = zip(*out)
    return list(ws), list(ss)


if __name__ == "__main__":
    sys.exit(main())
