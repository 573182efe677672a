"""HLG lattice decoding behind an optional k2 (port of the JAX
``models/k2_model.py``).

``hlg_onebest`` runs k2's lattice one-best on the CTC posteriors when k2
and an HLG file are present, else falls back to the CTC prefix beam;
``hlg_rescore`` combines ``am + lm_scale * ngram + decoder_scale * decoder
+ r_decoder_scale * r_decoder`` over an n-best list: k2/icefall's lattice
n-best when present, else the CTC prefix beam's n-best with the n-gram
term from ``ngram_lm`` (``decode/lm.NGramLM``).  ``export_posteriors``
writes the posteriors and lengths for an external icefall HLG decode.  k2
is imported lazily, only on its branch; the attention decoder's path
scores run on the caller's device.
"""
from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np
import torch

from paper_accurate_fast_cheap_tpu_torch.decode.search import (
    DecodeResult,
    ctc_prefix_beam_search,
)

log = logging.getLogger(__name__)

_K2_MSG = (
    "k2 is not installed; HLG lattice decoding falls back to CTC prefix "
    "beam search. Use export_posteriors() and run icefall's HLG decode "
    "externally for exact HLG parity."
)


def k2_available() -> bool:
    try:
        import k2  # noqa: F401

        return True
    except ImportError:
        return False


def export_posteriors(path: str, ctc_logp: np.ndarray,
                      lengths: np.ndarray, keys: Optional[list] = None):
    """Write CTC log-posteriors in an npz the external icefall HLG recipe
    (or `hlg_onebest` on a k2-equipped host) can consume."""
    np.savez(path, ctc_logp=np.asarray(ctc_logp),
             lengths=np.asarray(lengths),
             keys=np.asarray(keys if keys is not None else
                             [str(i) for i in range(len(lengths))]))


def hlg_onebest(ctc_logp: np.ndarray, lengths: np.ndarray,
                hlg_path: Optional[str] = None,
                beam_size: int = 10,
                search_beam: float = 20.0,
                output_beam: float = 8.0,
                min_active_states: int = 30,
                max_active_states: int = 10000) -> List[DecodeResult]:
    """HLG one-best (`k2/model.py` get_lattice + one_best semantics).

    With k2 present and an HLG fst file: real lattice decode on the CPU.
    Without k2: CTC prefix beam fallback with a warning.
    """
    if not k2_available() or hlg_path is None:
        if not k2_available():
            log.warning(_K2_MSG)
        else:
            log.warning("k2 present but no --hlg fst given; CTC fallback")
        return ctc_prefix_beam_search(ctc_logp, lengths,
                                      beam_size=beam_size)
    import k2

    hlg = k2.Fsa.from_dict(torch.load(hlg_path, map_location="cpu"))
    logp = torch.from_numpy(np.asarray(ctc_logp, np.float32))
    lens = torch.from_numpy(np.asarray(lengths, np.int32))
    B = logp.shape[0]
    supervision = torch.stack(
        [torch.arange(B, dtype=torch.int32),
         torch.zeros(B, dtype=torch.int32), lens], dim=1)
    lattice = k2.get_lattice(
        logp, supervision, hlg,
        search_beam=search_beam, output_beam=output_beam,
        min_active_states=min_active_states,
        max_active_states=max_active_states,
        subsampling_factor=1,
    )
    best = k2.shortest_path(lattice, use_double_scores=True)
    results = []
    for i in range(B):
        fsa = best[i]
        aux = fsa.aux_labels
        if hasattr(aux, "values"):
            aux = aux.values
        toks = [int(t) for t in aux.tolist() if t > 0]
        score = float(fsa.get_tot_scores(
            use_double_scores=True, log_semiring=False).item()) \
            if hasattr(fsa, "get_tot_scores") else 0.0
        results.append(DecodeResult(tokens=toks, score=score))
    return results


def hlg_rescore(
    ctc_logp: np.ndarray,
    lengths: np.ndarray,
    decoder_apply,
    sos: int,
    eos: int,
    enc_out: Optional[np.ndarray] = None,
    enc_lens: Optional[np.ndarray] = None,
    hlg_path: Optional[str] = None,
    word_table: Optional[dict] = None,
    lm_scale: float = 0.0,
    decoder_scale: float = 0.0,
    r_decoder_scale: float = 0.0,
    num_paths: int = 100,
    nbest_scale: float = 0.5,
    ngram_lm=None,
    beam_size: int = 8,
):
    """HLG n-best rescore (`wenet/k2/model.py:185-303` `hlg_rescore`).

    Combined score per path: ``am + lm_scale * ngram_lm +
    decoder_scale * decoder + r_decoder_scale * r_decoder`` — the
    attention decoder scores come from `decoder_apply` exactly like
    `attention_rescoring_scores` (the reference pads hyps with sos/eos
    and sums per-token log-probs both directions, `k2/model.py:244-291`).

    With k2 + an HLG fst present: real lattice n-best via
    `icefall.decode.get_lattice`/`Nbest.from_lattice` semantics (on the
    CPU).  Without k2: the n-best comes from the CTC prefix beam and the
    ngram term from ``ngram_lm`` (`decode/lm.NGramLM` over word ids via
    ``word_table``) — the same
    score combination, lattice-free.
    """
    B = ctc_logp.shape[0]
    if k2_available() and hlg_path:
        import k2
        import icefall.decode as idec

        logp = torch.from_numpy(np.asarray(ctc_logp))
        supervision = torch.stack(
            (torch.arange(B), torch.zeros(B),
             torch.from_numpy(np.asarray(lengths))), 1).to(torch.int32)
        hlg = k2.Fsa.from_dict(torch.load(hlg_path, map_location="cpu"))
        lattice = idec.get_lattice(
            nnet_output=logp, decoding_graph=hlg,
            supervision_segments=supervision,
            search_beam=20, output_beam=7, min_active_states=30,
            max_active_states=10000, subsampling_factor=4)
        nbest = idec.Nbest.from_lattice(
            lattice=lattice, num_paths=num_paths,
            use_double_scores=True, nbest_scale=nbest_scale)
        nbest = nbest.intersect(lattice)
        tokens_shape = nbest.fsa.arcs.shape().remove_axis(1)
        tokens = k2.RaggedTensor(tokens_shape, nbest.fsa.tokens)
        tokens = tokens.remove_values_leq(0)
        hyps_all = tokens.tolist()
        am = nbest.compute_am_scores().values.numpy()
        lm = nbest.compute_lm_scores().values.numpy()
        # rows -> utterances
        row_splits = nbest.shape.row_splits(1).numpy()
        groups = [list(range(row_splits[i], row_splits[i + 1]))
                  for i in range(B)]
    else:
        if hlg_path and not k2_available():
            log.warning("hlg_rescore: k2 unavailable — CTC-prefix-beam "
                        "n-best + ngram_lm fallback (install k2 for "
                        "lattice rescore)")
        ctc_res = ctc_prefix_beam_search(
            np.asarray(ctc_logp), np.asarray(lengths),
            beam_size=beam_size)
        hyps_all, am, lm, groups = [], [], [], []
        for b, r in enumerate(ctc_res):
            idxs = []
            for hyp, sc in zip(r.nbest, r.nbest_scores):
                idxs.append(len(hyps_all))
                hyps_all.append(list(hyp))
                am.append(sc)
                lm.append(ngram_lm.sequence_logp(hyp)
                          if ngram_lm is not None else 0.0)
            groups.append(idxs)
        am = np.asarray(am, np.float64)
        lm = np.asarray(lm, np.float64)

    results = []
    for b in range(B):
        idxs = groups[b]
        if not idxs:
            results.append(DecodeResult(tokens=[]))
            continue
        nb = [hyps_all[i] for i in idxs]
        dec_s = np.zeros(len(nb))
        r_dec_s = np.zeros(len(nb))
        if (decoder_apply is not None and enc_out is not None
                and (decoder_scale or r_decoder_scale)):
            dec_s, r_dec_s = _decoder_path_scores(
                decoder_apply, torch.as_tensor(enc_out[b:b + 1]),
                torch.as_tensor(enc_lens[b:b + 1]), nb, sos, eos)
        tot = [am[i] + lm_scale * lm[i]
               + decoder_scale * dec_s[j]
               + r_decoder_scale * r_dec_s[j]
               for j, i in enumerate(idxs)]
        best = int(np.argmax(tot))
        results.append(DecodeResult(
            tokens=nb[best], score=float(tot[best]),
            nbest=nb, nbest_scores=[float(t) for t in tot]))
    return results


def _decoder_path_scores(decoder_apply, enc_out, enc_len, nbest,
                         sos: int, eos: int):
    """Bidirectional per-path decoder log-probs, reference-exact
    (`k2/model.py:244-291`): the forward sum EXCLUDES the eos term, the
    reverse sum INCLUDES it (the reference's asymmetry), and both
    directions run with reverse_weight=0.5 so r_logits are real.  The
    log-probs come to the host in float32 and sum there, as in JAX."""
    n = len(nbest)
    maxu = max((len(h) for h in nbest), default=0) + 1
    ignore = eos
    ys_in = np.full((n, maxu), ignore, np.int32)
    r_ys_in = np.full((n, maxu), ignore, np.int32)
    ys_in[:, 0] = sos
    r_ys_in[:, 0] = sos
    ys_lens = np.zeros((n,), np.int32)
    for i, h in enumerate(nbest):
        ys_in[i, 1:1 + len(h)] = h
        r_ys_in[i, 1:1 + len(h)] = h[::-1]
        ys_lens[i] = len(h) + 1
    dev = enc_out.device
    enc = enc_out.repeat_interleave(n, dim=0)
    enc_lens_r = enc_len.to(dev).repeat_interleave(n, dim=0)
    with torch.no_grad():
        l_logits, r_logits = decoder_apply(
            enc, enc_lens_r, torch.from_numpy(ys_in).to(dev),
            torch.from_numpy(ys_lens).to(dev),
            torch.from_numpy(r_ys_in).to(dev), 0.5)
        l_logp = torch.log_softmax(l_logits.float(), -1).cpu().numpy()
        r_logp = torch.log_softmax(r_logits.float(), -1).cpu().numpy()
    dec = np.zeros((n,), np.float64)
    rdec = np.zeros((n,), np.float64)
    for i, h in enumerate(nbest):
        dec[i] = sum(l_logp[i, j, tok] for j, tok in enumerate(h))
        rdec[i] = sum(r_logp[i, len(h) - j - 1, tok]
                      for j, tok in enumerate(h))
        rdec[i] += r_logp[i, len(h), eos]
    return dec, rdec
