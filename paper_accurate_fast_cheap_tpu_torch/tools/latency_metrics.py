"""Emission-latency summaries (port of the report part of the JAX
``tools/latency_metrics.py``): per-token delays of emission against each
token's own audio time, FirstToken / LastToken / AvgToken per utterance,
and their percentiles over utterances."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np


@dataclasses.dataclass
class UttLatency:
    first_token: float
    last_token: float
    avg_token: float


def token_delays(emission_times: Sequence[float],
                 reference_times: Sequence[float]) -> List[float]:
    """Per-token delay = emitted - reference (the same token order)."""
    n = min(len(emission_times), len(reference_times))
    return [emission_times[i] - reference_times[i] for i in range(n)]


def utterance_latency(emission_times: Sequence[float],
                      reference_times: Sequence[float]) -> UttLatency:
    d = token_delays(emission_times, reference_times)
    if not d:
        return UttLatency(0.0, 0.0, 0.0)
    return UttLatency(first_token=d[0], last_token=d[-1],
                      avg_token=float(np.mean(d)))


def latency_report(per_utt: List[UttLatency],
                   percentiles=(50, 90, 95, 99)) -> Dict[str, Dict]:
    """Mean and percentiles over utterances of each delay kind."""
    out = {}
    for field in ("first_token", "last_token", "avg_token"):
        vals = np.asarray([getattr(u, field) for u in per_utt])
        if len(vals) == 0:
            out[field] = {}
            continue
        out[field] = {
            "mean": float(vals.mean()),
            **{f"p{p}": float(np.percentile(vals, p)) for p in percentiles},
        }
    return out
