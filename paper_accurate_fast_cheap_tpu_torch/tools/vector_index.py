"""Cosine-similarity vector index (port of the JAX
``tools/vector_index.py``, numpy only): named, L2-normalised embeddings
with an optional payload, exact cosine search, or an IVF coarse quantizer
(k-means over the normalised vectors, seeded 0; the ``nprobe`` nearest
lists are searched) once the index holds more than 4 x ``nlist`` vectors,
and ``.npz`` persistence.  ``bin/write_embeddings.py --build_index`` writes
one per layer.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


def _normalize(x: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(n, 1e-12)


@dataclasses.dataclass
class SearchHit:
    name: str
    score: float          # cosine similarity
    payload: str = ""


class VectorIndex:
    """Cosine index over named embeddings."""

    def __init__(self, dim: int, nlist: int = 0):
        self.dim = dim
        self.nlist = nlist
        self.names: List[str] = []
        self.payloads: List[str] = []
        self._vecs = np.zeros((0, dim), np.float32)
        self._centroids: Optional[np.ndarray] = None
        self._assign: Optional[np.ndarray] = None

    # -- building ---------------------------------------------------------
    def add(self, names: Sequence[str], vecs: np.ndarray,
            payloads: Optional[Sequence[str]] = None) -> None:
        vecs = _normalize(np.asarray(vecs, np.float32))
        if vecs.shape[1] != self.dim:
            raise ValueError(f"dim {vecs.shape[1]} != index dim {self.dim}")
        self.names.extend(names)
        self.payloads.extend(payloads if payloads is not None
                             else [""] * len(names))
        self._vecs = np.concatenate([self._vecs, vecs], axis=0)
        self._centroids = None  # invalidate coarse quantizer

    def _train_ivf(self, iters: int = 10, seed: int = 0) -> None:
        """k-means (cosine == L2 on normalized vectors) coarse lists."""
        n = len(self._vecs)
        k = min(self.nlist, n)
        rng = np.random.RandomState(seed)
        cent = self._vecs[rng.choice(n, k, replace=False)]
        for _ in range(iters):
            sim = self._vecs @ cent.T
            assign = np.argmax(sim, axis=1)
            for j in range(k):
                m = assign == j
                if m.any():
                    cent[j] = _normalize(self._vecs[m].mean(0))
        self._centroids = cent
        self._assign = assign

    # -- search -----------------------------------------------------------
    def search(self, query: np.ndarray, k: int = 5,
               nprobe: int = 8) -> List[SearchHit]:
        if not len(self._vecs):
            return []
        q = _normalize(np.asarray(query, np.float32).reshape(-1))
        if self.nlist and len(self._vecs) > 4 * self.nlist:
            if self._centroids is None:
                self._train_ivf()
            lists = np.argsort(-(self._centroids @ q))[:nprobe]
            cand = np.flatnonzero(np.isin(self._assign, lists))
        else:
            cand = np.arange(len(self._vecs))
        sims = self._vecs[cand] @ q
        top = cand[np.argsort(-sims)[:k]]
        return [SearchHit(self.names[i], float(self._vecs[i] @ q),
                          self.payloads[i]) for i in top]

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        np.savez_compressed(
            path, dim=self.dim, nlist=self.nlist, vecs=self._vecs,
            names=np.asarray(self.names, dtype=object),
            payloads=np.asarray(self.payloads, dtype=object))

    @classmethod
    def load(cls, path: str) -> "VectorIndex":
        z = np.load(path, allow_pickle=True)
        idx = cls(int(z["dim"]), int(z["nlist"]))
        idx._vecs = z["vecs"].astype(np.float32)
        idx.names = [str(x) for x in z["names"]]
        idx.payloads = [str(x) for x in z["payloads"]]
        return idx
