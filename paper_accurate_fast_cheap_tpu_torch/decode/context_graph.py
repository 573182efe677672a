"""Context graph for shallow-fusion keyword biasing (port of the JAX
``decode/context_graph.py``).

A token trie over the biasing phrases with Aho-Corasick fail links:
extending a partial match adds ``context_score`` a token, falling off a
partial match takes the accumulated boost back, and completing a phrase
keeps it.  The CTC prefix beam search (``decode/search.py``) walks it.
Host code, no tensors.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple


class ContextState:
    __slots__ = ("token", "score", "total_score", "is_end", "next",
                 "fail", "output")

    def __init__(self, token: int = -1, score: float = 0.0,
                 total_score: float = 0.0, is_end: bool = False):
        self.token = token
        self.score = score              # boost gained entering this node
        self.total_score = total_score  # boost accumulated from the root
        self.is_end = is_end
        self.next: Dict[int, "ContextState"] = {}
        self.fail: Optional["ContextState"] = None
        self.output: Optional["ContextState"] = None


class ContextGraph:
    def __init__(self, phrases: List[List[int]],
                 context_score: float = 3.0):
        """phrases: the token-id sequences to bias toward."""
        self.context_score = context_score
        self.root = ContextState()
        self.root.fail = self.root
        for phrase in phrases:
            node = self.root
            for i, tok in enumerate(phrase):
                if tok not in node.next:
                    node.next[tok] = ContextState(
                        token=tok, score=context_score,
                        total_score=node.total_score + context_score,
                        is_end=(i == len(phrase) - 1))
                elif i == len(phrase) - 1:
                    node.next[tok].is_end = True
                node = node.next[tok]
        self._build_fail_links()

    def _build_fail_links(self):
        q = deque()
        for node in self.root.next.values():
            node.fail = self.root
            q.append(node)
        while q:
            cur = q.popleft()
            for tok, nxt in cur.next.items():
                f = cur.fail
                while tok not in f.next and f is not self.root:
                    f = f.fail
                nxt.fail = f.next.get(tok, self.root)
                if nxt.fail is nxt:
                    nxt.fail = self.root
                out = nxt.fail
                nxt.output = out if out.is_end else out.output
                q.append(nxt)

    def forward_one_step(self, state: ContextState,
                         token: int) -> Tuple[float, ContextState]:
        """Advance by one token: (score delta, new state).  The delta takes
        back the partial match's boost when the match dies."""
        node = state
        while token not in node.next and node is not self.root:
            node = node.fail
        if token in node.next:
            nxt = node.next[token]
            delta = nxt.total_score - state.total_score
            if nxt.is_end and not nxt.next:
                # a completed phrase with no continuation: back to the
                # root, the boost kept
                return delta, self.root
            return delta, nxt
        return -state.total_score, self.root

    def finalize(self, state: ContextState) -> float:
        """The adjustment when decoding ends inside a phrase: the partial
        boost is dropped unless the state completes a phrase."""
        if state.is_end:
            return 0.0
        return -state.total_score
