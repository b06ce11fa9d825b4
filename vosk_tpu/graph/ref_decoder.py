"""Exact host-side Viterbi over an StdFst — the correctness oracle for the
device token-passing program (tests compare against this; the reference's
behavioral contract is Kaldi's LatticeFasterDecoder best path).

Pure numpy/dict implementation, no pruning (or wide beam), full traceback
with epsilon arcs so output-label sequences are exact.
"""
from __future__ import annotations

import heapq
from typing import Optional

import numpy as np

from .fst import EPSILON, StdFst


def ref_decode(
    fst: StdFst,
    loglikes: np.ndarray,
    acoustic_scale: float = 1.0,
    ilabel_to_pdf: Optional[np.ndarray] = None,
) -> tuple[float, list[int], list[int]]:
    """Exact Viterbi.

    loglikes: [T, n_pdf] acoustic log-likelihood rows; arc cost for an
    emitting arc with ilabel l at frame t is
    ``w - acoustic_scale * loglikes[t, pdf(l)]`` with pdf(l) = l-1 by default.

    Returns (best_total_cost, word_olabels, frame_olabel_alignment) where
    word_olabels includes epsilons removed and alignment maps each output
    symbol to nothing in particular (words may sit on eps arcs) — we return
    the olabel sequence in path order.
    """
    T = loglikes.shape[0]

    def pdf(il: int) -> int:
        return int(ilabel_to_pdf[il]) if ilabel_to_pdf is not None else il - 1

    # cost maps per "level": after eps closure at time t
    # Each entry: state -> (cost, backpointer) ; backpointer = (prev_state_level, arc)
    # We store full per-level maps for traceback.
    def eps_closure(costs: dict, bp: dict, level_tag):
        """Dijkstra-style closure over epsilon arcs (exact even with cycles)."""
        heap = [(c, s) for s, c in costs.items()]
        heapq.heapify(heap)
        while heap:
            c, s = heapq.heappop(heap)
            if c > costs.get(s, np.inf):
                continue
            for il, ol, w, ns in fst.arcs[s]:
                if il != EPSILON:
                    continue
                nc = c + w
                if nc < costs.get(ns, np.inf) - 1e-12:
                    costs[ns] = nc
                    bp[ns] = (s, (il, ol, w, ns), level_tag)
                    heapq.heappush(heap, (nc, ns))
        return costs, bp

    levels = []  # list of (costs, bp) after closure at each time
    costs = {fst.start: 0.0}
    bp: dict = {fst.start: None}
    costs, bp = eps_closure(costs, bp, "eps")
    levels.append((dict(costs), dict(bp)))

    for t in range(T):
        ncosts: dict = {}
        nbp: dict = {}
        for s, c in costs.items():
            for il, ol, w, ns in fst.arcs[s]:
                if il == EPSILON:
                    continue
                nc = c + w - acoustic_scale * float(loglikes[t, pdf(il)])
                if nc < ncosts.get(ns, np.inf):
                    ncosts[ns] = nc
                    nbp[ns] = (s, (il, ol, w, ns), "em")
        ncosts, nbp = eps_closure(ncosts, nbp, "eps")
        costs, bp = ncosts, nbp
        levels.append((dict(costs), dict(bp)))
        if not costs:
            return np.inf, [], []

    # pick best final (or best overall if no final reachable)
    best_state, best_cost, used_final = None, np.inf, False
    for s, c in costs.items():
        fc = fst.final[s]
        if fc != np.inf and c + fc < best_cost:
            best_state, best_cost, used_final = s, c + fc, True
    if best_state is None:
        for s, c in costs.items():
            if c < best_cost:
                best_state, best_cost = s, c

    # traceback (eps entries stay within a level; em entries step back a frame)
    olabels: list[int] = []
    t = T
    s = best_state
    while True:
        entry = levels[t][1][s]
        if entry is None:
            break  # reached the start state at level 0
        prev_s, (il, ol, w, ns), kind = entry
        if ol != EPSILON:
            olabels.append(ol)
        if kind == "em":
            t -= 1
        s = prev_s
    olabels.reverse()
    return best_cost, olabels, []
