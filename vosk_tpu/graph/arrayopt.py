"""Array-level decoding-graph transforms for the device frame step.

Operates directly on the flattened CSR `DecodingGraph` (numpy), so it
scales to multi-million-state graphs where the python-object `StdFst`
transforms in graph/optimize.py would be too slow.

Two transforms, composed by `prepare_graph_v4`:

- `remove_epsilons_arrays`: eliminate UNLABELED (olabel==0) epsilon arcs by
  fanning every arc that targets an eps-source state out to that state's
  weighted epsilon closure.  Min-plus path costs are preserved exactly
  (weights composed as float64, stored float32).  Labeled epsilon arcs
  (word-emitting backoffs) are kept in the eps tables, with their targets
  closure-fanned the same way.  Graphs whose eps arcs are all unlabeled
  come out with ZERO eps arcs -> the decoder runs no epsilon-closure
  rounds at all (the single biggest per-frame saving at the honest
  operating point: each closure round costs a selection pass).

- `cap_degree_pred_dup`: cap emitting out-degree at M by splitting
  high-degree states into parts and DUPLICATING the arcs that enter them
  (one copy per part), instead of linking parts with epsilon arcs the way
  graph/optimize.py:split_high_degree does.  This keeps the graph
  epsilon-free.  Token recombination still happens per part, and every
  reference path maps 1:1 onto a path here, so best-path results are
  identical; the only semantic drift is that a hub token occupies
  `parts` frontier slots, slightly tightening effective max_active at
  the cap (same order of drift as the reference's own hash-table
  collisions in the CUDA decoder, cf. paper 1804.03243).

The reference decodes HCLG graphs with epsilon (backoff) arcs in place
(Kaldi LatticeIncrementalDecoder processes non-emitting arcs each frame,
consumed via /root/reference/src/recognizer.cc:310); eliminating them at
load is the fixed-shape equivalent: one dense, eps-free [state, M] arc
table per frame step.
"""
from __future__ import annotations

import numpy as np

from .fst import DecodingGraph


def _csr_src(off: np.ndarray) -> np.ndarray:
    """Source-state id per CSR arc."""
    cnt = (off[1:] - off[:-1]).astype(np.int64)
    return np.repeat(np.arange(len(cnt), dtype=np.int64), cnt)


def _dedup_min(src, dst, w):
    """Keep the min-weight arc per (src, dst) pair."""
    if len(src) == 0:
        return src, dst, w
    order = np.lexsort((w, dst, src))
    src, dst, w = src[order], dst[order], w[order]
    first = np.ones(len(src), bool)
    first[1:] = (src[1:] != src[:-1]) | (dst[1:] != dst[:-1])
    return src[first], dst[first], w[first]


def eps_closure_arrays(
    g: DecodingGraph, max_iters: int = 4096
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Weighted closure over UNLABELED eps arcs, restricted to useful
    targets.

    Returns (cl_src, cl_dst, cl_w, useful) where (cl_src, cl_dst, cl_w)
    are closure entries s ->* t (t useful, t != s or not; identity entries
    are NOT included) and `useful` marks states that can hold a token
    meaningfully: emitting arcs, labeled eps arcs, or finality.
    """
    S = g.num_states
    eps_src = _csr_src(g.eps_off)
    rem = g.eps_olabel == 0
    r_src = eps_src[rem]
    r_dst = g.eps_next[rem].astype(np.int64)
    r_w = g.eps_w[rem].astype(np.float64)

    em_cnt = (g.em_off[1:] - g.em_off[:-1]).astype(np.int64)
    lab_cnt = np.zeros(S, np.int64)
    if (~rem).any():
        np.add.at(lab_cnt, eps_src[~rem], 1)
    useful = (em_cnt > 0) | (lab_cnt > 0) | np.isfinite(g.final_cost)

    has_rem = np.zeros(S, bool)
    has_rem[r_src] = True
    # CSR over removable eps arcs for composition joins
    order = np.argsort(r_src, kind="stable")
    r_src, r_dst, r_w = r_src[order], r_dst[order], r_w[order]
    r_off = np.zeros(S + 1, np.int64)
    np.add.at(r_off, r_src + 1, 1)
    r_off = np.cumsum(r_off)

    # closure accumulates (s, t, w); frontier = newly improved entries
    c_src, c_dst, c_w = r_src.copy(), r_dst.copy(), r_w.copy()
    c_src, c_dst, c_w = _dedup_min(c_src, c_dst, c_w)
    f_src, f_dst, f_w = c_src, c_dst, c_w
    for _ in range(max_iters):
        ext = has_rem[f_dst]
        if not ext.any():
            break
        es, ed, ew = f_src[ext], f_dst[ext], f_w[ext]
        cnt = (r_off[ed + 1] - r_off[ed]).astype(np.int64)
        n_src = np.repeat(es, cnt)
        n_w0 = np.repeat(ew, cnt)
        # positions into r arrays for each expansion
        base = np.repeat(r_off[ed], cnt)
        pos = np.arange(len(n_src)) - np.repeat(
            np.cumsum(cnt) - cnt, cnt
        )
        idx = base + pos
        n_dst = r_dst[idx]
        n_w = n_w0 + r_w[idx]
        keep = n_src != n_dst  # drop eps self-cycles (never improve)
        n_src, n_dst, n_w = n_src[keep], n_dst[keep], n_w[keep]
        if len(n_src) == 0:
            break
        # merge with closure; keep entries that improved
        a_src = np.concatenate([c_src, n_src])
        a_dst = np.concatenate([c_dst, n_dst])
        a_w = np.concatenate([c_w, n_w])
        is_new = np.concatenate(
            [np.zeros(len(c_src), bool), np.ones(len(n_src), bool)]
        )
        order = np.lexsort((is_new, a_w, a_dst, a_src))
        a_src, a_dst, a_w, is_new = (
            a_src[order], a_dst[order], a_w[order], is_new[order]
        )
        first = np.ones(len(a_src), bool)
        first[1:] = (a_src[1:] != a_src[:-1]) | (a_dst[1:] != a_dst[:-1])
        improved = first & is_new
        c_src, c_dst, c_w = a_src[first], a_dst[first], a_w[first]
        f_src, f_dst, f_w = a_src[improved], a_dst[improved], a_w[improved]
        if len(f_src) == 0:
            break

    keep = useful[c_dst]
    return c_src[keep], c_dst[keep], c_w[keep], useful


def remove_epsilons_arrays(g: DecodingGraph) -> DecodingGraph:
    """Eliminate unlabeled epsilon arcs (see module docstring).

    Every arc (emitting or labeled-eps) whose target t has an unlabeled-eps
    closure is fanned out: one copy per closure entry (t', w + w_cl), plus
    the original iff t itself is useful.  Unlabeled eps arcs are dropped;
    labeled eps arcs are kept.  The start state's closure is recorded as
    `init_entries` [(state, cost), ...] for the decoder's initial frontier.
    """
    S = g.num_states
    cl_src, cl_dst, cl_w, useful = eps_closure_arrays(g)
    # per-state fan-out lists: identity (t, 0) iff useful[t], plus closure
    fan_src = np.concatenate(
        [np.flatnonzero(useful).astype(np.int64), cl_src]
    )
    fan_dst = np.concatenate(
        [np.flatnonzero(useful).astype(np.int64), cl_dst]
    )
    fan_w = np.concatenate([np.zeros(int(useful.sum())), cl_w])
    order = np.argsort(fan_src, kind="stable")
    fan_src, fan_dst, fan_w = fan_src[order], fan_dst[order], fan_w[order]
    fan_off = np.zeros(S + 1, np.int64)
    np.add.at(fan_off, fan_src + 1, 1)
    fan_off = np.cumsum(fan_off)
    fan_cnt = fan_off[1:] - fan_off[:-1]

    def fan_arcs(src, dst, w, *payloads):
        """Replace each arc by its target's fan-out set."""
        cnt = fan_cnt[dst]
        rsrc = np.repeat(src, cnt)
        rw0 = np.repeat(w.astype(np.float64), cnt)
        base = np.repeat(fan_off[dst], cnt)
        pos = np.arange(len(rsrc)) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        idx = base + pos
        rdst = fan_dst[idx]
        rw = (rw0 + fan_w[idx]).astype(np.float32)
        rpay = [np.repeat(p, cnt) for p in payloads]
        return rsrc, rdst, rw, rpay

    # ---- emitting arcs
    em_src = _csr_src(g.em_off)
    e_src, e_dst, e_w, (e_pdf, e_ol) = fan_arcs(
        em_src, g.em_next.astype(np.int64), g.em_w, g.em_pdf, g.em_olabel
    )
    # dedup identical (src, dst, pdf, olabel) keeping min weight: fanning
    # can create duplicates when two eps paths reach the same target
    if len(e_src):
        order = np.lexsort((e_w, e_ol, e_pdf, e_dst, e_src))
        e_src, e_dst, e_w = e_src[order], e_dst[order], e_w[order]
        e_pdf, e_ol = e_pdf[order], e_ol[order]
        first = np.ones(len(e_src), bool)
        first[1:] = (
            (e_src[1:] != e_src[:-1]) | (e_dst[1:] != e_dst[:-1])
            | (e_pdf[1:] != e_pdf[:-1]) | (e_ol[1:] != e_ol[:-1])
        )
        e_src, e_dst, e_w = e_src[first], e_dst[first], e_w[first]
        e_pdf, e_ol = e_pdf[first], e_ol[first]
        order = np.argsort(e_src, kind="stable")
        e_src, e_dst, e_w = e_src[order], e_dst[order], e_w[order]
        e_pdf, e_ol = e_pdf[order], e_ol[order]
    em_off = np.zeros(S + 1, np.int64)
    np.add.at(em_off, e_src + 1, 1)
    em_off = np.cumsum(em_off)

    # ---- labeled eps arcs: kept, targets fanned
    eps_src = _csr_src(g.eps_off)
    lab = g.eps_olabel != 0
    l_src, l_dst, l_w, (l_ol,) = fan_arcs(
        eps_src[lab],
        g.eps_next[lab].astype(np.int64),
        g.eps_w[lab],
        g.eps_olabel[lab],
    )
    eps_off = np.zeros(S + 1, np.int64)
    np.add.at(eps_off, l_src + 1, 1)
    eps_off = np.cumsum(eps_off)

    # ---- start closure
    init_entries = [(int(g.start), 0.0)] if useful[g.start] else []
    st_mask = cl_src == g.start
    for t, w in zip(cl_dst[st_mask], cl_w[st_mask]):
        init_entries.append((int(t), float(w)))
    if not init_entries:
        init_entries = [(int(g.start), 0.0)]

    em_cnt2 = em_off[1:] - em_off[:-1]
    eps_cnt2 = eps_off[1:] - eps_off[:-1]
    g2 = DecodingGraph(
        num_states=S,
        start=g.start,
        em_off=em_off.astype(np.int32),
        em_pdf=e_pdf.astype(np.int32),
        em_olabel=e_ol.astype(np.int32),
        em_w=e_w.astype(np.float32),
        em_next=e_dst.astype(np.int32),
        eps_off=eps_off.astype(np.int32),
        eps_olabel=l_ol.astype(np.int32),
        eps_w=l_w.astype(np.float32),
        eps_next=l_dst.astype(np.int32),
        final_cost=g.final_cost,
        eps_depth=_eps_depth_arrays(eps_off, l_dst, S) if len(l_src) else 0,
        max_em_out=int(em_cnt2.max()) if len(e_src) else 0,
        max_eps_out=int(eps_cnt2.max()) if len(l_src) else 0,
    )
    g2.init_entries = init_entries
    return g2


def _eps_depth_arrays(eps_off, eps_next, S, cap: int = 10) -> int:
    depth = np.zeros(S, np.int64)
    src = _csr_src(eps_off)
    dst = eps_next
    for _ in range(cap):
        nd = np.zeros(S, np.int64)
        np.maximum.at(nd, dst, depth[src] + 1)
        nd = np.minimum(nd, cap)
        if (nd <= depth).all():
            break
        depth = np.maximum(depth, nd)
    return int(depth.max()) if S else 0


def cap_degree_pred_dup(
    g: DecodingGraph, M: int, max_iters: int = 40
) -> DecodingGraph:
    """Cap emitting out-degree at M by pred-duplication splitting.

    Requires an eps-free graph (run remove_epsilons_arrays first when the
    graph has only unlabeled eps arcs); labeled-eps graphs fall back to
    graph/optimize.py's eps-link splitting at prepare time.
    """
    if g.num_eps_arcs:
        raise ValueError("cap_degree_pred_dup requires an eps-free graph")
    em_off = g.em_off.astype(np.int64)
    em_next = g.em_next.astype(np.int64)
    em_pdf, em_ol, em_w = g.em_pdf, g.em_olabel, g.em_w
    S = g.num_states
    A = len(em_next)
    cnt = em_off[1:] - em_off[:-1]
    if A == 0 or cnt.max() <= M:
        return g

    # ---- phase 1: fixpoint on part counts only.  An arc into t costs
    # parts[t] slots post-duplication, so parts[s] must satisfy
    # parts[s] = ceil(sum_{arcs a of s} parts[target(a)] / M); iterate
    # monotonically (self-loops on hubs make this genuinely recursive).
    src = _csr_src(em_off)
    parts = np.ones(S, np.int64)
    budget = 4 * A
    for _ in range(max_iters):
        slots = np.zeros(S, np.int64)
        np.add.at(slots, src, parts[em_next])
        new_parts = np.maximum(-(-slots // np.int64(M)), 1)
        if (new_parts <= parts).all():
            break
        parts = np.maximum(parts, new_parts)
        if int(parts[src].sum()) > budget:  # cheap over-estimate
            raise ValueError(
                f"cap_degree_pred_dup(M={M}) diverging (arc growth > 4x); "
                "use a larger M"
            )
    else:
        raise ValueError(
            f"cap_degree_pred_dup(M={M}) did not converge in {max_iters} "
            "iterations; use a larger M"
        )

    # ---- phase 2: single-pass build.  Expanded arc list: each original
    # arc (CSR order) becomes parts[target] copies targeting the parts;
    # each source state's expanded list is chunked M-at-a-time into its
    # own parts.
    extra = parts - 1
    part_base = np.cumsum(extra) - extra  # extra-id block start per state
    n_extra = int(extra.sum())
    S2 = S + n_extra

    exp_cnt = parts[em_next]  # copies per original arc
    r = np.repeat(np.arange(A, dtype=np.int64), exp_cnt)
    p = np.arange(len(r), dtype=np.int64) - np.repeat(
        np.cumsum(exp_cnt) - exp_cnt, exp_cnt
    )
    tgt0 = em_next[r]
    d_dst = np.where(p == 0, tgt0, S + part_base[tgt0] + p - 1)
    d_pdf, d_ol, d_w = em_pdf[r], em_ol[r], em_w[r]

    # position of each expanded arc within its source state's expanded list
    exp_src = src[r]
    state_slots = np.zeros(S, np.int64)
    np.add.at(state_slots, src, exp_cnt)
    state_start = np.zeros(S + 1, np.int64)
    state_start[1:] = np.cumsum(state_slots)
    pos_in_state = np.arange(len(r), dtype=np.int64) - state_start[exp_src]
    part_of_arc = pos_in_state // np.int64(M)
    d_src = np.where(
        part_of_arc == 0, exp_src, S + part_base[exp_src] + part_of_arc - 1
    )
    # expanded arcs are already grouped by source state and chunk order, so
    # d_src is nondecreasing in part-id blocks per state; build CSR by count
    em_off2 = np.zeros(S2 + 1, np.int64)
    np.add.at(em_off2, d_src + 1, 1)
    em_off2 = np.cumsum(em_off2)
    order = np.argsort(d_src, kind="stable")
    d_src, d_dst = d_src[order], d_dst[order]
    d_pdf, d_ol, d_w = d_pdf[order], d_ol[order], d_w[order]

    final_cost = np.concatenate(
        [g.final_cost, np.full(n_extra, np.inf, np.float32)]
    )  # finality on part0 only (min over parts unchanged)
    init_entries = list(getattr(g, "init_entries", None) or
                        [(int(g.start), 0.0)])
    for st, c in list(init_entries):
        for p2 in range(1, int(parts[st])):
            init_entries.append((int(S + part_base[st] + p2 - 1), float(c)))

    cnt2 = em_off2[1:] - em_off2[:-1]
    assert int(cnt2.max()) <= M
    g2 = DecodingGraph(
        num_states=S2,
        start=g.start,
        em_off=em_off2.astype(np.int32),
        em_pdf=d_pdf.astype(np.int32),
        em_olabel=d_ol.astype(np.int32),
        em_w=d_w.astype(np.float32),
        em_next=d_dst.astype(np.int32),
        eps_off=np.zeros(S2 + 1, np.int32),
        eps_olabel=np.zeros(0, np.int32),
        eps_w=np.zeros(0, np.float32),
        eps_next=np.zeros(0, np.int32),
        final_cost=final_cost,
        eps_depth=0,
        max_em_out=int(cnt2.max()),
        max_eps_out=0,
    )
    g2.init_entries = init_entries
    return g2


def prepare_graph_v4(g: DecodingGraph, M: int = 8) -> DecodingGraph:
    """remove_epsilons_arrays + cap_degree_pred_dup, when applicable.

    Graphs with labeled eps arcs keep them (the decoder runs closure
    rounds for those); degree capping then falls back to leaving the
    degree as-is if the graph is not eps-free (the padded layout will use
    the larger M).
    """
    g2 = remove_epsilons_arrays(g)
    if g2.num_eps_arcs == 0:
        try:
            return cap_degree_pred_dup(g2, M)
        except ValueError:
            # degree capping diverged at this M: try doubling once
            try:
                return cap_degree_pred_dup(g2, 2 * M)
            except ValueError:
                pass
    # capping failed (cyclic high-degree cores — pred-dup cannot converge
    # there) or labeled eps arcs remain.  Epsilon removal can FAN degrees
    # up dramatically on LM-backoff structures (r5: a 600-word trie graph
    # went 16 -> 42 max degree, 0.09M -> 1.4M arcs); when the blowup is
    # severe, prefer the ORIGINAL graph: its (tree-shaped, shallow) eps
    # arcs are handled exactly by the padded eps-closure rounds, and the
    # dense layout keeps the small M.  Mild growth keeps the eps-free
    # graph (it still unlocks the single-phase v4 step).
    # scale guard: on small graphs the wider rows are cheap and the
    # eps-free single-phase step always wins; the blowup only matters at
    # production scale where E = K*M drives the per-frame cost.
    if (g2.num_states >= 50_000
            and g2.max_em_out > max(16, 2 * max(g.max_em_out, M))):
        return g
    return g2
