"""Batched WFST token-passing beam search on the accelerator.

Replaces Kaldi's `SingleUtteranceNnet3IncrementalDecoder` /
`BatchedThreadedNnet3CudaOnlinePipeline` beam search (reference
src/recognizer.cc:310, src/batch_model.cc:90-92).  The CPU reference walks
linked-list tokens; this is a fixed-shape JAX program after the CUDA
decoder's design (papers 1804.03243 / 1910.10032): fixed-size frontier,
arc expansion over a flattened CSR table, dedup by next-state via
scatter-min, beam + max-active pruning via top-k, backpointer records
emitted per frame for host traceback.

All shapes are static:
  K = max_active (frontier slots; padded with sentinel state S, cost +inf)
  E = emitting-expansion budget, Ee = epsilon-expansion budget
Each decoded frame produces (1 + eps_iters) record levels of K slots each;
traceback walks levels backwards on the host.

Batch dimension = channels (streams); a single jitted scan advances all
channels one chunk at a time.  Dead/padded frames pass the frontier through
unchanged (valid mask), which is how dynamic stream join/leave stays inside
one fixed-shape program (reference: `reset_on_endpoint`, batch_model.cc:72).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..graph.fst import EPSILON, DecodingGraph
from .gather import gather_rows

INF = jnp.float32(jnp.inf)
BIG_I32 = jnp.int32(2**31 - 1)

# device-side trailing-silence tracking: the per-arc pdf field carries a
# silence-pdf flag in bit 30; per-token state "tsil" packs the trailing
# silence frame count (low bits) with a has-speech flag (bit 21).  This is
# what makes endpoint checks O(1): no host traceback needed (the reference
# reads equivalent decoder state at recognizer.cc:318).
SIL_FLAG = jnp.int32(1 << 30)
PDF_MASK = jnp.int32((1 << 30) - 1)
SPEECH_BIT = jnp.int32(1 << 21)
TSIL_MASK = jnp.int32((1 << 21) - 1)
# padded-layout ns fields carry "target state has epsilon arcs" in bit 30,
# so epsilon-closure rounds know their sources without a graph lookup
EPS_NS_FLAG = jnp.int32(1 << 30)
NS_MASK = jnp.int32((1 << 30) - 1)
# v4 record pm-plane flags: bit 30 = arc is silence (device-side only, not
# stored in records), bit 29 = identity carry (masked frame, no arc taken)
PM_SIL_FLAG = jnp.int32(1 << 30)
PM_IDENT_FLAG = jnp.int32(1 << 29)
PM_MASK = jnp.int32((1 << 29) - 1)


@dataclasses.dataclass
class DecodeParams:
    """Pruning semantics match the reference defaults (src/model.cc:134-147)."""

    beam: float = 13.0
    max_active: int = 7000
    lattice_beam: float = 6.0
    acoustic_scale: float = 1.0


class BatchViterbi:
    """Channel-batched streaming Viterbi over one decoding graph."""

    def __init__(
        self,
        graph: DecodingGraph,
        params: DecodeParams,
        expand_budget: Optional[int] = None,
        eps_expand_budget: Optional[int] = None,
        dedup: str = "sort",
        lattice_records: bool = False,
        lattice_budget: Optional[int] = None,
        layout: Optional[str] = None,  # "padded" | "csr" | None (auto)
        padded_max_out: int = 16,
        silence_pdfs=None,
        dedup_slack: float = 2.0,
        eps_budget: int = 1024,
        frame_step: str = "v3",  # "v3" | "v4" | "auto"
        pack: str = "auto",      # "exact3" | "packed16" | "auto"
        optimize_graph: bool = False,
        ragged: bool = True,     # live-prefix bucketed expansion (v4 only)
        cap_m: Optional[int] = None,  # degree cap for optimize_graph
    ):
        if optimize_graph:
            # load-time transform: unlabeled-eps removal + pred-dup degree
            # capping (graph/arrayopt.py).  Min-plus exact; typically leaves
            # the graph eps-free, enabling the v4 single-phase frame step.
            # cap_m tunes the dense-row width M: smaller rows shrink the
            # per-frame arc-row gather and the candidate pool E=K*M at the
            # price of more part-duplicated hub tokens.  Default M=4, exact
            # (min-plus preserving; word parity vs the v3 oracle in
            # tests/test_wer_parity.py).
            from ..graph.arrayopt import prepare_graph_v4

            graph = prepare_graph_v4(
                graph, M=cap_m if cap_m else min(padded_max_out, 4))
        self.graph = graph
        self.params = params
        self.dedup = dedup
        self.lattice_records = lattice_records
        self.silence_pdfs = (
            np.asarray(silence_pdfs, np.int64)
            if silence_pdfs is not None and len(np.asarray(silence_pdfs))
            else np.zeros(0, np.int64)
        )
        S = graph.num_states
        self.S = S
        K = min(params.max_active, max(S, 1))
        self.K = K
        if layout is None:
            layout = "padded" if 0 < graph.max_em_out <= padded_max_out else "csr"
        self.layout = layout
        self.M = max(graph.max_em_out, 1)
        if layout == "padded":
            expand_budget = K * self.M  # each token contributes exactly M slots
        # top_k(k=K) needs at least K candidates, so E >= K always.
        self.E = expand_budget or max(K, 128, min(K * max(graph.max_em_out, 1), 1 << 18))
        self.Ee = eps_expand_budget or max(
            128, min(K * max(graph.max_eps_out, 1), 1 << 18)
        )
        self.Me = 0  # padded eps tables; set by _build_padded_tables
        self.has_eps = graph.num_eps_arcs > 0
        # no eps arcs -> no closure rounds, regardless of claimed depth
        self.eps_iters = graph.eps_depth if self.has_eps else 0
        # lattice candidate budget per level (must fit both candidate pools)
        R = lattice_budget or max(self.K, min(2048, self.E))
        self.R = min(max(R, self.K), self.E, self.K + self.Ee)
        # v3 selection: dedup/top-K run on the cost-ordered top-K2 prefix of
        # the candidate pool (exact when the pool fits; otherwise equivalent
        # to max_active pruning with the duplicate-heavy tail cut first)
        self._dedup_slack = dedup_slack
        self.K2 = max(self.K, int(np.ceil(dedup_slack * K)))
        # v3 eps rounds expand only the best Eb eps-flagged tokens
        self.Eb = max(1, min(K, eps_budget))

        # ---- v4 single-phase frame step (requires padded layout, no eps
        # rounds); "auto" picks v4 whenever eligible
        if frame_step == "auto":
            frame_step = (
                "v4" if (layout == "padded" and self.eps_iters == 0) else "v3"
            )
        if frame_step == "v4" and (layout != "padded" or self.eps_iters != 0):
            raise ValueError(
                "frame_step='v4' needs the padded layout and an eps-free "
                "graph (run with optimize_graph=True)"
            )
        self.frame_step = frame_step
        # ---- arc-table pack: packed16 halves the arc-row gather bytes by
        # quantizing graph weights to float16 (|w| error <= 2^-11 relative;
        # pdf/sil share the low half-word).  "auto": packed16 for v4 when
        # the fields fit, else exact3.
        if pack == "auto":
            pack = "packed16" if frame_step == "v4" else "exact3"
        self.ragged = bool(ragged)
        if pack == "packed16" and frame_step != "v4":
            # the v3 expansion reads 3/4-plane rows; packed16's 2-plane rows
            # would be silently misread as weights.  Explicit packed16 with
            # frame_step='auto' therefore degrades to exact3 when the graph
            # forces the v3 step (e.g. residual epsilons after optimization).
            pack = "exact3"
        self.pack = pack

        # device tables; state-indexed arrays padded so sentinel state S is a
        # zero-out-degree, non-final state.
        g = graph
        # device pdf table carries the silence flag in bit 30 (SIL_FLAG);
        # host-side consumers keep using graph.em_pdf (clean ids)
        if len(g.em_pdf):
            sil_mask = np.isin(g.em_pdf, self.silence_pdfs)
            self._em_pdf_flagged = np.where(
                sil_mask, g.em_pdf | (1 << 30), g.em_pdf
            ).astype(np.int32)
        else:
            self._em_pdf_flagged = np.zeros((1,), np.int32)
        self.em_off = jnp.asarray(np.append(g.em_off, g.em_off[-1]))
        self.em_pdf = jnp.asarray(self._em_pdf_flagged)
        self.em_olabel = jnp.asarray(g.em_olabel) if len(g.em_olabel) else jnp.zeros((1,), jnp.int32)
        self.em_w = jnp.asarray(g.em_w) if len(g.em_w) else jnp.zeros((1,), jnp.float32)
        self.em_next = jnp.asarray(g.em_next) if len(g.em_next) else jnp.zeros((1,), jnp.int32)
        self.eps_off = jnp.asarray(np.append(g.eps_off, g.eps_off[-1]))
        self.eps_olabel = jnp.asarray(g.eps_olabel) if len(g.eps_olabel) else jnp.zeros((1,), jnp.int32)
        self.eps_w = jnp.asarray(g.eps_w) if len(g.eps_w) else jnp.zeros((1,), jnp.float32)
        self.eps_next = jnp.asarray(g.eps_next) if len(g.eps_next) else jnp.zeros((1,), jnp.int32)
        self.final_cost = jnp.asarray(np.append(g.final_cost, np.float32(np.inf)))

        if self.layout == "padded":
            self._build_padded_tables()

        # initial frontier: epsilon closure of the start state, done exactly on
        # host once (tiny).  Initial tokens carry an olabel prefix for traceback.
        self._init_states, self._init_costs, self._init_prefixes = self._initial_closure()

        # Graph tables are passed through jit as ARGUMENTS (self.tables), not
        # captured by closure: closed-over arrays are embedded in the lowered
        # program as literals, which at real-graph scale (a 2M-state pack is
        # ~256 MB) breaks compilation and forces retraces per graph.
        table_keys = [
            "em_off", "em_pdf", "em_olabel", "em_w", "em_next",
            "eps_off", "eps_olabel", "eps_w", "eps_next", "final_cost",
        ]
        if self.layout == "padded":
            table_keys.append("em_pack")
            if self.Me:
                table_keys.append("eps_pack")
        self._table_keys = table_keys
        self.tables = {k: getattr(self, k) for k in table_keys}
        self._decode_jit = jax.jit(self._decode_entry)
        # decoders are shared across recognizer threads (one Model, N
        # recognizers): _decode_entry rebinds self attributes during
        # tracing, so dispatch is serialized under this lock (execution
        # stays async on device; only the enqueue path is locked)
        import threading

        self._dispatch_lock = threading.RLock()

    def clone_with_max_active(self, k: int) -> "BatchViterbi":
        """A decoder over the SAME graph tables with a smaller max_active.

        Device tables (em_pack/eps_pack/...) and host dense views are shared
        by reference; only the K-derived shapes and the jit cache are
        rebuilt.  Used for adaptive max-active: when few tokens are live,
        a small-K variant decodes identically (max_active is an upper
        bound) at a fraction of the per-frame cost.  Padded layout only.
        """
        if self.layout != "padded":
            raise ValueError("clone_with_max_active requires the padded layout")
        c = object.__new__(BatchViterbi)
        c.__dict__.update(self.__dict__)
        c.params = dataclasses.replace(self.params, max_active=k)
        K = min(k, max(self.S, 1))
        c.K = K
        c.E = K * self.M
        c.K2 = max(K, int(np.ceil(self._dedup_slack * K)))
        c.Eb = max(1, min(K, self.Eb))
        c.R = min(max(K, min(2048, c.E)), c.E)
        e_ids = np.arange(c.E, dtype=np.int32)
        c._prevm_const = jnp.asarray(((e_ids // self.M) << self.mbits)
                                     | (e_ids % self.M))
        c._init_states, c._init_costs, c._init_prefixes = c._initial_closure()
        c._decode_jit = jax.jit(c._decode_entry)
        import threading

        c._dispatch_lock = threading.RLock()
        return c

    def resize_frontier(self, frontier, k_new: int):
        """Adapt a frontier pytree between max_active variants.  Selection
        leaves slots cost-sorted, so truncation keeps the best tokens;
        growth pads dead slots (sentinel state, +inf cost)."""
        B, K = frontier["state"].shape
        if k_new == K:
            return frontier
        if k_new < K:
            return {k: v[:, :k_new] for k, v in frontier.items()}
        pad = k_new - K
        fill = {"state": self.S, "cost": jnp.inf, "tsil": 0}
        return {
            k: jnp.concatenate(
                [v, jnp.full((B, pad), fill[k], v.dtype)], axis=1
            )
            for k, v in frontier.items()
        }

    def live_tokens(self, frontier) -> np.ndarray:
        """Per-channel count of live (finite-cost) tokens — the adaptive
        max-active signal (host-side, piggybacks on the endpoint pull)."""
        cost = np.asarray(frontier["cost"])
        return np.isfinite(cost).sum(axis=1)

    def _decode_entry(self, tables, frontier, loglikes, valid):
        """Jit entry point: rebinds the graph tables to the traced arguments
        for the duration of tracing (restored afterwards)."""
        saved = {k: getattr(self, k) for k in tables}
        try:
            for k, v in tables.items():
                setattr(self, k, v)
            return self._decode_chunk_impl(frontier, loglikes, valid)
        finally:
            for k, v in saved.items():
                setattr(self, k, v)

    # ------------------------------------------------------------------ init

    def _build_padded_tables(self) -> None:
        """Dense [S+1, M] arc layout packed into ONE f32 gather row per state.

        v3 packing (3 planes per arc instead of 4 — the row gather is
        latency-bound per row and near-linear in row bytes):
          w    : f32 graph weight (+inf pad)
          nsf  : next state | EPS_NS_FLAG if the target has epsilon arcs
          meta : (olabel << (pdf_bits+1)) | (is_silence << pdf_bits) | pdf
        When the olabel doesn't fit the remaining meta bits, a 4th plane
        carries it separately (self.ol_in_meta False).
        Pad slots: w=+inf, next=S, meta=0."""
        g, S, M = self.graph, self.S, self.M
        if S >= (1 << 30):
            raise ValueError("padded layout supports < 2^30 states")
        A = len(g.em_pdf)
        w = np.full((S + 1, M), np.inf, np.float32)
        nxt = np.full((S + 1, M), S, np.int32)
        pdf = np.zeros((S + 1, M), np.int32)
        ola = np.zeros((S + 1, M), np.int32)
        sil = np.zeros((S + 1, M), np.int32)
        has_eps = np.zeros(S + 1, bool)
        if self.has_eps:
            has_eps[:S] = g.eps_off[1:] > g.eps_off[:-1]
        if A:
            cnt = (g.em_off[1:] - g.em_off[:-1]).astype(np.int64)
            state_of_arc = np.repeat(np.arange(S), cnt)
            pos = np.arange(A) - g.em_off[:-1].astype(np.int64)[state_of_arc]
            w[state_of_arc, pos] = g.em_w
            nxt[state_of_arc, pos] = g.em_next
            pdf[state_of_arc, pos] = g.em_pdf
            sil[state_of_arc, pos] = np.isin(g.em_pdf, self.silence_pdfs)
            ola[state_of_arc, pos] = g.em_olabel
        nsf = np.where(has_eps[nxt], nxt | (1 << 30), nxt).astype(np.int32)

        self.pdf_bits = max(int(pdf.max()).bit_length(), 1)
        if self.pack == "packed16" and self.pdf_bits > 14:
            self.pack = "exact3"  # pdf doesn't fit beside the f16 weight
        ol_bits = 32 - (self.pdf_bits + 1)
        self.ol_in_meta = int(ola.max()) < (1 << ol_bits)
        if self.pack == "packed16":
            # two planes per arc instead of 3-4: fewer bytes per arc-row
            # gather.
            #   plane1 = f16(w) << 16 | sil << 14 | pdf   (pdf_bits <= 14)
            #   plane2 = nsf (next state | EPS_NS_FLAG)
            # olabels are NOT on device: v4 records carry (prev, m) and the
            # host reconstructs olabel/pdf/w from the dense views below.
            w16 = w.astype(np.float16).view(np.uint16).astype(np.uint32)
            p1 = (
                (w16 << 16)
                | (sil.astype(np.uint32) << 14)
                | pdf.astype(np.uint32)
            ).astype(np.uint32)
            self.em_pack = jnp.asarray(
                np.concatenate(
                    [p1.view(np.int32).view(np.float32),
                     nsf.view(np.float32)], axis=1,
                )
            )
        else:
            meta = (
                (sil.astype(np.uint32) << self.pdf_bits) | pdf.astype(np.uint32)
            )
            if self.ol_in_meta:
                meta |= ola.astype(np.uint32) << (self.pdf_bits + 1)
            planes = [w, nsf.view(np.float32), meta.view(np.int32).view(np.float32)]
            if not self.ol_in_meta:
                planes.append(ola.view(np.float32))
            self.em_pack = jnp.asarray(np.concatenate(planes, axis=1))
        # host-side dense views for lattice building (arc id = state*M + m);
        # packed16 stores the f16-rounded weights so host-reconstructed
        # graph costs match the device path costs exactly
        if self.pack == "packed16":
            w = w.astype(np.float16).astype(np.float32)
        self.dense_w, self.dense_next = w, nxt
        self.dense_pdf, self.dense_olabel = pdf, ola
        # static (prev << mbits | m) vector for candidate slot e = prev*M + m
        self.mbits = max((M - 1).bit_length(), 1)
        e_ids = np.arange(self.K * M, dtype=np.int32)
        self._prevm_const = jnp.asarray(
            ((e_ids // M) << self.mbits) | (e_ids % M)
        )

        # padded epsilon tables (w | nsf | olabel | CSR arc idx); the CSR
        # index rides along so lattice records keep CSR eps-arc ids.
        self.Me = 0
        if self.has_eps and g.max_eps_out <= 32:
            Me = max(int(g.max_eps_out), 1)
            An = len(g.eps_next)
            ew = np.full((S + 1, Me), np.inf, np.float32)
            enxt = np.full((S + 1, Me), S, np.int32)
            eola = np.zeros((S + 1, Me), np.int32)
            eidx = np.full((S + 1, Me), -1, np.int32)
            cnt = (g.eps_off[1:] - g.eps_off[:-1]).astype(np.int64)
            st = np.repeat(np.arange(S), cnt)
            pos = np.arange(An) - g.eps_off[:-1].astype(np.int64)[st]
            ew[st, pos] = g.eps_w
            enxt[st, pos] = g.eps_next
            eola[st, pos] = g.eps_olabel
            eidx[st, pos] = np.arange(An, dtype=np.int32)
            ensf = np.where(has_eps[enxt], enxt | (1 << 30), enxt).astype(np.int32)
            self.Me = Me
            self.eps_pack = jnp.asarray(
                np.concatenate(
                    [ew, ensf.view(np.float32), eola.view(np.float32),
                     eidx.view(np.float32)], axis=1,
                )
            )

    def _initial_closure(self):
        import heapq

        g = self.graph
        # transformed graphs (graph/arrayopt.py) carry an explicit initial
        # frontier: the start state's unlabeled-eps closure computed before
        # those eps arcs were removed
        seeds = getattr(g, "init_entries", None) or [(g.start, 0.0)]
        costs = {int(s): float(c) for s, c in seeds}
        prefix: dict[int, tuple] = {int(s): () for s, _ in seeds}
        heap = [(float(c), int(s)) for s, c in seeds]
        heapq.heapify(heap)
        while heap:
            c, s = heapq.heappop(heap)
            if c > costs.get(s, np.inf):
                continue
            for i in range(g.eps_off[s], g.eps_off[s + 1]):
                ns, w, ol = int(g.eps_next[i]), float(g.eps_w[i]), int(g.eps_olabel[i])
                nc = c + w
                if nc < costs.get(ns, np.inf) - 1e-12:
                    costs[ns] = nc
                    prefix[ns] = prefix[s] + ((ol,) if ol != EPSILON else ())
                    heapq.heappush(heap, (nc, ns))
        items = sorted(costs.items(), key=lambda kv: kv[1])[: self.K]
        states = np.full(self.K, self.S, np.int32)
        cost = np.full(self.K, np.inf, np.float32)
        prefixes = []
        for i, (s, c) in enumerate(items):
            states[i] = s
            cost[i] = c
            prefixes.append(list(prefix[s]))
        while len(prefixes) < self.K:
            prefixes.append([])
        return states, cost, prefixes

    def init_frontier(self, batch: int):
        return {
            "state": jnp.tile(jnp.asarray(self._init_states)[None, :], (batch, 1)),
            "cost": jnp.tile(jnp.asarray(self._init_costs)[None, :], (batch, 1)),
            # packed trailing-silence count + has-speech bit per token
            "tsil": jnp.zeros((batch, self.K), jnp.int32),
        }

    # ------------------------------------------------------------- expansion

    def _expand(self, tok_state, tok_cost, off_table, budget):
        """CSR arc expansion with a fixed budget.

        Returns (tok_idx [budget], arc_idx [budget], mask [budget], overflow).
        """
        off = off_table[tok_state]
        cnt = off_table[tok_state + 1] - off
        cum = jnp.cumsum(cnt)
        total = cum[-1]
        e = jnp.arange(budget, dtype=jnp.int32)
        tok = jnp.searchsorted(cum, e, side="right").astype(jnp.int32)
        tok_c = jnp.minimum(tok, self.K - 1)
        base = jnp.where(tok_c > 0, cum[tok_c - 1], 0).astype(jnp.int32)
        arc = off[tok_c] + (e - base)
        mask = e < total
        arc = jnp.where(mask, arc, 0)
        return tok_c, arc, mask, total > budget

    def _dedup_prune(self, ns, cost, mask):
        """Dedup by next state + top-K/beam prune.

        ns/cost/mask: [N] candidates. Returns (sel [K] candidate indices,
        new_state [K], new_cost [K], valid [K]).

        Two strategies:
          - "sort": one lexicographic sort by (state, cost); the first entry
            of each state run is its min — no scatters.
          - "scatter": dense table scatter-min + winner compare (good on CPU
            and for very large N where sort costs more).
        """
        if self.dedup == "sort":
            return self._dedup_prune_sort(ns, cost, mask)
        return self._dedup_prune_scatter(ns, cost, mask)

    def _dedup_prune_scatter(self, ns, cost, mask):
        S, K = self.S, self.K
        beam = self.params.beam
        nsm = jnp.where(mask, ns, S)
        costm = jnp.where(mask, cost, INF)
        table = jnp.full((S + 1,), INF).at[nsm].min(costm)
        best_for_state = table[nsm]
        win = (costm <= best_for_state) & mask
        idx = jnp.arange(ns.shape[0], dtype=jnp.int32)
        owner = jnp.full((S + 1,), BIG_I32).at[nsm].min(jnp.where(win, idx, BIG_I32))
        winner = win & (idx == owner[nsm])
        wcost = jnp.where(winner, costm, INF)
        neg, sel = jax.lax.top_k(-wcost, K)
        new_cost = -neg
        best = new_cost[0]
        keep = new_cost <= best + beam
        new_state = jnp.where(keep, nsm[sel], S)
        new_cost = jnp.where(keep, new_cost, INF)
        return sel, new_state, new_cost, keep

    def _dedup_prune_sort(self, ns, cost, mask):
        S, K = self.S, self.K
        beam = self.params.beam
        nsm = jnp.where(mask, ns, S)
        costm = jnp.where(mask, cost, INF)
        idx = jnp.arange(ns.shape[0], dtype=jnp.int32)
        s_ns, s_cost, s_idx = jax.lax.sort((nsm, costm, idx), num_keys=2)
        first = jnp.concatenate(
            [jnp.ones((1,), bool), s_ns[1:] != s_ns[:-1]]
        )
        winner = first & (s_ns != S) & jnp.isfinite(s_cost)
        wcost = jnp.where(winner, s_cost, INF)
        neg, sel2 = jax.lax.top_k(-wcost, K)
        new_cost = -neg
        best = new_cost[0]
        keep = new_cost <= best + beam
        new_state = jnp.where(keep, s_ns[sel2], S)
        new_cost = jnp.where(keep, new_cost, INF)
        sel = s_idx[sel2]
        return sel, new_state, new_cost, keep

    # ---------------------------------------------------- packed sort helpers
    #
    # The frame step's irregular work runs through sorts and gathers, never
    # scatters: one cost-ordered sort of the full candidate pool carrying
    # packed payloads, then dedup/top-K sorts on a short prefix, then small
    # gathers to reconstruct per-token state.

    @staticmethod
    def _cost_bits(cost):
        """Order-preserving int32 encoding of an f32 cost (monotone: a < b
        <=> bits(a) < bits(b)); +inf maps above all finite costs."""
        cb = jax.lax.bitcast_convert_type(cost, jnp.int32)
        return jnp.where(cb < 0, jnp.int32(-2147483648) - cb, cb)

    @staticmethod
    def _bits_cost(bits):
        raw = jnp.where(bits < 0, jnp.int32(-2147483648) - bits, bits)
        return jax.lax.bitcast_convert_type(raw, jnp.float32)

    def _select_v3(self, cbits, nsf, pay1, pay2, pay3=None):
        """Shared selection core: dedup by next state + top-K + beam prune
        + lattice prefix, from a cost-ordered single sort.

        cbits: [B, N] order-encoded candidate costs (BIG_I32 for masked).
        nsf:   [B, N] flagged next states (sentinel S for masked).
        pay1/pay2/pay3: int32 payloads carried through.

        Returns (kbits, nsf_k, pays_k, lat_prefix) where lat_prefix is the
        cost-ordered top-R rows (cbits, nsf, pay1, pay2, pay3) for lattice
        emission.  Selection semantics match Kaldi's: per-state min (dedup),
        then the best max_active states by cost, then the caller applies
        beam pruning about the best.

        Dedup runs on the cost-ordered top-K2 prefix only (K2 >= 2*K by
        default): exact whenever the pool fits the prefix, and otherwise
        equivalent to Kaldi's max_active pruning with the duplicate-heavy
        tail cut first.
        """
        B, N = cbits.shape
        K, R = self.K, self.R
        ops = (cbits, nsf, pay1, pay2) + (() if pay3 is None else (pay3,))
        sA = jax.lax.sort(ops, num_keys=1, dimension=1)

        def takeR(x, fill):
            if N >= R:
                return x[:, :R]
            return jnp.concatenate(
                [x, jnp.full((B, R - N), fill, x.dtype)], axis=1
            )

        lat_prefix = (
            takeR(sA[0], BIG_I32),
            takeR(sA[1], self.S),
            takeR(sA[2], -1),
            takeR(sA[3], -1),
        ) + (() if pay3 is None else (takeR(sA[4], -1),))

        K2 = min(N, self.K2)
        sub = tuple(x[:, :K2] for x in sA)
        sB = jax.lax.sort((sub[1], sub[0]) + sub[2:], num_keys=2, dimension=1)
        first = jnp.concatenate(
            [jnp.ones((B, 1), bool), sB[0][:, 1:] != sB[0][:, :-1]], axis=1
        )
        alive = first & (sB[0] != self.S) & (sB[1] < BIG_I32)
        key = jnp.where(alive, sB[1], BIG_I32)
        sC = jax.lax.sort((key, sB[0]) + sB[2:], num_keys=1, dimension=1)
        if K2 < K:  # tiny graphs: pool smaller than max_active
            sC = tuple(
                jnp.concatenate(
                    [x, jnp.full((B, K - K2), f, x.dtype)], axis=1
                )
                for x, f in zip(sC, (BIG_I32, self.S, -1, -1, -1))
            )
        kbits = sC[0][:, :K]
        nsf_k = sC[1][:, :K]
        pays_k = tuple(x[:, :K] for x in sC[2:])
        return kbits, nsf_k, pays_k, lat_prefix

    # ------------------------------------------------------------- one frame

    def _frame_step_batched(self, frontier, ll, valid):
        """Whole-batch frame step for the padded layout (v3).

        Structure:
          1. one row gather em_pack[tok_state] -> [B, K, 3M]
          2. candidate costs with the acoustic term gathered from ll
             (ops/gather.py)
          3. one cost-ordered sort of all E=K*M candidates carrying packed
             payloads (nsf, prev|m, meta); its prefix feeds both the lattice
             rows and a short dedup/top-K sort pair
          4. survivors' per-token extras (trailing silence) reconstructed by
             small gathers from the [B, K] frontier tables

        ll: [B, P] acoustic rows; valid: [B] bool.
        """
        cands = self._expand_candidates(
            frontier["state"], frontier["cost"], ll
        )
        return self._finish_from_candidates(frontier, cands, valid)

    def _expand_candidates(self, tok_state, tok_cost, ll, slot_base=0,
                           slot_stride=1):
        """Expand tokens into scored candidates.

        tok_state/tok_cost: [B, Kn] (the full frontier, or a stride-n stripe
        of it for the sharded mode — slot j here is global slot
        slot_base + j*slot_stride, recorded in prevm so tracebacks always
        carry global slot ids).  Returns (cbits, nsm, prevm, metam, olab).
        """
        M, S = self.M, self.S
        scale = self.params.acoustic_scale
        pb, mbits = self.pdf_bits, self.mbits
        pdf_mask = jnp.int32((1 << pb) - 1)
        B, Kn = tok_state.shape
        En = Kn * M

        rows = self.em_pack[tok_state]  # [B, Kn, 3M or 4M] row gather
        w = rows[:, :, :M].reshape(B, En)
        nsf = jax.lax.bitcast_convert_type(rows[:, :, M : 2 * M], jnp.int32).reshape(B, En)
        meta = jax.lax.bitcast_convert_type(rows[:, :, 2 * M : 3 * M], jnp.int32).reshape(B, En)
        olab_sep = None
        if not self.ol_in_meta:
            olab_sep = jax.lax.bitcast_convert_type(
                rows[:, :, 3 * M : 4 * M], jnp.int32
            ).reshape(B, En)
        pdf = meta & pdf_mask
        ac = gather_rows(ll, pdf)
        cost = jnp.repeat(tok_cost, M, axis=1) + w - scale * ac
        mask = jnp.isfinite(w)

        e_ids = np.arange(En, dtype=np.int32)
        prevm_c = jnp.asarray(
            (((e_ids // M) * slot_stride + slot_base) << mbits) | (e_ids % M)
        )
        nsm = jnp.where(mask, nsf, S)
        cbits = jnp.where(mask, self._cost_bits(cost), BIG_I32)
        prevm = jnp.broadcast_to(prevm_c, (B, En))
        metam = jnp.where(mask, meta, 0)
        olab = None if olab_sep is None else jnp.where(mask, olab_sep, 0)
        return cbits, nsm, prevm, metam, olab

    def _finish_from_candidates(self, frontier, cands, valid):
        """Selection + records + eps rounds from a scored candidate pool."""
        K, S = self.K, self.S
        pb, mbits = self.pdf_bits, self.mbits
        pdf_mask = jnp.int32((1 << pb) - 1)
        tok_state, tok_cost = frontier["state"], frontier["cost"]
        B = tok_state.shape[0]
        cbits, nsm, prevm, metam, olab_sep = cands

        kbits, nsf_k, pays_k, lat_prefix = self._select_v3(
            cbits, nsm, prevm, metam, olab_sep
        )
        new_cost = self._bits_cost(kbits)
        keep = (kbits < BIG_I32) & (
            kbits <= self._cost_bits(new_cost[:, :1] + self.params.beam)
        )
        new_state = jnp.where(keep, nsf_k & NS_MASK, S)
        new_cost = jnp.where(keep, new_cost, INF)
        eflag = keep & ((nsf_k & EPS_NS_FLAG) != 0)
        prevm_k, meta_k = pays_k[0], pays_k[1]
        prev = jnp.where(keep, prevm_k >> mbits, 0)
        sil = ((meta_k >> pb) & 1) != 0
        pdf_k = meta_k & pdf_mask
        if self.ol_in_meta:
            olab_k = jax.lax.shift_right_logical(meta_k, pb + 1)
        else:
            olab_k = pays_k[2]

        # trailing-silence update: gather the source token's tsil, then
        # silence arcs extend the run, speech arcs reset it + latch speech
        prev_ts = gather_rows(frontier["tsil"], prev)
        cand_ts = jnp.where(
            sil,
            ((prev_ts & TSIL_MASK) + 1) | (prev_ts & SPEECH_BIT),
            SPEECH_BIT,
        )
        new_tsil = jnp.where(keep, cand_ts, 0)

        rec = {
            "prev": jnp.where(keep, prev, -1),
            "olabel": jnp.where(keep, olab_k, 0),
            "pdf": jnp.where(keep, pdf_k, -1),
        }
        if self.lattice_records:
            lat_cb, lat_nsf = lat_prefix[0], lat_prefix[1]
            lat_prevm, lat_meta = lat_prefix[2], lat_prefix[3]
            lat_cost = self._bits_cost(lat_cb)
            # threshold against the WORST surviving winner, not the frame
            # best: every selected token must keep its inbound lattice arc
            # (a token outside frame_best+lattice_beam can still ancestor
            # the global best path; dropping its arc disconnects the
            # lattice).  Final pruning is retrospective (Lattice.prune).
            wk = jnp.max(
                jnp.where(jnp.isfinite(new_cost), new_cost, -jnp.inf),
                axis=1, keepdims=True,
            )
            lkeep = (lat_cb < BIG_I32) & (
                lat_cost <= wk + self.params.lattice_beam
            )
            rec.update(
                {
                    "lat_ns": jnp.where(lkeep, lat_nsf & NS_MASK, S),
                    "lat_prev": jnp.where(lkeep, lat_prevm >> mbits, -1),
                    # em-level lat_arc stores the in-row arc slot m; hosts
                    # reconstruct the dense arc id as prev_state * M + m
                    "lat_arc": jnp.where(lkeep, lat_prevm & ((1 << mbits) - 1), -1),
                    "lat_cost": jnp.where(lkeep, lat_cost, INF),
                    "f_state": new_state,
                    "f_cost": new_cost,
                }
            )

        # eps closure rounds
        cur_state, cur_cost, cur_tsil = new_state, new_cost, new_tsil
        rec_levels = [rec]
        for _ in range(self.eps_iters):
            if self.Me:
                (cur_state, cur_cost, cur_tsil, eflag), lvl_rec = (
                    self._eps_level_batched(cur_state, cur_cost, cur_tsil, eflag)
                )
            else:
                (cur_state, cur_cost, cur_tsil), lvl_rec = jax.vmap(
                    self._eps_level
                )(cur_state, cur_cost, cur_tsil)
            rec_levels.append(lvl_rec)

        vb = valid[:, None]
        new_frontier = {
            "state": jnp.where(vb, cur_state, tok_state),
            "cost": jnp.where(vb, cur_cost, tok_cost),
            "tsil": jnp.where(vb, cur_tsil, frontier["tsil"]),
        }
        slot = jnp.broadcast_to(jnp.arange(K, dtype=jnp.int32), (B, K))
        ident = {
            "prev": slot,
            "olabel": jnp.zeros((B, K), jnp.int32),
            "pdf": jnp.full((B, K), -1, jnp.int32),
        }
        if self.lattice_records:
            R = self.R
            pad_i = jnp.full((B, R - K), -1, jnp.int32) if R > K else None

            def padk(x, fill):
                if R > K:
                    return jnp.concatenate(
                        [x, jnp.full((B, R - K), fill, x.dtype)], axis=1
                    )
                return x[:, :R]

            ident.update(
                {
                    "f_state": tok_state,
                    "f_cost": tok_cost,
                    "lat_ns": padk(tok_state, S),
                    "lat_prev": padk(slot, -1),
                    "lat_arc": jnp.full((B, R), -1, jnp.int32),
                    "lat_cost": padk(tok_cost, jnp.inf),
                }
            )
        records = {
            k: jnp.stack(
                [
                    jnp.where(
                        vb if lvl[k].ndim == 2 else vb[:, :, None],
                        lvl[k],
                        ident[k],
                    )
                    for lvl in rec_levels
                ],
                axis=1,
            )
            for k in rec_levels[0]
        }
        return new_frontier, records

    # ------------------------------------------------------------- v4 step
    #
    # Single-phase frame step for eps-free padded graphs (graphs through
    # graph/arrayopt.prepare_graph_v4).  Differences vs v3:
    #   * no epsilon-closure rounds, so exactly ONE record level per frame
    #   * packed16 2-plane arc rows by default (f16 weights) — the arc-row
    #     gather is byte-bound
    #   * records carry only (pm = prev|m, state) [+ lattice planes]; the
    #     host reconstructs olabel/pdf/weight from the dense views, so no
    #     olabel/pdf planes are written to HBM per frame
    #   * records keep the scan-native [T, B, ...] layout (no transpose)

    def _unpack_rows_v4(self, tok_state):
        """Gather + unpack arc rows: returns (w f32, nsf i32, sil i32,
        pdf i32), each [B, E]."""
        M = self.M
        B, K = tok_state.shape
        E = K * M
        rows = self.em_pack[tok_state]  # [B, K, 2M or 3M/4M]
        if self.pack == "packed16":
            p1 = jax.lax.bitcast_convert_type(
                rows[:, :, :M], jnp.int32
            ).reshape(B, E)
            nsf = jax.lax.bitcast_convert_type(
                rows[:, :, M : 2 * M], jnp.int32
            ).reshape(B, E)
            w16 = jax.lax.shift_right_logical(p1, 16).astype(jnp.uint16)
            w = jax.lax.bitcast_convert_type(w16, jnp.float16).astype(
                jnp.float32
            )
            sil = jax.lax.shift_right_logical(p1, 14) & 1
            pdf = p1 & jnp.int32((1 << 14) - 1)
            return w, nsf, sil, pdf
        w = rows[:, :, :M].reshape(B, E)
        nsf = jax.lax.bitcast_convert_type(
            rows[:, :, M : 2 * M], jnp.int32
        ).reshape(B, E)
        meta = jax.lax.bitcast_convert_type(
            rows[:, :, 2 * M : 3 * M], jnp.int32
        ).reshape(B, E)
        pdf = meta & jnp.int32((1 << self.pdf_bits) - 1)
        sil = jax.lax.shift_right_logical(meta, self.pdf_bits) & 1
        return w, nsf, sil, pdf

    def _expand_v4(self, tok_state, tok_cost, ll, slot_base=0, slot_stride=1):
        """v4 expansion: tokens -> scored candidates (cbits, nsm, pm), each
        [B, Kn*M].  tok_state/tok_cost may be a stride-n stripe of the
        frontier (sharded mode): local slot j is global slot
        slot_base + j*slot_stride, and pm always carries GLOBAL slot ids so
        tracebacks work unchanged."""
        M, S = self.M, self.S
        scale = self.params.acoustic_scale
        B, Kn = tok_state.shape
        En = Kn * M

        w, nsf, sil, pdf = self._unpack_rows_v4(tok_state)
        ac = gather_rows(ll, pdf)
        cost = jnp.repeat(tok_cost, M, axis=1) + w - scale * ac
        finite = jnp.isfinite(w)
        cbits = jnp.where(finite, self._cost_bits(cost), BIG_I32)
        nsm = jnp.where(finite, nsf & NS_MASK, S)
        if (isinstance(slot_base, int) and slot_base == 0
                and slot_stride == 1 and En == self.E):
            pm_c = self._prevm_const
        else:
            # slot_base may be a traced axis_index in sharded mode
            e_ids = jnp.arange(En, dtype=jnp.int32)
            pm_c = (
                ((e_ids // M) * slot_stride + slot_base) << self.mbits
            ) | (e_ids % M)
        pm = jnp.broadcast_to(pm_c, (B, En)) + (sil.astype(jnp.int32) << 30)
        return cbits, nsm, pm

    def _frame_step_v4(self, frontier, ll, valid):
        """One whole-batch frame step, v4.  ll: [B, P]; valid: [B] bool.
        Returns (frontier, records) with records [B?]-free: {pm, state}
        [B, K] (+ f_cost, lat_pm, lat_cost when lattice_records)."""
        cbits, nsm, pm = self._expand_v4(
            frontier["state"], frontier["cost"], ll
        )
        # one cost-ordered sort carrying the payload planes
        sA = jax.lax.sort((cbits, nsm, pm), num_keys=1, dimension=1)
        return self._select_v4(frontier, sA, valid)

    def _frame_step_v4_bucket(self, frontier, ll, valid, Kb: int):
        """v4 frame step expanding only the first Kb frontier slots.

        EXACT whenever every live (finite-cost) token sits in slots < Kb:
        selection leaves slots cost-sorted with dead (+inf, sentinel-state)
        slots at the end, and dead slots expand to BIG_I32-keyed candidates
        that a stable sort places after every real candidate — so dropping
        them changes nothing.  Output shapes are Kb-independent ([B, K] /
        [B, R]), so buckets can be lax.switch branches."""
        if Kb >= self.K:
            return self._frame_step_v4(frontier, ll, valid)
        cbits, nsm, pm = self._expand_v4(
            frontier["state"][:, :Kb], frontier["cost"][:, :Kb], ll
        )
        sA = jax.lax.sort((cbits, nsm, pm), num_keys=1, dimension=1)
        return self._select_v4(frontier, sA, valid)

    def _frame_step_v4_ragged_unrolled(self, frontier, ll, valid):
        """_frame_step_v4_ragged with the G channel groups UNROLLED instead
        of lax.scan'd: the groups are data-independent, so XLA can schedule
        their (latency-bound, B/G-row) sort pipelines concurrently instead
        of strictly sequentially.  Identical results; more compile time
        (G copies of the bucket switch)."""
        B, K = frontier["state"].shape
        G = self._ragged_G(B)
        if G <= 1:
            return self._frame_step_v4(frontier, ll, valid)
        Bg = B // G
        buckets = self._ragged_buckets()

        finite = jnp.isfinite(frontier["cost"])
        rev_has = jnp.cumsum(finite[:, ::-1].astype(jnp.int32), axis=1) > 0
        extent = jnp.sum(rev_has, axis=1)
        order = jnp.argsort(-extent)
        inv = jnp.argsort(order)

        fr_p = {k: v[order] for k, v in frontier.items()}
        ll_p = ll[order]
        valid_p = valid[order]
        ext_p = extent[order]
        barr = jnp.asarray(np.asarray(buckets, np.int32))
        bidx = jnp.clip(
            jnp.searchsorted(barr, ext_p[:: Bg][:G], side="left"),
            0, len(buckets) - 1,
        )
        branches = [
            (lambda fr_g, ll_g, v_g, Kb=Kb:
             self._frame_step_v4_bucket(fr_g, ll_g, v_g, Kb))
            for Kb in buckets
        ]
        f2_parts, rec_parts = [], []
        for g in range(G):
            fr_g = {k: v[g * Bg: (g + 1) * Bg] for k, v in fr_p.items()}
            f2_g, rec_g = jax.lax.switch(
                bidx[g], branches, fr_g, ll_p[g * Bg: (g + 1) * Bg],
                valid_p[g * Bg: (g + 1) * Bg],
            )
            f2_parts.append(f2_g)
            rec_parts.append(rec_g)
        f2 = {k: jnp.concatenate([p[k] for p in f2_parts], axis=0)[inv]
              for k in f2_parts[0]}
        rec = {k: jnp.concatenate([p[k] for p in rec_parts], axis=0)[inv]
               for k in rec_parts[0]}
        return f2, rec

    def _frame_step_v4_ragged(self, frontier, ll, valid):
        """v4 frame step with live-prefix bucketed expansion over channel
        groups — a fixed-shape answer to data-dependent beam-search work
        (the CUDA decoder's analogue is its per-channel token queues,
        ref. batched online decoding, PAPERS.md 1910.10032):

          * per channel, only the live slot prefix is expanded, rounded up
            to a bucket size (exact: see _frame_step_v4_bucket)
          * channels are sorted by live extent each frame so calm channels
            share small buckets while busy ones pay full K — a lax.scan
            over G groups picks each group's bucket with lax.switch at
            runtime (one trace, data-dependent work inside jit)

        Results are bit-exact vs _frame_step_v4 (tests/test_viterbi_v4.py)."""
        B, K = frontier["state"].shape
        G = self._ragged_G(B)
        if G <= 1:
            return self._frame_step_v4(frontier, ll, valid)
        Bg = B // G
        buckets = self._ragged_buckets()

        finite = jnp.isfinite(frontier["cost"])
        # live EXTENT (last live slot + 1), not count — robust to frontiers
        # that aren't a clean prefix (e.g. hand-built test frontiers)
        rev_has = jnp.cumsum(finite[:, ::-1].astype(jnp.int32), axis=1) > 0
        extent = jnp.sum(rev_has, axis=1)  # [B]
        order = jnp.argsort(-extent)
        inv = jnp.argsort(order)

        fr_p = {k: v[order] for k, v in frontier.items()}
        ll_p = ll[order]
        valid_p = valid[order]
        ext_p = extent[order]
        barr = jnp.asarray(np.asarray(buckets, np.int32))
        bidx = jnp.clip(
            jnp.searchsorted(barr, ext_p[:: Bg][:G], side="left"),
            0, len(buckets) - 1,
        )

        branches = [
            (lambda fr_g, ll_g, v_g, Kb=Kb:
             self._frame_step_v4_bucket(fr_g, ll_g, v_g, Kb))
            for Kb in buckets
        ]

        def gbody(_, xs):
            fr_g, ll_g, v_g, bi = xs
            f2, rec = jax.lax.switch(bi, branches, fr_g, ll_g, v_g)
            return (), (f2, rec)

        stack = (
            {k: v.reshape(G, Bg, *v.shape[1:]) for k, v in fr_p.items()},
            ll_p.reshape(G, Bg, -1),
            valid_p.reshape(G, Bg),
            bidx,
        )
        _, (f2_s, rec_s) = jax.lax.scan(gbody, (), stack)
        f2 = {k: v.reshape(B, *v.shape[2:])[inv] for k, v in f2_s.items()}
        rec = {k: v.reshape(B, *v.shape[2:])[inv] for k, v in rec_s.items()}
        return f2, rec

    def _ragged_G(self, B: int) -> int:
        """Channel-group count for ragged expansion (0 disables)."""
        if self.frame_step != "v4" or not self.ragged:
            return 0
        if self.K < 1024:
            return 0  # nothing to save below one bucket step
        for G in (4, 2):
            if B % G == 0 and B >= 4 * G:
                return G
        return 0

    def _ragged_buckets(self) -> list:
        """Geometric bucket ladder ending at K (ascending)."""
        out, k = [], self.K
        while k > 512:
            out.append(k)
            k = (k + 1) // 2
        out.append(max(k, 1))
        return out[::-1]

    def _select_v4(self, frontier, sA, valid):
        """v4 selection from a cost-ordered candidate pool sA = (cbits, nsm,
        pm), each [B, P_pool] (P_pool = E whole-batch, n*C sharded)."""
        K, S, R = self.K, self.S, self.R
        mbits = self.mbits
        tok_state, tok_cost = frontier["state"], frontier["cost"]
        B = tok_state.shape[0]
        E = sA[0].shape[1]  # candidate pool size

        if self.lattice_records:
            lat_cb = sA[0][:, :R] if E >= R else jnp.pad(
                sA[0], ((0, 0), (0, R - E)), constant_values=BIG_I32
            )
            lat_pm = sA[2][:, :R] if E >= R else jnp.pad(
                sA[2], ((0, 0), (0, R - E)), constant_values=-1
            )

        # dedup by next state on the cost-ordered top-K2 prefix, then
        # winners re-ranked by cost (v3 selection semantics)
        K2 = min(E, self.K2)
        sub = tuple(x[:, :K2] for x in sA)
        sB = jax.lax.sort((sub[1], sub[0], sub[2]), num_keys=2, dimension=1)
        first = jnp.concatenate(
            [jnp.ones((B, 1), bool), sB[0][:, 1:] != sB[0][:, :-1]], axis=1
        )
        alive = first & (sB[0] != S) & (sB[1] < BIG_I32)
        key = jnp.where(alive, sB[1], BIG_I32)
        sC = jax.lax.sort((key, sB[0], sB[2]), num_keys=1, dimension=1)
        if K2 < K:
            sC = tuple(
                jnp.concatenate(
                    [x, jnp.full((B, K - K2), f, x.dtype)], axis=1
                )
                for x, f in zip(sC, (BIG_I32, S, -1))
            )
        kbits = sC[0][:, :K]
        new_cost = self._bits_cost(kbits)
        keep = (kbits < BIG_I32) & (
            kbits <= self._cost_bits(new_cost[:, :1] + self.params.beam)
        )
        new_state = jnp.where(keep, sC[1][:, :K], S)
        new_cost = jnp.where(keep, new_cost, INF)
        pm_k = sC[2][:, :K]
        prev = jax.lax.shift_right_logical(pm_k & PM_MASK, mbits)
        silk = (pm_k & PM_SIL_FLAG) != 0

        prev_ts = gather_rows(frontier["tsil"], jnp.where(keep, prev, 0))
        cand_ts = jnp.where(
            silk,
            ((prev_ts & TSIL_MASK) + 1) | (prev_ts & SPEECH_BIT),
            SPEECH_BIT,
        )
        new_tsil = jnp.where(keep, cand_ts, 0)

        vb = valid[:, None]
        new_frontier = {
            "state": jnp.where(vb, new_state, tok_state),
            "cost": jnp.where(vb, new_cost, tok_cost),
            "tsil": jnp.where(vb, new_tsil, frontier["tsil"]),
        }
        slot = jnp.broadcast_to(jnp.arange(K, dtype=jnp.int32), (B, K))
        ident_pm = PM_IDENT_FLAG | (slot << mbits)
        rec = {
            "pm": jnp.where(
                vb, jnp.where(keep, pm_k & PM_MASK, -1), ident_pm
            ),
            "state": jnp.where(vb, new_state, tok_state),
        }
        if self.lattice_records:
            lat_cost = self._bits_cost(lat_cb)
            # worst-surviving-winner threshold (see _finish_from_candidates):
            # keeps every selected token's inbound arc so the lattice stays
            # connected; retrospective pruning happens in Lattice.prune
            wk = jnp.max(
                jnp.where(jnp.isfinite(new_cost), new_cost, -jnp.inf),
                axis=1, keepdims=True,
            )
            lkeep = (lat_cb < BIG_I32) & (
                lat_cost <= wk + self.params.lattice_beam
            )
            lat_pm_m = jnp.where(lkeep, lat_pm & PM_MASK, -1)
            lat_cost_m = jnp.where(lkeep, lat_cost, INF)
            # identity lattice rows keep masked frames connected
            id_pm = jnp.concatenate(
                [ident_pm, jnp.full((B, R - K), -1, jnp.int32)], axis=1
            ) if R > K else ident_pm[:, :R]
            id_cost = jnp.concatenate(
                [tok_cost, jnp.full((B, R - K), jnp.inf)], axis=1
            ) if R > K else tok_cost[:, :R]
            rec.update(
                {
                    "f_cost": jnp.where(vb, new_cost, tok_cost),
                    "lat_pm": jnp.where(vb, lat_pm_m, id_pm),
                    "lat_cost": jnp.where(vb, lat_cost_m, id_cost),
                }
            )
        return new_frontier, rec

    def _eps_level_batched(self, cur_state, cur_cost, cur_tsil, eflag):
        """One whole-batch epsilon-closure round (v3).

        Only tokens whose state actually has epsilon arcs (eflag, tracked
        via EPS_NS_FLAG on arc targets) are expanded — the top `Eb` of them
        by cost, selected with a cheap top_k.  In real HCLG graphs only a
        few percent of states carry eps arcs, so this replaces a K*Me-wide
        expansion with an Eb*Me one (Eb ~ K/8).  When more than Eb tokens
        carry eps arcs the worst ones are not expanded — the non-emitting
        analogue of max_active pruning.  Frontier tokens ride along as
        identity candidates so states without eps arcs survive the round;
        eps moves consume no frame, so tsil passes through from the source.
        """
        K, Me, S = self.K, self.Me, self.S
        B = cur_state.shape[0]
        Eb = self.Eb
        Ke = Eb * Me

        # pick eps-expansion sources: best Eb eps-flagged tokens
        src_key = jnp.where(eflag, self._cost_bits(cur_cost), BIG_I32)
        neg, src = jax.lax.top_k(-src_key, Eb)  # src: [B, Eb] slot ids
        src_cb = -neg
        src_alive = src_cb < BIG_I32
        src_cost = self._bits_cost(src_cb)
        src_state = gather_rows(cur_state, src)
        rows = self.eps_pack[jnp.where(src_alive, src_state, S)]  # [B, Eb, 4Me]
        w = rows[:, :, :Me].reshape(B, Ke)
        ensf = jax.lax.bitcast_convert_type(rows[:, :, Me : 2 * Me], jnp.int32).reshape(B, Ke)
        eol = jax.lax.bitcast_convert_type(rows[:, :, 2 * Me : 3 * Me], jnp.int32).reshape(B, Ke)
        earc = jax.lax.bitcast_convert_type(rows[:, :, 3 * Me :], jnp.int32).reshape(B, Ke)
        ecost = jnp.repeat(src_cost, Me, axis=1) + w
        emask = jnp.isfinite(w) & jnp.repeat(src_alive, Me, axis=1)

        # candidate pool: identity carries (frontier tokens) + eps targets
        slot = jnp.broadcast_to(jnp.arange(K, dtype=jnp.int32), (B, K))
        id_nsf = jnp.where(
            cur_state == S, S, cur_state | jnp.where(eflag, EPS_NS_FLAG, 0)
        )
        all_cb = jnp.concatenate(
            [self._cost_bits(cur_cost),
             jnp.where(emask, self._cost_bits(ecost), BIG_I32)], axis=1
        )
        all_ns = jnp.concatenate([id_nsf, jnp.where(emask, ensf, S)], axis=1)
        all_prev = jnp.concatenate([slot, jnp.repeat(src, Me, axis=1)], axis=1)
        all_ol = jnp.concatenate(
            [jnp.zeros((B, K), jnp.int32), jnp.where(emask, eol, 0)], axis=1
        )
        all_arc = jnp.concatenate(
            [jnp.full((B, K), -1, jnp.int32), jnp.where(emask, earc, -1)], axis=1
        )

        kbits, nsf_k, pays_k, lat_prefix = self._select_v3(
            all_cb, all_ns, all_prev, all_ol, all_arc
        )
        c2 = self._bits_cost(kbits)
        keep2 = (kbits < BIG_I32) & (
            kbits <= self._cost_bits(c2[:, :1] + self.params.beam)
        )
        st2 = jnp.where(keep2, nsf_k & NS_MASK, S)
        c2 = jnp.where(keep2, c2, INF)
        eflag2 = keep2 & ((nsf_k & EPS_NS_FLAG) != 0)
        prev_k = jnp.where(keep2, pays_k[0], 0)
        # eps moves consume no frame: tsil carries over from the source slot
        ts2 = jnp.where(keep2, gather_rows(cur_tsil, prev_k), 0)
        lvl_rec = {
            "prev": jnp.where(keep2, prev_k, -1),
            "olabel": jnp.where(keep2, pays_k[1], 0),
            "pdf": jnp.full((B, K), -1, jnp.int32),
        }
        if self.lattice_records:
            lat_cb, lat_nsf = lat_prefix[0], lat_prefix[1]
            lat_prev, lat_ol, lat_arc = lat_prefix[2], lat_prefix[3], lat_prefix[4]
            lat_cost = self._bits_cost(lat_cb)
            wk = jnp.max(
                jnp.where(jnp.isfinite(c2), c2, -jnp.inf),
                axis=1, keepdims=True,
            )
            lkeep = (lat_cb < BIG_I32) & (
                lat_cost <= wk + self.params.lattice_beam
            )
            lvl_rec.update(
                {
                    "lat_ns": jnp.where(lkeep, lat_nsf & NS_MASK, S),
                    "lat_prev": jnp.where(lkeep, lat_prev, -1),
                    "lat_arc": jnp.where(lkeep, lat_arc, -1),
                    "lat_cost": jnp.where(lkeep, lat_cost, INF),
                    "f_state": st2,
                    "f_cost": c2,
                }
            )
        return (st2, c2, ts2, eflag2), lvl_rec

    def _eps_level(self, cur_state, cur_cost, cur_tsil):
        """One per-channel epsilon-closure round (vmapped); eps moves
        consume no frame, so tsil passes through from the source token."""
        K = self.K
        toke, arce, maske, _ovfe = self._expand(
            cur_state, cur_cost, self.eps_off, self.Ee
        )
        ecost = cur_cost[toke] + self.eps_w[arce]
        ens = self.eps_next[arce]
        slot = jnp.arange(K, dtype=jnp.int32)
        all_ns = jnp.concatenate([cur_state, ens])
        all_cost = jnp.concatenate([cur_cost, ecost])
        all_mask = jnp.concatenate([cur_state != self.S, maske])
        all_prev = jnp.concatenate([slot, toke])
        all_ol = jnp.concatenate([jnp.zeros(K, jnp.int32), self.eps_olabel[arce]])
        all_ts = jnp.concatenate([cur_tsil, cur_tsil[toke]])
        sel2, st2, c2, keep2 = self._dedup_prune(all_ns, all_cost, all_mask)
        ts2 = jnp.where(keep2, all_ts[sel2], 0)
        lvl_rec = {
            "prev": jnp.where(keep2, all_prev[sel2], -1),
            "olabel": jnp.where(keep2, all_ol[sel2], 0),
            "pdf": jnp.full((K,), -1, jnp.int32),
        }
        if self.lattice_records:
            all_arc = jnp.concatenate([jnp.full((K,), -1, jnp.int32), arce])
            lvl_rec.update(
                self._lattice_level(all_ns, all_cost, all_mask, all_prev, all_arc, c2)
            )
            lvl_rec["f_state"], lvl_rec["f_cost"] = st2, c2
        return (st2, c2, ts2), lvl_rec

    def _frame_step(self, frontier, loglike, valid):
        """Advance one channel one frame (CSR layout).

        loglike: [n_pdf] acoustic row. valid: scalar bool.
        Returns new frontier + per-level records.
        """
        scale = self.params.acoustic_scale
        tok_state, tok_cost = frontier["state"], frontier["cost"]
        tok, arc, mask, _ovf = self._expand(
            tok_state, tok_cost, self.em_off, self.E
        )
        pdf_f = self.em_pdf[arc]
        sil = (pdf_f & SIL_FLAG) != 0
        pdf = pdf_f & PDF_MASK
        cost = tok_cost[tok] + self.em_w[arc] - scale * loglike[pdf]
        ns = self.em_next[arc]
        olab = self.em_olabel[arc]
        prev_ts = frontier["tsil"][tok]
        cand_ts = jnp.where(
            sil,
            ((prev_ts & TSIL_MASK) + 1) | (prev_ts & SPEECH_BIT),
            SPEECH_BIT,
        )
        return self._frame_finish(
            frontier, tok, arc, ns, cost, pdf, olab, cand_ts, mask, valid
        )

    def _frame_finish(self, frontier, tok, arc, ns, cost, pdf, olab, cand_ts,
                      mask, valid):
        K = self.K
        tok_state, tok_cost = frontier["state"], frontier["cost"]
        sel, st1, c1, keep = self._dedup_prune(ns, cost, mask)
        rec_levels = []
        em_rec = {
            "prev": jnp.where(keep, tok[sel], -1),
            "olabel": jnp.where(keep, olab[sel], 0),
            "pdf": jnp.where(keep, pdf[sel], -1),
        }
        cur_tsil = jnp.where(keep, cand_ts[sel], 0)
        if self.lattice_records:
            em_rec.update(self._lattice_level(ns, cost, mask, tok, arc, c1))
            em_rec["f_state"], em_rec["f_cost"] = st1, c1
        rec_levels.append(em_rec)
        cur_state, cur_cost = st1, c1

        # ---- epsilon closure levels
        for _ in range(self.eps_iters):
            (cur_state, cur_cost, cur_tsil), lvl_rec = self._eps_level(
                cur_state, cur_cost, cur_tsil
            )
            rec_levels.append(lvl_rec)

        # ---- valid masking: pass-through when frame is padding
        slot = jnp.arange(K, dtype=jnp.int32)
        new_frontier = {
            "state": jnp.where(valid, cur_state, tok_state),
            "cost": jnp.where(valid, cur_cost, tok_cost),
            "tsil": jnp.where(valid, cur_tsil, frontier["tsil"]),
        }
        ident = {
            "prev": slot,
            "olabel": jnp.zeros(K, jnp.int32),
            "pdf": jnp.full((K,), -1, jnp.int32),
        }
        if self.lattice_records:
            R = self.R
            pad_i32 = jnp.full((R,), -1, jnp.int32)
            ident.update(
                {
                    "f_state": tok_state,
                    "f_cost": tok_cost,
                    # identity carries so lattice stays connected across
                    # masked frames: first K lattice rows mirror the frontier
                    "lat_ns": jnp.concatenate([tok_state, jnp.full((R - K,), self.S, jnp.int32)]) if R > K else tok_state[:R],
                    "lat_prev": jnp.concatenate([slot, pad_i32[: R - K]]) if R > K else slot[:R],
                    "lat_arc": pad_i32,
                    "lat_cost": jnp.concatenate([tok_cost, jnp.full((R - K,), jnp.inf)]) if R > K else tok_cost[:R],
                }
            )
        records = {
            k: jnp.stack(
                [jnp.where(valid, lvl[k], ident[k]) for lvl in rec_levels], 0
            )
            for k in rec_levels[0]
        }
        return new_frontier, records

    def _lattice_level(self, ns, cost, mask, prev, arc, frontier_cost):
        """Top-R candidate arcs of one level, pruned to lattice_beam above the
        level's best cost — the forward links Kaldi's lattice decoder keeps.
        For carry entries (eps levels) arc == -1."""
        R = self.R
        costm = jnp.where(mask, cost, INF)
        neg, sel = jax.lax.top_k(-costm, R)
        lcost = -neg
        best = jnp.min(frontier_cost)
        keep = lcost <= best + self.params.lattice_beam
        return {
            "lat_ns": jnp.where(keep, ns[sel], self.S),
            "lat_prev": jnp.where(keep, prev[sel], -1),
            "lat_arc": jnp.where(keep, arc[sel], -1),
            "lat_cost": jnp.where(keep, lcost, INF),
        }

    # ------------------------------------------------------------- chunk API

    def _decode_chunk_impl(self, frontier, loglikes, valid):
        """loglikes: [B, T, P]; valid: [B, T] bool."""

        def step(car, xs):
            ll, v = xs
            if self.frame_step == "v4":
                B = car["state"].shape[0]
                if self._ragged_G(B) > 1:
                    if getattr(self, "ragged_unroll", False):
                        f2, rec = self._frame_step_v4_ragged_unrolled(
                            car, ll, v)
                    else:
                        f2, rec = self._frame_step_v4_ragged(car, ll, v)
                else:
                    f2, rec = self._frame_step_v4(car, ll, v)
            elif self.layout == "padded":
                f2, rec = self._frame_step_batched(car, ll, v)
            else:
                f2, rec = jax.vmap(self._frame_step)(car, ll, v)
            return f2, rec

        xs = (jnp.swapaxes(loglikes, 0, 1), jnp.swapaxes(valid, 0, 1))
        frontier, recs = jax.lax.scan(step, frontier, xs)
        if self.frame_step != "v4":
            # recs: [T, B, L, K] -> [B, T, L, K]
            recs = {k: jnp.swapaxes(v, 0, 1) for k, v in recs.items()}
        # v4 records stay scan-native [T, B, K] — the post-scan transpose
        # of multi-GB record stacks costs real HBM bandwidth
        best_cost = jnp.min(frontier["cost"], axis=1)
        final_tot = frontier["cost"] + self.final_cost[frontier["state"]]
        best_final_cost = jnp.min(final_tot, axis=1)
        return frontier, recs, best_cost, best_final_cost

    def endpoint_info(self, frontier):
        """O(1) endpoint inputs from the device-tracked token state: per
        channel, the best (non-final) token's trailing-silence frame count
        and whether its path contains speech.  Replaces per-chunk host
        tracebacks (the reference reads equivalent decoder state,
        recognizer.cc:318).  Returns (trailing [B], has_speech [B])."""
        cost = np.asarray(frontier["cost"])
        tsil = np.asarray(frontier["tsil"])
        slot = np.argmin(np.where(np.isfinite(cost), cost, np.inf), axis=1)
        ts = tsil[np.arange(len(slot)), slot]
        return (ts & int(TSIL_MASK), (ts & int(SPEECH_BIT)) != 0)

    def decode_chunk(self, frontier, loglikes, valid=None):
        if valid is None:
            valid = jnp.ones(loglikes.shape[:2], bool)
        with self._dispatch_lock:
            return self._decode_jit(self.tables, frontier, loglikes, valid)

    # ------------------------------------------------- sharded-frontier mode

    def _frame_step_sharded(self, frontier, ll, valid, axis: str, shard_slack: int):
        """One frame with the expansion phase sharded over mesh axis `axis`
        (utterance/search sharding; the reference has no equivalent, its
        scale-out is process-level).

        Each shard expands a round-robin stripe of the cost-sorted frontier
        (stripe i holds every n-th token by cost rank, so shards stay
        balanced), scores its E/n candidates, prunes them against the
        GLOBALLY synced beam threshold (pmin collective over `axis`), and
        contributes its best shard_slack*K/n candidates; an all_gather
        merges the contributions and the regular selection/dedup/lattice/
        eps machinery runs on the merged pool.  Identical to single-device
        decoding whenever no shard has more than shard_slack*K/n candidates
        inside the global beam (striping makes shares ~K/n; the parity test
        asserts exact equality).
        """
        n = jax.lax.axis_size(axis)
        i = jax.lax.axis_index(axis)
        B = frontier["state"].shape[0]
        K = self.K
        assert K % n == 0, "sharded mode needs max_active % n_shards == 0"
        Kn = K // n

        # round-robin stripe: this shard expands global slots g = j*n + i
        def stripe(x):
            return jax.lax.dynamic_index_in_dim(
                x.reshape(B, Kn, n), i, axis=2, keepdims=False
            )

        tok_state = stripe(frontier["state"])
        tok_cost = stripe(frontier["cost"])
        cbits, nsm, prevm, metam, olab = self._expand_candidates(
            tok_state, tok_cost, ll, slot_base=i, slot_stride=n
        )

        # synced beam threshold: the pmin collective (global best cost)
        local_best = jnp.min(cbits, axis=1)  # [B] order-encoded
        global_best = jax.lax.pmin(local_best, axis)
        thresh = self._cost_bits(self._bits_cost(global_best) + self.params.beam)
        inside = cbits <= thresh[:, None]
        cbits = jnp.where(inside, cbits, BIG_I32)

        # per-shard contribution: best C candidates by cost
        C = min(cbits.shape[1], shard_slack * Kn)
        ops = (cbits, nsm, prevm, metam) + (() if olab is None else (olab,))
        sL = jax.lax.sort(ops, num_keys=1, dimension=1)
        contrib = tuple(x[:, :C] for x in sL)
        merged = tuple(
            jax.lax.all_gather(x, axis, axis=1, tiled=True) for x in contrib
        )
        cands = merged + (None,) if olab is None else merged
        return self._finish_from_candidates(frontier, cands, valid)

    def _frame_step_v4_sharded(self, frontier, ll, valid, axis: str,
                               shard_slack: int):
        """v4 variant of `_frame_step_sharded`: the single-phase expansion is
        striped over mesh axis `axis`, the beam threshold is synced with a
        pmin collective, each shard contributes its best shard_slack*K/n
        candidates, and `_select_v4` runs on the all_gather-merged pool.
        Exact vs `_frame_step_v4` whenever no shard overflows its
        contribution budget (tests/test_multichip.py asserts equality)."""
        n = jax.lax.axis_size(axis)
        i = jax.lax.axis_index(axis)
        B = frontier["state"].shape[0]
        K = self.K
        assert K % n == 0, "sharded mode needs max_active % n_shards == 0"
        Kn = K // n

        def stripe(x):
            return jax.lax.dynamic_index_in_dim(
                x.reshape(B, Kn, n), i, axis=2, keepdims=False
            )

        cbits, nsm, pm = self._expand_v4(
            stripe(frontier["state"]), stripe(frontier["cost"]), ll,
            slot_base=i, slot_stride=n,
        )

        # globally synced beam threshold (pmin over the search axis)
        local_best = jnp.min(cbits, axis=1)
        global_best = jax.lax.pmin(local_best, axis)
        thresh = self._cost_bits(self._bits_cost(global_best) + self.params.beam)
        cbits = jnp.where(cbits <= thresh[:, None], cbits, BIG_I32)

        C = min(cbits.shape[1], shard_slack * Kn)
        sL = jax.lax.sort((cbits, nsm, pm), num_keys=1, dimension=1)
        merged = tuple(
            jax.lax.all_gather(x[:, :C], axis, axis=1, tiled=True) for x in sL
        )
        # merged pool = n sorted segments; one sort restores global cost order
        sA = jax.lax.sort(merged, num_keys=1, dimension=1)
        return self._select_v4(frontier, sA, valid)

    def decode_chunk_sharded(self, mesh, frontier, loglikes, valid=None,
                             axis: str = "model", shard_slack: int = 2):
        """decode_chunk with the expansion phase sharded over `axis` of
        `mesh` (channels stay sharded over "data").  Outputs match
        decode_chunk exactly when no shard overflows its contribution
        budget (tests/test_multichip.py asserts this)."""
        from jax.sharding import PartitionSpec as P

        try:
            from jax import shard_map  # jax >= 0.8
        except ImportError:
            from jax.experimental.shard_map import shard_map  # type: ignore

        if valid is None:
            valid = jnp.ones(loglikes.shape[:2], bool)
        key = (id(mesh), axis, shard_slack)
        if getattr(self, "_sharded_key", None) != key:
            rep = P()
            dat = P("data")

            def body(tables, frontier, loglikes, valid):
                saved = {k: getattr(self, k) for k in tables}
                try:
                    for k, v in tables.items():
                        setattr(self, k, v)

                    fstep = (
                        self._frame_step_v4_sharded
                        if self.frame_step == "v4"
                        else self._frame_step_sharded
                    )

                    def step(car, xs):
                        ll, v = xs
                        return fstep(car, ll, v, axis, shard_slack)

                    xs = (jnp.swapaxes(loglikes, 0, 1),
                          jnp.swapaxes(valid, 0, 1))
                    frontier2, recs = jax.lax.scan(step, frontier, xs)
                    recs = {k: jnp.swapaxes(v, 0, 1) for k, v in recs.items()}
                    best = jnp.min(frontier2["cost"], axis=1)
                    final_tot = frontier2["cost"] + self.final_cost[
                        frontier2["state"]
                    ]
                    return frontier2, recs, best, jnp.min(final_tot, axis=1)
                finally:
                    for k, v in saved.items():
                        setattr(self, k, v)

            self._sharded_jit = jax.jit(
                shard_map(
                    body,
                    mesh=mesh,
                    in_specs=(rep, dat, dat, dat),
                    out_specs=(dat, dat, dat, dat),
                    check_vma=False,
                )
            )
            self._sharded_key = key
        return self._sharded_jit(self.tables, frontier, loglikes, valid)

    # ------------------------------------------------------------ host side

    @property
    def lat_arc_is_m(self) -> bool:
        """Padded-layout (v3) em-level lattice records store the in-row arc
        slot m instead of the dense arc id; hosts reconstruct the id as
        prev_state * M + m (see graph/lattice.py, core/src/lattice.cc)."""
        return self.layout == "padded"

    def host_em_arc(self, ai: int) -> tuple[float, int, int]:
        """(graph_weight, olabel, pdf) of an emitting-arc record id — dense
        ids for the padded layout, CSR indices otherwise."""
        if self.layout == "padded":
            s, m = divmod(int(ai), self.M)
            return (
                float(self.dense_w[s, m]),
                int(self.dense_olabel[s, m]),
                int(self.dense_pdf[s, m]),
            )
        g = self.graph
        return float(g.em_w[ai]), int(g.em_olabel[ai]), int(g.em_pdf[ai])

    def traceback(
        self,
        records: list[dict],
        frontier,
        channel: int,
        use_final: bool = True,
        at_start: bool = True,
        init_states=None,
    ) -> tuple[float, list[int], list[int]]:
        """Best-path traceback on host.

        Returns (cost, olabels, per-frame pdf alignment).
        """
        cost, ols_frames, pdfs = self.traceback_with_frames(
            records, frontier, channel, use_final, at_start, init_states
        )
        return cost, [o for o, _ in ols_frames], pdfs

    def traceback_with_frames(
        self,
        records: list[dict],
        frontier,
        channel: int,
        use_final: bool = True,
        at_start: bool = True,
        init_states=None,
    ) -> tuple[float, list[tuple[int, int]], list[int]]:
        """Best-path traceback with frame indices.

        records: list of per-chunk record pytrees ({prev, olabel, pdf} each
        [B, T, L, K]; v4: {pm, state} each [T, B, K]).  Returns
        (cost, [(olabel, frame_idx)], pdf alignment) where frame_idx counts
        *valid decoded frames* from utterance start (identity records of
        masked frames don't count).

        init_states: [K] graph states of the frontier PRECEDING records[0]
        — required for v4 records when at_start=False (fold-boundary
        anchoring: the first frame's arc sources live in that frontier, not
        in the utterance-initial closure).  v3 records carry olabel/pdf
        inline and ignore it.
        """
        if records and "pm" in records[0]:
            return self._traceback_v4(
                records, frontier, channel, use_final, at_start, init_states
            )
        state = np.asarray(frontier["state"][channel])
        cost = np.asarray(frontier["cost"][channel])
        fc = np.asarray(self.final_cost)[state]
        tot = cost + fc
        if use_final and np.isfinite(tot).any():
            slot = int(np.argmin(tot))
            best_cost = float(tot[slot])
        else:
            slot = int(np.argmin(cost))
            best_cost = float(cost[slot])
        if not np.isfinite(cost[slot]):
            return np.inf, [], []

        # total valid frames = count of level-0 records with pdf >= 0 along
        # the path; first pass collects raw entries, then frames are numbered.
        raw: list[tuple[int, bool, int]] = []  # (olabel, is_frame_level, pdf)
        for rec in reversed(records):
            prev = np.asarray(rec["prev"][channel])  # [T, L, K]
            olab = np.asarray(rec["olabel"][channel])
            pdf = np.asarray(rec["pdf"][channel])
            T, L, _ = prev.shape
            for t in range(T - 1, -1, -1):
                for lvl in range(L - 1, -1, -1):
                    if slot < 0:
                        return best_cost, [], []
                    raw.append(
                        (int(olab[t, lvl, slot]), lvl == 0, int(pdf[t, lvl, slot]))
                    )
                    slot = int(prev[t, lvl, slot])

        n_valid = sum(1 for _, isf, p in raw if isf and p >= 0)
        pdfs = [0] * n_valid
        ols_frames: list[tuple[int, int]] = []
        fidx = n_valid  # walking backwards; current frame = fidx - 1
        for ol, is_frame, p in raw:
            if ol != 0:
                ols_frames.append((ol, max(fidx - 1, 0)))
            if is_frame and p >= 0:
                fidx -= 1
                pdfs[fidx] = p
        # initial-closure olabel prefix of the starting slot (frame 0);
        # skipped when the records don't reach utterance start (at_start
        # False: folded-window mode, the caller holds the frozen prefix)
        if at_start and 0 <= slot < len(self._init_prefixes):
            for ol in reversed(self._init_prefixes[slot]):
                ols_frames.append((ol, 0))
        ols_frames.reverse()
        return best_cost, ols_frames, pdfs

    def _traceback_v4(
        self, records, frontier, channel, use_final=True, at_start=True,
        init_states=None,
    ):
        """Best-path traceback for v4 records ({pm, state} each [T, B, K]).

        olabel/pdf/weight come from the host dense views keyed by
        (source state, arc slot m); the device never writes them.
        init_states anchors frame 0's arc sources at a fold boundary
        (at_start=False); required there because v4 records don't carry
        olabel/pdf planes the way v3 records do."""
        if init_states is None:
            if not at_start:
                raise ValueError(
                    "v4 traceback with at_start=False needs init_states "
                    "(the fold-boundary frontier's state row)"
                )
            init_states = self._init_states
        state = np.asarray(frontier["state"][channel])
        cost = np.asarray(frontier["cost"][channel])
        fc = np.asarray(self.final_cost)[state]
        tot = cost + fc
        if use_final and np.isfinite(tot).any():
            slot = int(np.argmin(tot))
            best_cost = float(tot[slot])
        else:
            slot = int(np.argmin(cost))
            best_cost = float(cost[slot])
        if not np.isfinite(cost[slot]):
            return np.inf, [], []

        pm_fr, st_fr = [], []
        for rec in records:
            pm = np.asarray(rec["pm"][:, channel])  # [T, K]
            st = np.asarray(rec["state"][:, channel])
            for t in range(pm.shape[0]):
                pm_fr.append(pm[t])
                st_fr.append(st[t])

        mmask = (1 << self.mbits) - 1
        ident = int(PM_IDENT_FLAG)
        steps: list[tuple[int, int, int]] = []  # (t, prev, m), backwards
        for t in range(len(pm_fr) - 1, -1, -1):
            pmv = int(pm_fr[t][slot])
            if pmv < 0:
                return best_cost, [], []
            if pmv & ident:
                slot = (pmv & int(PM_MASK)) >> self.mbits
                continue
            prev = pmv >> self.mbits
            steps.append((t, prev, pmv & mmask))
            slot = prev
        steps.reverse()

        ols_frames: list[tuple[int, int]] = []
        pdfs: list[int] = []
        for fidx, (t, prev, m) in enumerate(steps):
            # source state of the arc: the prev slot's state one frame back
            if t > 0:
                src_state = int(st_fr[t - 1][prev])
            else:
                src_state = int(init_states[prev])
            pdfs.append(int(self.dense_pdf[src_state, m]))
            ol = int(self.dense_olabel[src_state, m])
            if ol:
                ols_frames.append((ol, fidx))
        if at_start and 0 <= slot < len(self._init_prefixes):
            prefix = [
                (ol, 0) for ol in self._init_prefixes[slot]
            ]
            ols_frames = prefix + ols_frames
        return best_cost, ols_frames, pdfs
