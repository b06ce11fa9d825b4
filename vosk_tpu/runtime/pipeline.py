"""Fused streaming pipeline: features -> TDNN-F -> token passing in ONE
jitted step over the channel batch.

This is the analogue of the reference's single CUDA pipeline launch per
dynamic batch (`BatchedThreadedNnet3CudaOnlinePipeline::DecodeBatch`): one
compiled program advances all channels by one 0.2 s chunk, keeping all
streaming state on device.  Used by bench and the scale paths; the
object-per-stream API (runtime/batch.py) drives the same building blocks.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..io.native import NativeModel
from ..ops.features import FeatureExtractor
from ..ops.viterbi import BatchViterbi, DecodeParams


class FusedPipeline:
    def __init__(
        self,
        model: NativeModel,
        batch: int,
        chunk_seconds: float = 0.2,
        mesh=None,
        collect_records: bool = True,
        expand_budget: Optional[int] = None,
        lattice_records: bool = False,
        lattice_budget: Optional[int] = None,
        frame_step: str = "auto",
        optimize_graph: Optional[bool] = None,
        cap_m: Optional[int] = None,
        dedup_slack: Optional[float] = None,
        ragged_unroll: bool = False,
    ):
        self.model = model
        self.B = batch
        self.ex = model.feature_extractor()
        self.am = model.make_am()
        if optimize_graph is None:
            # default: run the exact load-time transforms (eps removal +
            # degree capping) so eligible graphs take the v4 single-phase
            # frame step — the production fast path
            optimize_graph = frame_step in ("auto", "v4")
        self.dec = BatchViterbi(
            model.graph,
            DecodeParams(
                beam=model.config.beam,
                max_active=model.config.max_active,
                lattice_beam=model.config.lattice_beam,
                acoustic_scale=model.config.acoustic_scale,
            ),
            expand_budget=expand_budget,
            lattice_records=lattice_records,
            lattice_budget=lattice_budget,
            silence_pdfs=model.silence_pdfs,
            frame_step=frame_step,
            optimize_graph=optimize_graph,
            cap_m=cap_m,
            **({"dedup_slack": dedup_slack} if dedup_slack else {}),
        )
        self.dec.ragged_unroll = ragged_unroll
        self.rate = model.config.sample_rate
        self.chunk_samples = int(chunk_seconds * self.rate)
        self.F = self.ex.stream_max_frames(self.chunk_samples)
        self.collect_records = collect_records
        self.mesh = mesh
        # adaptive max-active ladder (run_adaptive); ascending, capped by
        # the model's max_active
        self.adaptive_ladder = (1024, 2048, 4096)

        params = self.am.params
        if mesh is not None:
            from ..parallel import mesh as pm

            params = pm.shard_am_params(mesh, params)
            # graph tables are identical on every device: replicate them
            # explicitly so channel-sharded decode doesn't pull from chip 0
            rep = pm.replicated(mesh)
            self.dec.tables = {
                k: jax.device_put(v, rep) for k, v in self.dec.tables.items()
            }
        self.params = params
        self._step = jax.jit(self._step_impl)

    def init_state(self):
        st = {
            "feat": self.ex.init_stream_state(self.B, self.chunk_samples),
            "am": self.am.init_stream_state(self.B, self.F),
            "frontier": self.dec.init_frontier(self.B),
        }
        if self.mesh is not None:
            from ..parallel import mesh as pm

            st = {k: pm.shard_channel_state(self.mesh, v) for k, v in st.items()}
        return st

    def _step_impl(self, params, tables, state, audio, n_samples, ll_bias=None):
        feat_state, feats, fvalid = self.ex._extract_chunk_impl(
            state["feat"], audio, None, n_samples
        )
        am_state, ll, lvalid = self.am._process_chunk_impl(
            params, state["am"], feats, fvalid, None
        )
        if ll_bias is not None:
            # benchmark hook: structured acoustic scores added to the AM
            # output so the decoder sees plausible-path dynamics
            ll = ll * 1e-3 + ll_bias
        frontier, recs, best, bestf = self.dec._decode_entry(
            tables, state["frontier"], ll, lvalid
        )
        new_state = {"feat": feat_state, "am": am_state, "frontier": frontier}
        if not self.collect_records:
            recs = None
        return new_state, recs, best, bestf, jnp.sum(lvalid, axis=1)

    def step(self, state, audio: np.ndarray, n_samples=None):
        """audio: [B, chunk_samples]. Returns (state, records|None, best,
        best_final, frames_decoded[B])."""
        if n_samples is None:
            n_samples = jnp.full((self.B,), audio.shape[1], jnp.int32)
        return self._step(self.params, self.dec.tables, state, audio, n_samples)

    def run_scan(self, state, audio, n_samples=None, ll_bias=None):
        """Advance many chunks in ONE device program via lax.scan.

        audio: [T, B, chunk_samples] pre-staged chunks.  Minimizes host
        round-trips — the shape for offline batch jobs and benchmarking.
        ll_bias: optional [T, B, F, P] acoustic bias (see _step_impl).
        Returns (state, stacked records|None, best [T, B]).
        """
        return self._run_scan_for(self.dec, state, audio, n_samples, ll_bias)

    def _run_scan_for(self, dec, state, audio, n_samples=None, ll_bias=None):
        key = (id(dec), ll_bias is not None)
        if not hasattr(self, "_scan_jits"):
            self._scan_jits = {}
        if key not in self._scan_jits:
            def step_impl(params, tables, st, a, n, lb):
                feat_state, feats, fvalid = self.ex._extract_chunk_impl(
                    st["feat"], a, None, n
                )
                am_state, ll, lvalid = self.am._process_chunk_impl(
                    params, st["am"], feats, fvalid, None
                )
                if lb is not None:
                    ll = ll * 1e-3 + lb
                frontier, recs, best, bestf = dec._decode_entry(
                    tables, st["frontier"], ll, lvalid
                )
                st2 = {"feat": feat_state, "am": am_state, "frontier": frontier}
                if not self.collect_records:
                    recs = None
                return st2, recs, best

            def scan_fn(params, tables, state, audio, n_samples, ll_bias):
                def body(st, xs):
                    if ll_bias is None:
                        a, n = xs
                        lb = None
                    else:
                        a, n, lb = xs
                    st2, recs, best = step_impl(params, tables, st, a, n, lb)
                    return st2, (recs, best)

                xs = (audio, n_samples) if ll_bias is None else (
                    audio, n_samples, ll_bias)
                return jax.lax.scan(body, state, xs)

            self._scan_jits[key] = jax.jit(scan_fn, static_argnames=())
        if n_samples is None:
            n_samples = jnp.full(audio.shape[:2], audio.shape[2], jnp.int32)
        state, (recs, best) = self._scan_jits[key](
            self.params, dec.tables, state, audio, n_samples, ll_bias
        )
        return state, recs, best

    # ---------------------------------------------------- adaptive max-active

    def run_adaptive(self, state, audio, n_samples=None, ll_bias=None,
                     seg: int = 8, headroom: float = 0.75):
        """run_scan in segments with an adaptive max_active ladder.

        max_active is an UPPER BOUND on live tokens (Kaldi semantics): when
        beam pruning keeps fewer tokens live, decoding at a smaller
        max_active variant is identical and cheaper (the frame step's work
        scales ~linearly in K).  Between segments the host reads the live
        token count and picks the smallest variant k with live <= headroom*k
        for the next segment; a segment that fills a small variant steps up
        on the next boundary (transiently equivalent to a tighter
        max_active — the same adaptation Kaldi's own beam logic applies).

        Returns (state, [per-segment records|None], best [T, B]).
        """
        if not getattr(self, "_adaptive_decs", None):
            ladder = [k for k in self.adaptive_ladder if k < self.dec.params.max_active]
            clones = [self.dec.clone_with_max_active(k) for k in ladder]
            for c in clones:
                # the ladder already adapts K per segment; ragged expansion
                # inside each clone would mostly re-adapt the same slack at
                # 5x the compile cost (one lax.switch branch per bucket)
                c.ragged = False
            self._adaptive_decs = clones + [self.dec]
        decs = self._adaptive_decs
        T = audio.shape[0]
        if n_samples is None:
            n_samples = jnp.full(audio.shape[:2], audio.shape[2], jnp.int32)
        # initial rung from the INCOMING frontier's live count: fresh
        # utterances (initial closure, few live tokens) start small, but a
        # carried mid-stream frontier must not be truncated to the lowest
        # rung (that would silently tighten max_active for a whole first
        # segment on every call)
        live0 = int(self.dec.live_tokens(state["frontier"]).max())
        cur = next(
            (i for i, d in enumerate(decs) if live0 <= headroom * d.K),
            len(decs) - 1,
        )
        recs_out, best_out = [], []
        for t0 in range(0, T, seg):
            t1 = min(t0 + seg, T)
            dec = decs[cur]
            state = dict(state)
            state["frontier"] = self.dec.resize_frontier(
                state["frontier"], dec.K
            )
            state, recs, best = self._run_scan_for(
                dec, state, audio[t0:t1],
                n_samples[t0:t1],
                None if ll_bias is None else ll_bias[t0:t1],
            )
            recs_out.append(recs)
            best_out.append(best)
            live = int(dec.live_tokens(state["frontier"]).max())
            cur = next(
                (i for i, d in enumerate(decs) if live <= headroom * d.K),
                len(decs) - 1,
            )
        return state, recs_out, jnp.concatenate(best_out, axis=0)
