"""Online i-vector extraction as batched GEMMs.

Replaces Kaldi's `OnlineIvectorFeature` (used by the reference's feature
pipeline when a model ships an `ivector/` dir, src/model.cc:247-263):
per frame, splice+LDA the MFCCs, pick the top `num_gselect` diagonal-UBM
Gaussians on the CMVN'd stream, turn their log-likelihoods into pruned
posteriors, accumulate zeroth/first-order stats on the non-CMVN'd stream,
and solve the i-vector posterior mean

    (I + sum_g gamma_g M_g^T Sigma_g^{-1} M_g) x
        = prior_offset * e0 + sum_g M_g^T Sigma_g^{-1} x_g

Everything is channel-batched: UBM log-likes and stats are [B, ...] float32
matmuls at full precision (`HIGHEST`); the solve is a small batched linear
system.  Silence weighting (reference recognizer.cc:226-237) enters
retroactively through `reweight(frame_ids, weights)` over a bounded ring of
recent per-frame stats, matching `OnlineSilenceWeighting::GetDeltaWeights`
semantics without unbounded history.

Deviations from Kaldi (documented, small):
  * online CMVN for the posterior stream subtracts the global mean only
    (Kaldi interpolates utterance stats with the global prior).
  * frames older than the reweight ring keep their original weight.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..io.kaldi_ivector import IvectorDirConfig

_HIGHEST = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HIGHEST)


@dataclasses.dataclass
class _Tables:
    lda: jnp.ndarray          # [Do, Ds]
    lda_offset: jnp.ndarray   # [Do]
    miv: jnp.ndarray          # [G, D] means * invvars
    ivars: jnp.ndarray        # [G, D]
    gconsts: jnp.ndarray      # [G]
    proj: jnp.ndarray         # [G, I, D]  M_g^T Sigma_g^{-1}
    U: jnp.ndarray            # [G, I, I]  M_g^T Sigma_g^{-1} M_g
    cmvn_mean: jnp.ndarray    # [Din]


class OnlineIvectorExtractor:
    """Streaming i-vector extractor over B channels.

    A frame's stats are accumulated once it has `splice_right` frames of
    real right context (`flush()` emits the tail with edge-copy context).
    Recent frames' contributions live in a ring so silence weighting can
    retroactively reweight them by absolute frame index.
    """

    def __init__(self, cfg: IvectorDirConfig, chunk_frames: int = 32,
                 ring: int = 64):
        self.cfg = cfg
        g = cfg.dubm
        ie = cfg.extractor
        self.G, self.D = g.num_gauss, ie.feat_dim
        self.I = ie.ivector_dim
        self.Q = min(cfg.num_gselect, self.G)
        self.ring = ring
        self.splice_l, self.splice_r = cfg.splice_left, cfg.splice_right
        self.period = cfg.ivector_period
        self.T = chunk_frames

        lda = cfg.lda.astype(np.float32)
        Din = cfg.global_cmvn.shape[1] - 1
        self.Din = Din
        spliced = Din * (self.splice_l + self.splice_r + 1)
        if lda.shape[1] == spliced + 1:
            lda_m, lda_off = lda[:, :-1], lda[:, -1]
        else:
            lda_m, lda_off = lda, np.zeros(lda.shape[0], np.float32)

        stats = cfg.global_cmvn
        count = max(float(stats[0, -1]), 1.0)
        mean = (stats[0, :-1] / count).astype(np.float32)

        proj = np.einsum("gdi,gde->gie", ie.M, ie.sigma_inv).astype(np.float32)
        U = np.einsum("gie,gej->gij", proj, ie.M).astype(np.float32)

        self.t = _Tables(
            lda=jnp.asarray(lda_m),
            lda_offset=jnp.asarray(lda_off),
            miv=jnp.asarray(g.means_invvars),
            ivars=jnp.asarray(g.inv_vars),
            gconsts=jnp.asarray(g.gconsts),
            proj=jnp.asarray(proj),
            U=jnp.asarray(U),
            cmvn_mean=jnp.asarray(mean),
        )
        self.prior_offset = float(ie.prior_offset)
        self._update_jit = jax.jit(self._update_impl, static_argnames=("flush",))
        self._reweight_jit = jax.jit(self._reweight_impl)

    # ------------------------------------------------------------- state

    def init_state(self, batch: int):
        ctx = self.splice_l + self.splice_r
        H = ctx + self.T + 4
        return {
            "gamma": jnp.zeros((batch, self.G), jnp.float32),
            "xstat": jnp.zeros((batch, self.G, self.D), jnp.float32),
            "hist": jnp.zeros((batch, H, self.Din), jnp.float32),
            "hist_len": jnp.zeros((batch,), jnp.int32),
            "feats_seen": jnp.zeros((batch,), jnp.int32),
            "centers_done": jnp.zeros((batch,), jnp.int32),
            "ring_idx": jnp.zeros((batch, self.ring, self.Q), jnp.int32),
            "ring_post": jnp.zeros((batch, self.ring, self.Q), jnp.float32),
            "ring_y": jnp.zeros((batch, self.ring, self.D), jnp.float32),
            "ring_w": jnp.ones((batch, self.ring), jnp.float32),
            "ring_pos": jnp.zeros((batch,), jnp.int32),
        }

    # ----------------------------------------------------------- pipeline

    def _splice_lda(self, frames, cmvn: bool):
        """frames: [B, T+l+r, Din] -> [B, T, D]."""
        l, r = self.splice_l, self.splice_r
        if cmvn:
            frames = frames - self.t.cmvn_mean
        B, Tc, Din = frames.shape
        T = Tc - l - r
        win = [frames[:, i : i + T] for i in range(l + r + 1)]
        spliced = jnp.concatenate(win, axis=2)
        return _mm(spliced, self.t.lda.T) + self.t.lda_offset

    def _update_impl(self, state, feats, valid, flush=False):
        """Append one chunk and accumulate stats for every center frame that
        now has full right context (all of them, edge-copied, if flush).

        feats: [B, T, Din] raw MFCC frames; valid: [B, T] bool (prefix).
        """
        B, T, Din = feats.shape
        l, r = self.splice_l, self.splice_r
        hist, hist_len = state["hist"], state["hist_len"]
        H = hist.shape[1]
        O = T + (r if flush else 0)  # max centers emitted this call

        # ---- shift-append valid frames into hist (StreamingAm pattern)
        n_new = jnp.sum(valid, axis=1).astype(jnp.int32)
        col = jax.lax.broadcasted_iota(jnp.int32, (B, H), 1)
        overflow = jnp.maximum(hist_len + n_new - H, 0)
        src = jnp.clip(col + overflow[:, None], 0, H - 1)
        hist = jnp.take_along_axis(hist, src[:, :, None], axis=1)
        hist_len2 = hist_len - overflow
        fsrc = jnp.clip(col - hist_len2[:, None], 0, T - 1)
        newf = jnp.take_along_axis(feats, fsrc[:, :, None], axis=1)
        write = (col >= hist_len2[:, None]) & (col < (hist_len2 + n_new)[:, None])
        hist = jnp.where(write[:, :, None], newf, hist)
        hist_len3 = hist_len2 + n_new
        feats_seen = state["feats_seen"] + n_new
        done = state["centers_done"]

        # centers ready: full right context (or everything seen, if flush)
        total_ready = jnp.maximum(feats_seen - r, 0)
        if flush:
            total_ready = feats_seen
        n_emit = jnp.clip(total_ready - done, 0, O)

        # ---- window: centers done..done+O-1 with l left / r right context,
        # clamped to the stream edges (edge replication)
        W = O + l + r
        hist_base = feats_seen - hist_len3
        want0 = done - l
        wcol = jax.lax.broadcasted_iota(jnp.int32, (B, W), 1)
        abs_pos = jnp.clip(
            want0[:, None] + wcol, 0, jnp.maximum(feats_seen - 1, 0)[:, None]
        )
        widx = jnp.clip(abs_pos - hist_base[:, None], 0, H - 1)
        window = jnp.take_along_axis(hist, widx[:, :, None], axis=1)

        y = self._splice_lda(window, cmvn=False)   # [B, O, D] stats stream
        yc = self._splice_lda(window, cmvn=True)   # [B, O, D] posterior stream

        ll = (
            _mm(yc, self.t.miv.T)
            - 0.5 * _mm(yc * yc, self.t.ivars.T)
            + self.t.gconsts
        )
        top, idx = jax.lax.top_k(ll, self.Q)       # [B, O, Q]
        post = jax.nn.softmax(top, axis=-1)
        post = jnp.where(post >= self.cfg.min_post, post, 0.0)
        post = post / jnp.maximum(jnp.sum(post, axis=-1, keepdims=True), 1e-9)
        emask = (
            jax.lax.broadcasted_iota(jnp.int32, (B, O), 1) < n_emit[:, None]
        )
        post = post * (emask.astype(jnp.float32) * self.cfg.posterior_scale)[:, :, None]

        onehot = jax.nn.one_hot(idx, self.G, dtype=jnp.float32)  # [B,O,Q,G]
        pg = jnp.einsum("btq,btqg->btg", post, onehot, precision=_HIGHEST)
        gamma = state["gamma"] + jnp.sum(pg, axis=1)
        xstat = state["xstat"] + jnp.einsum("btg,btd->bgd", pg, y,
                                            precision=_HIGHEST)

        # ---- ring of per-center contributions (absolute center index
        # done+j lands in slot (ring_pos+j) % ring)
        ring = self.ring
        pos = state["ring_pos"]
        tcol = jax.lax.broadcasted_iota(jnp.int32, (B, O), 1)
        slot = (pos[:, None] + tcol) % ring
        bcol = jax.lax.broadcasted_iota(jnp.int32, (B, O), 0)
        sel = emask[:, :, None]
        ring_idx = state["ring_idx"].at[bcol, slot].set(
            jnp.where(sel, idx, state["ring_idx"][bcol, slot])
        )
        ring_post = state["ring_post"].at[bcol, slot].set(
            jnp.where(sel, post, state["ring_post"][bcol, slot])
        )
        ring_y = state["ring_y"].at[bcol, slot].set(
            jnp.where(sel, y, state["ring_y"][bcol, slot])
        )
        ring_w = state["ring_w"].at[bcol, slot].set(
            jnp.where(emask, 1.0, state["ring_w"][bcol, slot])
        )

        return {
            "gamma": gamma,
            "xstat": xstat,
            "hist": hist,
            "hist_len": hist_len3,
            "feats_seen": feats_seen,
            "centers_done": done + n_emit,
            "ring_idx": ring_idx,
            "ring_post": ring_post,
            "ring_y": ring_y,
            "ring_w": ring_w,
            "ring_pos": (pos + n_emit) % ring,
        }

    def _reweight_impl(self, state, frame_ids, new_weights):
        """Retroactively change weights of recent frames (silence weighting).

        frame_ids: [B, N] absolute frame indices (-1 = ignore);
        new_weights: [B, N].  Frames older than the ring keep their
        original weight (bounded-memory approximation)."""
        B, N = frame_ids.shape
        ring = self.ring
        done = state["centers_done"]
        age = done[:, None] - 1 - frame_ids  # 0 = newest accumulated
        ok = (
            (frame_ids >= 0)
            & (age >= 0)
            & (age < jnp.minimum(ring, done[:, None]))
        )
        slot = jnp.where(ok, (state["ring_pos"] - 1 - age) % ring, 0)
        bcol = jax.lax.broadcasted_iota(jnp.int32, (B, N), 0)
        old_w = state["ring_w"][bcol, slot]
        ratio = jnp.where(
            ok & (old_w > 1e-9), new_weights / jnp.maximum(old_w, 1e-9), 1.0
        )
        post = state["ring_post"][bcol, slot]  # [B, N, Q]
        idx = state["ring_idx"][bcol, slot]
        yv = state["ring_y"][bcol, slot]
        dpost = post * (ratio[:, :, None] - 1.0)
        onehot = jax.nn.one_hot(idx, self.G, dtype=jnp.float32)
        dg = jnp.einsum("bnq,bnqg->bg", dpost, onehot, precision=_HIGHEST)
        gamma = state["gamma"] + dg
        xstat = state["xstat"] + jnp.einsum(
            "bnq,bnqg,bnd->bgd", dpost, onehot, yv, precision=_HIGHEST)
        ring_post = state["ring_post"].at[bcol, slot].set(
            jnp.where(ok[:, :, None], post * ratio[:, :, None], post)
        )
        ring_w = state["ring_w"].at[bcol, slot].set(
            jnp.where(ok, new_weights, old_w)
        )
        return {**state, "gamma": gamma, "xstat": xstat,
                "ring_post": ring_post, "ring_w": ring_w}

    def _solve(self, gamma, xstat):
        """gamma [B, G], xstat [B, G, D] -> i-vector [B, I], prior-corrected
        (dim 0 has prior_offset subtracted), ready for the AM input."""
        cfg = self.cfg
        count = jnp.sum(gamma, axis=1)
        scale = jnp.where(
            (cfg.max_count > 0) & (count > cfg.max_count),
            cfg.max_count / jnp.maximum(count, 1e-9),
            1.0,
        )
        gamma = gamma * scale[:, None]
        xstat = xstat * scale[:, None, None]
        quad = jnp.einsum("bg,gij->bij", gamma, self.t.U, precision=_HIGHEST)
        quad = quad + jnp.eye(self.I, dtype=jnp.float32)
        lin = jnp.einsum("gid,bgd->bi", self.t.proj, xstat,
                         precision=_HIGHEST)
        lin = lin.at[:, 0].add(self.prior_offset)
        iv = jnp.linalg.solve(quad, lin[:, :, None])[:, :, 0]
        return iv.at[:, 0].add(-self.prior_offset)

    # -------------------------------------------------------------- API

    def update(self, state, feats, valid=None, flush=False):
        B, T, _ = feats.shape
        if valid is None:
            valid = jnp.ones((B, T), bool)
        return self._update_jit(state, feats, valid, flush=flush)

    def flush(self, state):
        """Emit the held-back tail frames (edge-copied right context)."""
        B = state["gamma"].shape[0]
        feats = jnp.zeros((B, 1, self.Din), jnp.float32)
        valid = jnp.zeros((B, 1), bool)
        return self._update_jit(state, feats, valid, flush=True)

    def reweight(self, state, frame_ids, new_weights):
        return self._reweight_jit(state, frame_ids, new_weights)

    def current(self, state):
        """Most-recent i-vector estimate [B, I] (the reference's
        use_most_recent_ivector=true online mode)."""
        if not hasattr(self, "_solve_jit"):
            self._solve_jit = jax.jit(self._solve)
        return self._solve_jit(state["gamma"], state["xstat"])
