"""Pitch features (NCCF + Viterbi lag tracking + POV), Kaldi-style.

The reference enables Kaldi's online pitch when a model ships
conf/pitch.conf (/root/reference/src/model.cc:265-276); the algorithm is
Ghahremani et al. 2014 ("A pitch extraction algorithm tuned for ASR"),
implemented in Kaldi feat/pitch-functions.cc:

  1. resample the signal to 4 kHz (band-limited; ops/resample.py)
  2. per 10 ms frame, NCCF over candidate lags in [rate/max_f0,
     rate/min_f0], with a ballast term that de-emphasizes low-energy frames
  3. Viterbi smoothing over the lag grid with a log-lag transition penalty
  4. per-frame features: [POV feature, POV-weighted mean-subtracted log
     pitch, delta log pitch]

This module is the utterance-level (offline) extractor, written as jnp so
the NCCF (a batch of sliding dot products) and the Viterbi recursion
(lax.scan over frames) run on the accelerator; streaming integration into
the feature pipeline is tracked in COVERAGE.md.  Differences from Kaldi kept simple
deliberately: integer lag grid (Kaldi interpolates onto a log-spaced grid)
and a fixed POV mapping from the paper's NCCF statistic.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class PitchOptions:
    sample_rate: float = 16000.0
    resample_rate: float = 4000.0
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    min_f0: float = 50.0
    max_f0: float = 400.0
    penalty_factor: float = 0.1
    nccf_ballast: float = 7000.0
    pov_scale: float = 2.0
    delta_window: int = 2
    mean_window: int = 151  # POV-weighted moving mean of log pitch


@partial(jax.jit, static_argnums=(1, 2, 3))
def _nccf(sig, window, shift, max_lag):
    """sig: [N] at the resampled rate. Returns [T, max_lag+1] NCCF (lag 0
    column unused) and frame energies [T]."""
    n = sig.shape[0]
    T = max(1 + (n - window - max_lag) // shift, 1)
    starts = jnp.arange(T) * shift
    idx = starts[:, None] + jnp.arange(window + max_lag)[None, :]
    frames = sig[jnp.clip(idx, 0, n - 1)]  # [T, window+max_lag]
    x0 = frames[:, :window]
    x0c = x0 - jnp.mean(x0, axis=1, keepdims=True)
    e0 = jnp.sum(x0c * x0c, axis=1)

    def one_lag(lag):
        xl = jax.lax.dynamic_slice_in_dim(frames, lag, window, axis=1)
        xlc = xl - jnp.mean(xl, axis=1, keepdims=True)
        el = jnp.sum(xlc * xlc, axis=1)
        num = jnp.sum(x0c * xlc, axis=1)
        return num, el

    lags = jnp.arange(max_lag + 1)
    nums, els = jax.vmap(one_lag)(lags)  # [L+1, T]
    mean_sq = jnp.mean(e0) / window + 1e-12
    ballast = 0.0  # applied by the caller (two NCCF flavors)
    den = jnp.sqrt((e0[None, :] + ballast) * els + 1e-10)
    return (nums / den).T, e0, mean_sq  # [T, L+1]


def compute_pitch_features(wave, opts: PitchOptions = PitchOptions()):
    """wave: [N] float at opts.sample_rate. Returns np.ndarray [T, 3] =
    (pov_feature, normalized_log_pitch, delta_log_pitch) plus the raw
    per-frame (pitch_hz, pov) for inspection: (feats, pitch_hz, pov)."""
    from .resample import resample_offline

    wave = np.asarray(wave, np.float32)
    rr = opts.resample_rate
    if abs(rr - opts.sample_rate) > 1e-6:
        sig = resample_offline(wave, opts.sample_rate, rr)
    else:
        sig = wave
    sig = jnp.asarray(sig / max(np.abs(sig).max(), 1e-6))

    shift = int(rr * opts.frame_shift_ms / 1000.0)
    window = int(rr * opts.frame_length_ms / 1000.0)
    min_lag = max(int(rr / opts.max_f0), 2)
    max_lag = int(rr / opts.min_f0)
    nccf, e0, mean_sq = _nccf(sig, window, shift, max_lag)
    nccf = np.asarray(nccf)[:, min_lag:]  # [T, L]
    T, L = nccf.shape
    lags_s = (np.arange(min_lag, max_lag + 1)) / rr  # lag in seconds

    # ballast flavor for pitch tracking (de-emphasizes silence); the raw
    # nccf above (no ballast) is the POV statistic
    ballast = opts.nccf_ballast * float(mean_sq)
    e0n = np.asarray(e0)
    scale = np.sqrt(e0n / (e0n + ballast * window))[:, None]
    nccf_pitch = nccf * scale
    # short-lag preference against subharmonic (octave-down) picks: a pure
    # tone correlates equally at lag and 2*lag; bias the tracker toward the
    # true (shorter) period like Kaldi's local-cost shaping
    lag_bias = 1.0 - 0.02 * (np.log(lags_s) - np.log(lags_s[0]))
    nccf_pitch = nccf_pitch * lag_bias[None, :]

    # Viterbi over lags: local cost = -nccf_pitch, transition cost =
    # penalty * (log lag ratio)^2 (pitch-functions.cc ComputeLocalCost)
    loglags = np.log(lags_s)
    trans = opts.penalty_factor * (loglags[:, None] - loglags[None, :]) ** 2

    @jax.jit
    def viterbi(obs):
        def step(car, ob):
            best = jnp.min(car[:, None] + jnp.asarray(trans), axis=0)
            bp = jnp.argmin(car[:, None] + jnp.asarray(trans), axis=0)
            nxt = best - ob
            return nxt, (nxt, bp)

        init = -obs[0]
        _, (costs, bps) = jax.lax.scan(step, init, obs[1:])
        return costs, bps

    if T > 1:
        costs, bps = viterbi(jnp.asarray(nccf_pitch))
        costs, bps = np.asarray(costs), np.asarray(bps)
        path = np.zeros(T, np.int64)
        path[-1] = int(np.argmin(costs[-1]))
        for t in range(T - 2, -1, -1):
            path[t] = bps[t][path[t + 1]]
    else:
        path = np.array([int(np.argmax(nccf_pitch[0]))])

    pitch_hz = 1.0 / lags_s[path]
    nccf_at = nccf[np.arange(T), path]

    # POV feature: the paper's monotone transform of the (ballast-free)
    # NCCF at the chosen lag
    c = np.clip(nccf_at, -1.0, 1.0)
    pov_raw = np.abs(c)
    pov_feature = opts.pov_scale * (np.power(1.0001 - c, 0.15) - 1.0)
    pov = np.clip(pov_raw, 0.0, 1.0)

    # POV-weighted moving-mean subtraction of log pitch
    logp = np.log(pitch_hz)
    half = opts.mean_window // 2
    norm_logp = np.empty(T, np.float32)
    for t in range(T):
        lo, hi = max(0, t - half), min(T, t + half + 1)
        w = pov[lo:hi] + 1e-4
        norm_logp[t] = logp[t] - float(np.sum(w * logp[lo:hi]) / np.sum(w))

    # delta of log pitch (standard 2-sided delta window)
    dw = opts.delta_window
    k = np.arange(-dw, dw + 1, dtype=np.float32)
    denom = float(np.sum(k * k))
    pad = np.pad(logp, (dw, dw), mode="edge")
    delta = np.convolve(pad, -k / denom, mode="valid").astype(np.float32)

    feats = np.stack([pov_feature, norm_logp, delta], axis=1).astype(np.float32)
    return feats, pitch_hz.astype(np.float32), pov.astype(np.float32)


class StreamingPitch:
    """Chunk-invariant streaming pitch (jnp; runs inside the jitted feature
    pipeline).  The reference wires Kaldi's online pitch into the feature
    pipeline when conf/pitch.conf exists (src/model.cc:265-276); this is
    the JAX equivalent with sequential (carried-state) recursions so
    any chunking of the input produces identical features:

      * FIR-decimation of the input to `resample_rate` (integer factor)
      * per-frame NCCF over the lag grid (vectorized over lags)
      * ONLINE Viterbi lag tracking: the forward recursion is carried
        across chunks and each frame emits the filtering argmin (Kaldi's
        offline smoother backtracks from the utterance end; the online
        estimate is the same recursion without future context — Kaldi's
        own online pitch emits provisional values the same way)
      * POV-weighted log-pitch mean over a BACKWARD window of
        `mean_window` frames (offline uses a centered window)
      * delta(log pitch) as the one-frame backward difference

    Frame emission is delayed by `la16` input samples (pitch lookahead +
    FIR halfwidth) so every emitted frame has its full NCCF window — the
    feature pipeline's ready-count subtracts this lookahead, and offline/
    finalize paths append `la16` zeros so frame counts match Kaldi's
    num_frames_ready exactly.
    """

    def __init__(self, opts: PitchOptions = PitchOptions()):
        self.opts = opts
        rr, sr = opts.resample_rate, opts.sample_rate
        R = int(round(sr / rr))
        if abs(R * rr - sr) > 1e-3:
            raise ValueError(
                f"pitch resample rate {rr} must divide the sample rate {sr}")
        self.R = R
        self.sh16 = int(sr * opts.frame_shift_ms / 1000.0)
        self.ws16 = int(sr * opts.frame_length_ms / 1000.0)
        if self.sh16 % R:
            raise ValueError("frame shift must be a multiple of the "
                             "pitch decimation factor")
        self.sh4 = self.sh16 // R
        self.ws4 = self.ws16 // R
        self.min_lag = max(int(rr / opts.max_f0), 2)
        self.max_lag = int(rr / opts.min_f0)
        self.L = self.max_lag - self.min_lag + 1
        self.MW = opts.mean_window

        # FIR decimation taps (Hann-windowed sinc, Kaldi FilterFunc shape),
        # normalized to unit DC gain
        cutoff = 0.99 * 0.5 * rr
        hw_s = 10.0 / (2.0 * cutoff)  # 10-zero windowed sinc
        W16 = int(np.ceil(hw_s * sr))
        t = np.arange(-W16, W16 + 1) / sr
        win = np.where(np.abs(t) < hw_s,
                       0.5 * (1.0 + np.cos(np.pi / hw_s * t)), 0.0)
        x = 2.0 * cutoff * t
        sinc = np.where(x == 0.0, 1.0,
                        np.sin(np.pi * x) / np.where(x == 0.0, 1.0, np.pi * x))
        h = (win * sinc).astype(np.float32)
        self.fir = h / h.sum()
        self.W16 = W16
        # input-sample lookahead an emitted frame needs beyond its MFCC
        # window: the NCCF lag tail plus the FIR halfwidth
        self.la16 = R * self.max_lag + W16

        lags_s = np.arange(self.min_lag, self.max_lag + 1) / rr
        self.lags_s = lags_s.astype(np.float32)
        self.neg_log_lags = (-np.log(lags_s)).astype(np.float32)  # log f0
        loglags = np.log(lags_s)
        self.trans = (opts.penalty_factor
                      * (loglags[:, None] - loglags[None, :]) ** 2
                      ).astype(np.float32)
        self.lag_bias = (1.0 - 0.02 * (loglags - loglags[0])).astype(np.float32)

    # -------------------------------------------------------------- state

    def init_state(self, batch: int):
        L, MW = self.L, self.MW
        return {
            "fwd": jnp.zeros((batch, L), jnp.float32),
            "ring_logp": jnp.zeros((batch, MW), jnp.float32),
            "ring_w": jnp.zeros((batch, MW), jnp.float32),
            "ring_pos": jnp.zeros((batch,), jnp.int32),
            "e_sum": jnp.zeros((batch,), jnp.float32),
            "n_frames": jnp.zeros((batch,), jnp.int32),
            "prev_logp": jnp.zeros((batch,), jnp.float32),
        }

    # ------------------------------------------------------------- compute

    def frame_features(self, state, buf, start0, F, valid):
        """Pitch features for this chunk's frames.

        buf: [B, W] raw-input working buffer (mfcc pipeline's); start0: [B]
        buffer-local input-sample index of frame 0's window start; F: static
        frame budget; valid: [B, F] frame mask.  Returns (state', [B, F, 3]).
        """
        o = self.opts
        R, ws4, sh4, max_lag = self.R, self.ws4, self.sh4, self.max_lag
        L, W16 = self.L, self.W16
        B, Wb = buf.shape
        Lr = (F - 1) * sh4 + ws4 + max_lag  # decimated region length

        # FIR decimation of the region (gather + einsum; edge-clipped —
        # interior frames always have real margin because the pipeline
        # retains W16 extra tail samples)
        taps = self.fir.shape[0]
        qi = jnp.arange(Lr, dtype=jnp.int32) * R
        ti = jnp.arange(taps, dtype=jnp.int32) - W16
        idx = start0[:, None, None] + qi[None, :, None] + ti[None, None, :]
        idx = jnp.clip(idx, 0, Wb - 1)
        x16 = jnp.take_along_axis(buf, idx.reshape(B, -1), axis=1)
        sig4 = jnp.matmul(x16.reshape(B, Lr, taps), jnp.asarray(self.fir),
                          precision=jax.lax.Precision.HIGHEST)  # [B, Lr]

        # frames [B, F, ws4 + max_lag]
        fi = jnp.arange(F, dtype=jnp.int32) * sh4
        wi = jnp.arange(ws4 + max_lag, dtype=jnp.int32)
        fidx = fi[:, None] + wi[None, :]  # [F, ws4+max_lag]
        frames = sig4[:, fidx]  # [B, F, ws4+max_lag]

        x0 = frames[..., :ws4]
        x0c = x0 - jnp.mean(x0, axis=-1, keepdims=True)
        e0 = jnp.sum(x0c * x0c, axis=-1)  # [B, F]

        def one_lag(lag):
            xl = jax.lax.dynamic_slice_in_dim(frames, lag, ws4, axis=2)
            xlc = xl - jnp.mean(xl, axis=-1, keepdims=True)
            return jnp.sum(x0c * xlc, axis=-1), jnp.sum(xlc * xlc, axis=-1)

        nums, els = jax.vmap(one_lag)(
            jnp.arange(self.min_lag, self.max_lag + 1))
        nums = jnp.moveaxis(nums, 0, -1)  # [B, F, L]
        els = jnp.moveaxis(els, 0, -1)
        nccf_pure = nums / jnp.sqrt(e0[..., None] * els + 1e-10)

        trans = jnp.asarray(self.trans)
        lag_bias = jnp.asarray(self.lag_bias)
        neg_log_lags = jnp.asarray(self.neg_log_lags)
        MW = self.MW

        def step(car, xs):
            nccf_f, e_f, v_f = xs  # [B, L], [B], [B]
            fwd, r_logp, r_w, pos, e_sum, n, prev_lp = car
            e_sum2 = e_sum + jnp.where(v_f, e_f, 0.0)
            n2 = n + v_f.astype(jnp.int32)
            mean_sq = e_sum2 / jnp.maximum(n2, 1) / ws4
            ballast = o.nccf_ballast * mean_sq
            scale = jnp.sqrt(e_f / (e_f + ballast * ws4 + 1e-10))
            obs = nccf_f * scale[:, None] * lag_bias[None, :]

            fwd2 = jnp.min(fwd[:, :, None] + trans[None], axis=1) - obs
            fwd2 = fwd2 - jnp.min(fwd2, axis=1, keepdims=True)
            lag_idx = jnp.argmin(fwd2, axis=1)  # [B]

            c = jnp.clip(
                jnp.take_along_axis(nccf_f, lag_idx[:, None], axis=1)[:, 0],
                -1.0, 1.0)
            pov_feat = o.pov_scale * (jnp.power(1.0001 - c, 0.15) - 1.0)
            pov = jnp.clip(jnp.abs(c), 0.0, 1.0)
            logp = neg_log_lags[lag_idx]

            # backward POV-weighted mean of log pitch over the ring
            slot = pos % MW
            r_logp2 = jnp.where(
                (jnp.arange(MW)[None] == slot[:, None]) & v_f[:, None],
                logp[:, None], r_logp)
            r_w2 = jnp.where(
                (jnp.arange(MW)[None] == slot[:, None]) & v_f[:, None],
                (pov + 1e-4)[:, None], r_w)
            mean = jnp.sum(r_w2 * r_logp2, axis=1) / jnp.maximum(
                jnp.sum(r_w2, axis=1), 1e-8)
            norm_logp = logp - mean
            delta = jnp.where(n > 0, logp - prev_lp, 0.0)

            feats_f = jnp.stack([pov_feat, norm_logp, delta], axis=1)
            feats_f = jnp.where(v_f[:, None], feats_f, 0.0)

            vb = v_f
            car2 = (
                jnp.where(vb[:, None], fwd2, fwd),
                r_logp2, r_w2,
                jnp.where(vb, pos + 1, pos),
                e_sum2,
                n2,
                jnp.where(vb, logp, prev_lp),
            )
            return car2, feats_f

        car0 = (state["fwd"], state["ring_logp"], state["ring_w"],
                state["ring_pos"], state["e_sum"], state["n_frames"],
                state["prev_logp"])
        xs = (jnp.moveaxis(nccf_pure, 1, 0), jnp.moveaxis(e0, 1, 0),
              jnp.moveaxis(valid, 1, 0))
        car1, feats = jax.lax.scan(step, car0, xs)
        state2 = {
            "fwd": car1[0], "ring_logp": car1[1], "ring_w": car1[2],
            "ring_pos": car1[3], "e_sum": car1[4], "n_frames": car1[5],
            "prev_logp": car1[6],
        }
        return state2, jnp.moveaxis(feats, 0, 1)  # [B, F, 3]
