"""Flat-start monophone GMM-HMM bootstrap alignment.

The in-framework equivalent of the reference recipe's GMM stages
(`/root/reference/training/run.sh:31-60`: train_mono -> align -> tri ->
align ...): starting from transcripts only, train a diagonal-covariance
GMM per phone with Viterbi-EM and emit per-frame phone alignments, so the
chain/CE recipe (training/recipe.py stage 0) no longer needs provided
alignments — completing the reference pipeline's flat-start property.

Scope notes vs Kaldi gmm-align:
  * monophone, one HMM state per phone (matching the recipe's
    Topology(states_per_phone=1)); optional silence between words with a
    skippable-state alignment graph, like Kaldi's training graphs.
  * diag-cov GMMs grown by binary mean splitting (Kaldi's mixture-up),
    default up to 4 components/phone — enough to bootstrap; the heavy
    acoustic modeling lives in the TDNN-F stage that follows.
  * alignment DP is plain vectorized numpy: utterances are seconds long
    and this runs once at the head of training; the jit-compiled pipeline
    (features/AM/chain) stays the device path.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

LOG0 = -1e30


@dataclasses.dataclass
class GmmConfig:
    num_iters: int = 8
    max_components: int = 4
    split_iters: Tuple[int, ...] = (2, 4)   # grow mixtures after these iters
    self_loop_prob: float = 0.7
    var_floor: float = 1e-3
    optional_silence: bool = True


class DiagGmm:
    """Diagonal-covariance GMM over feature dim D."""

    def __init__(self, means: np.ndarray, variances: np.ndarray,
                 weights: np.ndarray):
        self.means = means          # [C, D]
        self.vars = variances       # [C, D]
        self.weights = weights      # [C]

    def loglikes(self, feats: np.ndarray) -> np.ndarray:
        """[T, D] -> [T] log sum_c w_c N(x; mu_c, var_c)."""
        x = feats[:, None, :]                       # [T, 1, D]
        d = x - self.means[None]                    # [T, C, D]
        ll = -0.5 * np.sum(
            d * d / self.vars[None] + np.log(2 * math.pi * self.vars)[None],
            axis=2,
        ) + np.log(np.maximum(self.weights, 1e-20))[None]
        m = ll.max(axis=1)
        return m + np.log(np.sum(np.exp(ll - m[:, None]), axis=1))

    def split(self, max_components: int, perturb: float = 0.1) -> None:
        C = len(self.weights)
        if 2 * C > max_components:
            return
        eps = perturb * np.sqrt(self.vars)
        self.means = np.concatenate([self.means - eps, self.means + eps])
        self.vars = np.concatenate([self.vars, self.vars])
        self.weights = np.concatenate([self.weights, self.weights]) * 0.5


def _utt_graph(words: Sequence[int], prons: Dict[int, List[List[int]]],
               sil_phone: int, optional_silence: bool):
    """Linear alignment graph: [opt-sil] w1-phones [opt-sil] ... [opt-sil].
    Returns (phone_of_state [S], optional [S] bool)."""
    phones: List[int] = []
    optional: List[bool] = []

    def emit_sil():
        if optional_silence:
            phones.append(sil_phone)
            optional.append(True)

    emit_sil()
    for w in words:
        pron = prons.get(int(w))
        if not pron:
            continue
        for p in pron[0]:
            phones.append(int(p))
            optional.append(False)
        emit_sil()
    return np.asarray(phones, np.int32), np.asarray(optional, bool)


def viterbi_align(ll_state: np.ndarray, optional: np.ndarray,
                  self_loop_logp: float, forward_logp: float) -> np.ndarray:
    """Align frames to a left-to-right state chain with skippable states.

    ll_state: [T, S] per-frame state log-likelihoods; optional: [S] states
    that may be skipped (optional silence).  Returns state index per frame.
    Transitions: self-loop, advance +1, and advance +2 over an optional
    state.  The path must start in state 0 (or 1 if 0 optional) and end in
    the last (or second-to-last if last optional) state.
    """
    T, S = ll_state.shape
    delta = np.full((T, S), LOG0)
    back = np.zeros((T, S), np.int8)  # 0=self, 1=+1, 2=+2
    delta[0, 0] = ll_state[0, 0]
    if S > 1 and optional[0]:
        delta[0, 1] = ll_state[0, 1]
    for t in range(1, T):
        stay = delta[t - 1] + self_loop_logp
        adv1 = np.full(S, LOG0)
        adv1[1:] = delta[t - 1, :-1] + forward_logp
        adv2 = np.full(S, LOG0)
        if S > 2:
            skip_ok = optional[1:-1]
            adv2[2:] = np.where(skip_ok, delta[t - 1, :-2] + 2 * forward_logp,
                                LOG0)
        best = np.maximum(np.maximum(stay, adv1), adv2)
        back[t] = np.where(best == stay, 0, np.where(best == adv1, 1, 2))
        delta[t] = best + ll_state[t]
    ends = [S - 1]
    if S > 1 and optional[S - 1]:
        ends.append(S - 2)
    s = max(ends, key=lambda e: delta[T - 1, e])
    path = np.zeros(T, np.int32)
    path[T - 1] = s
    for t in range(T - 1, 0, -1):
        s = s - int(back[t, s])
        path[t - 1] = s
    return path


def _equal_align(T: int, optional: np.ndarray) -> np.ndarray:
    """Uniform frame-to-state split over a chain graph: mandatory states
    weighted 3, optional (silence) states 1; every state gets >= 1 frame
    when T allows."""
    S = len(optional)
    w = np.where(optional, 1.0, 3.0)
    edges = np.round(np.cumsum(w) / w.sum() * T).astype(np.int64)
    starts = np.concatenate([[0], edges[:-1]])
    st = np.zeros(T, np.int32)
    for j in range(S):
        st[starts[j]: edges[j]] = j
    if edges[-1] < T:
        st[edges[-1]:] = S - 1
    return st


class MonoGmmAligner:
    """Flat-start Viterbi-EM monophone aligner."""

    def __init__(self, num_phones: int, cfg: GmmConfig = GmmConfig()):
        self.num_phones = num_phones  # phones are 1..num_phones
        self.cfg = cfg
        self.gmms: List[Optional[DiagGmm]] = [None] * (num_phones + 1)

    def _flat_start(self, feats_all: np.ndarray) -> None:
        mu = feats_all.mean(axis=0)
        var = np.maximum(feats_all.var(axis=0), self.cfg.var_floor)
        for p in range(1, self.num_phones + 1):
            # tiny per-phone mean jitter breaks the flat-start symmetry
            rng = np.random.default_rng(p)
            self.gmms[p] = DiagGmm(
                (mu + 0.01 * rng.standard_normal(mu.shape) * np.sqrt(var))[
                    None
                ].copy(),
                var[None].copy(),
                np.ones(1),
            )

    def _phone_ll(self, feats: np.ndarray) -> np.ndarray:
        """[T, num_phones+1]; column 0 unused."""
        out = np.full((feats.shape[0], self.num_phones + 1), LOG0)
        for p in range(1, self.num_phones + 1):
            out[:, p] = self.gmms[p].loglikes(feats)
        return out

    def train_align(
        self,
        utt_feats: Sequence[np.ndarray],
        utt_words: Sequence[Sequence[int]],
        prons: Dict[int, List[List[int]]],
        sil_phone: int,
        log=lambda s: None,
    ) -> List[np.ndarray]:
        """Viterbi-EM from flat start; returns per-frame PHONE alignments."""
        cfg = self.cfg
        self._flat_start(np.concatenate(utt_feats, axis=0))
        graphs = [
            _utt_graph(ws, prons, sil_phone, cfg.optional_silence)
            for ws in utt_words
        ]
        sl = math.log(cfg.self_loop_prob)
        fw = math.log(1.0 - cfg.self_loop_prob)
        aligns: List[np.ndarray] = []
        for it in range(cfg.num_iters):
            aligns = []
            acc_n = np.zeros(self.num_phones + 1)
            acc_x: List[Optional[np.ndarray]] = [None] * (self.num_phones + 1)
            acc_xx: List[Optional[np.ndarray]] = [None] * (self.num_phones + 1)
            total_ll = 0.0
            for feats, (phs, opt) in zip(utt_feats, graphs):
                pll = self._phone_ll(feats)
                if it == 0:
                    # equal alignment (Kaldi align-equal-compiled, the
                    # first iteration of train_mono): flat-start GMMs are
                    # near-identical, so Viterbi would segment arbitrarily;
                    # a proportional split gives every phone distinct
                    # initial statistics.  Optional silences get a smaller
                    # share than mandatory phones.
                    st = _equal_align(len(feats), opt)
                else:
                    st = viterbi_align(pll[:, phs], opt, sl, fw)
                frame_phone = phs[st]
                aligns.append(frame_phone)
                total_ll += float(pll[np.arange(len(st)), frame_phone].sum())
                for p in np.unique(frame_phone):
                    sel = feats[frame_phone == p]
                    acc_n[p] += len(sel)
                    sx = sel.sum(axis=0)
                    sxx = (sel * sel).sum(axis=0)
                    acc_x[p] = sx if acc_x[p] is None else acc_x[p] + sx
                    acc_xx[p] = sxx if acc_xx[p] is None else acc_xx[p] + sxx
            log(f"gmm iter {it}: avg frame ll "
                f"{total_ll / max(sum(len(a) for a in aligns), 1):.3f}")
            # M-step: single-Gaussian re-estimation per phone, then
            # hard-assign frames to mixture components for GMM phones
            for p in range(1, self.num_phones + 1):
                if acc_n[p] < 3:
                    continue
                g = self.gmms[p]
                if len(g.weights) == 1:
                    mu = acc_x[p] / acc_n[p]
                    var = np.maximum(
                        acc_xx[p] / acc_n[p] - mu * mu, cfg.var_floor)
                    g.means[0], g.vars[0] = mu, var
                else:
                    self._reestimate_mixture(g, p, utt_feats, aligns)
            if it in cfg.split_iters:
                for p in range(1, self.num_phones + 1):
                    self.gmms[p].split(cfg.max_components)
        return aligns

    def _reestimate_mixture(self, g: DiagGmm, p: int, utt_feats, aligns):
        sel = np.concatenate(
            [f[a == p] for f, a in zip(utt_feats, aligns)] or
            [np.zeros((0, g.means.shape[1]))]
        )
        if len(sel) < 3 * len(g.weights):
            return
        # one EM step with soft responsibilities
        x = sel[:, None, :]
        d = x - g.means[None]
        lw = -0.5 * np.sum(
            d * d / g.vars[None] + np.log(2 * math.pi * g.vars)[None], axis=2
        ) + np.log(np.maximum(g.weights, 1e-20))[None]
        lw -= lw.max(axis=1, keepdims=True)
        r = np.exp(lw)
        r /= r.sum(axis=1, keepdims=True)
        n = r.sum(axis=0) + 1e-10
        g.weights = n / n.sum()
        g.means = (r.T @ sel) / n[:, None]
        g.vars = np.maximum(
            (r.T @ (sel * sel)) / n[:, None] - g.means * g.means,
            self.cfg.var_floor,
        )


def flat_start_align(
    utt_wavs: Sequence[np.ndarray],
    utt_words: Sequence[Sequence[int]],
    prons: Dict[int, List[List[int]]],
    num_phones: int,
    sil_phone: int,
    extractor,
    cfg: GmmConfig = GmmConfig(),
    log=lambda s: None,
) -> List[np.ndarray]:
    """Transcripts-only bootstrap: returns per-SAMPLE phone alignments
    (the format training/recipe.py stage 0 consumes), produced by the
    flat-start GMM Viterbi-EM loop."""
    feats = [np.asarray(extractor.extract(w[None]))[0] for w in utt_wavs]
    aligner = MonoGmmAligner(num_phones, cfg)
    frame_aligns = aligner.train_align(feats, utt_words, prons, sil_phone,
                                       log=log)
    fo = extractor.frame_opts
    out = []
    for wav, fa in zip(utt_wavs, frame_aligns):
        n = len(wav)
        # frame t covers samples [t*shift, t*shift+shift); tail frames pad
        idx = np.minimum(np.arange(n) // fo.window_shift, len(fa) - 1)
        out.append(fa[idx].astype(np.int32))
    return out
