"""LF-MMI ("chain") acoustic-model training, in JAX.

The reference's acoustic models are trained with Kaldi's lattice-free MMI
recipe (training/run.sh stages 4-5, local/chain/run_tdnn.sh:135-166); the
objective is

    F = sum_u [ log p(O_u | num_u) - log p(O_u | den) ]

where the numerator graph encodes the transcript and the denominator graph
is a phone-LM HMM accepting all phone sequences.  This module implements
the same objective with a matmul-shaped design:

  * the DENOMINATOR forward recursion runs in probability space with
    per-frame renormalization so the S x S transition step is a single
    matmul per frame (log-space logsumexp-matmuls cannot use the matrix
    units);
    gradients flow through the scan by autodiff — no hand-written
    occupancy accumulation like Kaldi's chain-den-graph code
  * the NUMERATOR is the forced alignment (per-frame pdf targets), i.e. a
    linear FSA — Kaldi's numerator is a small alignment lattice; the fixed
    alignment is the standard simplification and is exact when alignments
    come from the same topology
  * leaky-HMM is applied as a per-frame rank-1 leak through a virtual
    hub distributed by the initial probabilities (Kaldi's
    leaky_hmm_coefficient, default 0.1) — in the prob-space recursion it
    composes with the transition matmul at no extra matmul cost
  * cross-entropy regularization (Kaldi --xent-regularize 0.1) uses the
    same output head with a small weight.

Reference: training/local/chain/run_tdnn.sh:135-166 (chain options),
src/model.cc:134-147 (the decode side these models feed).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from .tdnnf import TdnnfConfig, TdnnfModel, init_params


@dataclasses.dataclass
class DenominatorGraph:
    """Phone-LM HMM in dense form: state = pdf (1-state-per-phone topology,
    the toy/demo topology; chain-topology trees map similarly with one
    state per pdf-class).

    trans: [S, S] transition probabilities (rows sum to <= 1; the leftover
    mass is the final probability), built from a bigram phone LM with
    self-loops.  init: [S] initial probabilities.
    """

    trans: np.ndarray  # [S, S] probabilities
    init: np.ndarray   # [S]
    final: np.ndarray  # [S]
    # leaky-HMM coefficient (Kaldi default 0.1): per-frame rank-1 leak
    # through a virtual hub distributed by `init`, the numerical aid the
    # reference recipe applies to the denominator recursion
    leaky_hmm: float = 0.0

    @classmethod
    def from_alignments(
        cls,
        labels: np.ndarray,  # [N, T] pdf targets (the training alignments)
        num_pdfs: int,
        discount: float = 0.1,
    ) -> "DenominatorGraph":
        """Estimate the phone bigram (with add-k smoothing) from the
        training alignments — the role of Kaldi's chain den phone LM
        (chain-den-graph.cc builds it from the numerator alignments the
        same way)."""
        S = num_pdfs
        big = np.full((S, S), discount, np.float64)
        init = np.full(S, discount, np.float64)
        fin = np.full(S, discount, np.float64)
        for row in np.asarray(labels):
            init[row[0]] += 1
            fin[row[-1]] += 1
            a, b = row[:-1], row[1:]
            np.add.at(big, (a, b), 1)
        # rows normalized together with the final mass
        tot = big.sum(1) + fin
        trans = big / tot[:, None]
        final = fin / tot
        return cls(
            trans=trans.astype(np.float32),
            init=(init / init.sum()).astype(np.float32),
            final=final.astype(np.float32),
        )


def den_logprob(den: DenominatorGraph, ll: jnp.ndarray) -> jnp.ndarray:
    """log p(O | den) per utterance.  ll: [B, T, S] pseudo-log-likelihoods
    (the network output; chain models are trained without priors).

    Probability-space forward with per-frame renormalization: alpha is kept
    as (unit-scaled probs, log-scale) so the transition step is one
    matmul per frame."""
    T = jnp.asarray(den.trans)          # [S, S]
    init = jnp.asarray(den.init)
    fin = jnp.asarray(den.final)

    a0 = init[None, :] * jnp.exp(
        ll[:, 0] - jnp.max(ll[:, 0], axis=1, keepdims=True)
    )
    s0 = jnp.max(ll[:, 0], axis=1)
    n0 = jnp.sum(a0, axis=1)
    a0 = a0 / n0[:, None]
    logscale0 = s0 + jnp.log(n0)
    leaky = float(getattr(den, "leaky_hmm", 0.0))

    def step(car, ll_t):
        a, logscale = car
        if leaky > 0.0:
            # leaky-HMM (Kaldi chain-denominator-graph leaky_hmm_coefficient,
            # default 0.1): every state leaks mass through a virtual hub
            # distributed by the initial probabilities — a rank-1 update,
            # so the transition step stays one matmul
            a = a + leaky * jnp.sum(a, axis=1, keepdims=True) * init[None, :]
        m = jnp.max(ll_t, axis=1, keepdims=True)
        e = jnp.exp(ll_t - m)
        a2 = (a @ T) * e                     # matmul + emission
        n = jnp.sum(a2, axis=1)
        a2 = a2 / jnp.maximum(n, 1e-30)[:, None]
        return (a2, logscale + m[:, 0] + jnp.log(jnp.maximum(n, 1e-30))), None

    (aT, logscale), _ = jax.lax.scan(
        step, (a0, logscale0), jnp.moveaxis(ll[:, 1:], 1, 0)
    )
    return logscale + jnp.log(jnp.maximum(jnp.sum(aT * fin[None], axis=1),
                                          1e-30))


def num_logprob(den: DenominatorGraph, ll: jnp.ndarray,
                labels: jnp.ndarray) -> jnp.ndarray:
    """log p(O, alignment | num): linear-FSA numerator score along the
    forced alignment, with the SAME transition model as the denominator so
    the two terms are comparable."""
    B, T, S = ll.shape
    em = jnp.take_along_axis(ll, labels[..., None], axis=2)[..., 0]  # [B, T]
    lt = jnp.log(jnp.maximum(jnp.asarray(den.trans), 1e-30))
    li = jnp.log(jnp.maximum(jnp.asarray(den.init), 1e-30))
    lf = jnp.log(jnp.maximum(jnp.asarray(den.final), 1e-30))
    tr = lt[labels[:, :-1], labels[:, 1:]]  # [B, T-1]
    return (
        em.sum(1) + tr.sum(1) + li[labels[:, 0]] + lf[labels[:, -1]]
    )


def chain_objective(den: DenominatorGraph, ll, labels,
                    xent_scale: float = 0.1):
    """(negated) LF-MMI objective + cross-entropy regularization.
    Returns (loss, aux dict)."""
    num = num_logprob(den, ll, labels)
    dn = den_logprob(den, ll)
    T = ll.shape[1]
    mmi = jnp.mean(num - dn) / T
    logp = jax.nn.log_softmax(ll, axis=-1)
    xent = jnp.mean(
        jnp.take_along_axis(logp, labels[..., None], axis=2)
    )
    loss = -(mmi + xent_scale * xent)
    return loss, {"mmi": mmi, "xent": xent}


def train_chain(
    cfg: TdnnfConfig,
    feats: np.ndarray,   # [N, T, D]
    labels: np.ndarray,  # [N, ceil(T/ss)] pdf alignment targets
    steps: int = 300,
    lr: float = 2e-3,
    seed: int = 0,
    xent_scale: float = 0.1,
    log_every: int = 0,
    den: Optional[DenominatorGraph] = None,
) -> Dict[str, np.ndarray]:
    """LF-MMI training loop (the in-process equivalent of the reference's
    training/run.sh stage 4; same API shape as train_frame_ce)."""
    if den is None:
        den = DenominatorGraph.from_alignments(labels, cfg.num_pdfs)
        den.leaky_hmm = 0.1  # reference recipe default (run_tdnn.sh)
    params = jax.tree_util.tree_map(jnp.asarray, init_params(cfg, seed))
    model = TdnnfModel(cfg, params)
    opt = optax.adam(lr)
    opt_state = opt.init(params)
    feats_j = jnp.asarray(feats)
    labels_j = jnp.asarray(labels)

    def loss_fn(p):
        out = model.forward_utterance(p, feats_j)  # [N, T_out, P]
        Tl = labels_j.shape[1]
        out = out[:, :Tl]
        return chain_objective(den, out, labels_j, xent_scale)

    @jax.jit
    def step(p, s):
        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss, aux

    for i in range(steps):
        params, opt_state, loss, aux = step(params, opt_state)
        if log_every and i % log_every == 0:
            print(
                f"chain step {i}: loss {float(loss):.4f} "
                f"mmi {float(aux['mmi']):.4f} xent {float(aux['xent']):.4f}"
            )
    return jax.tree_util.tree_map(np.asarray, params)
