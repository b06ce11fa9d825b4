"""TDNN-F acoustic model — the chain-model family the reference serves
(nnet3 `AmNnetSimple` loaded at reference src/model.cc:233-246; architecture
family per training/local/chain/run_tdnn.sh:104-118: relu-batchnorm input
layer, a stack of factorized TDNN-F layers with bottleneck + bypass, prefinal
linear, chain output without log-softmax, frame-subsampling 3).

Formulation: every layer is a batched matmul over *spliced* frames
(gather + reshape), so the whole forward is a chain of [B*T, in] @ [in, out]
matmuls — no conv primitives, no dynamic shapes.  bfloat16 matmuls with
f32 accumulation are used when `compute_dtype=bfloat16`.

Streaming uses sliding-window recompute: to emit outputs for frames
[t0, t1) the model is fed features [t0 - left_ctx, t1 + right_ctx), with the
context tail carried between chunks (same contract as the reference's
chunked looped computation, `DecodableNnetSimpleLoopedInfo`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class TdnnfConfig:
    feat_dim: int = 40
    ivector_dim: int = 0
    hidden_dim: int = 512
    bottleneck_dim: int = 96
    prefinal_dim: int = 192
    num_pdfs: int = 128
    # per-TDNN-F-layer time strides (0 = no splicing in that layer)
    time_strides: tuple = (1, 1, 1, 0, 3, 3, 3, 3, 3, 3, 3)
    subsample: int = 3
    bypass_scale: float = 0.75
    compute_dtype: str = "float32"  # or "bfloat16"

    @property
    def left_context(self) -> int:
        return 1 + sum(self.time_strides)

    @property
    def right_context(self) -> int:
        return 1 + sum(self.time_strides)


def init_params(cfg: TdnnfConfig, seed: int = 0) -> dict:
    """Random (inference-normalized) parameters; real models load weights via
    io.native / io.kaldi converters."""
    rng = np.random.default_rng(seed)

    def mat(i, o):
        return (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)

    p: dict = {}
    in_dim = (cfg.feat_dim + cfg.ivector_dim) * 3  # splice (-1,0,1)
    p["tdnn1_w"] = mat(in_dim, cfg.hidden_dim)
    p["tdnn1_b"] = np.zeros(cfg.hidden_dim, np.float32)
    p["tdnn1_scale"] = np.ones(cfg.hidden_dim, np.float32)
    p["tdnn1_offset"] = np.zeros(cfg.hidden_dim, np.float32)
    for i, s in enumerate(cfg.time_strides):
        taps = 1 if s == 0 else 2
        p[f"tdnnf{i}_lin"] = mat(cfg.hidden_dim * taps, cfg.bottleneck_dim)
        p[f"tdnnf{i}_aff_w"] = mat(cfg.bottleneck_dim * taps, cfg.hidden_dim)
        p[f"tdnnf{i}_aff_b"] = np.zeros(cfg.hidden_dim, np.float32)
        p[f"tdnnf{i}_scale"] = np.ones(cfg.hidden_dim, np.float32)
        p[f"tdnnf{i}_offset"] = np.zeros(cfg.hidden_dim, np.float32)
    p["prefinal_l"] = mat(cfg.hidden_dim, cfg.prefinal_dim)
    p["prefinal_w"] = mat(cfg.prefinal_dim, cfg.hidden_dim)
    p["prefinal_b"] = np.zeros(cfg.hidden_dim, np.float32)
    p["prefinal_scale"] = np.ones(cfg.hidden_dim, np.float32)
    p["prefinal_offset"] = np.zeros(cfg.hidden_dim, np.float32)
    p["prefinal_l2"] = mat(cfg.hidden_dim, cfg.prefinal_dim)
    p["output_w"] = mat(cfg.prefinal_dim, cfg.num_pdfs)
    p["output_b"] = np.zeros(cfg.num_pdfs, np.float32)
    return p


def _splice(x, offsets):
    """x: [B, T, D] -> [B, T, D*len(offsets)] with edge clamping.

    Edge clamping only matters for frames inside the context margin; callers
    (forward_utterance / streaming) pre-pad the input with edge-frame copies
    — Kaldi's looped-decodable convention — so emitted frames never depend on
    the clamping.
    """
    T = x.shape[1]
    parts = []
    for off in offsets:
        idx = np.clip(np.arange(T) + off, 0, T - 1)
        parts.append(x[:, idx])
    return jnp.concatenate(parts, axis=-1)


from .streaming import StreamingAm


class TdnnfModel(StreamingAm):
    """Stateless forward over parameter pytrees (pure-functional, jit/pjit
    friendly); streaming state = carried feature context."""

    def __init__(self, cfg: TdnnfConfig, params: dict):
        self.cfg = cfg
        self.params = jax.tree_util.tree_map(jnp.asarray, params)

    # ---- full forward: feats [B, T, feat_dim], ivec [B, ivector_dim]|None
    def forward(self, params, feats, ivector=None):
        cfg = self.cfg
        cdt = jnp.bfloat16 if cfg.compute_dtype == "bfloat16" else jnp.float32

        def mm(x, w):
            return jnp.matmul(x.astype(cdt), w.astype(cdt), preferred_element_type=jnp.float32)

        x = feats
        if cfg.ivector_dim:
            if ivector is None:
                raise ValueError("model expects an i-vector input")
            iv = jnp.broadcast_to(ivector[:, None, :], (x.shape[0], x.shape[1], cfg.ivector_dim))
            x = jnp.concatenate([x, iv], axis=-1)
        x = _splice(x, (-1, 0, 1))
        x = mm(x, params["tdnn1_w"]) + params["tdnn1_b"]
        x = jnp.maximum(x, 0.0) * params["tdnn1_scale"] + params["tdnn1_offset"]

        for i, s in enumerate(self.cfg.time_strides):
            y = x if s == 0 else _splice(x, (-s, 0))
            b = mm(y, params[f"tdnnf{i}_lin"])
            y2 = b if s == 0 else _splice(b, (0, s))
            y2 = mm(y2, params[f"tdnnf{i}_aff_w"]) + params[f"tdnnf{i}_aff_b"]
            y2 = jnp.maximum(y2, 0.0) * params[f"tdnnf{i}_scale"] + params[f"tdnnf{i}_offset"]
            x = cfg.bypass_scale * x + y2

        x = mm(x, params["prefinal_l"])
        x = mm(x, params["prefinal_w"]) + params["prefinal_b"]
        x = jnp.maximum(x, 0.0) * params["prefinal_scale"] + params["prefinal_offset"]
        x = mm(x, params["prefinal_l2"])
        out = mm(x, params["output_w"]) + params["output_b"]
        # chain output: raw pseudo-loglikes, no log-softmax (run_tdnn.sh:120)
        return out[:, :: cfg.subsample]

    # streaming/offline drivers come from StreamingAm

    @property
    def feat_dim(self) -> int:
        return self.cfg.feat_dim

    @property
    def subsample(self) -> int:
        return self.cfg.subsample

    @property
    def left_context(self) -> int:
        return self.cfg.left_context

    @property
    def right_context(self) -> int:
        return self.cfg.right_context
