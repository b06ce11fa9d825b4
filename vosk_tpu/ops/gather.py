"""Per-channel table gathers for the frame step.

`gather_rows(table, idx)` is `out[b, n] = table[b, idx[b, n]]`, exact for
any dtype.  It is the decoder's acoustic lookup ll[b, pdf] (the reference
reads per-arc acoustic costs through DecodableAmNnetLoopedOnline,
recognizer.cc:310 -> Kaldi decodable->LogLikelihood) and its small
per-channel payload gathers (trailing-silence counts, eps-source states).

XLA emits a native gather for it: at the bulk operating point (B=96,
E=28,000 lookups from P=6008 pdfs per frame) that reads and writes about
22 MB per frame.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def gather_rows(table: jax.Array, idx: jax.Array) -> jax.Array:
    """out[..., n] = table[..., idx[..., n]].

    table: [B, P] (or [P]); idx: [B, N] (or [N]) int32, every entry in
    [0, P).  Callers guarantee the range (masked slots point at a valid
    entry, never past the end), so no bounds handling is emitted.
    """
    return jnp.take_along_axis(table, idx, axis=-1, mode="promise_in_bounds")
