"""Adaptive max-active (FusedPipeline.run_adaptive + BatchViterbi clones).

max_active is an upper bound on live tokens (Kaldi semantics,
/root/reference/src/model.cc:134-147): when beam pruning keeps fewer tokens
live than the smallest ladder variant, adaptive decoding must be EXACTLY
the fixed-K decode.  Also pins frontier resizing and clone table sharing.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from vosk_tpu.ops.viterbi import BatchViterbi, DecodeParams
from vosk_tpu.runtime.pipeline import FusedPipeline
from vosk_tpu.utils.benchdata import make_bench_model, structured_ll_bias


@pytest.fixture(scope="module")
def small_model():
    return make_bench_model(
        num_states=3000, num_pdfs=256, max_active=512, realistic=True,
        num_words=500, seed=3,
    )


def test_clone_shares_tables(small_model):
    pipe = FusedPipeline(small_model, batch=2, collect_records=False)
    c = pipe.dec.clone_with_max_active(64)
    assert c.em_pack is pipe.dec.em_pack  # no re-upload
    assert c.K == 64 and c.E == 64 * c.M
    assert c.params.max_active == 64
    assert len(c._init_states) == 64


def test_resize_frontier_roundtrip(small_model):
    pipe = FusedPipeline(small_model, batch=2, collect_records=False)
    dec = pipe.dec
    f = dec.init_frontier(2)
    g = dec.resize_frontier(f, 64)
    assert g["state"].shape == (2, 64)
    h = dec.resize_frontier(g, dec.K)
    assert h["state"].shape == (2, dec.K)
    # grown slots are dead
    assert bool(jnp.all(h["state"][:, 64:] == dec.S))
    assert bool(jnp.all(~jnp.isfinite(h["cost"][:, 64:])))


def test_adaptive_matches_fixed_when_unsaturated(small_model):
    """Easy scores keep live tokens far below the smallest variant: the
    adaptive path must produce identical best costs to the fixed decode."""
    B = 2
    pipe = FusedPipeline(small_model, batch=B, collect_records=False)
    pipe.adaptive_ladder = (128, 256)
    S = pipe.chunk_samples
    n_chunks = 4
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((n_chunks, B, S)) * 300).astype(np.float32)
    ll_bias = structured_ll_bias(pipe, n_chunks, snr=8.0, seed=0)

    s1, _, best_fixed = pipe.run_scan(pipe.init_state(), jnp.asarray(audio),
                                      ll_bias=ll_bias)
    s2, _, best_adapt = pipe.run_adaptive(pipe.init_state(), jnp.asarray(audio),
                                          ll_bias=ll_bias, seg=2)
    live = pipe.dec.live_tokens(s1["frontier"])
    assert live.max() < 128, "test premise: unsaturated beam"
    np.testing.assert_allclose(
        np.asarray(best_adapt), np.asarray(best_fixed), rtol=0, atol=1e-5
    )


def test_adaptive_steps_up(small_model):
    """Ambiguous scores saturate the small variant; the ladder must step up
    and keep decoding (sanity: finite best costs, larger frontier)."""
    B = 2
    pipe = FusedPipeline(small_model, batch=B, collect_records=False)
    pipe.adaptive_ladder = (4,)  # tiny variant: ambiguous scores flood it
    S = pipe.chunk_samples
    n_chunks = 4
    rng = np.random.default_rng(1)
    audio = (rng.standard_normal((n_chunks, B, S)) * 300).astype(np.float32)
    # zero bias scales the AM scores by 1e-3: near-tied acoustics, so beam
    # pruning keeps everything and the small variant saturates
    st0 = pipe.init_state()
    _, ll, _ = pipe.am._process_chunk_impl(
        pipe.params, st0["am"],
        *pipe.ex._extract_chunk_impl(st0["feat"], audio[0], None,
                                     np.full((B,), S, np.int32))[1:],
        None,
    )
    fd = ll.shape[1]
    ll_bias = jnp.zeros((n_chunks, B, fd, 256), jnp.float32)
    st, recs, best = pipe.run_adaptive(
        pipe.init_state(), jnp.asarray(audio), ll_bias=ll_bias, seg=1
    )
    assert np.isfinite(np.asarray(best)[-1]).all()
    assert st["frontier"]["state"].shape[1] == pipe.dec.K  # stepped up to full
