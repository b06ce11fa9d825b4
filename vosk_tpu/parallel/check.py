"""Self-checking run of the multi-device path.

`check_multichip(devices)` drives the production classes over a
(data, model) mesh of `devices` and compares them with the 1-device path:

  * FusedPipeline (features -> flagship-width TDNN-F -> WFST token passing
    with lattice records), channels sharded over `data`, the AM
    tensor-sharded over `model`;
  * the utterance-sharded search (expansion striped over `model`, pmin
    beam sync, all_gather merge) against the plain decode of the same
    loglikes: frontier, costs and words must be EXACTLY equal;
  * one sharded training update of the same AM.

It also checks placement: graph tables are replicated and per-channel
state and outputs span every device of the mesh, so nothing is left on
device 0 by default.  Run on virtual CPU devices by `__graft_entry__.py`
and on real cards by `chip_smoke.py --four-cards`.
"""
from __future__ import annotations

import numpy as np


def _spans_mesh(x, mesh) -> bool:
    return set(x.sharding.device_set) == set(mesh.devices.flat)


def check_multichip(devices, batch: int = 64) -> dict:
    """Returns a summary dict; raises AssertionError on any mismatch."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..runtime.pipeline import FusedPipeline
    from ..utils.benchdata import make_bench_model
    from . import mesh as pm

    n = len(devices)
    n_model = 2 if n % 2 == 0 and n >= 2 else 1
    mesh = pm.make_mesh(n // n_model, n_model, devices=list(devices))
    B = batch

    # flagship AM architecture (hidden 512, 11 TDNN-F stages) on a
    # realistic-shape graph small enough to compile quickly everywhere
    model = make_bench_model(
        num_states=20_000, num_pdfs=512, hidden=512, max_active=512,
        realistic=True, num_words=2000, seed=0,
    )
    pipe = FusedPipeline(
        model, batch=B, mesh=mesh, collect_records=True, lattice_records=True
    )
    for k, v in pipe.dec.tables.items():
        assert _spans_mesh(v, mesh), f"graph table {k} not replicated"

    chunk = pipe.chunk_samples
    n_chunks = 2
    audio = (
        np.random.default_rng(0)
        .standard_normal((n_chunks, B, chunk))
        .astype(np.float32)
        * 300
    )
    audio_dev = jax.device_put(audio, NamedSharding(mesh, P(None, "data")))
    state = pipe.init_state()
    for leaf in jax.tree_util.tree_leaves(state):
        assert _spans_mesh(leaf, mesh), "channel state not sharded"
    state, recs, best = pipe.run_scan(state, audio_dev)
    jax.block_until_ready(best)
    assert _spans_mesh(best, mesh), "pipeline output on a subset of devices"
    assert np.isfinite(np.asarray(best)[-1]).all()
    # v4 records: 'pm' [chunks, frames_per_chunk, B, K]; v3: 'prev'
    # [chunks, B, ...] (ops/viterbi.py)
    assert recs is not None
    if "pm" in recs:
        assert recs["pm"].shape[0] == n_chunks and recs["pm"].shape[2] == B
    else:
        assert recs["prev"].shape[:2] == (n_chunks, B)
    live = pipe.dec.live_tokens(state["frontier"])

    # ---- utterance-sharded search: expansion split over `model` with the
    # pmin-synced beam threshold + all_gather merge (real collectives)
    dec = pipe.dec
    rng = np.random.default_rng(3)
    ll = (rng.standard_normal((B, 4, 512)) * 2).astype(np.float32)
    csh = pm.channel_sharding(mesh)
    sh_frontier = {
        k: jax.device_put(v, csh) for k, v in dec.init_frontier(B).items()
    }
    f_sh, recs_sh, best_sh, bestf_sh = dec.decode_chunk_sharded(
        mesh, sh_frontier, jax.device_put(ll, csh)
    )
    jax.block_until_ready(best_sh)
    assert np.isfinite(np.asarray(best_sh)).all()

    # the same loglikes through the plain decode on ONE device must match
    # EXACTLY (the sharded expansion is bit-exact whenever no shard
    # overflows its contribution budget)
    one = devices[0]
    mesh_tables = dec.tables
    dec.tables = jax.device_put(mesh_tables, one)
    try:
        f_1d, recs_1d, best_1d, bestf_1d = dec.decode_chunk(
            jax.device_put(dec.init_frontier(B), one), jax.device_put(ll, one)
        )
    finally:
        dec.tables = mesh_tables
    np.testing.assert_array_equal(np.asarray(best_sh), np.asarray(best_1d))
    np.testing.assert_array_equal(np.asarray(bestf_sh), np.asarray(bestf_1d))
    for k in f_1d:
        np.testing.assert_array_equal(
            np.asarray(f_sh[k]), np.asarray(f_1d[k]),
            err_msg=f"sharded-vs-1device frontier[{k}]",
        )
    for ch in range(0, B, max(B // 8, 1)):
        _, ols_sh, _ = dec.traceback([recs_sh], f_sh, ch, at_start=True)
        _, ols_1d, _ = dec.traceback([recs_1d], f_1d, ch, at_start=True)
        assert ols_sh == ols_1d, (ch, ols_sh, ols_1d)

    # ---- one sharded training update of the SAME AM (dp over utterances,
    # tp over hidden; XLA inserts the all-reduces)
    am, params = pipe.am, pipe.params
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)
    feats_b = jax.device_put(
        np.random.default_rng(1)
        .standard_normal((B, 30, model.config.am["feat_dim"]))
        .astype(np.float32),
        csh,
    )
    num_pdfs = model.config.am["num_pdfs"]
    labels_b = jax.device_put(
        np.random.default_rng(2).integers(0, num_pdfs, (B, 10)), csh
    )

    def train_step(params, opt_state, feats, labels):
        def loss_fn(p):
            out = am.forward_utterance(p, feats)
            logp = jax.nn.log_softmax(out, axis=-1)
            return -jnp.mean(
                jnp.take_along_axis(logp, labels[..., None], axis=-1))

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    _, _, loss = jax.jit(train_step)(params, opt_state, feats_b, labels_b)
    assert np.isfinite(float(loss))
    return {
        "mesh": dict(mesh.shape),
        "channels": B,
        "live_tokens": live[:4].tolist(),
        "decode_best": np.asarray(best)[-1, :2].tolist(),
        "sharded_search_live_tokens": dec.live_tokens(f_sh)[:4].tolist(),
        "train_loss": float(loss),
        "parity": "sharded==1device (exact: frontier+costs+words)",
    }
