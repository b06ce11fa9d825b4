"""Multi-host worker: one process of an N-process jax.distributed
slice decoding utterance shards (data-parallel utterance shards across
hosts, beam-pruning thresholds synchronized via collectives).

The reference's scale-out analogue is process-level websocket sharding
(python/vosk/transcriber/transcriber.py:51-72); here the hosts form ONE
global device mesh — per-host channel shards ride the `data` axis (the
network between processes), and the utterance-sharded search mode additionally
splits each frame's expansion over a `model` axis that CROSSES the host
boundary, so its pmin beam sync and all_gather merge are real cross-host
collectives.

Usage: python tools/dcn_worker.py <pid> <nproc> <coordinator> <out.json>
Run via tests/test_dcn.py (2 processes x 4 CPU devices).
"""
from __future__ import annotations

import json
import os
import sys


def main() -> None:
    pid, nproc = int(sys.argv[1]), int(sys.argv[2])
    coord, out_path = sys.argv[3], sys.argv[4]

    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4"
    ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=coord, num_processes=nproc, process_id=pid
    )
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from jax.experimental import multihost_utils

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from vosk_tpu.runtime.pipeline import FusedPipeline
    from vosk_tpu.utils.benchdata import make_bench_model

    devs = jax.devices()
    assert len(devs) == 4 * nproc, f"expected {4*nproc} global devices, got {len(devs)}"

    model = make_bench_model(
        num_states=3000, num_pdfs=256, hidden=64, max_active=512,
        realistic=True, num_words=500, seed=3,
    )

    # ---- utterance shards over `data` spanning both hosts
    mesh = Mesh(np.asarray(devs).reshape(len(devs), 1), ("data", "model"))
    B = 2 * len(devs)  # 2 channels per device
    pipe = FusedPipeline(model, batch=B, mesh=mesh, collect_records=False)
    S = pipe.chunk_samples
    T = 3
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((T, B, S)) * 300).astype(np.float32)
    sh = NamedSharding(mesh, P(None, "data"))
    audio_dev = multihost_utils.host_local_array_to_global_array(
        audio[:, pid * (B // nproc):(pid + 1) * (B // nproc)], mesh,
        P(None, "data"),
    )
    st = pipe.init_state()
    st, _, best = pipe.run_scan(st, audio_dev)
    # tiled=True: gathering a global (non-fully-addressable) array
    # returns the full global value on every process
    best_np = np.asarray(multihost_utils.process_allgather(best, tiled=True))

    # ---- utterance-sharded search with the model axis CROSSING hosts:
    # device grid [[0,4],[1,5],[2,6],[3,7]] -> pmin/all_gather cross hosts
    grid = np.asarray(devs).reshape(nproc, 4).T  # [4, nproc]
    mesh2 = Mesh(grid, ("data", "model"))
    B2 = 8
    dec = pipe.dec
    # re-place the (replicated) graph tables onto mesh2's device order
    dec.tables = {
        k: jax.device_put(v, NamedSharding(mesh2, P()))
        for k, v in dec.tables.items()
    }
    ll = (np.random.default_rng(7).standard_normal((B2, 4, 256)) * 2).astype(
        np.float32
    )
    fr0 = dec.init_frontier(B2)
    fr_sh = {
        k: multihost_utils.host_local_array_to_global_array(
            np.asarray(v), mesh2, P("data")
        )
        for k, v in fr0.items()
    }
    ll_sh = multihost_utils.host_local_array_to_global_array(
        ll, mesh2, P("data")
    )
    f2, recs, best_sh, bestf_sh = dec.decode_chunk_sharded(
        mesh2, fr_sh, ll_sh, axis="model", shard_slack=4
    )
    best_sh_np = np.asarray(
        multihost_utils.process_allgather(best_sh, tiled=True))

    if pid == 0:
        with open(out_path, "w") as f:
            json.dump(
                {
                    "best": best_np.tolist(),
                    "best_sharded": best_sh_np.tolist(),
                    "n_devices": len(devs),
                    "n_processes": nproc,
                },
                f,
            )
    multihost_utils.sync_global_devices("dcn_worker_done")


if __name__ == "__main__":
    main()
