"""Multi-host utterance sharding: 2 jax.distributed processes x 4 CPU
devices decode channel shards on ONE global mesh; the utterance-sharded
search mode additionally runs its pmin beam sync + all_gather merge over a
`model` axis that crosses the host boundary.

This is the BASELINE.md north-star configuration (N>=2 hosts, data-parallel
utterance shards, synchronized pruning) at CI scale; the reference's
scale-out analogue is process-level websocket sharding
(python/vosk/transcriber/transcriber.py:51-72).
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tools", "dcn_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def dcn_result(tmp_path_factory):
    out = tmp_path_factory.mktemp("dcn") / "result.json"
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), "2", coord, str(out)],
            env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(2)
    ]
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, _ = p.communicate()
        logs.append(stdout)
    rcs = [p.returncode for p in procs]
    assert rcs == [0, 0], f"worker rcs={rcs}\n--- w0:\n{logs[0][-4000:]}\n--- w1:\n{logs[1][-4000:]}"
    with open(out) as f:
        return json.load(f)


def _oracle():
    """Single-process oracle on the same seeds (runs on this process's
    8-device CPU backend; values must match the 2-process decode)."""
    from vosk_tpu.runtime.pipeline import FusedPipeline
    from vosk_tpu.utils.benchdata import make_bench_model

    model = make_bench_model(
        num_states=3000, num_pdfs=256, hidden=64, max_active=512,
        realistic=True, num_words=500, seed=3,
    )
    pipe = FusedPipeline(model, batch=16, collect_records=False)
    S = pipe.chunk_samples
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((3, 16, S)) * 300).astype(np.float32)
    st = pipe.init_state()
    st, _, best = pipe.run_scan(st, audio)

    dec = pipe.dec
    ll = (np.random.default_rng(7).standard_normal((8, 4, 256)) * 2).astype(
        np.float32
    )
    fr = dec.init_frontier(8)
    _, _, best_sh, _ = dec.decode_chunk(fr, ll)
    return np.asarray(best), np.asarray(best_sh)


def test_dcn_two_process_decode_matches_single(dcn_result):
    assert dcn_result["n_processes"] == 2
    assert dcn_result["n_devices"] == 8
    best_o, best_sh_o = _oracle()
    # full pipeline: bf16 AM matmuls partition differently across mesh
    # layouts, so reduction order (and thus loglikes) drifts slightly —
    # decode COSTS may differ by that acoustic drift, not decoder error
    np.testing.assert_allclose(
        np.asarray(dcn_result["best"]), best_o, rtol=5e-2,
        err_msg="cross-host channel-sharded decode != single-process")
    # decoder-level check runs on identical precomputed f32 loglikes:
    # the pmin-synced cross-host sharded search must match plain decode
    # to f32 tolerance
    np.testing.assert_allclose(
        np.asarray(dcn_result["best_sharded"]), best_sh_o, rtol=1e-5,
        err_msg="cross-host pmin-synced sharded search != plain decode")
