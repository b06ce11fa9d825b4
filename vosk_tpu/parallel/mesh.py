"""Device mesh + sharding layout for the batch pipeline.

The reference scales by thread-level stream parallelism on CPU and a CUDA
dynamic batcher on GPU (SURVEY §2c); the layout here is:

  mesh = (data, model)
  - `data`:  channels (concurrent streams) — the throughput axis; per-channel
    streaming state (feature rings, AM context, decode frontiers, record
    outputs) is sharded along it.
  - `model`: tensor-sharding of the acoustic model's hidden dimension, used
    only when an AM exceeds a single chip; XLA inserts the all-reduces.

Beam-search state stays channel-local, so token passing needs no cross-chip
collectives in the data-parallel regime.  The utterance-sharded search mode
(BatchViterbi.decode_chunk_sharded) splits each frame's expansion over the
`model` axis with a pmin-synced global beam threshold and an all_gather
candidate merge; parity vs single-device is tested in
tests/test_multichip.py.

The mesh shape follows the algorithm alone: the cards of one host are
joined all to all, so no axis order is tied to a physical topology.
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_data: Optional[int] = None,
    n_model: int = 1,
    devices=None,
) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    if n_data is None:
        n_data = len(devices) // n_model
    dev = np.asarray(devices[: n_data * n_model]).reshape(n_data, n_model)
    return Mesh(dev, ("data", "model"))


def channel_sharding(mesh: Mesh) -> NamedSharding:
    """Per-channel state arrays: leading dim = channels -> shard over data."""
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def am_param_sharding(mesh: Mesh, name: str, shape) -> NamedSharding:
    """Tensor-sharding rule for TDNN-F parameters over the `model` axis.

    Hidden-dim outputs shard on the last axis; hidden-dim inputs on the
    first.  1-D bias/scale vectors shard on their only axis when they match
    the hidden dim.  Falls back to replication for small/odd shapes.
    """
    n_model = mesh.shape["model"]
    if n_model == 1:
        return replicated(mesh)
    if len(shape) == 2:
        if shape[1] % n_model == 0:
            return NamedSharding(mesh, P(None, "model"))
        if shape[0] % n_model == 0:
            return NamedSharding(mesh, P("model", None))
    if len(shape) == 1 and shape[0] % n_model == 0:
        return NamedSharding(mesh, P("model"))
    return replicated(mesh)


def shard_am_params(mesh: Mesh, params: dict) -> dict:
    return {
        k: jax.device_put(v, am_param_sharding(mesh, k, np.shape(v)))
        for k, v in params.items()
    }


def shard_channel_state(mesh: Mesh, state: dict) -> dict:
    sh = channel_sharding(mesh)
    return {k: jax.device_put(v, sh) for k, v in state.items()}
