"""The device a measurement ran on, and the refusal to run without a GPU.

Every number this repo reports names its device: JAX's view (platform,
device kind, count) and the card's own (`nvidia-smi` name and power limit;
a card held below its maximum power runs slower under load).
"""
from __future__ import annotations

import subprocess

SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]


def smi_name_and_power() -> str:
    """`nvidia-smi`'s name and power limit, one line per card.  Runs as a
    child process that never touches JAX."""
    out = subprocess.run(SMI_QUERY, capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip()


def jax_device() -> dict:
    """{"platform", "kind", "count"} of JAX's default devices."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> dict:
    """jax_device(), or SystemExit when JAX's default device is no GPU: a
    measurement must not fall back to the CPU."""
    dev = jax_device()
    if dev["platform"] != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default device is {dev['platform']} "
            f"({dev['kind']}); this needs an NVIDIA GPU")
    return dev
