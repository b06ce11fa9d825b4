"""Where JAX keeps compiled programs between runs.

The bulk decoding program (a 2M-state graph, a ragged bucket switch in the
frame scan) takes minutes to compile, so the entry points keep XLA's
persistent compilation cache:

  * `JAX_COMPILATION_CACHE_DIR` set: JAX reads it itself; nothing is changed.
  * otherwise: a fixed directory inside the checkout, `<repo>/.jax_cache`.
    The path is part of the cache key, so it must not move between runs.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Mapping, Optional

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir(environ: Mapping[str, str]) -> tuple[str, bool]:
    """(directory, whether it came from the environment) for `environ`."""
    env = environ.get(ENV_VAR)
    if env:
        return env, True
    return str(DEFAULT_DIR), False


def enable(environ: Optional[Mapping[str, str]] = None) -> str:
    """Point JAX's persistent cache at `cache_dir(environ)`; returns it."""
    path, from_env = cache_dir(os.environ if environ is None else environ)
    if not from_env:
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
