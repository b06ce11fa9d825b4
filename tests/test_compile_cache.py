"""utils/compile_cache.py: JAX_COMPILATION_CACHE_DIR wins when set;
otherwise the cache sits at one fixed path inside the checkout."""
import os
import subprocess
import sys
from pathlib import Path

import jax

from vosk_tpu.utils import compile_cache

ROOT = Path(__file__).resolve().parents[1]


def test_environment_variable_is_honoured():
    env = {"JAX_COMPILATION_CACHE_DIR": "/some/cache"}
    assert compile_cache.cache_dir(env) == ("/some/cache", True)


def test_fixed_path_inside_checkout_otherwise():
    path, from_env = compile_cache.cache_dir({"HOME": "/elsewhere"})
    assert not from_env
    assert Path(path) == ROOT / ".jax_cache"
    # an empty variable counts as unset
    assert compile_cache.cache_dir({"JAX_COMPILATION_CACHE_DIR": ""}) == (
        path, False)


def test_enable_leaves_jax_alone_when_variable_set():
    before = jax.config.jax_compilation_cache_dir
    got = compile_cache.enable({"JAX_COMPILATION_CACHE_DIR": "/some/cache"})
    assert got == "/some/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_compiled_program_lands_in_variable_dir(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
               PYTHONPATH=str(ROOT))
    code = ("from vosk_tpu.utils import compile_cache; compile_cache.enable();"
            "import jax, jax.numpy as jnp;"
            "jax.jit(lambda x: jnp.sin(x) * 3)(jnp.ones(7)).block_until_ready()")
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=300)
    assert any(tmp_path.iterdir())
