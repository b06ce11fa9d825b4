"""ops/gather.py: the per-channel gather the frame step uses is exact
against numpy for every shape and value range the decoder feeds it."""
import numpy as np
import pytest

import jax.numpy as jnp

from vosk_tpu.ops.gather import gather_rows


@pytest.mark.parametrize("B,P,N", [(2, 300, 1000), (3, 6008, 4096), (1, 64, 17)])
def test_gather_rows_exact(B, P, N):
    rng = np.random.default_rng(0)
    table = rng.standard_normal((B, P)).astype(np.float32)
    idx = rng.integers(0, P, (B, N)).astype(np.int32)
    out = np.asarray(gather_rows(jnp.asarray(table), jnp.asarray(idx)))
    assert out.shape == (B, N) and out.dtype == np.float32
    np.testing.assert_array_equal(out, np.take_along_axis(table, idx, axis=1))


def test_gather_rows_int32_full_range():
    rng = np.random.default_rng(1)
    table = rng.integers(-(2**31), 2**31 - 1, (2, 500), dtype=np.int64).astype(
        np.int32
    )
    idx = rng.integers(0, 500, (2, 700)).astype(np.int32)
    out = np.asarray(gather_rows(jnp.asarray(table), jnp.asarray(idx)))
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, np.take_along_axis(table, idx, axis=1))


def test_gather_rows_1d():
    """A single channel's table and indices gather without a batch axis."""
    rng = np.random.default_rng(2)
    table = rng.standard_normal(300).astype(np.float32)
    idx = rng.integers(0, 300, 50).astype(np.int32)
    out = np.asarray(gather_rows(jnp.asarray(table), jnp.asarray(idx)))
    assert out.shape == (50,)
    np.testing.assert_array_equal(out, table[idx])


def test_gather_rows_padded_slots():
    """Dead frontier slots point at entry 0 and padded pdf columns at the
    last entry; both read back exactly, including +inf costs."""
    table = np.array([[np.inf, 1.5, -2.0, 7.0], [3.0, np.inf, 0.0, -1.0]],
                     np.float32)
    idx = np.array([[0, 0, 3, 3, 1], [3, 1, 0, 0, 2]], np.int32)
    out = np.asarray(gather_rows(jnp.asarray(table), jnp.asarray(idx)))
    np.testing.assert_array_equal(out, np.take_along_axis(table, idx, axis=1))
