"""The port's threefry-2x32 against ``jax.random`` (the default
partitionable threefry of this JAX): keys, fold_in chains, uniforms and
the engines' uniform grid must be bit-equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import sampling as JS
from repro_torch.runtime import prng
from repro_torch.runtime import sampling as TS

SEEDS = [0, 1, 42, 123456789, 2**31 - 1]


def _u32(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)
                      if jnp.issubdtype(key.dtype, jax.dtypes.prng_key)
                      else key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_bits(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed).numpy(),
                                  _u32(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_chain_and_uniform(seed):
    kj, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for data in [0, 1, 7, 2**31 - 1, 99991, 3]:
        kj = jax.random.fold_in(kj, data)
        kt = prng.fold_in(kt, data)
        np.testing.assert_array_equal(kt.numpy(), _u32(kj))
        uj = np.asarray(jax.random.uniform(kj, ()), np.float32)
        ut = prng.uniform(kt).numpy()
        assert uj.tobytes() == ut.tobytes(), (seed, data, uj, ut)


def test_fold_in_wraps_negative_data_like_uint32():
    kj = jax.random.fold_in(jax.random.PRNGKey(5), jnp.int32(-1))
    kt = prng.fold_in(prng.PRNGKey(5), -1)
    np.testing.assert_array_equal(kt.numpy(), _u32(kj))


def test_batched_fold_in_matches_per_key():
    base = prng.PRNGKey(9)
    data = torch.arange(17)
    batch = prng.fold_in(base, data)
    for i in range(17):
        assert torch.equal(batch[i], prng.fold_in(base, i))


@pytest.mark.parametrize("seed", [0, 2**31 - 1, 11])
@pytest.mark.parametrize("width", [1, 5, 16])
def test_uniform_grid_bit_equal(seed, width):
    rng = np.random.default_rng(seed % 1000)
    rids = rng.integers(0, 1000, size=6).astype(np.int32)
    ctrs = rng.integers(0, 10_000, size=6).astype(np.int32)
    want = np.asarray(JS.uniform_grid(jax.random.PRNGKey(seed),
                                      jnp.asarray(rids), jnp.asarray(ctrs),
                                      width))
    got = TS.uniform_grid(prng.PRNGKey(seed), torch.from_numpy(rids),
                          torch.from_numpy(ctrs), width).numpy()
    assert got.dtype == np.float32 and got.shape == (6, width)
    assert got.tobytes() == want.tobytes()
    assert ((got >= 0) & (got < 1)).all()
