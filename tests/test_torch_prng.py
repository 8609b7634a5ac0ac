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

# One intra-op thread: the tiny models gain nothing from more, and the
# test workers share the machine's cores (eight threads in each of six
# workers slow every small op here many times over).
torch.set_num_threads(1)

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


MANY_SEEDS = [0, 1, 2, 3, 42, 99, 1234, 65535, 123456789, 2**31 - 1,
              2**32 - 1]


@pytest.mark.parametrize("seed", MANY_SEEDS)
def test_split_chain_bit_equal(seed):
    """The engines' key discipline: ``_Ctx.split`` (split in two, keep the
    first) and ``split(key, k)`` for branch rows."""
    kj, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for n in (2, 2, 6, 1, 3):
        sj, st = jax.random.split(kj, n), prng.split(kt, n)
        np.testing.assert_array_equal(st.numpy(), _u32(sj))
        kj, kt = sj[0], st[0]


@pytest.mark.parametrize("seed", MANY_SEEDS)
@pytest.mark.parametrize("shape", [(1,), (5,), (3, 7), (199,)])
def test_shaped_uniform_bit_equal(seed, shape):
    kj, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    uj = np.asarray(jax.random.uniform(kj, shape))
    ut = prng.uniform_shaped(kt, shape).numpy()
    assert ut.dtype == np.float32 and uj.tobytes() == ut.tobytes()
    tiny = float(jnp.finfo(jnp.float32).tiny)
    uj = np.asarray(jax.random.uniform(kj, shape, minval=tiny, maxval=1.0))
    ut = prng.uniform_shaped(kt, shape, minval=prng.TINY).numpy()
    assert uj.tobytes() == ut.tobytes()


@pytest.mark.parametrize("seed", MANY_SEEDS)
def test_batched_keys_uniform_rows(seed):
    keys = prng.split(prng.PRNGKey(seed), 4)
    rows = prng.uniform_shaped(keys, (9,))
    for i in range(4):
        assert torch.equal(rows[i], prng.uniform_shaped(keys[i], (9,)))


@pytest.mark.parametrize("seed", MANY_SEEDS)
def test_gumbel_within_one_ulp(seed):
    """The gumbel noise -log(-log(u)): the uniforms are bit-equal, the two
    logs may differ from XLA's by one f32 ulp each, so the noise agrees
    to 1e-6 absolute (one ulp at its largest magnitude, ~16)."""
    kj, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    gj = np.asarray(jax.random.gumbel(kj, (4096,)))
    u = prng.uniform_shaped(kt, (4096,), minval=prng.TINY)
    gt = (-torch.log(-torch.log(u))).numpy()
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", MANY_SEEDS)
@pytest.mark.parametrize("V", [2, 199, 32000])
def test_categorical_equal(seed, V):
    """``jax.random.categorical`` on one key and vmapped over split keys
    (the engines' draft and branch sampling), on logits of softmax
    probabilities as ``sampling.sample`` forms them."""
    rng = np.random.default_rng(seed % 977)
    lg = rng.standard_normal((6, V)).astype(np.float32) * 3
    kj, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    one_j = int(jax.random.categorical(kj, jnp.asarray(lg[0])))
    assert int(prng.categorical(kt, torch.from_numpy(lg[0]))) == one_j
    keys_j = jax.random.split(kj, 6)
    want = np.asarray(jax.vmap(jax.random.categorical)(keys_j,
                                                       jnp.asarray(lg)))
    got = prng.categorical(prng.split(kt, 6), torch.from_numpy(lg)).numpy()
    np.testing.assert_array_equal(got, want)
    pj = np.asarray(JS.sample(kj, jax.nn.softmax(jnp.asarray(lg[1]))))
    pt = TS.sample(kt, torch.softmax(torch.from_numpy(lg[1]), -1))
    assert int(pt) == int(pj)
