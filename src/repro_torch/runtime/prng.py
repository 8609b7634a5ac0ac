"""Threefry-2x32 counter-based PRNG, bit-exact with ``jax.random``'s
default implementation (``jax_threefry_partitionable=True``).

The batched engines draw every uniform from folded keys
(``sampling.uniform_grid``: ``fold_in(fold_in(key, rid), ctr)`` then
``uniform(key, ())``), and draft tokens are sampled even under a greedy
target, so the port reproduces the reference's streams only with the
reference's bits.  A key is an int64 tensor of shape (..., 2) holding two
uint32 words; all arithmetic runs in int64 masked to 32 bits, on whatever
device the key lives.

The hash is the Salmon et al. Threefry-2x32 with 20 rounds as JAX's
``_threefry2x32_lowering`` applies it: key schedule (k0, k1,
k0 ^ k1 ^ 0x1BD11BDA), rotations (13, 15, 26, 6) / (17, 29, 16, 24), key
injection every 4 rounds.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1):
    """Hash the counter pair (x0, x1) under key (k0, k1); int64 tensors
    holding uint32 values, broadcast together.  Returns (y0, y1)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for 0 <= seed < 2**32: the key words
    are (seed >> 32, seed & 0xFFFFFFFF)."""
    seed = int(seed)
    if not 0 <= seed <= MASK:
        raise ValueError(f"seed {seed} outside [0, 2**32)")
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: data (int tensor or int, wrapped to uint32)
    broadcast against the key's leading axes."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & MASK
    y0, y1 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def uniform(key: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(key, (), float32)`` for every key of a (..., 2)
    batch: 23 random mantissa bits under exponent 0, minus 1."""
    y0, y1 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(key[..., 0]),
                          torch.zeros_like(key[..., 0]))
    bits = ((y0 ^ y1) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f, 0.0)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` for one (2,) key: key i hashes the
    counter pair (0, i), so the result is (num, 2)."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[0], key[1], torch.zeros_like(i), i)
    return torch.stack([y0, y1], dim=-1)


def uniform_shaped(key: torch.Tensor, shape, minval: float = 0.0,
                   maxval: float = 1.0, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` for a
    (..., 2) batch of keys: element j of the flattened ``shape`` hashes
    the counter pair (0, j) (partitionable threefry), its bits are
    ``y0 ^ y1``, and the float is ``max(minval, f * (maxval - minval) +
    minval)`` for the 23-bit mantissa draw f in [0, 1), all in float32.
    Returns (..., *shape) on ``device`` (default: the key's)."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    dev = key.device if device is None else torch.device(device)
    key = key.to(dev)
    j = torch.arange(n, dtype=torch.int64, device=dev)
    lead = key.shape[:-1]
    k0 = key[..., 0].reshape(lead + (1,))
    k1 = key[..., 1].reshape(lead + (1,))
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(j), j)
    bits = ((y0 ^ y1) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=dev)
    hi = torch.tensor(maxval, dtype=torch.float32, device=dev)
    f = torch.maximum(lo, f * (hi - lo) + lo)
    return f.reshape(lead + shape)


TINY = float(torch.finfo(torch.float32).tiny)


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis, gumbel
    mode "low": ``argmax(logits - log(-log(u)))`` with u uniform on
    [tiny, 1).  ``key`` is (2,) or a (..., 2) batch matching the leading
    axes of ``logits`` (the ``vmap`` over split keys of the engines).  The
    uniforms are bit-exact with JAX; the two logs may differ from XLA's
    by one ulp, which can move an argmax only at a near tie."""
    V = logits.shape[-1]
    u = uniform_shaped(key, (V,), minval=TINY, maxval=1.0,
                       device=logits.device)
    g = -torch.log(-torch.log(u))
    return torch.argmax(g + logits.float(), dim=-1)
