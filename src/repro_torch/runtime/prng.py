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
