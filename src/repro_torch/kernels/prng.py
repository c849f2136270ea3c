"""The JAX package's random draws, reproduced bit for bit in PyTorch.

The serving sampler keys each token ``fold_in(fold_in(PRNGKey(seed),
rid), position)`` and draws its gumbel noise with ``jax.random.gumbel``
(``repro/kernels/ref.py`` ``sample_keys``, ``repro/kernels/ops.py``
``sample_tokens``).  The port draws the same noise so that its engine
samples the same tokens as the reference.  This module is the port's own
copy of what that needs, for JAX's default threefry generator with
``jax_threefry_partitionable`` on (JAX 0.5 and later):

  threefry2x32(k1, k2, x1, x2)   the Threefry-2x32 hash, 20 rounds
  prng_key(seed)                 ``jax.random.PRNGKey``: (0, seed mod 2^32)
  fold_in(key, data)             ``threefry2x32(key, (0, data))``
  random_bits(key, n)            32-bit draw of shape (n,): the two words
                                 of ``threefry2x32(key, (0, iota))`` XORed
  uniform(key, n)                f32 in [tiny, 1): top 23 bits as mantissa
  gumbel(key, n)                 ``-log(-log(uniform))`` (mode "low")

Keys are int64 tensors of shape (..., 2) holding the two uint32 words;
``prng_key`` gives a pair of Python ints, which ``fold_in`` takes too, so
a seed reaches the device as kernel arguments and never as a copy.
PyTorch has no full uint32 arithmetic, so every word lives in an int64
and every add, shift and rotate is masked back to 32 bits.  Everything
runs on the keys' device, without a host sync.  The bits are exact; the
floats differ from XLA's only where ``log`` rounds differently.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
F32_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 of the counter pair (x1, x2) under key (k1, k2);
    int64 tensors of uint32 values, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & MASK, (x2 + ks[1]) & MASK]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = (x[0] + x[1]) & MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & MASK
    return x[0], x[1]


def prng_key(seed: int) -> tuple:
    """``jax.random.PRNGKey(seed)`` as a pair of ints, as JAX makes it
    with 64-bit types off (its default): the seed is taken mod 2^32 and
    the high word is 0."""
    return (0, int(seed) & MASK)


def fold_in(key, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in``: key (..., 2) or a pair of ints, data an
    integer tensor broadcastable to the key's leading shape (int32 values
    are taken as their uint32 bits).  Returns (..., 2) int64."""
    k1, k2 = key if isinstance(key, tuple) else (key[..., 0], key[..., 1])
    data = data.to(torch.int64) & MASK
    y0, y1 = threefry2x32(k1, k2, torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` for each key of (..., 2):
    int64 tensor (..., n) of uint32 values."""
    iota = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(iota), iota)
    return b1 ^ b2


def uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), f32, minval=tiny, maxval=1)``."""
    bits = (random_bits(key, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    # (maxval - minval) rounds to 1.0 in f32, so the scale is exact
    return torch.clamp_min(floats + F32_TINY, F32_TINY)


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), f32)`` (mode "low"): (..., n) f32."""
    return -torch.log(-torch.log(uniform(key, n)))


def sample_keys(seed: int, rids: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """Per-row keys ``fold_in(fold_in(PRNGKey(seed), rid), position)``
    (``repro/kernels/ref.py`` ``sample_keys``): (B, 2) int64."""
    return fold_in(fold_in(prng_key(seed), rids), positions)
