"""The parts of ``jax.random`` the serving engine samples with, bit for bit.

The JAX package's engine draws its sampled tokens with ``jax.random``'s
default generator, threefry-2x32 (Salmon et al., "Parallel random numbers:
as easy as 1, 2, 3", SC 2011), in JAX's 32-bit mode and with
``jax_threefry_partitionable`` on, as JAX 0.9 sets both by default.  This
module gives the same bits from the same keys, so a sampled stream of the
port is the JAX package's stream:

* :func:`prng_key` — ``jax.random.PRNGKey(seed)``: the key ``(0, seed mod
  2**32)`` (in 32-bit mode the high word of a 64-bit seed is dropped);
* :func:`threefry2x32` — the 20-round threefry-2x32 block function;
* :func:`fold_in` — ``jax.random.fold_in``: the key hashed with the counter
  pair ``(0, data)``;
* :func:`random_bits` — 32-bit ``jax.random.bits`` of a 1-d shape: element
  i is the xor of the two words of the block at counter ``(0, i)`` (the
  partitionable layout, where counters are the 64-bit iota split in two
  words);
* :func:`uniform`, :func:`gumbel` and :func:`categorical` — ``jax.random``'s
  float32 ``uniform`` on ``[minval, 1)`` (23 random mantissa bits under the
  exponent of 1.0, minus 1), its "low" gumbel ``−log(−log(u))`` with ``u``
  on ``[tiny, 1)``, and ``argmax(gumbel + logits)``.

Keys are ``(..., 2)`` tensors and every word is held in ``int64``, masked to
32 bits, because ``torch.uint32`` lacks arithmetic on some devices; the
functions broadcast over leading axes, so one call serves a batch of keys.
The bits are integers and agree exactly on every device; ``log`` is the
device's, so gumbel noise may differ from XLA's by an ulp.  Everything is
plain tensor code with no host synchronisation, so it can run inside a
captured CUDA graph.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["prng_key", "threefry2x32", "fold_in", "random_bits", "uniform", "gumbel",
           "categorical"]

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = float(np.finfo(np.float32).tiny)


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as a (2,) uint32 array.  JAX takes the
    seed as an int64 (raising beyond that range) and, in 32-bit mode, keeps
    its low word under a zero high word."""
    return np.array([0, int(np.int64(seed)) & M32], dtype=np.uint32)


def as_words(key) -> torch.Tensor:
    """A uint32 key (numpy, or a tensor of any integer dtype holding its
    bits) as int64 words in [0, 2**32)."""
    if isinstance(key, np.ndarray):
        key = torch.from_numpy(key.astype(np.int64))
    return key.to(torch.int64) & M32


def _rotl(x, r: int):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds on int64 tensors of 32-bit words, all
    broadcast together: key ``(k0, k1)``, counter ``(x0, x1)``.  Returns the
    two output words, as JAX's ``threefry2x32_p``."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def fold_in(keys, data):
    """``jax.random.fold_in`` of each key with its ``data``: keys (..., 2)
    int64 words, data (...) integers taken mod 2**32.  Returns (..., 2)."""
    data = data.to(torch.int64) & M32
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def random_bits(keys, n: int):
    """32-bit ``jax.random.bits(key, (n,))`` of each key: keys (..., 2) int64
    words.  Returns (..., n) int64 in [0, 2**32)."""
    count = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[..., 0, None], keys[..., 1, None], torch.zeros_like(count),
                          count)
    return y0 ^ y1


def uniform(keys, n: int, minval: float = 0.0):
    """float32 ``jax.random.uniform(key, (n,), minval=minval, maxval=1.0)``
    of each key: the top 23 bits as a mantissa under 1.0's exponent, minus
    one, scaled to [minval, 1) and raised to at least ``minval``."""
    bits = (random_bits(keys, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = np.float32(minval)
    span = np.float32(1.0) - lo                # in float32, as JAX: 1.0 for lo = tiny
    return torch.clamp_min(floats * float(span) + float(lo), float(lo))


def gumbel(keys, n: int):
    """float32 ``jax.random.gumbel(key, (n,))`` of each key, JAX's "low"
    mode: ``−log(−log(u))`` with u uniform on [tiny, 1)."""
    return -torch.log(-torch.log(uniform(keys, n, _TINY)))


def categorical(keys, logits):
    """``jax.random.categorical(key, logits)`` of each row: the first index
    of the largest ``gumbel + logits``.  keys (B, 2); logits (B, n) float32.
    Returns (B,) int64."""
    return torch.argmax(gumbel(keys, logits.shape[-1]) + logits, dim=-1)
