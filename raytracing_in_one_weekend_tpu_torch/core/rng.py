"""Deterministic threefry keys (counterpart of the JAX package's
core/rng.py), bit for bit with `jax.random`.

The wavefront integrator draws its random numbers from stateless threefry
keys with the JAX package's fold-in discipline `(seed) -> batch -> sample
-> bounce -> purpose`, so it traces the same paths as the JAX wavefront.
This module reproduces what `jax.random` computes under its defaults
(`jax_threefry_partitionable=True`, the threefry2x32 hash):

* a key is a (2,) int64 tensor holding two uint32 words, kept on the host;
* `fold_in` hashes the key with the counter pair (0, data);
* `split` is JAX's fold-like split; `random_bits` hashes the 64-bit iota of
  the output shape, split into high and low words, and xors the two
  output words;
* `uniform` and `randint` turn those bits into numbers as `jax.random`
  does.

uint32 arithmetic is carried in int64 masked to 32 bits (torch's uint32
right shift has no CPU kernel).  The hash is plain PyTorch on whatever
device the output is asked for: JAX's threefry is XLA, not a Pallas
kernel.
"""

from __future__ import annotations

import enum
import math

import torch

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


class Purpose(enum.IntEnum):
    """Stream tags so independent consumers never share bits."""

    PIXEL_JITTER = 0
    LENS = 1
    TIME = 2
    SCATTER_A = 3
    SCATTER_B = 4
    SCATTER_CHOICE = 5
    VOLUME_FREE_PATH = 6
    VOLUME_SCATTER = 7
    DIELECTRIC_CHOICE = 8
    SAMPLE = 9


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK32


def threefry2x32(k1: int, k2: int, x1, x2):
    """The threefry2x32 block cipher of the key (k1, k2) on the counter
    pairs (x1, x2): Python ints or int64 tensors holding uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _MASK32, (x2 + ks[1]) & _MASK32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x[0], x[1]


def _words(key: torch.Tensor) -> tuple[int, int]:
    k1, k2 = (int(v) for v in key.tolist())
    return k1, k2


def _key(k1: int, k2: int) -> torch.Tensor:
    return torch.tensor([k1, k2], dtype=torch.int64)


def PRNGKey(seed: int) -> torch.Tensor:  # noqa: N802 (the JAX name)
    """jax.random.PRNGKey(seed): the 64-bit seed's high and low words."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return _key(seed >> 32, seed & _MASK32)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """jax.random.fold_in(key, data) for a uint32 `data`."""
    return _key(*threefry2x32(*_words(key), 0, int(data) & _MASK32))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split(key, num): (num, 2) keys."""
    counts = torch.arange(num, dtype=torch.int64)
    b1, b2 = threefry2x32(*_words(key), torch.zeros_like(counts), counts)
    return torch.stack([b1, b2], dim=1)


def random_bits(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """32 random bits per element (int64 holding uint32), as
    jax.random.bits(key, shape, uint32)."""
    shape = tuple(shape)
    size = math.prod(shape)
    counts = torch.arange(size, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(*_words(key), counts >> 32, counts & _MASK32)
    return (b1 ^ b2).reshape(shape)


def uniform(key: torch.Tensor, shape=(), minval=0.0, maxval=1.0,
            device=None) -> torch.Tensor:
    """jax.random.uniform(key, shape, float32, minval, maxval): the 23
    high bits as a mantissa in [1, 2), minus one, scaled and shifted.
    XLA's CPU compile fuses the scale and shift into one multiply-add;
    the float64 product of the 23-bit fraction and the float32 span is
    exact, so one rounding of the float64 sum matches it."""
    bits = random_bits(key, shape, device)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    floats = floats - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=device)
    scaled = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


def randint(key: torch.Tensor, shape, minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """jax.random.randint(key, shape, minval, maxval) for int32 bounds:
    two 32-bit draws from a split key, combined modulo the span with
    JAX's uint32 multiplier (2^16 mod span, squared and wrapped to 32
    bits, mod span)."""
    span = max(int(maxval) - int(minval), 1) if maxval > minval else 1
    k1, k2 = split(key, 2)
    higher = random_bits(k1, shape, device)
    lower = random_bits(k2, shape, device)
    multiplier = (2**16) % span
    multiplier = ((multiplier * multiplier) & _MASK32) % span
    offset = (((higher % span) * multiplier) & _MASK32) + lower % span
    offset = (offset & _MASK32) % span
    return (int(minval) + offset).to(torch.int32)


def batch_key(seed_key: torch.Tensor, batch_index: int) -> torch.Tensor:
    return fold_in(seed_key, batch_index)


def sample_key(key: torch.Tensor, sample_index: int) -> torch.Tensor:
    return fold_in(key, Purpose.SAMPLE * 131071 + int(sample_index))


def bounce_key(key: torch.Tensor, bounce_index: int) -> torch.Tensor:
    return fold_in(key, bounce_index)


def purpose_key(key: torch.Tensor, purpose: Purpose) -> torch.Tensor:
    return fold_in(key, int(purpose))
