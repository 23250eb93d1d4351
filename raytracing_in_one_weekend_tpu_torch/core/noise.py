"""Perlin noise (counterpart of the JAX package's core/noise.py, its
Perlin part).

Reference: Runtime/PerlinNoise.cs:8-69 — surflet gradient noise and
7-octave turbulence over three 256-entry permutation tables and 256 random
unit vectors (generated Fisher-Yates style in
Unity/PerlinNoiseData.cs:22-63).  The tables come from numpy's
`default_rng(seed)`, so they equal the JAX package's bit for bit.  The R2
sequence and the blue-noise tiles of that module belong to the sampler
flavors (ROADMAP queue 1, step 11).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracing_in_one_weekend_tpu_torch.utils.tensors import TensorGroup


@dataclasses.dataclass(frozen=True)
class PerlinTables(TensorGroup):
    perm_x: torch.Tensor  # (256,) int32
    perm_y: torch.Tensor  # (256,) int32
    perm_z: torch.Tensor  # (256,) int32
    random_vectors: torch.Tensor  # (256, 3) float32


def make_perlin_tables(seed: int = 1, device="cpu") -> PerlinTables:
    """Host-side table generation (Unity/PerlinNoiseData.cs:22-63):
    Fisher-Yates permutations and uniform unit-sphere vectors."""
    rng = np.random.default_rng(seed)
    perms = [rng.permutation(256).astype(np.int32) for _ in range(3)]
    z = rng.uniform(-1.0, 1.0, 256).astype(np.float32)
    angle = rng.uniform(0.0, 2.0 * np.pi, 256).astype(np.float32)
    r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    vectors = np.stack([np.cos(angle) * r, np.sin(angle) * r, z], axis=-1)
    return PerlinTables(
        *(torch.tensor(p, device=device) for p in perms),
        random_vectors=torch.tensor(vectors, device=device),
    )


def _falloff(t: torch.Tensor) -> torch.Tensor:
    """Surflet falloff (PerlinNoise.cs:24-28)."""
    t = torch.abs(t)
    return torch.where(t >= 1.0, 0.0, 1.0 - (3.0 - 2.0 * t) * t * t)


def perlin_noise(tables: PerlinTables, position: torch.Tensor) -> torch.Tensor:
    """Surflet gradient noise (PerlinNoise.cs:36-52) of (..., 3)
    positions, summed over the 8 cell corners and clipped to [0, 1]."""
    cell = torch.floor(position).to(torch.int32)
    result = torch.zeros(position.shape[:-1], dtype=position.dtype,
                         device=position.device)
    for dk in (0, 1):
        for dj in (0, 1):
            for di in (0, 1):
                corner = cell + torch.tensor([di, dj, dk], dtype=torch.int32,
                                             device=position.device)
                h = (tables.perm_x[(corner[..., 0] & 255).long()]
                     ^ tables.perm_y[(corner[..., 1] & 255).long()]
                     ^ tables.perm_z[(corner[..., 2] & 255).long()])
                frac = position - corner.to(position.dtype)
                grad = tables.random_vectors[h.long()]
                f = _falloff(frac)
                dot = torch.sum(frac * grad, -1)
                result = result + f[..., 0] * f[..., 1] * f[..., 2] * dot
    return torch.clamp(result, 0.0, 1.0)


def turbulence(tables: PerlinTables, position: torch.Tensor,
               depth: int = 7) -> torch.Tensor:
    """`depth`-octave fBm (PerlinNoise.cs:54-68), clipped to [0, 1]."""
    acc = torch.zeros(position.shape[:-1], dtype=position.dtype,
                      device=position.device)
    p = position
    weight = 1.0
    for _ in range(depth):
        acc = acc + weight * perlin_noise(tables, p)
        weight *= 0.5
        p = p * 2.0
    return torch.clamp(acc, 0.0, 1.0)
