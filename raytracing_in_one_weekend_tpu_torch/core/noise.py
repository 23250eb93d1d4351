"""Noise stack: Perlin gradient noise, the R2 low-discrepancy sequence
and a synthesized blue-noise tile (counterpart of the JAX package's
core/noise.py).

Reference components:
  * Runtime/PerlinNoise.cs:8-69 — surflet gradient noise and 7-octave
    turbulence over three 256-entry permutation tables and 256 random unit
    vectors (generated Fisher-Yates style in Unity/PerlinNoiseData.cs:
    22-63).  The tables come from numpy's `default_rng(seed)`, so they
    equal the JAX package's bit for bit.
  * Runtime/R2.cs:6-17 — the R2 quasirandom sequence (plastic constant).
  * Runtime/BlueNoise.cs + Unity/BlueNoiseData.cs — the reference loads
    64x64 baked blue-noise textures; without them a tile is synthesized on
    the host by iterated high-pass re-ranking (numpy, the JAX package's
    bytes for the same seed).
  * Runtime/PerPixelNoise.cs:7-45 — per-pixel progressive offsets into the
    tile, driven by the R2 sequence.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracing_in_one_weekend_tpu_torch.utils.tensors import TensorGroup

# --- R2 sequence (Runtime/R2.cs:6-17) ---------------------------------------

_PLASTIC = 1.32471795724474602596  # g: the plastic constant
R2_ALPHA = np.array([1.0 / _PLASTIC, 1.0 / (_PLASTIC * _PLASTIC)], np.float32)


def r2_sequence(n) -> torch.Tensor:
    """n-th element(s) of the R2 sequence in [0, 1)^2: (..., 2) float32
    frac(0.5 + n * alpha), each operation rounded on its own."""
    n = torch.as_tensor(n, dtype=torch.float32)
    alpha = torch.from_numpy(R2_ALPHA).to(n.device)
    return torch.remainder(0.5 + n[..., None] * alpha, 1.0)


def per_pixel_noise_offset(draw_index, tile_size: int) -> torch.Tensor:
    """R2-driven per-draw offset of pixel coordinates into the noise tile
    (Runtime/PerPixelNoise.cs:24-44): (..., 2) int32."""
    return (r2_sequence(draw_index) * tile_size).to(torch.int32)


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


# --- Blue-noise tile (Runtime/BlueNoise.cs + BlueNoiseData.cs) --------------


def make_blue_noise_tile(size: int = 64, channels: int = 4,
                         seed: int = 7) -> np.ndarray:
    """A tileable blue-noise-like tile by iterated high-pass re-ranking
    (a void-and-cluster stand-in for the reference's baked 64x64 HDR
    textures): (size, size, channels) float32 in [0, 1), the JAX package's
    bytes for the same seed (the same numpy operations in the same
    order)."""
    rng = np.random.default_rng(seed)
    out = np.empty((size, size, channels), np.float32)
    # toroidal Gaussian blur in Fourier space, sharpness 1.0, 64 rounds
    fy = np.fft.fftfreq(size)[:, None]
    fx = np.fft.fftfreq(size)[None, :]
    gauss = np.exp(-((fx**2 + fy**2) * (2.0 * np.pi * 1.0) ** 2) / 2.0)
    for c in range(channels):
        vals = rng.random((size, size)).astype(np.float32)
        for _ in range(64):
            blurred = np.real(np.fft.ifft2(np.fft.fft2(vals) * gauss))
            highpass = vals - blurred
            order = np.argsort(highpass.ravel())
            ranks = np.empty_like(order)
            ranks[order] = np.arange(size * size)
            vals = (ranks.reshape(size, size) + 0.5).astype(np.float32) / (
                size * size
            )
        out[..., c] = vals
    return out
