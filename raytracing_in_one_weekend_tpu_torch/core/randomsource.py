"""Sampler flavors: pixel-correlated draws from blue-noise tables
(counterpart of the JAX package's core/randomsource.py).

Reference: Runtime/RandomSource.cs:15-151 — a per-pixel RNG switched by
NoiseColor {White, Blue, SpatioTemporalBlue} (RandomSource.cs:8-13), with
per-pixel progressive offsets into baked noise tiles (PerPixelNoise.cs:
24-44, R2 offsets) and per-frame texture cycling (BlueNoiseData.cs:42-58).

White noise stays the threefry streams (core/rng.py).  Blue and
spatio-temporal blue supply the pixel-correlated draws from tables: the
reference's baked sets when an asset root holds them (core/stbn.py; their
decoding waits for ROADMAP step 14), else synthesized tileable tiles
(core/noise.make_blue_noise_tile).  Without the baked assets, BLUE is one
64x64x4 tile plus a 4-slice scalar stack made from its channels, and
SPATIO_TEMPORAL_BLUE eight 64x64x4 tiles and no other set; the cosine and
unitvec3 sets exist only with the baked assets (a state built by hand
carries them in the tests).

The float32 operations are the JAX package's, each rounded on its own (as
JAX runs them op by op); tables live on an explicit device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from raytracing_in_one_weekend_tpu_torch.core import noise, stbn
from raytracing_in_one_weekend_tpu_torch.utils.config import NoiseColor
from raytracing_in_one_weekend_tpu_torch.utils.tensors import TensorGroup

TILE = 64  # synthesized-tile size (no baked assets)


@dataclasses.dataclass(frozen=True)
class NoiseState(TensorGroup):
    """Sampler tables.

    tiles — (T, S, S, 4) camera-draw uniforms (jitter xy, lens theta_u,
    radius_u): T = 1 for blue, temporal slices for spatio-temporal blue.
    cosine — (T, S, S, 3) tangent-space (y-up) cosine-hemisphere
    directions, or None.
    scalar — (T', S, S) scalars, or None: with it, every in-path scalar
    draw (rough-normal inversion, lotteries, dielectric choice, the volume
    free path) is flavored.
    unitvec3 — (T, S, S, 3) ~unit directions for the isotropic volume
    scatter, or None."""

    tiles: torch.Tensor
    cosine: Optional[torch.Tensor] = None
    scalar: Optional[torch.Tensor] = None
    unitvec3: Optional[torch.Tensor] = None


def make_noise_state(color: NoiseColor, seed: int = 7, temporal: int = 8,
                     device="cpu") -> Optional[NoiseState]:
    """Sampler tables for the flavor (None for white noise), the JAX
    package's synthesized states bit for bit.  An asset root with the
    baked sets raises NotImplementedError (their decoding is step 14)."""
    if color == NoiseColor.WHITE:
        return None
    if stbn.find_asset_root() is not None:
        raise NotImplementedError(stbn.DECODE_STEP)
    if color == NoiseColor.BLUE:
        tile = noise.make_blue_noise_tile(TILE, 4, seed)[None]
        scalar = tile.transpose(0, 3, 1, 2).reshape(-1, TILE, TILE)
        return NoiseState(
            tiles=torch.tensor(tile, device=device),
            scalar=torch.tensor(scalar, device=device),
        )
    tiles = [noise.make_blue_noise_tile(TILE, 4, seed + i)
             for i in range(temporal)]
    return NoiseState(tiles=torch.stack(
        [torch.tensor(t, device=device) for t in tiles]))


def _pixel_grid(width: int, height: int, device):
    """(ys, xs) int32 of the row-major pixels."""
    p = torch.arange(width * height, dtype=torch.int32, device=device)
    return p // width, p % width


def _tile_lookup(table: torch.Tensor, draw_index, width: int, height: int):
    """(N, C) per-pixel fetch from a (T, S, S, C) table with the
    reference's PerPixelNoise addressing: R2-offset pixel coordinates
    wrapped to the tile, the temporal slice cycling per draw."""
    dev = table.device
    t, size = table.shape[0], table.shape[1]
    draw_index = torch.as_tensor(draw_index, device=dev)
    tile_idx = torch.remainder(draw_index.to(torch.int32), t)
    offs = noise.per_pixel_noise_offset(draw_index.to(torch.float32), size)
    ys, xs = _pixel_grid(width, height, dev)
    tx = torch.remainder(xs + offs[..., 0], size)
    ty = torch.remainder(ys + offs[..., 1], size)
    return table[tile_idx.long(), ty.long(), tx.long()]


def pixel_uniforms(state: NoiseState, draw_index, width: int,
                   height: int) -> torch.Tensor:
    """(width * height, 4) camera uniforms for one draw: the tile lookup
    plus a Cranley-Patterson rotation (R2 of draw + 0.5, then its golden
    ratio shift) so that values differ where offsets collide.  A (N,)
    draw_index (per-pixel progressive counters) vectorizes every per-draw
    quantity."""
    vals = _tile_lookup(state.tiles, draw_index, width, height)
    draw = torch.as_tensor(draw_index, device=vals.device)
    rot = noise.r2_sequence(draw.to(torch.float32) + 0.5)
    rotation = torch.cat([rot, rot * 0.61803398875 + 0.1], dim=-1)
    return torch.remainder(vals + rotation.expand(vals.shape), 1.0)


def pixel_cosine(state: Optional[NoiseState], draw_index, width: int,
                 height: int) -> Optional[torch.Tensor]:
    """(width * height, 3) tangent-space cosine directions for one draw
    from the cosine set (RandomSource.cs:63-89), or None; unit vectors
    take no rotation."""
    if state is None or state.cosine is None:
        return None
    return _tile_lookup(state.cosine, draw_index, width, height)


def _tile_lookup_split(table, slice_index, offset_index, width: int,
                       height: int):
    """_tile_lookup with the temporal slice decoupled from the R2 offset
    index: consecutive draws step slices by 1 (the sets' optimized axis),
    (bounce, purpose) ride the spatial offsets.  The offset index wraps
    mod 4096 before the float R2 math."""
    dev = table.device
    t, size = table.shape[0], table.shape[1]
    tile_idx = torch.remainder(
        torch.as_tensor(slice_index, device=dev).to(torch.int32), t)
    offs = noise.per_pixel_noise_offset(torch.remainder(
        torch.as_tensor(offset_index, device=dev).to(torch.float32),
        4096.0), size)
    ys, xs = _pixel_grid(width, height, dev)
    tx = torch.remainder(xs + offs[..., 0], size)
    ty = torch.remainder(ys + offs[..., 1], size)
    return table[tile_idx.long(), ty.long(), tx.long()]


def _split_indices(draw_index, bounce, dev):
    idx = torch.as_tensor(draw_index, device=dev).to(torch.float32)
    b = torch.as_tensor(bounce, device=dev).to(torch.float32)
    return idx, b


def pixel_scalar(state: Optional[NoiseState], draw_index, bounce,
                 purpose: int, width: int,
                 height: int) -> Optional[torch.Tensor]:
    """(width * height,) scalars from the scalar set (RandomSource.cs:
    27-33), or None: the slice advances 1 a draw, (bounce, purpose)
    decorrelate through the R2 offset and a Cranley-Patterson rotation."""
    if state is None or state.scalar is None:
        return None
    idx, b = _split_indices(draw_index, bounce, state.scalar.device)
    off_idx = idx * 97.0 + b * 11.0 + float(purpose) * 29.0
    vals = _tile_lookup_split(state.scalar[..., None], idx + b, off_idx,
                              width, height)[..., 0]
    rot = noise.r2_sequence(torch.remainder(off_idx, 4096.0) + 0.5)[..., 0]
    return torch.remainder(vals + rot, 1.0)


def pixel_cosine_at(state: Optional[NoiseState], draw_index, bounce,
                    width: int, height: int) -> Optional[torch.Tensor]:
    """pixel_cosine at every bounce: slice stride 1 a draw, per-bounce R2
    offsets (salt 7), no rotation; None without a cosine set."""
    if state is None or state.cosine is None:
        return None
    idx, b = _split_indices(draw_index, bounce, state.cosine.device)
    return _tile_lookup_split(state.cosine, idx + b,
                              idx * 97.0 + b * 11.0 + 7.0, width, height)


def pixel_unitvec3(state: Optional[NoiseState], draw_index, bounce,
                   width: int, height: int) -> Optional[torch.Tensor]:
    """(width * height, 3) ~unit directions from the unitvec3 set for the
    isotropic volume scatter (RandomSource.cs:113-128), or None: the
    cosine set's discipline with salt 13; consumers normalize."""
    if state is None or state.unitvec3 is None:
        return None
    idx, b = _split_indices(draw_index, bounce, state.unitvec3.device)
    return _tile_lookup_split(state.unitvec3, idx + b,
                              idx * 97.0 + b * 11.0 + 13.0, width, height)
