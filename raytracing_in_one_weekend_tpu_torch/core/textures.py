"""Procedural texture table, sampled struct-of-arrays style (counterpart
of the JAX package's core/textures.py).

Reference: Runtime/Texture.cs:13-139 — TextureType {None, Constant,
CheckerPattern, PerlinNoise, Image, ConstantScalar} with SampleColor /
SampleScalar.  The reference's checker and Perlin branches are commented
out (Texture.cs:61-78, 106-123); the JAX package implements them live (the
iq normal-projection checker and the turbulence-modulated Perlin marble
the dead code describes), and so does the port.  Image textures sit in one
(A, H, W, 3) atlas, read nearest-texel.

A texture table is a group of parallel tensors; `tex_id` indexes rows.
Sampling every ray's texture at once is a gather and a masked blend over
the type.
"""

from __future__ import annotations

import dataclasses
import enum

import torch

from raytracing_in_one_weekend_tpu_torch.core import noise as noise_mod
from raytracing_in_one_weekend_tpu_torch.utils.tensors import TensorGroup


class TextureType(enum.IntEnum):
    """Reference: Runtime/Texture.cs TextureType."""

    NONE = 0
    CONSTANT = 1
    CHECKER = 2
    PERLIN = 3
    IMAGE = 4
    CONSTANT_SCALAR = 5


@dataclasses.dataclass(frozen=True)
class TextureTable(TensorGroup):
    type: torch.Tensor  # (K,) int32
    main_color: torch.Tensor  # (K, 3) float32
    secondary_color: torch.Tensor  # (K, 3) float32
    parameter: torch.Tensor  # (K,) noise frequency / constant scalar
    scalar_channel: torch.Tensor  # (K,) int32 channel for SampleScalar
    image_index: torch.Tensor  # (K,) int32 row into the atlas (-1 = none)
    atlas: torch.Tensor | None = None  # (A, H, W, 3) float32, or None
    perlin: noise_mod.PerlinTables | None = None


def _checker_uv(normal: torch.Tensor) -> torch.Tensor:
    """Normal-projected uv of the checker (Texture.cs:63-72, after iq,
    https://www.shadertoy.com/view/ltl3D8): the dominant normal axis, the
    other two projected on it."""
    n = torch.abs(normal)
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    use_x = (nx > ny) & (nx > nz)
    use_y = (ny > nx) & (ny > nz)
    v = torch.where(
        use_x[..., None],
        normal,
        torch.where(
            use_y[..., None],
            torch.stack([normal[..., 1], normal[..., 2], normal[..., 0]], -1),
            torch.stack([normal[..., 2], normal[..., 0], normal[..., 1]], -1),
        ),
    )
    safe_x = torch.where(v[..., 0] == 0.0, 1.0, v[..., 0])
    q = v[..., 1:] / safe_x[..., None]
    return 0.5 + 0.5 * q


def _sample_all(table: TextureTable, tex_id, uv, position, normal):
    """Gather the rays' texture rows and evaluate every live branch once:
    (type, color (N, 3), scalar (N,))."""
    tex_id = tex_id.long()
    t = table.type[tex_id]
    main = table.main_color[tex_id]
    secondary = table.secondary_color[tex_id]
    param = table.parameter[tex_id]

    color = torch.zeros_like(main)
    color = torch.where((t == TextureType.CONSTANT)[..., None], main, color)
    color = torch.where((t == TextureType.CONSTANT_SCALAR)[..., None],
                        param[..., None], color)

    if table.perlin is not None:
        # 0.5 (1 + sin(freq z + 10 turbulence(p))) main (Texture.cs:74-78)
        turb = noise_mod.turbulence(table.perlin, position)
        marble = 0.5 * (1.0 + torch.sin(param * position[..., 2]
                                        + 10.0 * turb))
        color = torch.where((t == TextureType.PERLIN)[..., None],
                            marble[..., None] * main, color)

    cuv = _checker_uv(normal)
    sines = torch.sin(torch.pi * param[..., None] * cuv)
    checker = torch.where((sines[..., 0] * sines[..., 1] < 0.0)[..., None],
                          main, secondary)
    color = torch.where((t == TextureType.CHECKER)[..., None], checker, color)

    texel = None
    if table.atlas is not None:
        a, h, w = table.atlas.shape[:3]
        img = torch.clamp(table.image_index[tex_id], 0, a - 1).long()
        # nearest texel, as the reference (Texture.cs:82-90)
        cx = torch.clamp((uv[..., 0] * w).to(torch.int32), 0, w - 1).long()
        cy = torch.clamp((uv[..., 1] * h).to(torch.int32), 0, h - 1).long()
        texel = table.atlas[img, cy, cx]
        color = torch.where((t == TextureType.IMAGE)[..., None],
                            texel * main, color)

    ch = table.scalar_channel[tex_id].long()[..., None]
    scalar = torch.gather(main, -1, ch)[..., 0]
    scalar = torch.where(t == TextureType.CONSTANT, scalar, 0.0)
    scalar = torch.where(t == TextureType.CONSTANT_SCALAR, param, scalar)
    if texel is not None:
        img_scalar = torch.gather(texel, -1, ch)[..., 0]
        scalar = torch.where(t == TextureType.IMAGE,
                             img_scalar * torch.gather(main, -1, ch)[..., 0],
                             scalar)
    scalar = torch.where(t == TextureType.CHECKER, checker[..., 0], scalar)
    return t, color, scalar


def sample_color(table, tex_id, uv, position, normal):
    """SampleColor (Texture.cs:51-93); NONE gives 0."""
    return _sample_all(table, tex_id, uv, position, normal)[1]


def sample_scalar(table, tex_id, uv, position, normal):
    """SampleScalar (Texture.cs:96-138); NONE gives 0."""
    return _sample_all(table, tex_id, uv, position, normal)[2]
