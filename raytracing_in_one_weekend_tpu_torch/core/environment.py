"""Sky sampling (counterpart of the JAX package's core/environment.py).

Reference: Environment.cs:5-18 with the gradient evaluated at
SampleBatchJob.cs:352-354, and the HDR cubemap sampler at
Texture.cs:141-211 (major-axis face select, then the nearest texel).
"""

from __future__ import annotations

import torch

from raytracing_in_one_weekend_tpu_torch.scene.scene import SkyType


def sample_sky(env, direction: torch.Tensor) -> torch.Tensor:
    """Radiance from the sky along (N, 3) unit directions:
    lerp(bottom, top, 0.5 * (dir.y + 1)) for the gradient, the cubemap's
    nearest texel for the cubemap (differentiable in the texel values),
    black for none."""
    t = 0.5 * (direction[..., 1] + 1.0)
    gradient = env.sky_bottom + (env.sky_top - env.sky_bottom) * t[..., None]
    out = torch.where(env.sky_type == SkyType.GRADIENT, gradient,
                      torch.zeros_like(gradient))
    if env.cubemap is not None:
        cube = _sample_cubemap(env.cubemap, direction)
        out = torch.where(env.sky_type == SkyType.CUBEMAP, cube, out)
    return out


def cubemap_index(dx, dy, dz, w: int, h: int):
    """(face, y, x) int64 of the nearest texel of a cubemap with w x h
    faces along the direction (dx, dy, dz) (the JAX package's
    `_sample_cubemap`, Texture.cs:172-210): the major axis (ties to x,
    then y), the per-face numerators, one IEEE division by the major
    component, then min(int((uv + 1) * (size / 2)), size - 1).  The
    batch kernels compute the same float32 operations in the same order
    (csrc/megatrace_bounce.cuh::cube_texel), so all pick one texel."""
    ax, ay, az = torch.abs(dx), torch.abs(dy), torch.abs(dz)
    use_x = (ax >= ay) & (ax >= az)
    use_y = (ay > ax) & (ay >= az)
    positive = torch.where(use_x, dx >= 0.0,
                           torch.where(use_y, dy >= 0.0, dz >= 0.0))
    u_num = torch.where(use_x, torch.where(dx >= 0.0, -dz, dz),
                        torch.where(use_y, dx,
                                    torch.where(dz >= 0.0, dx, -dx)))
    v_num = torch.where(use_x, -dy,
                        torch.where(use_y, torch.where(dy >= 0.0, dz, -dz),
                                    -dy))
    major = torch.clamp(torch.where(use_x, ax, torch.where(use_y, ay, az)),
                        min=1e-12)
    face = (torch.where(use_x, 0, torch.where(use_y, 2, 4))
            + torch.where(positive, 0, 1))
    cx = torch.clamp(((u_num / major + 1.0) * (w / 2.0)).to(torch.int64),
                     0, w - 1)
    cy = torch.clamp(((v_num / major + 1.0) * (h / 2.0)).to(torch.int64),
                     0, h - 1)
    return face, cy, cx


def _sample_cubemap(cubemap: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Nearest-texel lookup of the (6, H, W, 3) faces (+x, -x, +y, -y, +z,
    -z) along (N, 3) directions, like the reference's raw pointer fetch.
    The texel index is a decision (no gradient); the texel values keep
    theirs."""
    d = v.detach()
    face, cy, cx = cubemap_index(d[..., 0], d[..., 1], d[..., 2],
                                 cubemap.shape[2], cubemap.shape[1])
    return cubemap[face, cy, cx]
