"""Monte-Carlo sampling primitives over ray lanes (counterpart of the JAX
package's core/sampling.py).

Each function mirrors one reference RandomSource method
(Runtime/RandomSource.cs) and takes its U[0,1) inputs explicitly.
"""

from __future__ import annotations

import math

import torch

from raytracing_in_one_weekend_tpu_torch.core import math3

TWO_PI = 2.0 * math.pi


def in_unit_disk(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Uniform point in the unit disk by polar inversion
    (RandomSource.cs:40-61).  Returns (..., 2)."""
    theta = u * TWO_PI
    radius = torch.sqrt(v)
    return radius[..., None] * torch.stack(
        [torch.cos(theta), torch.sin(theta)], dim=-1
    )


def cosine_hemisphere(u: torch.Tensor, v: torch.Tensor,
                      normal: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted hemisphere direction about `normal`
    (RandomSource.cs:63-89): tangent-space (r cos t, sqrt(1-u), r sin t)
    with r = sqrt(u)."""
    radius = torch.sqrt(u)
    theta = v * TWO_PI
    x = radius * torch.cos(theta)
    z = radius * torch.sin(theta)
    y = torch.sqrt(torch.clamp(1.0 - u, min=0.0))
    return math3.tangent_to_world(torch.stack([x, y, z], dim=-1), normal)


def unit_sphere(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Uniform direction on the unit sphere (RandomSource.cs:113-128)."""
    z = u * 2.0 - 1.0
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    angle = v * TWO_PI
    return torch.stack([torch.cos(angle) * r, torch.sin(angle) * r, z],
                       dim=-1)


def schlick(cosine: torch.Tensor, refractive_index) -> torch.Tensor:
    """Schlick's Fresnel approximation (Material.cs:212-217)."""
    r0 = (1.0 - refractive_index) / (1.0 + refractive_index)
    r0 = r0 * r0
    m = torch.clamp(1.0 - cosine, min=0.0)
    return r0 + (1.0 - r0) * m * m * m * m * m


def refract(v: torch.Tensor, n: torch.Tensor, ni_over_nt: torch.Tensor):
    """Snell refraction (Material.cs:198-210).  Returns (direction,
    can_refract); under total internal reflection the direction is
    finite garbage for the caller to mask, and the masked lanes never
    see sqrt(0), whose backward is inf."""
    dt = math3.dot(v, n)
    discriminant = 1.0 - ni_over_nt * ni_over_nt * (1.0 - dt * dt)
    can_refract = discriminant > 0.0
    sqrt_disc = torch.sqrt(torch.where(can_refract, discriminant, 1.0))
    sqrt_disc = torch.where(can_refract, sqrt_disc, 0.0)
    refracted = (
        ni_over_nt[..., None] * (v - n * dt[..., None])
        - n * sqrt_disc[..., None]
    )
    return refracted, can_refract
