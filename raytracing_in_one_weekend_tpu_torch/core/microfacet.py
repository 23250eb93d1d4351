"""Trowbridge-Reitz (GGX) microfacet functions (counterpart of the JAX
package's core/microfacet.py): the part the Standard material's
reflection lottery uses (Microfacet.cs:10-13, 49-83)."""

from __future__ import annotations

import torch

from raytracing_in_one_weekend_tpu_torch.core import math3


def roughness_to_alpha(roughness: torch.Tensor) -> torch.Tensor:
    """PBRT fitted polynomial (Microfacet.cs:74-83)."""
    roughness = torch.clamp(roughness, min=1e-3)
    x = torch.log(roughness)
    return (
        1.62142
        + 0.819955 * x
        + 0.1734 * x * x
        + 0.0171201 * x * x * x
        + 0.000640711 * x * x * x * x
    )


def smith_lambda(w: torch.Tensor, normal: torch.Tensor,
                 roughness: torch.Tensor) -> torch.Tensor:
    """Smith Lambda for GGX (Microfacet.cs:49-72).

    Degenerate lanes (grazing or zero normals, e.g. missed rays fed
    through the branchless scatter) see constant inputs to the division:
    a floored denominator alone keeps the primal finite, but its
    transpose -num/den^2 overflows float32, and inf times a masked lane's
    zero cotangent is a NaN that spreads through every gradient."""
    cos_theta = math3.dot(w, normal)
    sq_cos = cos_theta * cos_theta
    sq_sin = torch.clamp(1.0 - sq_cos, min=0.0)
    degenerate = sq_cos < 1e-12
    safe_sq_cos = torch.where(degenerate, 1.0, sq_cos)
    sq_tan = torch.where(degenerate, 0.0, sq_sin) / safe_sq_cos
    alpha = roughness_to_alpha(roughness)
    a2t2 = alpha * alpha * sq_tan
    lam = (-1.0 + torch.sqrt(1.0 + a2t2)) / 2.0
    return torch.where(degenerate, 0.0, lam)


def smith_masking_shadowing(w: torch.Tensor, normal: torch.Tensor,
                            roughness: torch.Tensor) -> torch.Tensor:
    """G1 (Microfacet.cs:10-13)."""
    return 1.0 / (1.0 + smith_lambda(w, normal, roughness))
