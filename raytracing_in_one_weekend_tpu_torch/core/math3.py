"""Batched 3-vector math over (..., 3) tensors (counterpart of the JAX
package's core/math3.py): the part the camera, the film and the
wavefront integrator use."""

from __future__ import annotations

import torch

EPSILON = 1e-8


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise dot product over the trailing xyz axis."""
    return torch.sum(a * b, dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b)


def length_sq(a: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * a, dim=-1)


def length(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(a * a, dim=-1))


def _safe_norm(a: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.sqrt(torch.clamp(torch.sum(a * a, dim=-1), min=eps * eps))


def normalize(a: torch.Tensor, eps: float = EPSILON) -> torch.Tensor:
    """a / max(|a|, eps)."""
    return a / _safe_norm(a, eps)[..., None]


def normalize_safe(a: torch.Tensor, eps: float = EPSILON) -> torch.Tensor:
    """Like Unity normalizesafe: a zero vector stays zero."""
    norm = _safe_norm(a, eps)
    out = a / norm[..., None]
    return torch.where((norm > eps)[..., None], out, torch.zeros_like(a))


def lerp(a, b, t):
    return a + (b - a) * t


def saturate(x: torch.Tensor) -> torch.Tensor:
    """clip(x, 0, 1) whose derivative is split in half at x == 0 or 1, as
    jnp.clip's is (torch.clamp passes it whole): Lambert hits sit exactly
    at the reflection lottery's lower tie."""
    return torch.minimum(torch.maximum(x, torch.zeros_like(x)),
                         torch.ones_like(x))


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by unit quaternions q (..., 4) = (x, y, z,
    w) (Entity.cs rotate(transform, normal)), in the two-cross form t = 2
    q_v x v, v' = v + w t + q_v x t with each cross product written out as
    the JAX package's jnp.cross computes it (no fused multiply-add)."""

    def cross3(a, b):
        return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                           dim=-1)

    qv, w = q[..., :3], q[..., 3:4]
    t = 2.0 * cross3(qv, v)
    return v + w * t + cross3(qv, t)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    """q / max(|q|, 1e-12): every rect and box consumer normalizes first,
    so the surface does not depend on a quaternion's scale and the
    gradient with respect to a raw quaternion has no component along it."""
    norm = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    return q / torch.clamp(norm, min=1e-12)


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection of direction d about normal n."""
    return d - 2.0 * dot(d, n)[..., None] * n


def orthonormal_basis(n: torch.Tensor):
    """Branchless Duff et al. orthonormal basis of a unit normal
    (Util/Tools.cs:19-28).  Returns (tangent, bitangent)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    tangent = torch.stack(
        [1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1
    )
    bitangent = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return tangent, bitangent


def tangent_to_world(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Map a tangent-space direction (y up) into the frame of the world
    normal n (Util/Tools.cs:30-46)."""
    tangent, bitangent = orthonormal_basis(n)
    return v[..., 0:1] * tangent + v[..., 1:2] * n + v[..., 2:3] * bitangent


def linear_to_gamma(c: torch.Tensor) -> torch.Tensor:
    """Linear -> sRGB-approx gamma (reference: Util/Tools.cs:185-189)."""
    return torch.clamp(
        1.055 * torch.pow(torch.clamp(c, min=1e-12), 0.416666667) - 0.055,
        min=0.0,
    )


def aces_fitted(c: torch.Tensor) -> torch.Tensor:
    """ACES fitted tonemap (reference: Util/Tools.cs:191-238)."""
    a = torch.stack(
        [
            0.59719 * c[..., 0] + 0.35458 * c[..., 1] + 0.04823 * c[..., 2],
            0.07600 * c[..., 0] + 0.90834 * c[..., 1] + 0.01566 * c[..., 2],
            0.02840 * c[..., 0] + 0.13383 * c[..., 1] + 0.83777 * c[..., 2],
        ],
        dim=-1,
    )
    r = (a * (a + 0.0245786) - 0.000090537) / (
        a * (0.983729 * a + 0.4329510) + 0.238081
    )
    out = torch.stack(
        [
            1.60475 * r[..., 0] - 0.53108 * r[..., 1] - 0.07367 * r[..., 2],
            -0.10208 * r[..., 0] + 1.10813 * r[..., 1] - 0.00605 * r[..., 2],
            -0.00327 * r[..., 0] - 0.07276 * r[..., 1] + 1.07602 * r[..., 2],
        ],
        dim=-1,
    )
    return torch.clamp(out, 0.0, 1.0)
