"""Batched ray-sphere, ray-rect, ray-box and ray-triangle intersection
(counterpart of the JAX package's ops/geometry.py, its sphere, rect, box
and triangle functions).

Reference: Runtime/HitTests.cs:23-60 (spheres), :62-78 (one-sided
local-XY rects), :81-113 (Majercik boxes) and :116-150
(Möller–Trumbore).  Every function returns a large but finite "miss"
distance (BIG) instead of a flag, so the nearest-hit reduction is a masked
min and everything stays differentiable.  The square roots are
adjoint-safe: lanes without a root never see sqrt(0), whose backward is
inf and would poison the gradient through 0 * inf; a degenerate triangle
(det == 0) divides by 1.  Rects and boxes take their quaternions
normalized (math3.quat_normalize), as the JAX package's do.
"""

from __future__ import annotations

import torch

from raytracing_in_one_weekend_tpu_torch.core import math3

BIG = 1e30  # "no hit" distance sentinel
T_MIN = 0.0  # reference FindHits uses tMin = 0 (SampleBatchJob.cs:458)


def _roots(b, a, c_term, t_min):
    """(t_entry, t_exit) of the quadratic a t^2 + 2 b t + c = 0."""
    discriminant = b * b - a * c_term
    has_root = discriminant > 0.0
    sqrt_disc = torch.sqrt(torch.where(has_root, discriminant, 1.0))
    sqrt_disc = torch.where(has_root, sqrt_disc, 0.0)
    t_near = (-b - sqrt_disc) / a
    t_far = (-b + sqrt_disc) / a
    near_ok = has_root & (t_near > t_min)
    far_ok = has_root & (t_far > t_min)
    # the near root, then the far root (HitTests.cs:40-56): a ray that
    # starts inside the sphere hits the far one
    t_entry = torch.where(near_ok, t_near, torch.where(far_ok, t_far, BIG))
    t_exit = torch.where(far_ok, t_far, BIG)
    return t_entry, t_exit


def sphere_hit_all(
    origin: torch.Tensor,  # (N, 3)
    direction: torch.Tensor,  # (N, 3)
    centers: torch.Tensor,  # (S, 3)
    radii: torch.Tensor,  # (S,)
    t_min: float = T_MIN,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Quadratic sphere test, all rays x all spheres, with the dot
    products expanded as the JAX package's (b = o.d - d.c, |o - c|^2 =
    |o|^2 - 2 o.c + |c|^2).  Returns (t_entry (N, S), t_exit (N, S)), BIG
    where there is no hit."""
    o_dot_d = math3.dot(origin, direction)[:, None]
    a = math3.length_sq(direction)[:, None]
    o_sq = math3.length_sq(origin)[:, None]
    d_dot_c = direction @ centers.T
    o_dot_c = origin @ centers.T
    c_sq = math3.length_sq(centers)[None, :]
    b = o_dot_d - d_dot_c
    c_term = o_sq - 2.0 * o_dot_c + c_sq - (radii * radii)[None, :]
    return _roots(b, a, c_term, t_min)


def sphere_hit_single(
    origin: torch.Tensor,  # (N, 3)
    direction: torch.Tensor,  # (N, 3)
    centers: torch.Tensor,  # (N, 3): one (gathered) sphere per ray
    radii: torch.Tensor,  # (N,)
    t_min: float = T_MIN,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-ray single-sphere quadratic: the differentiable re-evaluation
    of the winner that the selection kernel (ops/sphere_select.py)
    picked, with gradients to the gathered center and radius."""
    oc = origin - centers
    a = math3.length_sq(direction)
    b = math3.dot(oc, direction)
    c = math3.length_sq(oc) - radii * radii
    return _roots(b, a, c, t_min)


def sphere_normal_at(
    point: torch.Tensor,  # (N, 3)
    center: torch.Tensor,  # (N, 3)
    radius: torch.Tensor,  # (N,)
) -> torch.Tensor:
    """Outward geometric normal (p - c) / r (HitTests.cs:41,52)."""
    return (point - center) / radius[..., None]


def _moller_trumbore(origin, direction, edge_a, edge_b, vert0):
    """(det, u, v, t) of Möller–Trumbore, broadcasting over leading axes
    (the JAX package's expression order, plain float32)."""
    pvec = math3.cross(direction, edge_a)
    det = math3.dot(edge_b, pvec)
    inv_det = 1.0 / torch.where(det == 0.0, 1.0, det)
    tvec = origin - vert0
    u = math3.dot(tvec, pvec) * inv_det
    qvec = math3.cross(tvec, edge_b)
    v = math3.dot(direction, qvec) * inv_det
    t = math3.dot(edge_a, qvec) * inv_det
    return det, u, v, t


def _tri_ok(det, u, v, t, t_min):
    return ((det != 0.0) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
            & (u + v <= 1.0) & (t > t_min))


def triangle_hit_single(
    origin: torch.Tensor,  # (M, 3)
    direction: torch.Tensor,  # (M, 3)
    edge_a: torch.Tensor,  # (M, 3): one (gathered) triangle per ray
    edge_b: torch.Tensor,  # (M, 3)
    vert0: torch.Tensor,  # (M, 3)
    t_min: float = T_MIN,
) -> torch.Tensor:
    """Per-ray single-triangle Möller–Trumbore: the differentiable
    re-evaluation of the winner that the selection kernel
    (ops/triangle_select.py) picked; distance only (the winner's normal and
    uv come from intersect._shading_attributes)."""
    det, u, v, t = _moller_trumbore(origin, direction, edge_a, edge_b, vert0)
    return torch.where(_tri_ok(det, u, v, t, t_min), t, BIG)


def triangle_hit_all(
    origin: torch.Tensor,  # (N, 3)
    direction: torch.Tensor,  # (N, 3)
    edge_a: torch.Tensor,  # (T, 3) v2 - v0 (reference Data[0])
    edge_b: torch.Tensor,  # (T, 3) v1 - v0 (reference Data[1])
    vert0: torch.Tensor,  # (T, 3) v0 (reference Data[2])
    normals: torch.Tensor,  # (T, 3, 3) per-vertex normals (columns)
    uvs: torch.Tensor,  # (T, 2, 3) per-vertex texcoords (columns)
    t_min: float = T_MIN,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Möller–Trumbore of all rays against all triangles, with the
    barycentric normal and uv lerps (world-space triangles, Entity.cs:
    91-97).  Returns (t (N, T), normal (N, T, 3), uv (N, T, 2))."""
    det, u, v, t = _moller_trumbore(
        origin[:, None], direction[:, None], edge_a[None], edge_b[None],
        vert0[None])
    t = torch.where(_tri_ok(det, u, v, t, t_min), t, BIG)
    bary = torch.stack([1.0 - u - v, u, v], dim=-1)  # (N, T, 3)
    normal = torch.einsum("tij,ntj->nti", normals, bary)
    uv = torch.einsum("tij,ntj->nti", uvs, bary)
    return t, normal, uv


# ---------------------------------------------------------------------------
# Rects (HitTests.cs:62-78) and boxes (HitTests.cs:81-113)
# ---------------------------------------------------------------------------


def _rect_t(o_local, d_local, xy_from, xy_to, t_min):
    dz = d_local[..., 2]
    safe_dz = torch.where(dz == 0.0, 1.0, dz)
    t = -o_local[..., 2] / safe_dz
    xy = o_local[..., :2] + t[..., None] * d_local[..., :2]
    inside = torch.all((xy >= xy_from) & (xy <= xy_to), dim=-1)
    ok = (dz < 0.0) & (t > t_min) & inside
    return torch.where(ok, t, BIG)


def rect_hit_all(
    origin: torch.Tensor,  # (N, 3)
    direction: torch.Tensor,  # (N, 3)
    rot: torch.Tensor,  # (R, 4) world-from-local quaternion
    pos: torch.Tensor,  # (R, 3) world translation
    xy_from: torch.Tensor,  # (R, 2)
    xy_to: torch.Tensor,  # (R, 2)
    t_min: float = T_MIN,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One-sided rect in its local XY plane, all rays x all rects: the ray
    goes to entity space (Entity.cs:91-97) and hits only when its local
    direction faces the plane (dir.z < 0, HitTests.cs:69).  Returns (t (N,
    R), world normals (N, R, 3)); the normal is the rotated local +Z."""
    rot = math3.quat_normalize(rot)
    inv_rot = math3.quat_conjugate(rot)
    o_local = math3.quat_rotate(inv_rot[None], origin[:, None] - pos[None])
    d_local = math3.quat_rotate(inv_rot[None], direction[:, None].expand(
        -1, rot.shape[0], -1))
    t = _rect_t(o_local, d_local, xy_from[None], xy_to[None], t_min)
    up = torch.zeros_like(rot[:, :3])
    up[:, 2] = 1.0
    world_n = math3.quat_rotate(rot, up)
    return t, world_n[None].expand(origin.shape[0], -1, -1)


def _box_entry(o, d, extents, t_min):
    """(t_entry, local face normal, t_exit) of the Majercik box test in
    the box frame (o already offset by d t_min)."""
    inside = torch.amax(torch.abs(o) / torch.clamp(extents, min=1e-30),
                        dim=-1) < 1.0
    winding = torch.where(inside, -1.0, 1.0)
    sgn = -torch.sign(d)
    safe_d = torch.where(d == 0.0, 1e-30, d)
    dist_to_plane = (extents * winding[..., None] * sgn - o) / safe_d

    def face_test(axis):
        u, v = (axis + 1) % 3, (axis + 2) % 3
        da = dist_to_plane[..., axis]
        pu = o[..., u] + d[..., u] * da
        pv = o[..., v] + d[..., v] * da
        return ((da >= 0.0) & (torch.abs(pu) < extents[..., u])
                & (torch.abs(pv) < extents[..., v]))

    test_x, test_y, test_z = face_test(0), face_test(1), face_test(2)
    t = torch.where(test_x, dist_to_plane[..., 0],
                    torch.where(test_y, dist_to_plane[..., 1],
                                dist_to_plane[..., 2]))
    t = torch.where(test_x | test_y | test_z, t + t_min, BIG)
    local_n = torch.stack([
        torch.where(test_x, sgn[..., 0], 0.0),
        torch.where(test_y & ~test_x, sgn[..., 1], 0.0),
        torch.where(test_z & ~test_x & ~test_y, sgn[..., 2], 0.0),
    ], dim=-1)
    # the exit root of the plain slab test (the convex volume walk's);
    # 1 / 0 is +inf (SampleBatchJob.cs:409-412)
    inv_d = torch.where(d == 0.0, float("inf"),
                        1.0 / torch.where(d == 0.0, 1.0, d))
    t0 = (-extents - o) * inv_d
    t1 = (extents - o) * inv_d
    t_far = torch.amin(torch.maximum(t0, t1), dim=-1) + t_min
    t_near = torch.amax(torch.minimum(t0, t1), dim=-1) + t_min
    t_exit = torch.where((t_far > t_min) & (t_near < t_far), t_far, BIG)
    return t, local_n, t_exit


def box_hit_all(
    origin: torch.Tensor,  # (N, 3)
    direction: torch.Tensor,  # (N, 3)
    rot: torch.Tensor,  # (B, 4)
    pos: torch.Tensor,  # (B, 3)
    extents: torch.Tensor,  # (B, 3) half-sizes
    t_min: float = T_MIN,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Majercik et al. ray-box in entity space, all rays x all boxes:
    (t_entry (N, B), world normal (N, B, 3), t_exit (N, B)).  The origin
    is offset by t_min along the ray first (HitTests.cs:84)."""
    rot = math3.quat_normalize(rot)
    inv_rot = math3.quat_conjugate(rot)
    o = math3.quat_rotate(inv_rot[None], origin[:, None] - pos[None])
    d = math3.quat_rotate(inv_rot[None], direction[:, None].expand(
        -1, rot.shape[0], -1))
    o = o + d * t_min
    t, local_n, t_exit = _box_entry(o, d, extents[None], t_min)
    world_n = math3.quat_rotate(rot[None].expand(origin.shape[0], -1, -1),
                                local_n)
    return t, world_n, t_exit


def rect_hit_single(
    origin: torch.Tensor,  # (M, 3)
    direction: torch.Tensor,  # (M, 3)
    rot: torch.Tensor,  # (M, 4): one (gathered) rect per ray
    pos: torch.Tensor,  # (M, 3)
    xy_from: torch.Tensor,  # (M, 2)
    xy_to: torch.Tensor,  # (M, 2)
    t_min: float = T_MIN,
) -> torch.Tensor:
    """Per-ray single-rect test (HitTests.cs:62-78): t, BIG on a miss."""
    inv_rot = math3.quat_conjugate(math3.quat_normalize(rot))
    o_local = math3.quat_rotate(inv_rot, origin - pos)
    d_local = math3.quat_rotate(inv_rot, direction)
    return _rect_t(o_local, d_local, xy_from, xy_to, t_min)


def box_hit_single(
    origin: torch.Tensor,  # (M, 3)
    direction: torch.Tensor,  # (M, 3)
    rot: torch.Tensor,  # (M, 4): one (gathered) box per ray
    pos: torch.Tensor,  # (M, 3)
    extents: torch.Tensor,  # (M, 3)
    t_min: float = T_MIN,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-ray single-box entry and exit (HitTests.cs:81-113; slab exit):
    (t_entry, t_exit), BIG where there is none."""
    inv_rot = math3.quat_conjugate(math3.quat_normalize(rot))
    o = math3.quat_rotate(inv_rot, origin - pos)
    d = math3.quat_rotate(inv_rot, direction)
    o = o + d * t_min
    t, _, t_exit = _box_entry(o, d, extents, t_min)
    return t, t_exit
