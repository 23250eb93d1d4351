"""Scene-level nearest-hit query (counterpart of the JAX package's
ops/intersect.py), for scenes of spheres, rects, boxes and triangles.

Reference: the per-ray candidate walk, brute-force test and distance sort
of SampleBatchJob.cs:403-475, as a wavefront "intersect every entity,
reduce to the nearest" pass.  Each kind's selection runs in its kernel,
detached (spheres: ops/sphere_select.py; triangles: ops/triangle_select.py
up to its MAX_TRI_PAD, the brute force `geometry.triangle_hit_all` above,
as in the JAX package); the winner is then evaluated again in plain
PyTorch (ops/geometry.sphere_hit_single / triangle_hit_single), which
carries the gradients to its geometry.  Rects and boxes are plain PyTorch
in the JAX package too (no Pallas kernel): all rays against every rect
and box (`geometry.rect_hit_all`, `box_hit_all`), in the JAX order
spheres, rects, boxes, triangles, each kind winning only with a strictly
smaller t.  Each hit carries its entity's exit distance (`t_exit`, a
sphere's far root or a box's slab exit) for the volume walk, and
`point_inside_volume` finds the volume around a point.  Moving spheres
take the brute force with the centres at each ray's time
(`geometry.sphere_hit_all`, chunked over rays), as the JAX package's
wavefront does with motion.  The BVH raises NotImplementedError naming
its ROADMAP step.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from raytracing_in_one_weekend_tpu_torch.core import math3
from raytracing_in_one_weekend_tpu_torch.core.ray import Rays
from raytracing_in_one_weekend_tpu_torch.ops import (
    geometry, megatrace, sphere_select, triangle_select,
)
from raytracing_in_one_weekend_tpu_torch.scene.scene import (
    EntityKind, MaterialType, Scene,
)
from raytracing_in_one_weekend_tpu_torch.utils.tensors import TensorGroup

BIG = geometry.BIG


def gather_rows(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """table[index] along rows, through index_select: its backward adds
    into the rows with atomics, while advanced indexing's backward on CUDA
    sorts the indices and walks each run of equal ones in a single warp,
    which crawls when most rays hit one sphere (the cover's ground)."""
    return torch.index_select(table, 0, index)


@dataclasses.dataclass(frozen=True)
class Hit(TensorGroup):
    t: torch.Tensor  # (N,) distance, BIG on a miss
    hit: torch.Tensor  # (N,) bool
    point: torch.Tensor  # (N, 3)
    normal: torch.Tensor  # (N, 3) geometric, unit
    uv: torch.Tensor  # (N, 2)
    material: torch.Tensor  # (N,) int32 (0 on a miss; gate on .hit)
    kind: torch.Tensor  # (N,) int32 EntityKind (-1 on a miss)
    index: torch.Tensor  # (N,) int32 index within the kind
    t_exit: torch.Tensor  # (N,) exit distance of the hit entity, else BIG


def _nearest_triangle(tri, rays: Rays, t_min: float):
    """(t, row) of each ray's nearest triangle, t differentiable: the
    detached selection kernel and the winner's re-evaluation, or (above
    the kernel's MAX_TRI_PAD) the brute force, chunked over rays."""
    if triangle_select.fits_vmem(tri.vert0.shape[0]):
        _, idx = triangle_select.triangle_select(
            rays.origin.detach(), rays.direction.detach(),
            tri.edge_a.detach(), tri.edge_b.detach(), tri.vert0.detach(),
            t_min=t_min,
        )
        win = idx.long()
        t = geometry.triangle_hit_single(
            rays.origin, rays.direction, gather_rows(tri.edge_a, win),
            gather_rows(tri.edge_b, win), gather_rows(tri.vert0, win), t_min,
        )
        return t, idx
    n = rays.origin.shape[0]
    chunk = max(1, (1 << 22) // tri.vert0.shape[0])
    ts, idxs = [], []
    for c0 in range(0, n, chunk):
        t_all, _, _ = geometry.triangle_hit_all(
            rays.origin[c0:c0 + chunk], rays.direction[c0:c0 + chunk],
            tri.edge_a, tri.edge_b, tri.vert0, tri.normals, tri.uvs, t_min,
        )
        idx = torch.argmin(t_all, dim=1)
        ts.append(torch.gather(t_all, 1, idx[:, None])[:, 0])
        idxs.append(idx.to(torch.int32))
    return torch.cat(ts), torch.cat(idxs)


def _nearest_moving_sphere(sph, rays: Rays, t_min: float):
    """(t, t_exit, index) of each ray's nearest moving sphere, chunked over
    rays (the brute force, differentiable)."""
    n = rays.origin.shape[0]
    chunk = max(1, (1 << 22) // sph.center.shape[0])
    ts, exits, idxs = [], [], []
    for c0 in range(0, n, chunk):
        t_all, exit_all = geometry.sphere_hit_all(
            rays.origin[c0:c0 + chunk], rays.direction[c0:c0 + chunk],
            sph.center, sph.radius, t_min, time=rays.time[c0:c0 + chunk],
            move_offsets=sph.move_offset, time_ranges=sph.time_range)
        idx = torch.argmin(t_all, dim=1)
        ts.append(torch.gather(t_all, 1, idx[:, None])[:, 0])
        exits.append(torch.gather(exit_all, 1, idx[:, None])[:, 0])
        idxs.append(idx)
    return torch.cat(ts), torch.cat(exits), torch.cat(idxs)


def nearest_hit(scene: Scene, rays: Rays, t_min: float = 0.0) -> Hit:
    """All rays against every sphere and triangle; the nearest surface hit
    per ray."""
    missing = megatrace.unported_feature(scene)
    if missing is not None:
        raise NotImplementedError(f"wavefront not ported for {missing}")
    sph = scene.spheres
    n = rays.origin.shape[0]
    dev = rays.origin.device
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    best_kind = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_index = torch.zeros(n, dtype=torch.int32, device=dev)
    best_exit = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    if sph.center.shape[0] > 0 and sph.move_offset is not None:
        # moving spheres: all rays against all of them at each ray's time
        t, t_exit, idx = _nearest_moving_sphere(sph, rays, t_min)
        closer = t < BIG
        best_t = torch.where(closer, t, BIG)
        best_kind = torch.where(closer, int(EntityKind.SPHERE), -1).to(
            torch.int32)
        best_index = torch.where(closer, idx, 0).to(torch.int32)
        best_exit = torch.where(closer, t_exit, BIG)
    elif sph.center.shape[0] > 0:
        # detached selection kernel, then the differentiable (N,)-sized
        # re-evaluation of the winner
        _, idx, _ = sphere_select.sphere_select(
            rays.origin.detach(), rays.direction.detach(),
            sph.center.detach(), sph.radius.detach(), t_min=t_min,
        )
        win = idx.long()
        t, t_exit = geometry.sphere_hit_single(
            rays.origin, rays.direction, gather_rows(sph.center, win),
            gather_rows(sph.radius, win), t_min,
        )
        closer = t < BIG
        best_t = torch.where(closer, t, BIG)
        best_kind = torch.where(closer, int(EntityKind.SPHERE), -1).to(
            torch.int32)
        best_index = torch.where(closer, idx, 0).to(torch.int32)
        best_exit = torch.where(closer, t_exit, BIG)

    rct = scene.rects
    if rct.rot.shape[0] > 0:
        t_all, _ = geometry.rect_hit_all(
            rays.origin, rays.direction, rct.rot, rct.pos, rct.xy_from,
            rct.xy_to, t_min)
        idx = torch.argmin(t_all, dim=1)
        t = torch.gather(t_all, 1, idx[:, None])[:, 0]
        closer = t < best_t
        best_t = torch.where(closer, t, best_t)
        best_kind = torch.where(closer, int(EntityKind.RECT), best_kind)
        best_index = torch.where(closer, idx.to(torch.int32), best_index)
        best_exit = torch.where(closer, BIG, best_exit)

    box = scene.boxes
    if box.rot.shape[0] > 0:
        t_all, _, t_exit = geometry.box_hit_all(
            rays.origin, rays.direction, box.rot, box.pos, box.extents,
            t_min)
        idx = torch.argmin(t_all, dim=1)
        t = torch.gather(t_all, 1, idx[:, None])[:, 0]
        closer = t < best_t
        best_t = torch.where(closer, t, best_t)
        best_kind = torch.where(closer, int(EntityKind.BOX), best_kind)
        best_index = torch.where(closer, idx.to(torch.int32), best_index)
        best_exit = torch.where(
            closer, torch.gather(t_exit, 1, idx[:, None])[:, 0], best_exit)

    tri = scene.triangles
    if tri.vert0.shape[0] > 0:
        t, idx = _nearest_triangle(tri, rays, t_min)
        closer = t < best_t
        best_t = torch.where(closer, t, best_t)
        best_kind = torch.where(closer, int(EntityKind.TRIANGLE), best_kind)
        best_index = torch.where(closer, idx, best_index)
        best_exit = torch.where(closer, BIG, best_exit)

    hit = best_t < BIG
    point = rays.at(torch.where(hit, best_t, 0.0))
    normal, uv, material = _shading_attributes(scene, rays, point, best_kind,
                                               best_index)
    assert normal.shape == (n, 3)
    return Hit(t=best_t, hit=hit, point=point, normal=normal, uv=uv,
               material=material, kind=best_kind, index=best_index,
               t_exit=best_exit)


def _shading_attributes(scene: Scene, rays: Rays, point, kind, index):
    """Normal, uv and material of the winning entity only (rects and
    boxes keep uv = 0)."""
    n = point.shape[0]
    normal = torch.zeros_like(point)
    uv = torch.zeros((n, 2), dtype=point.dtype, device=point.device)
    material = torch.zeros(n, dtype=torch.int32, device=point.device)
    sph = scene.spheres
    if sph.center.shape[0] > 0:
        gi = torch.clamp(index, 0, sph.center.shape[0] - 1).long()
        is_sph = kind == EntityKind.SPHERE
        centers = gather_rows(sph.center, gi)
        if sph.move_offset is not None:  # the centre at the ray's time
            w = geometry.motion_weight(rays.time, sph.time_range[gi])
            centers = centers + gather_rows(sph.move_offset, gi) * w[:, None]
        sn = geometry.sphere_normal_at(point, centers,
                                       gather_rows(sph.radius, gi))
        normal = torch.where(is_sph[:, None], sn, normal)
        material = torch.where(is_sph, sph.material[gi].to(torch.int32),
                               material)
        # Shirley Book-2 spherical texcoords from the outward normal:
        # u = (atan2(-z, x) + pi) / 2pi, v = acos(-y) / pi (the reference
        # zeroes them, HitTests.cs:123; the JAX package restores the book's)
        sph_u = (torch.atan2(-sn[:, 2], sn[:, 0]) + math.pi) / (
            2.0 * math.pi)
        sph_v = torch.arccos(torch.clamp(-sn[:, 1], -1.0, 1.0)) / math.pi
        uv = torch.where(is_sph[:, None],
                         torch.stack([sph_u, sph_v], dim=-1), uv)

    rct = scene.rects
    if rct.rot.shape[0] > 0:
        gi = torch.clamp(index, 0, rct.rot.shape[0] - 1).long()
        up = torch.zeros_like(point)
        up[:, 2] = 1.0
        rn = math3.quat_rotate(gather_rows(rct.rot, gi), up)
        is_rct = kind == EntityKind.RECT
        normal = torch.where(is_rct[:, None], rn, normal)
        material = torch.where(is_rct, rct.material[gi].to(torch.int32),
                               material)

    box = scene.boxes
    if box.rot.shape[0] > 0:
        gi = torch.clamp(index, 0, box.rot.shape[0] - 1).long()
        rot = gather_rows(box.rot, gi)
        local_p = math3.quat_rotate(math3.quat_conjugate(rot),
                                    point - gather_rows(box.pos, gi))
        # the face of the dominant |p| / extent axis (the first on a tie),
        # sign(0) = 0
        rel = torch.abs(local_p) / torch.clamp(gather_rows(box.extents, gi),
                                               min=1e-12)
        axis = torch.argmax(rel, dim=-1)
        local_n = torch.sign(torch.gather(local_p, 1, axis[:, None])) \
            * torch.eye(3, dtype=point.dtype, device=point.device)[axis]
        bn = math3.quat_rotate(rot, local_n)
        is_box = kind == EntityKind.BOX
        normal = torch.where(is_box[:, None], bn, normal)
        material = torch.where(is_box, box.material[gi].to(torch.int32),
                               material)

    tri = scene.triangles
    if tri.vert0.shape[0] > 0:
        gi = torch.clamp(index, 0, tri.vert0.shape[0] - 1).long()
        # the winner's barycentrics by Möller–Trumbore again, then the
        # vertex normal and uv lerps
        _, u, v, _ = geometry._moller_trumbore(
            rays.origin, rays.direction, gather_rows(tri.edge_a, gi),
            gather_rows(tri.edge_b, gi), gather_rows(tri.vert0, gi))
        bary = torch.stack([1.0 - u - v, u, v], dim=-1)
        tn = torch.einsum("nij,nj->ni", gather_rows(tri.normals, gi), bary)
        tuv = torch.einsum("nij,nj->ni", gather_rows(tri.uvs, gi), bary)
        is_tri = kind == EntityKind.TRIANGLE
        normal = torch.where(is_tri[:, None], tn, normal)
        uv = torch.where(is_tri[:, None], tuv, uv)
        material = torch.where(is_tri, tri.material[gi].to(torch.int32),
                               material)
    # world normals are normalized (Entity.cs:65)
    return math3.normalize_safe(normal), uv, material


def point_inside_volume(scene: Scene, point: torch.Tensor) -> torch.Tensor:
    """(N,) int32: the material of a probabilistic-volume sphere or box
    containing each point (the first sphere, else the first box), or -1
    (the JAX package's `point_inside_volume`: a direct point-in-hull test
    for the convex entities volumes are restricted to, Entity.cs:24, in
    place of the reference's backwards ray, SampleBatchJob.cs:477-508).
    Box quaternions are normalized before their conjugate, as every other
    consumer normalizes them."""
    n = point.shape[0]
    inside_mat = torch.full((n,), -1, dtype=torch.int32, device=point.device)
    vol = int(MaterialType.PROBABILISTIC_VOLUME)
    sph = scene.spheres
    if sph.center.shape[0] > 0:
        is_vol = scene.materials.type[sph.material.long()] == vol
        d2 = torch.sum((point[:, None, :] - sph.center[None]) ** 2, dim=-1)
        inside = (d2 < (sph.radius * sph.radius)[None]) & is_vol[None]
        first = torch.argmax(inside.to(torch.int32), dim=1)
        inside_mat = torch.where(inside.any(dim=1),
                                 sph.material[first].to(torch.int32),
                                 inside_mat)
    box = scene.boxes
    if box.rot.shape[0] > 0:
        is_vol = scene.materials.type[box.material.long()] == vol
        inv_rot = math3.quat_conjugate(math3.quat_normalize(box.rot))
        local = math3.quat_rotate(inv_rot[None],
                                  point[:, None, :] - box.pos[None])
        inside = (torch.abs(local) < box.extents[None]).all(dim=-1) \
            & is_vol[None]
        first = torch.argmax(inside.to(torch.int32), dim=1)
        inside_mat = torch.where(inside.any(dim=1) & (inside_mat < 0),
                                 box.material[first].to(torch.int32),
                                 inside_mat)
    return inside_mat
