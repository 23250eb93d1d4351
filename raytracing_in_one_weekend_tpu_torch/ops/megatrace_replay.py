"""Differentiable tape replay of the fused batch kernel (counterpart of the
JAX package's ops/megatrace_replay.py, its sphere, rect, box, triangle and
convex-volume arms).

The forward kernel (ops/megatrace.sample_batch, want_tape=True) records
the winner of every iteration on every lane: the sphere row, the padded
sphere count plus the rect row, that plus the padded rect count plus the
box row, or the padded sphere count plus the triangle row (the JAX
kernel's combined row space), -1 for the sky, -2 for an idle lane.
Its hit attributes carry no gradient.  The replay re-runs the
persistent-lane state machine along that tape in plain differentiable
PyTorch: each iteration gathers only the winner's entity row (a sphere's
quadratic, a rect's plane or a box's face in the entity's frame, or a
triangle's Möller–Trumbore and barycentric normal lerp),
so there is no (lanes, entities) intersection work and no kernel in the
autograd graph.  Discrete decisions (winner, root, lotteries, the volume
walk's scatter or pass) are constants of the tape: the detached-decision
gradient estimator, plus the score-function `lp` terms that carry the
lotteries' probability shift and the Beer-Lambert free path's (a volume's
density moves only through them).  With `vol0` each lane carries its
medium (eight more state rows, VOL_KEYS), reset from vol0 at every regen;
with `move_offsets` (unit-shutter sphere motion) its shutter time
(`ptime`, drawn at every regen as the kernel draws it), and a sphere
winner's centre is taken at that time: the move offsets are leaves too.

Replay-vs-kernel contract: the same hash PRNG, the same branch rules and
the same precision helpers (`ops/megatrace._fma`, `_sqrt`, ...) where the
forward kernel uses them, so that the replay takes the kernel's branches
on the card and its primal equals the kernel's.  Two NaN guards change
the primal where the kernel's value would give an infinite derivative:
the sphere discriminant and the refraction discriminant are floored at
1e-8 (grazing hits only).

* `replay_iteration` is one iteration (regen, one bounce at the tape's
  winner, fold and termination), on per-lane rows.
* `replay` runs it over the whole tape, one `torch.utils.checkpoint`
  block per `trace_depth` iterations, so autograd memory stays bounded.
* `sample_batch_diff` is the `torch.autograd.Function` whose forward is
  the kernel (with the tape) and whose backward is
  `ops/megatrace_bwd.replay_grad`: the CUDA backward kernel on CUDA
  tensors, autograd over `replay` on CPU tensors.

Scope: `replay_eligible`, the batch kernel's scope but Perlin textures
and streamed meshes (the JAX package's): spheres, rects and boxes, convex
volumes, unit-shutter motion and checker and image albedos beside them,
meshes of at most TRI_MAX triangles, Lambert/GGX metal/dielectric,
gradient or no sky, white noise.
"""

from __future__ import annotations

import torch
from torch.utils import checkpoint as torch_checkpoint

from raytracing_in_one_weekend_tpu_torch.core import math3
from raytracing_in_one_weekend_tpu_torch.ops import megatrace as mk
from raytracing_in_one_weekend_tpu_torch.ops.megatrace import (
    _cos,
    _cosine_hemisphere,
    _dot3,
    _fma,
    _normalize3,
    _schlick,
    _sin,
    _smith_masking,
    _sqrt,
    _log,
    _unit_sphere,
    uniforms_hash,
)

ENTITY_COLS = 23  # build_entity_rows layout, sphere scenes
TRI_ENTITY_COLS = 38  # ... and mesh scenes (vertex normals and uvs added)
# entity columns that carry gradients: center, radius, albedo, emission,
# gloss, metallic, parameter (material rows 1-9)
GRAD_COLS = (0, 1, 2, 3, 11, 12, 13, 14, 15, 16, 17, 18, 19)
# ... in mesh scenes: those, then a triangle row's edge_b and vert0 and its
# three vertex normals (columns 0-2 hold a triangle's edge_a; uvs carry no
# gradient without textures): the backward kernel's cotangent layout
TRI_GRAD_COLS = (*GRAD_COLS, *range(4, 10), *range(23, 32))
# ... in scenes with rects or boxes: GRAD_COLS (columns 0-3 hold their
# quaternion), then a position (4-6) and a box's extents (7-9)
AUX_GRAD_COLS = (*GRAD_COLS, *range(4, 10))
# ... in scenes with moving spheres: the three move-offset columns after the
# others (ENTITY_COLS, ENTITY_COLS + 3), which follow GRAD_COLS or
# AUX_GRAD_COLS in the cotangent rows
MOVE_COLS = tuple(range(ENTITY_COLS, ENTITY_COLS + 3))
# ... in scenes with checker or image albedos: mk.TEX_COLS texture-record
# columns after the others (`tex_base`), of which the main and secondary
# colours (record columns 1-6) carry gradients; they follow the others in
# the cotangent rows
TEX_GRAD = tuple(range(1, 7))


def tex_base(has_motion: bool) -> int:
    """The first texture-record column of a textured scene's entity rows
    (not beside triangles)."""
    return ENTITY_COLS + (3 if has_motion else 0)
STATE_KEYS = (
    "ox", "oy", "oz", "dx", "dy", "dz", "thx", "thy", "thz",
    "radx", "rady", "radz", "active", "valid", "started", "depth_ct",
    "csx", "csy", "csz", "cnt", "lp",
)
VOL_STATE_KEYS = STATE_KEYS + mk.VOL_KEYS  # ... with the medium (volumes)
MOTION_KEYS = ("ptime",)  # ... then the shutter time (moving spheres)
AOV_OUTPUTS = ("normal", "albedo", "weight", "fallback_normal",
               "fallback_albedo")


def state_keys(has_volumes: bool, has_motion: bool = False) -> tuple:
    return ((VOL_STATE_KEYS if has_volumes else STATE_KEYS)
            + (MOTION_KEYS if has_motion else ()))


def grad_cols(has_tris: bool, has_aux: bool, has_motion: bool = False,
              has_tex: bool = False) -> tuple:
    """The entity columns of the backward kernel's cotangent rows."""
    if has_tris and has_aux:
        raise NotImplementedError(f"replay_grad: {mk.RECTS_IN_MESHES}")
    if has_tris and has_motion:
        raise NotImplementedError(f"replay_grad: {mk.MOTION_IN_MESHES}")
    if has_tris and has_tex:
        raise NotImplementedError(f"replay_grad: {mk.TEXTURES_IN_MESHES}")
    cols = (TRI_GRAD_COLS if has_tris
            else AUX_GRAD_COLS if has_aux else GRAD_COLS)
    base = tex_base(has_motion)
    return (cols + (MOVE_COLS if has_motion else ())
            + (tuple(base + k for k in TEX_GRAD) if has_tex else ()))


def replay_eligible(scene) -> bool:
    """Can this scene take the differentiable fused path?  The forward
    batch kernel's scope, rects, boxes, convex volumes, unit-shutter
    motion, checker and image albedos and meshes of at most TRI_MAX
    triangles included (JAX replay_eligible: the tape has no
    streamed-triangle arm, and the replay no Perlin marble)."""
    return (mk.scene_eligible(scene, allow_triangles=True,
                              allow_rect_box=True, allow_volumes=True,
                              allow_motion=True, allow_textures=True)
            and scene.triangles.vert0.shape[0] <= mk.TRI_MAX
            and scene.textures.perlin is None)


def build_entity_rows(centers, radii, records, tri_tables=None,
                      rect_tables=None, box_tables=None, move_offsets=None,
                      tex_rec=None):
    """Entity table in the kernel's padded combined row space, the JAX
    package's layout: spheres in rows [0, S_pad), then with `rect_tables`
    and `box_tables` (pack_aux_tables' pairs) the R_pad rect and B_pad box
    rows, then with `tri_tables` (pack_tri_tables' pair) the T_pad
    triangle rows.  Columns: 0:3 center | quat xyz | edge_a, 3 radius |
    quat w, 4:7 position | edge_b, 7:10 a rect's world normal (packed;
    JAX leaves these zero and recomputes it) | a box's extents | vert0,
    10:21 material rows 0-10, 21 kind (0 sphere, 1 rect, 2 box, 3
    triangle), 22 material id, and in mesh scenes 23:32 the vertex normals
    (v0, v1, v2 xyz) and 32:38 the uvs (u0-u2, v0-v2): ENTITY_COLS or
    TRI_ENTITY_COLS wide; with `move_offsets` ((S, 3), not beside
    triangles) three more columns, MOVE_COLS, the spheres' move offsets
    (zero on the other kinds' rows), the JAX layout's `mvbase`; with
    `tex_rec` (pack_texture_tables' records) its row of the entity's
    material, mk.TEX_COLS columns from `tex_base` (the JAX layout's
    `txbase`).  Differentiable with respect to every input; pad rows never
    hit."""
    s = centers.shape[0]
    s_pad = mk.sphere_pad_count(s)
    cols = ENTITY_COLS if tri_tables is None else TRI_ENTITY_COLS
    f32 = dict(dtype=torch.float32, device=centers.device)
    mat_id = (records[:, 11:12] if records.shape[1] > 11
              else torch.zeros((s, 1), **f32))
    rows = torch.cat([
        centers.to(torch.float32),
        radii.to(torch.float32)[:, None],
        torch.zeros((s, 6), **f32),
        records[:, :11].to(torch.float32),
        torch.zeros((s, 1), **f32),
        mat_id.to(torch.float32),
        torch.zeros((s, cols - ENTITY_COLS), **f32),
    ], dim=1)
    blocks = [rows, torch.zeros((s_pad - s, cols), **f32)]
    for tables, kind, geo_cols, id_row in ((rect_tables, 1.0, 7, 14),
                                           (box_tables, 2.0, 10, 21)):
        if tables is None:
            continue
        geo, rec = (t.to(torch.float32) for t in tables)
        k_pad = geo.shape[0]
        normal = (rec[11:14].T if kind == 1.0
                  else torch.zeros((k_pad, 3), **f32))
        blocks.append(torch.cat([
            geo[:, :geo_cols],
            normal[:, :10 - geo_cols],
            rec[0:11].T,
            torch.full((k_pad, 1), kind, **f32),
            rec[id_row:id_row + 1].T,
            torch.zeros((k_pad, cols - ENTITY_COLS), **f32),
        ], dim=1))
    if tri_tables is not None:
        geo, trec = (t.to(torch.float32) for t in tri_tables)
        t_pad = geo.shape[0]
        blocks.append(torch.cat([
            geo[:, 0:3],
            torch.zeros((t_pad, 1), **f32),
            geo[:, 3:9],
            trec[0:11].T,
            torch.full((t_pad, 1), 3.0, **f32),
            trec[11:27].T,
        ], dim=1))
    table = torch.cat(blocks)
    if move_offsets is not None:
        if tri_tables is not None:
            raise NotImplementedError(
                f"build_entity_rows: {mk.MOTION_IN_MESHES}")
        move = torch.cat([move_offsets.to(torch.float32),
                          torch.zeros((table.shape[0] - s, 3), **f32)])
        table = torch.cat([table, move], dim=1)
    if tex_rec is not None:
        if tri_tables is not None:
            raise NotImplementedError(
                f"build_entity_rows: {mk.TEXTURES_IN_MESHES}")
        ids = table[:, 22].detach().to(torch.int64)
        table = torch.cat([table, tex_rec.to(torch.float32)[ids]], dim=1)
    return table


def initial_state(n: int, device, has_volumes: bool = False,
                  has_motion: bool = False) -> dict:
    zero = torch.zeros(n, dtype=torch.float32, device=device)
    state = {k: zero for k in state_keys(has_volumes, has_motion)}
    state.update(thx=zero + 1.0, thy=zero + 1.0, thz=zero + 1.0)
    if has_volumes:
        state["in_id"] = zero - 1.0  # no medium
    return state


def make_env(lane_count, camera_row, sky_bottom, sky_top, seed,
             lane_base: int = 0, vol0=None) -> dict:
    """Per-call constants of `replay_iteration`: per-lane rows and the
    camera, sky and camera-medium (`vol0`) pieces (0-d tensors,
    differentiable)."""
    n = lane_count.shape[0]
    dev = lane_count.device
    cam = camera_row.to(torch.float32)
    return dict(
        per_pixel=lane_count.to(torch.float32),
        # global lane ids through float32, as the kernel keys its PRNG
        lanes=(torch.arange(n, dtype=torch.float32, device=dev)
               + torch.tensor(float(lane_base), dtype=torch.float32))
        .to(torch.int64),
        pixels=torch.arange(n, dtype=torch.float32, device=dev),
        seed=int(seed),
        co=cam[0:3], ll=cam[3:6], hh=cam[6:9], vv=cam[9:12],
        rr=cam[12:15], uu=cam[15:18],
        lens_radius=cam[18], width=cam[19], height=cam[20],
        sky_b=sky_bottom.to(torch.float32), sky_t=sky_top.to(torch.float32),
        vol0=None if vol0 is None else vol0.to(torch.float32),
    )


def _primal_of(value, smooth):
    """`value` exactly, with the derivative of `smooth` (the same quantity
    in a form that rounds better): value + (smooth - smooth) adds 0."""
    return value.detach() + (smooth - smooth.detach())


def _log_floor(x):
    return torch.log(torch.clamp(x, min=1e-12))


def replay_iteration(state: dict, wt, tape_row, it: int, env: dict, *,
                     jitter: bool, has_dielectrics: bool, sky_on: bool,
                     trace_depth: int, t_min: float = 0.0,
                     has_tris: bool = False, has_aux: bool = False,
                     has_volumes: bool = False,
                     has_motion: bool = False,
                     tex: tuple | None = None) -> dict:
    """One persistent-lane iteration along the tape: regen, one bounce at
    the tape's winner, fold and termination (JAX replay_iteration :260,
    sphere, rect, box and triangle arms).

    state: dict of (n,) float32 rows, STATE_KEYS.  wt: (cols, n) winner
    entity rows (row k = column k of build_entity_rows, per lane).
    tape_row: (n,) winner codes.  env: make_env's dict; its camera and sky
    entries may also be (n,) rows.  has_tris: the table has triangle rows
    (kind 3), whose winners take Möller–Trumbore and the normal lerp.
    has_aux: it has rect or box rows (kinds 1, 2), whose winners take the
    ray in the entity's frame, the rect's plane distance or the box's face
    distance, and their normals.  has_volumes: the convex volume walk,
    the medium in state keys VOL_KEYS and env["vol0"] (the JAX replay's
    :682-760, :856-870, :957-975).  has_motion: the path's shutter time in
    state key "ptime" (drawn at regen: the camera draws' stream 7) and a
    sphere winner's centre at that time, c + m t with the move offsets m
    in entity columns MOVE_COLS (the JAX replay's :353-354, :383-390).
    tex: (the atlas or None, its (W, H)) of a scene with checker or image
    albedos, the texture records in entity columns from tex_base: the
    winner's albedo textured as the kernel does (the JAX replay's
    :580-680; the checker's colours from the record, the atlas texel at a
    detached index)."""
    per_pixel, lanes, seed = env["per_pixel"], env["lanes"], env["seed"]
    co, ll, hh, vv = env["co"], env["ll"], env["hh"], env["vv"]
    rr, uu = env["rr"], env["uu"]
    lens_radius, width, height = (env["lens_radius"], env["width"],
                                  env["height"])
    sky_b, sky_t = env["sky_b"], env["sky_t"]
    py_row = torch.floor(env["pixels"] / width)
    px_row = env["pixels"] - py_row * width

    ox, oy, oz = state["ox"], state["oy"], state["oz"]
    dx, dy, dz = state["dx"], state["dy"], state["dz"]
    thx, thy, thz = state["thx"], state["thy"], state["thz"]
    radx, rady, radz = state["radx"], state["rady"], state["radz"]
    active, valid = state["active"], state["valid"]
    started, depth_ct = state["started"], state["depth_ct"]

    # ---- regen: thin-lens camera ray (View.cs:38-48) --------------------
    regen = (active < 0.5) & (started < per_pixel)
    salt = it * mk.SALT_STEP
    u = uniforms_hash(seed, salt, lanes, 8 if has_motion else 4)
    jx, jy = (u[0], u[1]) if jitter else (0.5, 0.5)
    un = (px_row + jx) / width
    vn = (py_row + jy) / height
    theta = u[2] * mk.TWO_PI
    radius = _sqrt(u[3]) * lens_radius
    rdx = radius * _cos(theta)
    rdy = radius * _sin(theta)
    offx = _fma(rdx, rr[0], rdy * uu[0])
    offy = _fma(rdx, rr[1], rdy * uu[1])
    offz = _fma(rdx, rr[2], rdy * uu[2])
    cdx = _fma(vn, vv[0], _fma(un, hh[0], ll[0] - offx))
    cdy = _fma(vn, vv[1], _fma(un, hh[1], ll[1] - offy))
    cdz = _fma(vn, vv[2], _fma(un, hh[2], ll[2] - offz))
    cdx, cdy, cdz = _normalize3(cdx, cdy, cdz)
    ox = torch.where(regen, co[0] + offx, ox)
    oy = torch.where(regen, co[1] + offy, oy)
    oz = torch.where(regen, co[2] + offz, oz)
    dx = torch.where(regen, cdx, dx)
    dy = torch.where(regen, cdy, dy)
    dz = torch.where(regen, cdz, dz)
    thx = torch.where(regen, 1.0, thx)
    thy = torch.where(regen, 1.0, thy)
    thz = torch.where(regen, 1.0, thz)
    radx = torch.where(regen, 0.0, radx)
    rady = torch.where(regen, 0.0, rady)
    radz = torch.where(regen, 0.0, radz)
    valid = torch.where(regen, 0.0, valid)
    depth_ct = torch.where(regen, 0.0, depth_ct)
    started = started + torch.where(regen, 1.0, 0.0)
    active = torch.where(regen, 1.0, active)
    was_active = active > 0.5
    lp = torch.where(regen, 0.0, state["lp"])
    if has_volumes:  # the camera's medium
        med = {k: torch.where(regen, env["vol0"][j], state[k])
               for j, k in enumerate(mk.VOL_KEYS)}
    if has_motion:  # the path's shutter time
        ptime = torch.where(regen, u[7], state["ptime"])

    # ---- one bounce at the tape's winner ---------------------------------
    u_bounce = uniforms_hash(seed, salt + mk.SALT_BOUNCE, lanes,
                             7 if has_volumes else 6)
    ua, ub, uc, ud, u_choice, u_choice2 = u_bounce[:6]
    hit = was_active & (tape_row >= -0.5)
    miss = was_active & ~hit
    cx, cy, cz, r = wt[0], wt[1], wt[2], wt[3]
    # triangle rows hold edges where spheres hold center and radius: the
    # sphere expressions see only sphere winners (s_hit), the triangle
    # ones only triangle winners (t3_hit)
    t3_hit = hit & (wt[21] > 2.5) if has_tris else None
    s_hit = hit & (wt[21] < 0.5) if has_tris or has_aux else hit

    # the kernel's sweep expressions at the winner; their derivatives are
    # taken through the same quantities in (o - c) form, which does not
    # cancel (the expanded form loses ~12 bits on the cover's far spheres)
    a = _dot3(dx, dy, dz, dx, dy, dz)
    o_dot_d = _dot3(ox, oy, oz, dx, dy, dz)
    o_sq = _dot3(ox, oy, oz, ox, oy, oz)
    if has_motion:
        # the centre at the path's time (move columns are zero on the
        # other kinds' rows), and the kernel's motion quadratic
        cx, cy, cz = (mk.moved_center(c_k, wt[MOVE_COLS[k]], ptime)
                      for k, c_k in enumerate((cx, cy, cz)))
        c_primal = ((o_sq - 2.0 * _dot3(ox, oy, oz, cx, cy, cz))
                    + _dot3(cx, cy, cz, cx, cy, cz)) + -(r * r)
    else:
        c_primal = ((o_sq - 2.0 * _dot3(ox, oy, oz, cx, cy, cz))
                    + mk.center_sq_minus_r2(cx, cy, cz, r))
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    b = _primal_of(o_dot_d - _dot3(dx, dy, dz, cx, cy, cz),
                   _dot3(dx, dy, dz, ocx, ocy, ocz))
    c_term = _primal_of(c_primal,
                        _dot3(ocx, ocy, ocz, ocx, ocy, ocz) - r * r)
    disc = _fma(b, b, -(a * c_term))
    # idle and sky lanes hold unrelated rows: sanitise every sqrt and
    # division argument so that the unselected branch stays finite; the
    # floor keeps sqrt' finite on grazing hits
    sq = _sqrt(torch.where(s_hit, torch.clamp(disc, min=1e-8), 1.0))
    inv_a = 1.0 / torch.where(s_hit, a, 1.0)
    t_near = (-b - sq) * inv_a
    t_far = (-b + sq) * inv_a
    t_hit = torch.where(t_near > t_min, t_near, t_far)
    t_hit = torch.where(s_hit, t_hit, 0.0)
    if has_tris:
        # Möller–Trumbore at the tape's winner, the kernel's expressions;
        # the tape guarantees det != 0 on triangle winners, every other
        # lane divides by 1
        _, bu, bv, t_mt = mk.mt_parts(
            (ox, oy, oz), (dx, dy, dz), (wt[0], wt[1], wt[2]),
            (wt[4], wt[5], wt[6]), (wt[7], wt[8], wt[9]), mask=t3_hit)
        t_hit = torch.where(t3_hit, t_mt, t_hit)
    if has_aux:
        # the rect and box winners' distances in the kernel's expressions
        # (rows of other kinds hold other data in the quat, position and
        # extent columns: the selects discard them, and the divisions are
        # guarded on those lanes)
        q = (wt[0], wt[1], wt[2], wt[3])
        pos, ext = (wt[4], wt[5], wt[6]), (wt[7], wt[8], wt[9])
        r_hit = hit & (wt[21] > 0.5) & (wt[21] < 1.5)
        b_hit = hit & (wt[21] > 1.5) & (wt[21] < 2.5)
        o, d = (ox, oy, oz), (dx, dy, dz)
        t_hit = torch.where(r_hit, mk.rect_parts(o, d, q, pos, r_hit)[0],
                            t_hit)
        t_hit = torch.where(
            b_hit, mk.box_parts(o, d, q, pos, ext, t_min, b_hit)[0], t_hit)
    px = _fma(t_hit, dx, ox)
    py = _fma(t_hit, dy, oy)
    pz = _fma(t_hit, dz, oz)
    inv_r = 1.0 / torch.where(s_hit & (r != 0.0), r, 1.0)
    nx = torch.where(s_hit, (px - cx) * inv_r, 0.0)
    ny = torch.where(s_hit, (py - cy) * inv_r, 0.0)
    nz = torch.where(s_hit, (pz - cz) * inv_r, 0.0)
    if has_aux:
        # a rect's normal: the packed one (the kernel reads it), with the
        # derivative of the rotated local +Z
        rn = mk._quat_rotate(*q, torch.zeros_like(dx), torch.zeros_like(dx),
                             torch.ones_like(dx))
        # a box's: the dominant face, rotated to the world
        bn = mk.box_normal((px, py, pz), q, pos, ext)
        for k, (n_k, packed) in enumerate(((nx, wt[7]), (ny, wt[8]),
                                           (nz, wt[9]))):
            n_k = torch.where(r_hit, _primal_of(packed, rn[k]), n_k)
            n_k = torch.where(b_hit, bn[k], n_k)
            if k == 0:
                nx = n_k
            elif k == 1:
                ny = n_k
            else:
                nz = n_k
    if has_tris:
        # barycentric vertex-normal lerp, normalised after the lerp
        tnx, tny, tnz = mk.tri_normal(
            (wt[23], wt[24], wt[25]), (wt[26], wt[27], wt[28]),
            (wt[29], wt[30], wt[31]), bu, bv)
        nx = torch.where(t3_hit, tnx, nx)
        ny = torch.where(t3_hit, tny, ny)
        nz = torch.where(t3_hit, tnz, nz)

    mtype = wt[10]
    alb_r, alb_g, alb_b = wt[11], wt[12], wt[13]
    if tex is not None:
        atlas, dims = tex
        tb = tex_base(has_motion)
        uv = (torch.zeros_like(dx), torch.zeros_like(dx))
        if atlas is not None:  # sphere winners take the spherical uv
            su, sv = mk.sphere_uv(nx.detach(), ny.detach(), nz.detach())
            uv = (torch.where(s_hit, su, 0.0), torch.where(s_hit, sv, 0.0))
        alb_r, alb_g, alb_b = mk.bounce_textures(
            mk.TexTables(None, None, atlas, dims), wt[tb:tb + mk.TEX_COLS].T,
            (alb_r, alb_g, alb_b), (nx, ny, nz), (px, py, pz), uv)
    em_r, em_g, em_b = wt[14], wt[15], wt[16]
    gloss, metallic, parameter = wt[17], wt[18], wt[19]

    scatter_mask = hit
    if has_volumes:
        # ---- probabilistic volume walk (the kernel's): the decisions
        # recompute from the uniforms and the winner; the free path is
        # detached, so the density moves through the lp terms only -------
        t_exit = torch.where(s_hit & (t_far > t_min), t_far, mk.BIG)
        if has_aux:
            t_exit = torch.where(b_hit, mk.box_exit(
                o, d, q, pos, ext, t_min, parallel_inf=False), t_exit)
        in_vol = med["in_id"] >= 0.0
        hit_is_vol = hit & (mtype > 1.5)
        entering = _dot3(dx, dy, dz, nx, ny, nz) < 0.0
        v = {k: torch.where(in_vol, med[k], own) for k, own in (
            ("in_id", wt[22]), ("in_den", parameter), ("in_ar", alb_r),
            ("in_ag", alb_g), ("in_ab", alb_b), ("in_er", em_r),
            ("in_eg", em_g), ("in_eb", em_b))}
        free_path = -_log(torch.clamp(u_bounce[6], min=1e-12)) / torch.clamp(
            v["in_den"], min=1e-12).detach()
        best_t = torch.where(hit, t_hit, mk.BIG)
        seg_len = torch.where(in_vol, best_t, t_exit - best_t)
        vol_candidate = hit & (in_vol | (hit_is_vol & entering))
        vol_scatter = vol_candidate & (free_path < seg_len)
        vol_t = torch.where(in_vol, free_path, best_t + free_path)
        pass_through = hit & ~in_vol & hit_is_vol & entering & ~vol_scatter
        exits_own = (in_vol & hit & hit_is_vol & ~entering & ~vol_scatter
                     & (torch.abs(wt[22] - med["in_id"]) < 0.5))
        skip = pass_through | exits_own
        skip_t = torch.where(skip, torch.where(pass_through, t_exit, best_t),
                             0.0)
        scatter_mask = hit & ~skip
        # score function of the walk's decisions: a scatter at d has pdf
        # rho exp(-rho d), a survived segment L probability exp(-rho L)
        survive = vol_candidate & ~vol_scatter
        rho = torch.clamp(v["in_den"], min=1e-8)
        d_obs = torch.where(vol_scatter, free_path, 0.0).detach()
        l_obs = torch.where(survive, torch.clamp(seg_len, max=1e6),
                            0.0).detach()
        lp = lp + torch.where(vol_scatter, torch.log(rho) - rho * d_obs,
                              0.0) + torch.where(survive, -rho * l_obs, 0.0)
        # the in-medium scatter replaces the surface hit
        px = torch.where(vol_scatter, _fma(vol_t, dx, ox), px)
        py = torch.where(vol_scatter, _fma(vol_t, dy, oy), py)
        pz = torch.where(vol_scatter, _fma(vol_t, dz, oz), pz)
        nx = torch.where(vol_scatter, -dx, nx)
        ny = torch.where(vol_scatter, -dy, ny)
        nz = torch.where(vol_scatter, -dz, nz)
        em_r = torch.where(vol_scatter, v["in_er"], em_r)
        em_g = torch.where(vol_scatter, v["in_eg"], em_g)
        em_b = torch.where(vol_scatter, v["in_eb"], em_b)

    # ---- Standard scatter (Material.cs:75-119) ---------------------------
    roughness = (1.0 - gloss) * (1.0 - gloss)
    csx, csy, csz = _cosine_hemisphere(ua, ub, nx, ny, nz)
    rnx, rny, rnz = _normalize3(
        _fma(csx - nx, roughness, nx),
        _fma(csy - ny, roughness, ny),
        _fma(csz - nz, roughness, nz),
    )
    rough = roughness > 0.0
    rnx = torch.where(rough, rnx, nx)
    rny = torch.where(rough, rny, ny)
    rnz = torch.where(rough, rnz, nz)
    spec_dot = _dot3(dx, dy, dz, rnx, rny, rnz)
    std_ior = _fma(torch.full_like(metallic, mk.METAL_IOR - mk.PLASTIC_IOR),
                   metallic, mk.PLASTIC_IOR)
    fresnel = _schlick(-spec_dot, std_ior)
    masking = _smith_masking(_dot3(dx, dy, dz, nx, ny, nz), roughness)
    refl_chance = math3.saturate(fresnel * gloss * masking)
    spx = _fma(-(2.0 * spec_dot), rnx, dx)
    spy = _fma(-(2.0 * spec_dot), rny, dy)
    spz = _fma(-(2.0 * spec_dot), rnz, dz)
    lmx, lmy, lmz = _cosine_hemisphere(uc, ud, nx, ny, nz)
    take_spec = (refl_chance > 0.0) & (u_choice < refl_chance)
    take_metal = (metallic > 0.0) & (u_choice2 < metallic)
    # lottery log-probability (score-function term, materials Scatter.logp)
    lp_inc = torch.where(
        take_spec,
        _log_floor(refl_chance),
        _log_floor(1.0 - refl_chance) + torch.where(
            take_metal, _log_floor(metallic), _log_floor(1.0 - metallic)
        ),
    )
    spec_like = take_spec | take_metal
    sdx = torch.where(spec_like, spx, lmx)
    sdy = torch.where(spec_like, spy, lmy)
    sdz = torch.where(spec_like, spz, lmz)
    srr = torch.where(take_spec, 1.0, alb_r)
    srg = torch.where(take_spec, 1.0, alb_g)
    srb = torch.where(take_spec, 1.0, alb_b)

    if has_dielectrics:
        # ---- Dielectric (Material.cs:121-161) ----------------------------
        d_roughness = 1.0 - gloss
        ssx, ssy, ssz = _unit_sphere(ua, ub)
        drx, dry, drz = _normalize3(
            _fma(d_roughness, ssx, nx),
            _fma(d_roughness, ssy, ny),
            _fma(d_roughness, ssz, nz),
        )
        ddot = _dot3(dx, dy, dz, drx, dry, drz)
        exiting = ddot > 0.0
        onx = torch.where(exiting, -drx, drx)
        ony = torch.where(exiting, -dry, dry)
        onz = torch.where(exiting, -drz, drz)
        # non-dielectric lanes see a constant ior: 1/0 upstream of the
        # differentiable refl_prob would NaN the backward
        is_diel = mtype > 0.5
        ior = torch.where(is_diel, torch.clamp(parameter, min=1e-3), 1.5)
        ni_over_nt = torch.where(exiting, ior, 1.0 / ior)
        cosine = torch.where(exiting, ior * ddot, -ddot)
        dt = _dot3(dx, dy, dz, onx, ony, onz)
        disc_r = _fma(-(ni_over_nt * ni_over_nt), _fma(-dt, dt, 1.0), 1.0)
        can_refract = disc_r > 0.0
        sq_r = _sqrt(torch.where(can_refract, torch.clamp(disc_r, min=1e-8),
                                 1.0))
        rfx = _fma(ni_over_nt, _fma(-onx, dt, dx), -(onx * sq_r))
        rfy = _fma(ni_over_nt, _fma(-ony, dt, dy), -(ony * sq_r))
        rfz = _fma(ni_over_nt, _fma(-onz, dt, dz), -(onz * sq_r))
        refl_prob = _schlick(cosine, ior)
        do_refract = can_refract & (u_choice > refl_prob)
        diel_lp = torch.where(
            can_refract,
            torch.where(do_refract, _log_floor(1.0 - refl_prob),
                        _log_floor(refl_prob)),
            0.0,
        )
        lp_inc = torch.where(is_diel, diel_lp, lp_inc)
        dlx = torch.where(do_refract, rfx, _fma(-(2.0 * ddot), drx, dx))
        dly = torch.where(do_refract, rfy, _fma(-(2.0 * ddot), dry, dy))
        dlz = torch.where(do_refract, rfz, _fma(-(2.0 * ddot), drz, dz))
        sdx = torch.where(is_diel, dlx, sdx)
        sdy = torch.where(is_diel, dly, sdy)
        sdz = torch.where(is_diel, dlz, sdz)
        srr = torch.where(is_diel, torch.where(do_refract, alb_r, 1.0), srr)
        srg = torch.where(is_diel, torch.where(do_refract, alb_g, 1.0), srg)
        srb = torch.where(is_diel, torch.where(do_refract, alb_b, 1.0), srb)

    if has_volumes:
        # isotropic in-medium scatter: no lottery, the medium's albedo
        vsx, vsy, vsz = _unit_sphere(uc, ud)
        sdx = torch.where(vol_scatter, vsx, sdx)
        sdy = torch.where(vol_scatter, vsy, sdy)
        sdz = torch.where(vol_scatter, vsz, sdz)
        srr = torch.where(vol_scatter, v["in_ar"], srr)
        srg = torch.where(vol_scatter, v["in_ag"], srg)
        srb = torch.where(vol_scatter, v["in_ab"], srb)
        lp_inc = torch.where(vol_scatter, 0.0, lp_inc)

    # ---- sky + fold (SampleBatchJob.cs:341-396) --------------------------
    if sky_on:
        tsky = 0.5 * (dy + 1.0)
        skr = _fma(sky_t[0] - sky_b[0], tsky, sky_b[0])
        skg = _fma(sky_t[1] - sky_b[1], tsky, sky_b[1])
        skb = _fma(sky_t[2] - sky_b[2], tsky, sky_b[2])
    else:
        skr = skg = skb = torch.zeros_like(dx)
    lp = lp + torch.where(scatter_mask, lp_inc, 0.0)
    emr = torch.where(scatter_mask, em_r, torch.where(miss, skr, 0.0))
    emg = torch.where(scatter_mask, em_g, torch.where(miss, skg, 0.0))
    emb = torch.where(scatter_mask, em_b, torch.where(miss, skb, 0.0))
    radx = _fma(thx, emr, radx)
    rady = _fma(thy, emg, rady)
    radz = _fma(thz, emb, radz)
    thx = torch.where(scatter_mask, thx * srr, thx)
    thy = torch.where(scatter_mask, thy * srg, thy)
    thz = torch.where(scatter_mask, thz * srb, thz)

    # ---- advance + termination -------------------------------------------
    off = mk.SELF_EPS * torch.where(
        _dot3(sdx, sdy, sdz, nx, ny, nz) >= 0.0, 1.0, -1.0
    )
    new_o = [torch.where(scatter_mask, _fma(off, n_k, p_k), o_k)
             for n_k, p_k, o_k in ((nx, px, ox), (ny, py, oy), (nz, pz, oz))]
    if has_volumes:
        # a skip passes the boundary without scattering; the medium is
        # entered on a scatter, left on a skip
        new_o = [torch.where(skip, _fma(skip_t + mk.SELF_EPS, d_k, o_k), n_o)
                 for n_o, o_k, d_k in zip(new_o, (ox, oy, oz), (dx, dy, dz))]
        med = {k: torch.where(vol_scatter, v[k], med[k])
               for k in mk.VOL_KEYS}
        med["in_id"] = torch.where(skip, -1.0, med["in_id"])
    ox, oy, oz = new_o
    dx = torch.where(scatter_mask, sdx, dx)
    dy = torch.where(scatter_mask, sdy, dy)
    dz = torch.where(scatter_mask, sdz, dz)
    active = torch.where(miss, 0.0, active)
    valid = torch.where(miss, 1.0, valid)
    depth_ct = depth_ct + torch.where(was_active, 1.0, 0.0)
    exhausted = (active > 0.5) & (depth_ct > trace_depth - 0.5)
    active = torch.where(exhausted, 0.0, active)
    terminated = was_active & (active < 0.5)
    ok = terminated & (valid > 0.5)
    # zero-valued score surrogates on both accumulators (the valid count
    # is itself an outcome of the lotteries); their primal adds 0
    carrier = torch.where(ok, lp - lp.detach(), 0.0)
    rad_okx = torch.where(ok, radx, 0.0)
    rad_oky = torch.where(ok, rady, 0.0)
    rad_okz = torch.where(ok, radz, 0.0)
    ok_f = torch.where(ok, 1.0, 0.0)
    out = dict(
        ox=ox, oy=oy, oz=oz, dx=dx, dy=dy, dz=dz,
        thx=thx, thy=thy, thz=thz, radx=radx, rady=rady, radz=radz,
        active=active, valid=valid, started=started, depth_ct=depth_ct,
        csx=state["csx"] + rad_okx + rad_okx.detach() * carrier,
        csy=state["csy"] + rad_oky + rad_oky.detach() * carrier,
        csz=state["csz"] + rad_okz + rad_okz.detach() * carrier,
        cnt=state["cnt"] + ok_f + ok_f * carrier,
        lp=lp,
    )
    if has_volumes:
        out.update(med)
    if has_motion:
        out["ptime"] = ptime
    return out


def replay(
    tape,  # (samples*trace_depth, N) winner codes from the kernel
    lane_count,  # (N,)
    camera_row,  # (24,)
    centers,  # (S, 3)
    radii,  # (S,)
    records,  # (S, >= 11) pack_sphere_records
    sky_bottom,  # (3,)
    sky_top,  # (3,)
    seed,  # int32 batch seed
    lane_base: int = 0,
    *,
    samples: int,
    trace_depth: int,
    t_min: float = 0.0,
    has_dielectrics: bool = True,
    sky_on: bool = True,
    jitter: bool = True,
    tri_tables: tuple | None = None,
    rect_tables: tuple | None = None,
    box_tables: tuple | None = None,
    vol0: torch.Tensor | None = None,
    move_offsets: torch.Tensor | None = None,
    tex_tables: tuple | None = None,
):
    """Differentiable (color_sum (N, 3), count (N,)) of one batch,
    replaying the kernel's persistent-lane loop along the recorded tape
    (`tri_tables`: pack_tri_tables' pair, differentiable, for a mesh
    scene; `rect_tables`, `box_tables`: pack_aux_tables' pairs,
    differentiable; `vol0`: camera_containment_row, differentiable, for a
    scene with convex volumes; `move_offsets`: the spheres' (S, 3)
    unit-shutter motion, differentiable; `tex_tables`:
    pack_texture_tables' tables without Perlin ones, the records and the
    atlas differentiable).

    One checkpointed block per `trace_depth` iterations (JAX :1167-1201):
    the winner rows of the block are gathered at once, and only the
    block-entry state is kept for the backward.  Blocks whose tape rows
    are all idle are identity steps and are skipped."""
    n = lane_count.shape[0]
    if tex_tables is not None and tex_tables[1] is not None:
        raise ValueError("replay: the tape replay has no Perlin marble "
                         "(replay_eligible)")
    entity_rows = build_entity_rows(
        centers, radii, records, tri_tables, rect_tables, box_tables,
        move_offsets, None if tex_tables is None else tex_tables[0])
    env = make_env(lane_count, camera_row, sky_bottom, sky_top, seed,
                   lane_base, vol0)
    has_volumes = vol0 is not None
    has_motion = move_offsets is not None
    keys = state_keys(has_volumes, has_motion)
    statics = dict(jitter=jitter, has_dielectrics=has_dielectrics,
                   sky_on=sky_on, trace_depth=trace_depth, t_min=t_min,
                   has_tris=tri_tables is not None,
                   has_aux=rect_tables is not None or box_tables is not None,
                   has_volumes=has_volumes, has_motion=has_motion,
                   tex=None if tex_tables is None else (
                       None if tex_tables[2] is None
                       else tex_tables[2].to(torch.float32),
                       tuple(tex_tables[3])))
    state = initial_state(n, lane_count.device, has_volumes, has_motion)
    winners = torch.clamp(tape, min=0.0).to(torch.int64)
    block = trace_depth

    def run_block(b0, *flat):
        st = dict(zip(keys, flat))
        for it in range(b0, b0 + block):
            wt = entity_rows[winners[it]].T  # (cols, n) winner rows
            st = replay_iteration(st, wt, tape[it], it, env, **statics)
        return tuple(st[k] for k in keys)

    for b0 in range(0, samples * trace_depth, block):
        if not bool((tape[b0:b0 + block] > -1.5).any()):
            continue
        out = torch_checkpoint.checkpoint(
            run_block, b0, *(state[k] for k in keys),
            use_reentrant=False,
        )
        state = dict(zip(keys, out))
    return (torch.stack([state["csx"], state["csy"], state["csz"]], dim=-1),
            state["cnt"])


# ---------------------------------------------------------------------------
# autograd.Function: kernel primal, replay backward
# ---------------------------------------------------------------------------


TABLE_INPUTS = ("tri_geo", "tri_rec", "rect_geo", "rect_rec", "box_geo",
                "box_rec")


def _pairs(tables: dict):
    """(tri_tables, rect_tables, box_tables) from TABLE_INPUTS' tensors (a
    pair is None where its geometry is)."""
    return tuple(None if tables[f"{k}_geo"] is None
                 else (tables[f"{k}_geo"], tables[f"{k}_rec"])
                 for k in ("tri", "rect", "box"))


class _SampleBatchDiff(torch.autograd.Function):
    """Inputs: the six differentiable tables, the six tables of
    TABLE_INPUTS (None where the scene has no such kind), vol0 (None
    without volumes), the move offsets (None without motion), the texture
    records and atlas (None without checker or image albedos; the atlas
    None without an image), then the non-differentiable atlas dims, lane
    rows, the seed, the lane base and the static options."""

    @staticmethod
    def forward(ctx, camera_row, centers, radii, records, sky_bottom,
                sky_top, tri_geo, tri_rec, rect_geo, rect_rec, box_geo,
                box_rec, vol0, move_offsets, tex_rec, atlas, tex_dims,
                lane_count, count_in, seed, lane_base, statics):
        tables = dict(zip(TABLE_INPUTS, (tri_geo, tri_rec, rect_geo,
                                         rect_rec, box_geo, box_rec)))
        tri, rect, box = _pairs(tables)
        tex = (None if tex_rec is None
               else mk.TexTables(tex_rec, None, atlas, tex_dims))
        if centers.device.type == "cuda":
            from raytracing_in_one_weekend_tpu_torch.ops import megatrace_bwd

            # the backward kernel has this build (or raise before the
            # forward runs)
            megatrace_bwd.build_kind(tri is not None,
                                     rect is not None or box is not None,
                                     vol0 is not None,
                                     move_offsets is not None,
                                     tex is not None)
        out = mk.sample_batch(
            lane_count, count_in, camera_row, centers, radii, records,
            sky_bottom, sky_top, seed, lane_base, want_tape=True,
            tri_tables=tri, rect_tables=rect, box_tables=box, vol0=vol0,
            move_offsets=move_offsets, tex_tables=tex, **statics,
        )
        ctx.save_for_backward(out["tape"], lane_count, camera_row, centers,
                              radii, records, sky_bottom, sky_top,
                              *tables.values(), vol0, move_offsets, tex_rec,
                              atlas)
        ctx.seed, ctx.lane_base, ctx.statics = seed, lane_base, statics
        ctx.tex_dims = tex_dims
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(out["rays"])
        # separate contiguous tensors, not views of one accumulator buffer
        return tuple(out[k].clone(memory_format=torch.contiguous_format)
                     for k in mk.OUTPUT_KEYS)

    @staticmethod
    def backward(ctx, *cots):
        cot = dict(zip(mk.OUTPUT_KEYS, cots))
        leaked = [k for k in AOV_OUTPUTS if cot[k] is not None]
        if leaked:
            raise NotImplementedError(
                "sample_batch_diff propagates only the color sum's and "
                "valid count's cotangents, but this loss also "
                f"differentiates through {leaked}: render_batch gives AOV "
                "channels their gradients through the wavefront's AOV graft"
            )
        from raytracing_in_one_weekend_tpu_torch.ops import megatrace_bwd

        (tape, lane_count, camera_row, centers, radii, records, sky_bottom,
         sky_top, *table_list, vol0, move_offsets, tex_rec,
         atlas) = ctx.saved_tensors
        tex = (None if tex_rec is None
               else mk.TexTables(tex_rec, None, atlas, ctx.tex_dims))
        tables = dict(zip(TABLE_INPUTS, table_list))
        tri, rect, box = _pairs(tables)
        n = lane_count.shape[0]
        zeros = torch.zeros(n, dtype=torch.float32, device=tape.device)
        cot_color = (cot["color"] if cot["color"] is not None
                     else zeros[:, None].expand(n, 3))
        cot_count = cot["count"] if cot["count"] is not None else zeros
        grads = list(megatrace_bwd.replay_grad(
            tape, lane_count, camera_row, centers, radii, records,
            sky_bottom, sky_top, ctx.seed, cot_color, cot_count,
            ctx.lane_base, tri_tables=tri, rect_tables=rect,
            box_tables=box, vol0=vol0, move_offsets=move_offsets,
            tex_tables=tex, **ctx.statics,
        ))
        atlas_grad = grads.pop() if atlas is not None else None
        tex_grad = grads.pop() if tex_rec is not None else None
        move_grad = grads.pop() if move_offsets is not None else None
        vol0_grad = grads.pop() if vol0 is not None else None
        table_grads = [None] * len(TABLE_INPUTS)
        for j, pair in enumerate((tri, rect, box)):
            if pair is not None:
                table_grads[2 * j:2 * j + 2] = grads[6:8]
                del grads[6:8]
        return (*grads, *table_grads, vol0_grad, move_grad, tex_grad,
                atlas_grad, None, None, None, None, None, None)


def sample_batch_diff(
    lane_count: torch.Tensor,
    count_in: torch.Tensor,
    camera_row: torch.Tensor,
    centers: torch.Tensor,
    radii: torch.Tensor,
    records: torch.Tensor,
    sky_bottom: torch.Tensor,
    sky_top: torch.Tensor,
    seed,
    lane_base: int = 0,
    *,
    samples: int,
    trace_depth: int,
    t_min: float = 0.0,
    has_dielectrics: bool = True,
    sky_on: bool = True,
    jitter: bool = True,
    tri_tables: tuple | None = None,
    rect_tables: tuple | None = None,
    box_tables: tuple | None = None,
    vol0: torch.Tensor | None = None,
    move_offsets: torch.Tensor | None = None,
    tex_tables: tuple | None = None,
) -> dict:
    """`megatrace.sample_batch` with gradients with respect to camera_row,
    centers, radii, records, sky_bottom, sky_top and, where the scene has
    them, the two tables of `tri_tables` (pack_tri_tables' pair: the
    soup's edges, vertices and normals and the triangle materials), of
    `rect_tables` and `box_tables` (pack_aux_tables' pairs: quaternions,
    positions, extents and materials; JAX `_aux_pairs`), `vol0`
    (camera_containment_row: the camera medium's density, albedo and
    emission), `move_offsets` (the spheres' unit-shutter motion; JAX
    `aux_cot["move"]`) and `tex_tables`' records and atlas
    (pack_texture_tables, without Perlin tables: the texture colours and
    the texel plane), through the tape replay.  Outputs are the kernel's (no
    tape).  Only the `color` and `count` cotangents propagate; a loss that
    differentiates an AOV output raises NotImplementedError in backward
    (render_batch grafts the AOV gradients on from the wavefront).  When
    no input requires a gradient (or grad mode is off) this is the
    forward path, with no tape."""
    statics = dict(samples=samples, trace_depth=trace_depth, t_min=t_min,
                   has_dielectrics=has_dielectrics, sky_on=sky_on,
                   jitter=jitter)
    diff_inputs = (camera_row, centers, radii, records, sky_bottom, sky_top)
    tables = tuple(t for pair in (tri_tables, rect_tables, box_tables)
                   for t in ((None, None) if pair is None else tuple(pair)))
    tex = ((None, None, (0, 0)) if tex_tables is None
           else (tex_tables[0], tex_tables[2], tuple(tex_tables[3])))
    if not (torch.is_grad_enabled()
            and any(t is not None and t.requires_grad
                    for t in (*diff_inputs, *tables, vol0, move_offsets,
                              *tex[:2]))):
        return mk.sample_batch(lane_count, count_in, *diff_inputs, seed,
                               lane_base, tri_tables=tri_tables,
                               rect_tables=rect_tables,
                               box_tables=box_tables, vol0=vol0,
                               move_offsets=move_offsets,
                               tex_tables=tex_tables, **statics)
    if tex_tables is not None and tex_tables[1] is not None:
        raise ValueError("sample_batch_diff: the tape replay has no Perlin "
                         "marble (replay_eligible)")
    outs = _SampleBatchDiff.apply(*diff_inputs, *tables, vol0, move_offsets,
                                  *tex, lane_count, count_in, int(seed),
                                  int(lane_base), statics)
    return dict(zip(mk.OUTPUT_KEYS, outs))
