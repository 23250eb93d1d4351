"""Fused sample-batch path tracer: the CUDA kernel and its plain version.

Counterpart of the JAX package's `ops/pallas_megatrace.py`: the sphere arm,
the rect and box arm, the convex-volume arm, the unit-shutter motion and
albedo-texture arms, the triangle (VMEM) arm and the streamed-triangle
arm of its `_batch_kernel` (gradient or no sky, white noise), the
forward path of the book cover, of rect and box scenes (`cornell`,
`simple_light`), of scenes with fog spheres and boxes (`volume`,
`probabilistic`, `cornell_volumes`), of moving and textured spheres
(`cover_motion`, `checkered`, `perlin`, `textured_sphere`,
`final_book2`) and of mesh scenes of at most TRI_STREAM_MAX triangles.
One
call runs a whole SampleBatchJob (reference: SampleBatchJob.cs:59-164,
166-401) and returns per-lane accumulation deltas: thin-lens camera rays,
persistent-lane path regeneration over `samples * trace_depth`
iterations, the dense sphere sweep, the one-sided rect and Majercik box
tests in each entity's frame (`rect_test`, `box_test`), the
Möller–Trumbore sweep over
TRI_BLOCK-row triangle blocks (each skipped by a lane whose ray misses the
block's AABB; a streamed mesh adds a level above, one AABB per TRI_SUP
blocks), with `vol0` (`camera_containment_row`) the Beer-Lambert walk
through convex volumes (each lane carries its medium; a free path
shorter than the segment scatters isotropically in the medium, an entry
or an exit without one passes the boundary in an iteration of its own),
with `move_offsets` the spheres moved to each path's shutter time, with
`tex_tables` (`pack_texture_tables`) the winner's albedo textured
(checker, Perlin marble, nearest atlas texel),
Lambert / GGX-metal / dielectric scatter, the gradient sky, and the
per-pixel fold, AOVs, noise weight and ray count.  With `pixel_index`
lane i renders that pixel (the renderer passes `morton_order` for
streamed meshes) and the deltas stay in lane order.

* `sample_batch_reference` is the plain PyTorch version: vectorised over
  lanes, a Python loop over iterations, lanes processed in chunks so the
  (spheres or triangles, lanes) sweep temporaries stay bounded.
* `csrc/megatrace_batch.cu` holds the hand-written CUDA kernels for
  Hopper: one thread per lane, path state in registers, sphere geometry
  staged in shared memory.  Sphere scenes take `megatrace_sphere_kernel`,
  whose warps run 8x4 pixel tiles of lanes (`tile_lane_order` is the
  map's plain twin); scenes with rects or boxes its aux build, which
  stages them beside the spheres and sweeps them after (`AUX_LAUNCHES`
  counts it); scenes with convex volumes its volume builds, beside
  spheres or beside rects and boxes (`VOL_LAUNCHES`); scenes with moving
  spheres or textured albedos its motion and texture builds, every
  combination with the others (`MOTION_LAUNCHES`, `TEX_LAUNCHES`);
  meshes of at most
  TRI_MAX triangles take
  `megatrace_batch_kernel` (triangles read through the read-only cache,
  one thread a lane in lane order); streamed
  tables take `megatrace_stream_kernel`, whose thread blocks of 128 lanes
  run the iterations in lockstep and sweep the triangles together
  (`csrc/group_sweep.cuh`, the bounce-synchronous sampler's traversal).
* `sample_batch` is the wrapper: CPU tensors take the plain version; CUDA
  tensors launch the kernel or raise.  It counts launches in `LAUNCHES`.

The module also holds the per-ray fused trace `megatrace` (the JAX
package's `_kernel`, the wavefront integrator's `mega` arm, sphere-only
as in the JAX package): given rays traced to the end of `trace_depth`
bounces, with the same bounce code (`_bounce`; on the card
`csrc/megatrace_bounce.cuh`), its plain version `megatrace_reference` and
its kernel `csrc/megatrace_wave.cu`, launches counted in `WAVE_LAUNCHES`.

Both use the kernels' counter-based hash PRNG (lowbias32 of seed, global
lane, stream and an iteration salt), bit for bit, so the port traces the
same paths as the JAX kernel in interpret mode with `hw_prng=False`.
The packers keep the JAX kernel's table layouts, so tests compare like
with like.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from raytracing_in_one_weekend_tpu_torch.core import math3

BIG = 1e30
SPHERE_PAD = 128
SPH_CULL_MIN = 1024  # sphere count above which the JAX kernel switches to
# its blocked sweep (and the renderer to Morton lanes); this slice ports
# the dense sweep only and refuses bigger scenes
PAD_CENTER = 1e17
REC_COLS = 24  # 0-10 material | 11 material id | 12-14 center | 15 1/r
KERNEL_REC = 16  # record columns the kernel reads (0-15)
OUT_ROWS = 18  # color 0-2 | count 3 | normal 4-6 | albedo 7-9 | weight 10
#   | rays 11 | fallback normal 12-14 | fallback albedo 15-17
SELF_EPS = 1e-3  # Ray.OffsetTowards epsilon (Ray.cs:19)
PLASTIC_IOR = 1.5
METAL_IOR = 1.1
TWO_PI = 6.283185307179586
INV_2_24 = 1.0 / 16777216.0
SALT_STEP = 1013904223  # per-iteration salt of the camera draws
SALT_BOUNCE = 7919  # extra salt of the bounce draws
_MASK32 = 0xFFFFFFFF

LAUNCHES = 0  # CUDA kernel launches made by sample_batch
AUX_LAUNCHES = 0  # ... of them, launches of the aux build (rects, boxes)
MOTION_LAUNCHES = 0  # ... of them, launches of the motion builds (moving
#   spheres, beside rects, boxes or volumes or none; untextured)
TEX_LAUNCHES = 0  # ... of them, launches of the texture builds (checker,
#   Perlin and image albedos, with or without motion, rects, boxes and
#   volumes)
VOL_LAUNCHES = 0  # ... of them, launches of the volume builds (volumes
#   beside spheres, or beside rects and boxes)
WAVE_LAUNCHES = 0  # CUDA kernel launches made by megatrace
TRI_PAIRS = 0  # (lane, triangle) pairs the plain version's sweep tested:
#   the kernel tests the same ones (the operation count of its bound)
SLAB_TESTS = 0  # (lane, AABB) slab tests of the plain version's culls
SALT_DEPTH = 26699  # per-bounce salt of the per-ray megatrace's draws
WAVE_ROWS = 12  # radiance 0-2 | valid 3 | normal 4-6 | albedo 7-9 |
#   events 10 | rays 11

TILE_W, TILE_H = 8, 4  # a warp of the sphere kernel: a pixel tile

TRI_PAD = 128
TRI_BLOCK = 192  # triangle rows per culled block (the JAX kernel's chunk)
TRI_MAX = 4096  # triangles of pack_tri_tables (the JAX kernel's VMEM
# residence); beyond it pack_tri_stream_tables' streamed arm takes them
TRI_STREAM_MAX = 262144  # triangles the streamed arm takes (JAX's cap)
TRI_SUP = 16  # blocks under one super-block AABB (the second cull level)
MAX_SUPERS = 128  # supers the streamed kernels order (TRI_STREAM_MAX's: 86)
TRI_REC_ROWS = 32  # 0-10 material | 11 id | 12-20 vertex normals |
#   21-23 vertex u | 24-26 vertex v
TOO_MANY_TRIANGLES = (f"meshes of more than {TRI_STREAM_MAX} triangles "
                      "(the JAX package's cap; the BVH, ROADMAP queue 1, "
                      "step 9)")
AUX_PAD = 8  # rect and box table rows are padded to a multiple of this
AUX_REC_ROWS = 24
AUX_MAX = 1024  # rects plus boxes the kernels stage in shared memory
AUX_KERNEL_REC = 16  # record columns the kernel reads: 0-10 material |
#   11 material id | 12-14 a rect's world normal
RECTS_IN_MESHES = ("rects and boxes in mesh scenes (ROADMAP queue 1, "
                   "step 7.1b)")
VOLUMES_IN_MESHES = ("volumes in mesh scenes (ROADMAP queue 1, step 7.2b)")
MOTION_IN_MESHES = ("motion blur in mesh scenes (ROADMAP queue 1, "
                    "step 7.3b)")
TEXTURES_IN_MESHES = ("checker, Perlin and image textures in mesh scenes "
                      "(ROADMAP queue 1, step 7.5b)")
TEX_COLS = 16  # texture record columns (pack_texture_tables): 0 albedo
#   TextureType | 1-3 main colour | 4-6 secondary | 7 parameter | 8 atlas
#   row base (image index * H)
PERLIN_ROWS = 8  # Perlin table rows: perm_x, perm_y, perm_z, vectors xyz
VOL_ROWS = 8  # a medium: material id (-1: none) | density | albedo rgb |
#   emission rgb (camera_containment_row, the kernels' medium state)


# ---------------------------------------------------------------------------
# Scope
# ---------------------------------------------------------------------------


def unported_feature(scene) -> str | None:
    """The first scene feature no ported path draws, named with its
    ROADMAP item, or None (the scope of the wavefront integrator)."""
    tris = scene.triangles.vert0.shape[0] > 0
    checks = (
        (tris and (scene.rects.rot.shape[0] > 0
                   or scene.boxes.rot.shape[0] > 0), RECTS_IN_MESHES),
        (tris and scene.spheres.center.shape[0] == 0,
         "meshes without spheres (ROADMAP queue 1, step 7.1b)"),
        (tris and scene.flags.has_volumes, VOLUMES_IN_MESHES),
        (scene.flags.has_nonconvex_volumes,
         "volumes on triangles (non-convex; ROADMAP queue 1, step 7.2b)"),
        (tris and scene.flags.has_motion, MOTION_IN_MESHES),
        (tris and scene.flags.has_procedural_textures, TEXTURES_IN_MESHES),
        (scene.flags.sky not in (0, 1),
         "cubemap skies (ROADMAP queue 1, step 7.6)"),
    )
    for refused, what in checks:
        if refused:
            return what
    return None


def unsupported_feature(scene, allow_triangles: bool = False,
                        allow_rect_box: bool = False,
                        allow_volumes: bool = False,
                        allow_motion: bool = False,
                        allow_textures: bool = False) -> str | None:
    """The first feature of `scene` the fused kernels do not render, named
    with its ROADMAP item, or None when the scene is in scope: the ported
    features, at least one entity, at most SPH_CULL_MIN spheres, triangles
    only with `allow_triangles`, rects, boxes and sphere-free scenes
    only with `allow_rect_box`, convex volumes only with `allow_volumes`
    moving spheres only with `allow_motion` and the unit shutter
    (SceneFlags.motion_unit_time), and checker, Perlin and image textures
    only with `allow_textures` and on albedos alone
    (SceneFlags.procedural_albedo_only; the batch kernel takes all five;
    the per-ray megatrace is sphere-only, static, untextured and has no
    volume walk, as the JAX package's), at most TRI_STREAM_MAX triangles
    and AUX_MAX rects and boxes (the JAX package's `scene_eligible`
    flags)."""
    spheres = scene.spheres.center.shape[0]
    aux = scene.rects.rot.shape[0] + scene.boxes.rot.shape[0]
    tri_count = scene.triangles.vert0.shape[0]
    if spheres > SPH_CULL_MIN:
        return (f"more than {SPH_CULL_MIN} spheres: the blocked sweep "
                "(ROADMAP queue 1, step 7)")
    if spheres + aux + tri_count == 0:
        return "scenes without entities (nothing for a kernel to sweep)"
    if tri_count > 0 and not allow_triangles:
        return "triangles (the per-ray megatrace is sphere-only)"
    if (aux > 0 or spheres == 0) and not allow_rect_box:
        return ("rects, boxes and sphere-free scenes (the per-ray "
                "megatrace is sphere-only)")
    if scene.flags.has_volumes and not allow_volumes:
        return "volumes (the per-ray megatrace has no volume walk)"
    if scene.flags.has_motion and not allow_motion:
        return "motion blur (the per-ray megatrace is static)"
    if scene.flags.has_motion and not scene.flags.motion_unit_time:
        return ("motion beyond the unit shutter (the kernels take the "
                "shutter time as the motion weight; the wavefront takes "
                "any time range)")
    if scene.flags.has_procedural_textures and not allow_textures:
        return ("checker, Perlin and image textures (the per-ray megatrace "
                "reads constant albedos)")
    if (scene.flags.has_procedural_textures
            and not scene.flags.procedural_albedo_only):
        return ("procedural textures beyond albedos (the kernels texture "
                "albedos; the wavefront samples every slot)")
    if tri_count > TRI_STREAM_MAX:
        return TOO_MANY_TRIANGLES
    if aux > AUX_MAX:
        return (f"more than {AUX_MAX} rects and boxes: the kernels stage "
                "them in shared memory (ROADMAP queue 1, step 7)")
    return unported_feature(scene)


def scene_eligible(scene, allow_triangles: bool = False,
                   allow_rect_box: bool = False,
                   allow_volumes: bool = False,
                   allow_motion: bool = False,
                   allow_textures: bool = False) -> bool:
    """Can this scene run in the ported fused kernels?  The batch kernel
    asks with every flag True, the per-ray megatrace without (the JAX
    package's `scene_eligible` flags)."""
    return unsupported_feature(scene, allow_triangles, allow_rect_box,
                               allow_volumes, allow_motion,
                               allow_textures) is None


# ---------------------------------------------------------------------------
# Packers (the JAX kernel's table layouts)
# ---------------------------------------------------------------------------


def sphere_pad_count(s: int) -> int:
    """Padded sphere-table rows (at least one pad block)."""
    return max(SPHERE_PAD, -(-s // SPHERE_PAD) * SPHERE_PAD)


def center_sq_minus_r2(cx, cy, cz, r):
    """|c|^2 - r^2 of the sphere quadratic, summed in one fixed order so
    that the packer, the tape replay and the backward kernel
    (csrc/megatrace_bwd.cu) round it identically."""
    return (cx * cx + cy * cy) + cz * cz - r * r


def _pack_scene_tables(centers, radii, records, move_offsets=None):
    """Sphere and record tables in the JAX kernel's layout.

    sph (S_pad, 8): cols 0-2 center, col 3 |c|^2 - r^2, or with
    `move_offsets` (unit-shutter motion) -r^2 (|c(t)|^2 depends on the
    ray's time) and cols 4-6 the move offset; pad rows sit at PAD_CENTER
    with col 3 = inf and can never hit.  rec (24, S_pad): rows 0-11 the
    record, 12-14 the center, 15 1/r, 16-18 the move offset."""
    s = centers.shape[0]
    s_pad = sphere_pad_count(s)
    f32 = dict(dtype=torch.float32, device=centers.device)

    sph = torch.full((s_pad, 8), PAD_CENTER, **f32)
    sph[:s, 0:3] = centers
    if move_offsets is None:
        sph[:s, 3] = center_sq_minus_r2(centers[:, 0], centers[:, 1],
                                        centers[:, 2], radii)
    else:
        sph[:s, 3] = -radii * radii
        sph[:, 4:7] = 0.0
        sph[:s, 4:7] = move_offsets
    sph[s:, 3] = float("inf")

    safe_r = torch.where(radii == 0.0, 1.0, radii)
    rec_t = torch.zeros((REC_COLS, s_pad), **f32)
    rec_t[: records.shape[1], :s] = records.T
    rec_t[12:15, :s] = centers.T
    rec_t[15, :s] = 1.0 / safe_r
    if move_offsets is not None:
        rec_t[16:19, :s] = move_offsets.T
    return sph, rec_t, s_pad


def sweep_tables(centers, radii, records=None, move_offsets=None):
    """The kernels' tables without the TPU padding: (S, 4) sphere rows
    (centre, |c|^2 - r^2, or -r^2 with `move_offsets`) and (S, 16) winner
    records (`records` in columns 0-11, centre, 1/r).  Pad rows never hit
    and come last, so sweeping the real rows keeps every winner index."""
    s = centers.shape[0]
    if records is None:
        records = centers[:, :0]
    sph, rec_t, _ = _pack_scene_tables(centers, radii, records, move_offsets)
    return sph[:s, :4].contiguous(), rec_t[:KERNEL_REC, :s].T.contiguous()


def move_table(move_offsets) -> torch.Tensor:
    """(S, 4) float32 rows of the motion builds: a sphere's move offset
    over the unit shutter (x, y, z, 0)."""
    m = move_offsets.detach().to(torch.float32)
    return torch.cat([m, torch.zeros_like(m[:, :1])], dim=1).contiguous()


def _pack_sky_row(sky_bottom, sky_top):
    zeros = torch.zeros(2, dtype=torch.float32, device=sky_bottom.device)
    return torch.cat([sky_bottom, sky_top, zeros]).to(torch.float32) \
        .reshape(1, 8)


def pack_sphere_records(scene, packed_materials):
    """(S, 12) sphere records: packed material rows 0-10 + material id."""
    mat = scene.spheres.material.long()
    return torch.cat(
        [
            packed_materials[mat][:, :11],
            scene.spheres.material[:, None].to(torch.float32),
        ],
        dim=1,
    )


def aux_pad_count(k: int) -> int:
    """Padded rect/box-table rows (pack_aux_tables layout)."""
    return max(AUX_PAD, -(-k // AUX_PAD) * AUX_PAD)


def pack_aux_tables(scene, packed_materials):
    """(rect_tables, box_tables) in the JAX kernel's layout (JAX
    pack_aux_tables), each None where the scene has none of that kind.

    rect geo (R_pad, 16): quat xyzw | pos | xy_from | xy_to; rec (24,
    R_pad): material rows 0-10 | world normal 11-13 (the rotated local +Z,
    Entity.cs:65) | material id 14.  box geo (B_pad, 16): quat | pos |
    extents; rec (24, B_pad): material rows 0-10 | quat 11-14 | pos 15-17 |
    extents 18-20 | material id 21.  The quaternions are normalized here
    (the kernels and the replay assume unit ones, and a raw quaternion's
    scale then gets no gradient).  Pad rows never hit (a rect from (1, 1)
    to (0, 0); a box of zero extents).  Differentiable: gradients to the
    rects' and boxes' rotations, positions, extents and materials flow
    through this pack."""
    f32 = dict(dtype=torch.float32, device=scene.rects.rot.device)
    rect_tables = None
    rct = scene.rects
    r = rct.rot.shape[0]
    if r > 0:
        r_pad = aux_pad_count(r)
        rrot = math3.quat_normalize(rct.rot.to(torch.float32))
        geo = torch.zeros((r_pad, 16), **f32)
        geo[:, 3] = 1.0  # identity quats on pad rows
        geo[:, 7:9] = 1.0  # pad: from (1, 1) > to (0, 0) never hits
        geo[:r, 0:4] = rrot
        geo[:r, 4:7] = rct.pos
        geo[:r, 7:9] = rct.xy_from
        geo[:r, 9:11] = rct.xy_to
        up = torch.tensor([0.0, 0.0, 1.0], **f32).expand(r, 3)
        rec = torch.zeros((AUX_REC_ROWS, r_pad), **f32)
        rec[:11, :r] = packed_materials[rct.material.long()][:, :11].T
        rec[11:14, :r] = math3.quat_rotate(rrot, up).T
        rec[14, :r] = rct.material.to(torch.float32)
        rect_tables = (geo, rec)

    box_tables = None
    box = scene.boxes
    b = box.rot.shape[0]
    if b > 0:
        b_pad = aux_pad_count(b)
        brot = math3.quat_normalize(box.rot.to(torch.float32))
        geo = torch.zeros((b_pad, 16), **f32)
        geo[:, 3] = 1.0
        geo[:b, 0:4] = brot
        geo[:b, 4:7] = box.pos
        geo[:b, 7:10] = box.extents  # pad rows keep extents 0
        rec = torch.zeros((AUX_REC_ROWS, b_pad), **f32)
        rec[:11, :b] = packed_materials[box.material.long()][:, :11].T
        rec[11:15, :b] = brot.T
        rec[15:18, :b] = box.pos.T
        rec[18:21, :b] = box.extents.T
        rec[21, :b] = box.material.to(torch.float32)
        box_tables = (geo, rec)
    return rect_tables, box_tables


class TexTables(NamedTuple):
    """The batch kernel's albedo-texture tables (pack_texture_tables)."""

    rec: torch.Tensor  # (M, TEX_COLS) a texture record per material
    perlin: torch.Tensor | None  # (PERLIN_ROWS, 256): the JAX layout
    atlas: torch.Tensor | None  # (A * H, W, 3) the image atlas, rows
    #   image-major
    dims: tuple  # (W, H) of the atlas's images, (0, 0) without one


def pack_texture_tables(scene) -> TexTables | None:
    """Per-material albedo-texture tables of a scene with procedural
    textures (None without), the JAX package's `pack_texture_tables`
    transposed to a row a material: record columns 0 TextureType, 1-3
    main colour, 4-6 secondary, 7 parameter (checker or noise frequency),
    8 the atlas row of the image's first texel row (image index * H);
    the Perlin tables as JAX's (8, 256) rows (perm_x, perm_y, perm_z,
    vectors x, y, z; small ints and unit components, exact in float32);
    the atlas (A, H, W, 3) as (A * H, W, 3) rows.  Differentiable with
    respect to the texture colours and the atlas."""
    if not scene.flags.has_procedural_textures:
        return None
    tex = scene.textures
    mats = scene.materials
    tid = mats.albedo_tex.long()
    m = tid.shape[0]
    h = tex.atlas.shape[1] if tex.atlas is not None else 0
    f32 = dict(dtype=torch.float32, device=tex.main_color.device)
    rec = torch.cat([
        tex.type[tid].to(torch.float32)[:, None],
        tex.main_color[tid].to(torch.float32),
        tex.secondary_color[tid].to(torch.float32),
        tex.parameter[tid].to(torch.float32)[:, None],
        (torch.clamp(tex.image_index[tid], min=0) * h)
        .to(torch.float32)[:, None],
        torch.zeros((m, TEX_COLS - 9), **f32),
    ], dim=1)
    perlin = None
    if tex.perlin is not None:
        p = tex.perlin
        perlin = torch.cat([
            torch.stack([p.perm_x, p.perm_y, p.perm_z]).to(torch.float32),
            p.random_vectors.T.to(torch.float32),
            torch.zeros((PERLIN_ROWS - 6, 256), **f32),
        ])
    atlas, dims = None, (0, 0)
    if tex.atlas is not None:
        a, ih, iw = tex.atlas.shape[:3]
        atlas = tex.atlas.to(torch.float32).reshape(a * ih, iw, 3)
        dims = (iw, ih)
    return TexTables(rec, perlin, atlas, dims)


def camera_containment_row(scene, packed_materials, origin) -> torch.Tensor:
    """(VOL_ROWS,) row [volume material id or -1, density, albedo rgb,
    emission rgb] of the medium around the camera origin: the batch
    kernel's initial medium at every regen (the JAX package's
    `camera_containment_row`, DetermineVolumeContainment,
    SampleBatchJob.cs:477-508, taken once for the shared origin).  Zeros
    but the id when the origin is in no volume.  Differentiable with
    respect to the packed materials."""
    from raytracing_in_one_weekend_tpu_torch.ops import intersect

    mat = intersect.point_inside_volume(scene, origin.reshape(1, 3))[0]
    row = packed_materials[torch.clamp(mat, min=0).long()]
    inside = (mat >= 0).to(torch.float32)
    return torch.stack([
        torch.where(mat >= 0, mat.to(torch.float32), -1.0),
        row[9] * inside,  # density
        row[1] * inside, row[2] * inside, row[3] * inside,
        row[4] * inside, row[5] * inside, row[6] * inside,
    ]).to(torch.float32)


def tri_pad_count(t: int) -> int:
    return max(TRI_PAD, -(-t // TRI_PAD) * TRI_PAD)


def pack_tri_tables(scene, packed_materials):
    """Triangle tables in the JAX kernel's layout (JAX pack_tri_tables),
    or None when the scene has none.

    geo (T_pad, 16): edge_a xyz | edge_b xyz | vert0 xyz, world space
    (Entity.cs:91-97); cols 9-15 of each TRI_BLOCK's first row hold the
    block's AABB (min xyz | max xyz, padded by 1e-4); a pad-only block
    holds a degenerate point at 1e30 that no slab test passes.  rec
    (TRI_REC_ROWS, T_pad): material rows 0-10 | material id 11 |
    per-vertex normals 12-14 / 15-17 / 18-20 | per-vertex u 21-23 / v
    24-26.  Pad rows keep zero edges (det == 0: never hit).  Gradients
    flow to the soup's edges, vertices, normals and uvs and to the
    material rows; the AABBs carry none."""
    tri = scene.triangles
    t = tri.vert0.shape[0]
    if t == 0:
        return None
    t_pad = tri_pad_count(t)
    f32 = dict(dtype=torch.float32, device=tri.vert0.device)
    geo = torch.zeros((t_pad, 16), **f32)
    geo[:t, 0:3] = tri.edge_a
    geo[:t, 3:6] = tri.edge_b
    geo[:t, 6:9] = tri.vert0
    with torch.no_grad():
        v0 = tri.vert0
        vs_all = torch.stack([v0, v0 + tri.edge_b, v0 + tri.edge_a])
        for st in range(0, t_pad, TRI_BLOCK):
            lo, hi = st, min(st + TRI_BLOCK, t)
            if lo >= t:
                geo[st, 9:15] = 1e30
                continue
            vs = vs_all[:, lo:hi].reshape(-1, 3)
            geo[st, 9:12] = vs.min(dim=0).values - 1e-4
            geo[st, 12:15] = vs.max(dim=0).values + 1e-4
    rec = torch.zeros((TRI_REC_ROWS, t_pad), **f32)
    rec[:11, :t] = packed_materials[tri.material.long()][:, :11].T
    rec[11, :t] = tri.material.to(torch.float32)
    rec[12:15, :t] = tri.normals[:, :, 0].T
    rec[15:18, :t] = tri.normals[:, :, 1].T
    rec[18:21, :t] = tri.normals[:, :, 2].T
    rec[21:24, :t] = tri.uvs[:, 0, :].T
    rec[24:27, :t] = tri.uvs[:, 1, :].T
    return geo, rec


class TriStream(NamedTuple):
    """pack_tri_stream_tables' tables, in the kernel's per-triangle layout:
    geo (T_pad, 12) = edge_a | edge_b | vert0 | 0 (three float4 a row),
    rec (T_pad, 32) the records (pack_tri_tables' rows, transposed), aabb
    (n_blk, 8) = lo | 0 | hi | 0 per TRI_BLOCK rows and sup (n_sup, 8) the
    same per TRI_SUP blocks.  Pad-only blocks and supers hold the
    degenerate far point 1e30, which no slab test passes."""

    geo: torch.Tensor
    rec: torch.Tensor
    aabb: torch.Tensor
    sup: torch.Tensor


def _spread3(x: torch.Tensor) -> torch.Tensor:
    """10-bit integers spread to every third bit (JAX's _spread)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


def pack_tri_stream_tables(scene, packed_materials) -> TriStream | None:
    """The streamed-triangle arm's tables for TRI_MAX < T <= TRI_STREAM_MAX
    (JAX pack_tri_stream_tables), or None when the scene has none.

    The triangles are sorted a second time, by the Morton code of their
    centroid (vert0 + (edge_a + edge_b) / 3, 10 bits an axis over the
    centroid bounds, stable), so that each TRI_BLOCK is a spatial cluster
    with a tight AABB (padded by 1e-4).  n_blk is padded to a multiple of
    TRI_SUP.  The JAX package packs three triangles into each 128-column
    row for the TPU's DMA alignment; this layout holds the same triangles
    in the same order, one a row.  No gradients: streamed meshes take the
    wavefront when something requires grad."""
    tri = scene.triangles
    t = tri.vert0.shape[0]
    if t == 0:
        return None
    f32 = dict(dtype=torch.float32, device=tri.vert0.device)
    with torch.no_grad():
        edge_a, edge_b, vert0 = (x.detach().to(torch.float32) for x in (
            tri.edge_a, tri.edge_b, tri.vert0))
        cen = vert0 + (edge_a + edge_b) * (1.0 / 3.0)
        lo = cen.min(dim=0).values
        span = torch.clamp(cen.max(dim=0).values - lo, min=1e-30)
        q = torch.clamp((cen - lo) / span * 1023.0, 0.0, 1023.0).to(
            torch.int64)
        key = ((_spread3(q[:, 0]) << 2) | (_spread3(q[:, 1]) << 1)
               | _spread3(q[:, 2]))
        order = torch.argsort(key, stable=True)
        edge_a, edge_b, vert0 = edge_a[order], edge_b[order], vert0[order]

        n_blk = -(-t // TRI_BLOCK)
        n_blk = -(-n_blk // TRI_SUP) * TRI_SUP
        t_pad = n_blk * TRI_BLOCK
        geo = torch.zeros((t_pad, 12), **f32)
        geo[:t, 0:3] = edge_a
        geo[:t, 3:6] = edge_b
        geo[:t, 6:9] = vert0
        v1, v2 = vert0 + edge_b, vert0 + edge_a
        pad_lo = torch.full((t_pad, 3), float("inf"), **f32)
        pad_hi = torch.full((t_pad, 3), float("-inf"), **f32)
        pad_lo[:t] = torch.minimum(torch.minimum(vert0, v1), v2)
        pad_hi[:t] = torch.maximum(torch.maximum(vert0, v1), v2)
        blk_lo = pad_lo.reshape(n_blk, TRI_BLOCK, 3).min(dim=1).values - 1e-4
        blk_hi = pad_hi.reshape(n_blk, TRI_BLOCK, 3).max(dim=1).values + 1e-4
        blk_real = (torch.arange(n_blk, device=geo.device) * TRI_BLOCK
                    < t)[:, None]
        far = torch.full((3,), 1e30, **f32)
        n_sup = n_blk // TRI_SUP
        sup_lo = torch.where(blk_real, blk_lo, float("inf")).reshape(
            n_sup, TRI_SUP, 3).min(dim=1).values
        sup_hi = torch.where(blk_real, blk_hi, float("-inf")).reshape(
            n_sup, TRI_SUP, 3).max(dim=1).values
        sup_real = blk_real.reshape(n_sup, TRI_SUP).any(dim=1)[:, None]

        def boxes(lo_, hi_, real):
            out = torch.zeros((lo_.shape[0], 8), **f32)
            out[:, 0:3] = torch.where(real, lo_, far)
            out[:, 4:7] = torch.where(real, hi_, far)
            return out

        rec = torch.zeros((t_pad, TRI_REC_ROWS), **f32)
        mat = tri.material[order]
        rec[:t, :11] = packed_materials.detach()[mat.long()][:, :11]
        rec[:t, 11] = mat.to(torch.float32)
        normals, uvs = tri.normals.detach()[order], tri.uvs.detach()[order]
        rec[:t, 12:21] = normals.transpose(1, 2).reshape(t, 9)
        rec[:t, 21:24] = uvs[:, 0, :]
        rec[:t, 24:27] = uvs[:, 1, :]
        return TriStream(geo, rec, boxes(blk_lo, blk_hi, blk_real),
                         boxes(sup_lo, sup_hi, sup_real))


@functools.lru_cache(maxsize=8)
def morton_order(width: int, height: int):
    """(order, rank): the lane -> pixel Z-order permutation and its inverse
    (JAX morton_order), int64 CPU tensors cached per resolution and
    shared by every caller (read them only).  With
    lanes in this order a run of lanes is a compact block of pixels, so
    its rays stay near each other and so do their AABB culls."""
    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.int64),
                            torch.arange(width, dtype=torch.int64),
                            indexing="ij")

    def spread(v):
        v = (v | (v << 16)) & 0x0000FFFF0000FFFF
        v = (v | (v << 8)) & 0x00FF00FF00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0F
        v = (v | (v << 2)) & 0x3333333333333333
        return (v | (v << 1)) & 0x5555555555555555

    code = (spread(xs) | (spread(ys) << 1)).reshape(-1)
    order = torch.argsort(code, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel())
    return order, rank


def tile_lane_order(n: int, width: int) -> torch.Tensor:
    """(n,) int64: the lane thread t of the sphere kernel runs, of n lanes
    in rows of `width` (lane i is pixel (i % width, i // width)); the
    plain twin of csrc/megatrace_batch.cu::tile_lane.  The threads first
    take the whole TILE_W x TILE_H tiles of the whole rows, 32 threads (a
    warp) a tile, tile rows top down; then, in lane order, the lanes left
    over: each tiled row's last width % TILE_W lanes, then the rows below
    the tiles.  A permutation of range(n) for any n and width."""
    t = torch.arange(n, dtype=torch.int64)
    tiles_x = width // TILE_W if width > 0 else 0
    rows = n // width // TILE_H * TILE_H if width > 0 else 0
    tiled = tiles_x * rows * TILE_W
    tile, q = t // (TILE_W * TILE_H), t % (TILE_W * TILE_H)
    ty, tx = tile // max(tiles_x, 1), tile % max(tiles_x, 1)
    in_tile = (ty * TILE_H + q // TILE_W) * width + tx * TILE_W + q % TILE_W
    r = t - tiled
    strip = width - tiles_x * TILE_W
    y = r // max(strip, 1)
    in_strip = y * width + tiles_x * TILE_W + (r - y * strip)
    below = rows * width + (r - rows * strip)
    return torch.where(t < tiled, in_tile,
                       torch.where(r < rows * strip, in_strip, below))


def pack_camera_row(camera, width: int, height: int) -> torch.Tensor:
    """The kernel's (24,) camera row: origin, lower_left, horizontal,
    vertical, right, up, lens_radius, width, height, 3 pad."""
    dev = camera.origin.device
    return torch.cat([
        camera.origin,
        camera.lower_left_corner,
        camera.horizontal,
        camera.vertical,
        camera.right,
        camera.up,
        torch.stack([
            camera.lens_radius,
            torch.tensor(float(width), dtype=torch.float32, device=dev),
            torch.tensor(float(height), dtype=torch.float32, device=dev),
        ]),
        torch.zeros(3, dtype=torch.float32, device=dev),
    ]).to(torch.float32)


# ---------------------------------------------------------------------------
# Hash PRNG (bit-exact with the JAX kernels' _lowbias32 / _uniforms_hash)
# ---------------------------------------------------------------------------
#
# uint32 arithmetic is carried in int64 masked to 32 bits: torch's uint32
# right shift has no CPU kernel.  Every sum is taken mod 2^32, which is
# exactly the JAX kernels' wrapping int32 arithmetic.


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """Low 32 bits of x * c for x, c < 2^32, without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & _MASK32) << 16
    return (lo + hi) & _MASK32


def _lowbias32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def uniforms_hash(seed, salt, lanes: torch.Tensor, streams: int = 8):
    """(streams, *shape) float32 U[0,1): hash of (seed, global lane,
    stream, salt) with 24 mantissa bits.  `lanes` holds global lane ids;
    `seed` and `salt` are ints or int64 tensors that broadcast with it."""
    base = (lanes.to(torch.int64) * 9781 + seed + salt) & _MASK32
    rows = []
    for k in range(streams):
        bits = _lowbias32((base + k * 6271) & _MASK32)
        rows.append((bits >> 8).to(torch.float32) * INV_2_24)
    return torch.stack(rows)


# ---------------------------------------------------------------------------
# Row helpers (plain version of the kernel's per-lane math)
# ---------------------------------------------------------------------------


# Precision contract, shared with the CUDA kernel bit for bit:
# * sqrt, rsqrt, sin, cos, the volume walk's log and the sphere uv's atan2
#   and acos give correctly rounded float32 results, taken through float64
#   (torch's float32 CPU kernels are not correctly rounded; the kernel
#   computes the same float64 expressions).  The JAX kernel's uv uses a
#   polynomial atan2 (a TPU workaround, ~1e-6 rad): the port does not.
# * A multiply-add is fused (rounded once) exactly where it is written
#   with `_fma`: the places where the JAX kernel's CPU compile contracts
#   it.  Every other product and sum is rounded on its own, and the
#   kernel is compiled with -fmad=false so that nvcc adds no contraction.
# The sphere quadratic cancels most of its bits (it expands |o - c|^2),
# so one rounding more or less there moves a hit point far beyond
# float32 resolution: this is what keeps the port on the JAX kernel's
# paths and the kernel on its plain version's.


def _fma(a, b, c):
    """a * b + c rounded once to float32: the float64 product of two
    float32 values is exact, so only the float64 sum and its conversion
    round, and those agree with one float32 rounding."""
    def f64(x):
        return x.double() if isinstance(x, torch.Tensor) else float(x)

    return (f64(a) * f64(b) + f64(c)).float()


def _sqrt(x):
    return torch.sqrt(x.double()).float()


def _rsqrt(x):
    return (1.0 / torch.sqrt(x.double())).float()


def _log(x):
    return torch.log(x.double()).float()


def _sin(x):
    return torch.sin(x.double()).float()


def _cos(x):
    return torch.cos(x.double()).float()


def _atan2(y, x):
    return torch.atan2(y.double(), x.double()).float()


def _acos(x):
    return torch.acos(x.double()).float()


def _dot3(ax, ay, az, bx, by, bz):
    """fma(az, bz, fma(ax, bx, ay * by))."""
    return _fma(az, bz, _fma(ax, bx, ay * by))


def _normalize3(x, y, z, eps=1e-12):
    inv = _rsqrt(torch.clamp(_dot3(x, y, z, x, y, z), min=eps))
    return x * inv, y * inv, z * inv


def _basis(nx, ny, nz):
    """Branchless Duff et al. orthonormal basis (Util/Tools.cs:19-28)."""
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    tx, ty, tz = _fma(sign * nx * nx, a, 1.0), sign * b, -sign * nx
    bx, by, bz = b, _fma(ny * ny, a, sign), -ny
    return (tx, ty, tz), (bx, by, bz)


def _cosine_hemisphere(u, v, nx, ny, nz):
    r = _sqrt(u)
    th = v * TWO_PI
    x = r * _cos(th)
    z = r * _sin(th)
    y = _sqrt(torch.clamp(1.0 - u, min=0.0))
    (tx, ty, tz), (bx, by, bz) = _basis(nx, ny, nz)
    return (
        _fma(z, bx, _fma(x, tx, y * nx)),
        _fma(z, by, _fma(x, ty, y * ny)),
        _fma(z, bz, _fma(x, tz, y * nz)),
    )


def _unit_sphere(u, v):
    z = u * 2.0 - 1.0
    r = _sqrt(torch.clamp(1.0 - z * z, min=0.0))
    th = v * TWO_PI
    return _cos(th) * r, _sin(th) * r, z


def _schlick(cosine, ior):
    r0 = (1.0 - ior) / (1.0 + ior)
    r0 = r0 * r0
    m = torch.clamp(1.0 - cosine, min=0.0)
    return _fma((1.0 - r0) * m * m * m * m, m, r0)


def _roughness_to_alpha(roughness):
    roughness = torch.clamp(roughness, min=1e-3)
    x = torch.log(roughness)
    return (
        1.62142
        + 0.819955 * x
        + 0.1734 * x * x
        + 0.0171201 * x * x * x
        + 0.000640711 * x * x * x * x
    )


def _smith_masking(cos_theta, roughness):
    """Smith masking G1 given cos(w, n).  Degenerate lanes (cos^2 < 1e-12)
    see constant division inputs, which keeps a future adjoint finite."""
    sq_cos = cos_theta * cos_theta
    sq_sin = torch.clamp(1.0 - sq_cos, min=0.0)
    degenerate = sq_cos < 1e-12
    safe = torch.where(degenerate, 1.0, sq_cos)
    sq_tan = torch.where(degenerate, 0.0, sq_sin) / safe
    alpha = _roughness_to_alpha(roughness)
    lam = (-1.0 + _sqrt(_fma(alpha * alpha, sq_tan, 1.0))) / 2.0
    lam = torch.where(degenerate, 0.0, lam)
    return 1.0 / (1.0 + lam)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def moved_center(c, m, ptime):
    """A moving sphere's centre at shutter time `ptime` (the unit shutter:
    the time is the motion weight), c + m t rounded once, as the JAX
    kernel's CPU compile contracts it (Entity.cs:124-127)."""
    return _fma(m, ptime, c)


def _quadratic_bc(o, d, c, cw, m=None, ptime=None):
    """The sweep's b and c terms of the sphere quadratic for rays o, d
    against centres c (a 3-tuple) with column-3 values cw: b = o.d - d.c,
    c = (|o|^2 - 2 o.c) + cw; with move offsets m at times ptime the
    centre is c(t) = moved_center(c, m, t) and c = ((|o|^2 - 2 o.c(t)) +
    |c(t)|^2) + cw, cw = -r^2 (the JAX kernel's order, :379-390).
    fma(-2, o.c, |o|^2) is the first sum's one rounding: the product by 2
    is exact."""
    ox, oy, oz = o
    dx, dy, dz = d
    if m is not None:
        c = tuple(moved_center(ck, mk_, ptime) for ck, mk_ in zip(c, m))
    cx, cy, cz = c
    b = _dot3(ox, oy, oz, dx, dy, dz) - _dot3(dx, dy, dz, cx, cy, cz)
    cc = _dot3(ox, oy, oz, ox, oy, oz) - 2.0 * _dot3(ox, oy, oz, cx, cy, cz)
    if m is not None:
        cc = cc + _dot3(cx, cy, cz, cx, cy, cz)
    return b, cc + cw


def _sweep(o, d, sph, t_min, move=None, ptime=None):
    """Dense sphere sweep over the real rows: (best_t, best_idx) per lane,
    argmin's first-index rule on ties, index 0 on a miss.  With `move`
    ((S, 3) move offsets) and `ptime` ((C,) shutter times) the centres
    move (sph column 3 then holds -r^2)."""
    ox, oy, oz = o
    dx, dy, dz = d
    if sph.shape[0] == 0:  # a sphere-free scene: every lane misses them
        return (torch.full_like(ox, BIG),
                torch.zeros_like(ox, dtype=torch.int64))
    cx, cy, cz, cmr2 = (sph[:, k:k + 1] for k in range(4))  # (S, 1)
    m = None if move is None else tuple(move[:, k:k + 1] for k in range(3))
    a = _dot3(dx, dy, dz, dx, dy, dz)
    inv_a = 1.0 / a
    b, c = _quadratic_bc(o, d, (cx, cy, cz), cmr2, m, ptime)  # (S, C)
    disc = _fma(b, b, -(a * c))
    del c
    # roots only where the discriminant is positive (few (sphere, lane)
    # pairs); every other entry stays BIG
    s_idx, l_idx = torch.nonzero(disc > 0.0, as_tuple=True)
    bb = b[s_idx, l_idx]
    sq = _sqrt(disc[s_idx, l_idx])
    ia = inv_a[l_idx]
    t_near = (-bb - sq) * ia
    t_far = (-bb + sq) * ia
    t_root = torch.where(
        t_near > t_min, t_near, torch.where(t_far > t_min, t_far, BIG)
    )
    t_entry = torch.full_like(disc, BIG)
    t_entry[s_idx, l_idx] = t_root
    return torch.min(t_entry, dim=0).values, torch.argmin(t_entry, dim=0)


def sphere_exit(o, d, row, t_min, m=None, ptime=None):
    """The far root of the sphere quadratic for rays o, d against sphere
    rows `row` (centre, |c|^2 - r^2; each a 3-tuple or broadcastable;
    with move offsets `m` at times `ptime`, -r^2): the exit distance of a
    volume sphere the ray hit (the JAX kernel's `t_exit_rows`, :401-408),
    BIG where it is at or before t_min.  The same float operations as
    `_sweep`'s, so it is bit-equal to the root the sweep would take there;
    only meaningful where the discriminant is positive (a hit)."""
    dx, dy, dz = d
    cx, cy, cz, cmr2 = row
    a = _dot3(dx, dy, dz, dx, dy, dz)
    b, c = _quadratic_bc(o, d, (cx, cy, cz), cmr2, m, ptime)
    disc = _fma(b, b, -(a * c))
    t_far = (-b + _sqrt(torch.clamp(disc, min=0.0))) * (1.0 / a)
    return torch.where(t_far > t_min, t_far, BIG)


def _cross_fma(a, b):
    """a x b with each x*y - z*w as fma(x, y, -(z*w))."""
    return (_fma(a[1], b[2], -(a[2] * b[1])),
            _fma(a[2], b[0], -(a[0] * b[2])),
            _fma(a[0], b[1], -(a[1] * b[0])))


def mt_parts(o, d, ea, eb, v0, mask=None):
    """(det, u, v, t) of Möller–Trumbore (HitTests.cs:116-150) for rays
    o, d against triangles ea (v2 - v0), eb (v1 - v0), v0, each a 3-tuple
    of broadcastable tensors.  The division takes det where det != 0 (and
    `mask`, if given) and 1 elsewhere.  The products that XLA's CPU compile
    contracts are fused here (the precision contract above): a cross
    product's x*y - z*w is fma(x, y, -(z*w)), a 3-dot is `_dot3`.  The
    tape replay runs it with gradients."""
    pv = _cross_fma(d, ea)
    det = _dot3(*eb, *pv)
    divide = det != 0.0 if mask is None else mask & (det != 0.0)
    inv_det = 1.0 / torch.where(divide, det, 1.0)
    tv = (o[0] - v0[0], o[1] - v0[1], o[2] - v0[2])
    u = _dot3(*tv, *pv) * inv_det
    qv = _cross_fma(tv, eb)
    v = _dot3(*d, *qv) * inv_det
    t = _dot3(*ea, *qv) * inv_det
    return det, u, v, t


def moller_trumbore(o, d, ea, eb, v0, t_min):
    """Möller–Trumbore of rays o, d (3-tuples of rows) against triangles
    ea, eb, v0 (3-tuples of columns), broadcast: (t, u, v) with t = BIG
    where there is no hit (det == 0 divides by 1 and never hits)."""
    det, u, v, t = mt_parts(o, d, ea, eb, v0)
    ok = ((det != 0.0) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
          & ((u + v) <= 1.0) & (t > t_min))
    return torch.where(ok, t, BIG), u, v


def _inv_d(c):
    """1 / c with |c| floored at 1e-12, the slab test's inverse."""
    return 1.0 / torch.where(torch.abs(c) < 1e-12,
                             torch.where(c >= 0.0, 1e-12, -1e-12), c)


def _slab_may(lo, hi, o, inv, t_min, bound):
    """Lanes whose ray (o, 1/d = inv) meets the AABB lo..hi at or after
    t_min and before `bound`: the slab test of the JAX kernel's culls.
    Adds the lanes it tests to SLAB_TESTS."""
    global SLAB_TESTS
    SLAB_TESTS += o[0].numel()
    slab = [((lo[k] - o[k]) * inv[k], (hi[k] - o[k]) * inv[k])
            for k in range(3)]
    b_near = torch.maximum(
        torch.minimum(*slab[0]),
        torch.maximum(torch.minimum(*slab[1]), torch.minimum(*slab[2])))
    b_far = torch.minimum(
        torch.maximum(*slab[0]),
        torch.minimum(torch.maximum(*slab[1]), torch.maximum(*slab[2])))
    return (b_far >= torch.clamp(b_near, min=t_min)) & (b_near < bound)


def _tri_block(o, d, inv, lanes, best_t, lo, hi, rows, st, hit, t_min):
    """Sweep triangle rows st.. (geometry `rows`, edge_a | edge_b | vert0
    in columns 0-8) for those of `lanes` whose ray meets the block's AABB
    before their best hit so far (spheres' `best_t`, then earlier blocks),
    updating hit = [t, row, u, v] in place.  A row wins only with a
    strictly smaller t, so the first row wins a tie.  Adds the (lane,
    triangle) pairs it tests to TRI_PAIRS."""
    global TRI_PAIRS
    tri_t, tri_idx, tri_u, tri_v = hit
    ol, il = [c[lanes] for c in o], [c[lanes] for c in inv]
    may = _slab_may(lo, hi, ol, il, t_min,
                    torch.minimum(tri_t[lanes], best_t[lanes]))
    lanes = lanes[may]
    if lanes.numel() == 0:
        return
    TRI_PAIRS += lanes.numel() * rows.shape[0]
    t, u, v = moller_trumbore(
        tuple(c[lanes] for c in o), tuple(c[lanes] for c in d),
        tuple(rows[:, k:k + 1] for k in range(0, 3)),
        tuple(rows[:, k:k + 1] for k in range(3, 6)),
        tuple(rows[:, k:k + 1] for k in range(6, 9)), t_min)
    blk_t, blk_i = torch.min(t, dim=0)
    pos = torch.nonzero(blk_t < tri_t[lanes], as_tuple=True)[0]
    lw, bi = lanes[pos], blk_i[pos]
    tri_t[lw] = blk_t[pos]
    tri_idx[lw] = st + bi
    tri_u[lw] = u[bi, pos]
    tri_v[lw] = v[bi, pos]


def _no_tri_hit(ox):
    """[t, row, u, v] of lanes that hit no triangle: BIG, 0, 0, 0."""
    return [torch.full_like(ox, BIG),
            torch.zeros(ox.shape[0], dtype=torch.int64, device=ox.device),
            torch.zeros_like(ox), torch.zeros_like(ox)]


def _tri_sweep(o, d, best_t, geo, t_min):
    """Nearest triangle per lane, TRI_BLOCK rows of pack_tri_tables' geo
    at a time (each block's AABB in columns 9-15 of its first row), the
    per-lane form of the JAX kernel's per-tile skip.  Returns (t, row, u,
    v); BIG, 0, 0, 0 where no triangle is hit."""
    inv = [_inv_d(c) for c in d]
    hit = _no_tri_hit(o[0])
    lanes = torch.arange(o[0].shape[0], device=o[0].device)
    for st in range(0, geo.shape[0], TRI_BLOCK):
        _tri_block(o, d, inv, lanes, best_t, geo[st, 9:12], geo[st, 12:15],
                   geo[st:st + TRI_BLOCK], st, hit, t_min)
    return tuple(hit)


def _tri_stream_sweep(o, d, best_t, stream: TriStream, t_min):
    """Nearest triangle per lane over pack_tri_stream_tables' tables: a
    lane tests a super-block's AABB before its TRI_SUP blocks, each block
    as `_tri_sweep` does (the per-lane form of the JAX kernel's two-level
    per-tile cull; JAX and the kernel take the same nearest hit, the
    earlier row on a tie)."""
    inv = [_inv_d(c) for c in d]
    hit = _no_tri_hit(o[0])
    every = torch.arange(o[0].shape[0], device=o[0].device)
    for s in range(stream.sup.shape[0]):
        box = stream.sup[s]
        lanes = every[_slab_may(box[0:3], box[4:7], o, inv, t_min,
                                torch.minimum(hit[0], best_t))]
        if lanes.numel() == 0:
            continue
        for blk in range(s * TRI_SUP, (s + 1) * TRI_SUP):
            box, st = stream.aabb[blk], blk * TRI_BLOCK
            _tri_block(o, d, inv, lanes, best_t, box[0:3], box[4:7],
                       stream.geo[st:st + TRI_BLOCK], st, hit, t_min)
    return tuple(hit)


def _quat_rotate(qx, qy, qz, qw, vx, vy, vz):
    """v rotated by the quaternion (qx, qy, qz, qw), the JAX kernel's
    `_quat_rotate` (t = 2 q_v x v; v + w t + q_v x t) with the products its
    CPU compile contracts fused: a cross product's x*y - z*w is fma(x, y,
    -(z*w)), v + w t is fma(w, t, v).  Any broadcastable shapes."""
    tx = 2.0 * _fma(qy, vz, -(qz * vy))
    ty = 2.0 * _fma(qz, vx, -(qx * vz))
    tz = 2.0 * _fma(qx, vy, -(qy * vx))
    return (_fma(qw, tx, vx) + _fma(qy, tz, -(qz * ty)),
            _fma(qw, ty, vy) + _fma(qz, tx, -(qx * tz)),
            _fma(qw, tz, vz) + _fma(qx, ty, -(qy * tx)))


def _sign(x):
    return torch.where(x > 0.0, 1.0, torch.where(x < 0.0, -1.0, 0.0))


def rect_parts(o, d, q, pos, mask=None):
    """(t, ol, dl) of the one-sided local-XY rect test (HitTests.cs:62-78)
    for rays o, d and rects of unit quaternion q and position pos (each a
    tuple of broadcastable tensors): the ray in the rect's frame (rotated
    by the conjugate quaternion) and the distance to its plane, -ol.z /
    dl.z.  The division takes dl.z where dl.z != 0 (and `mask`, if given)
    and 1 elsewhere.  The tape replay runs it with gradients."""
    qx, qy, qz, qw = q
    ol = _quat_rotate(-qx, -qy, -qz, qw, o[0] - pos[0], o[1] - pos[1],
                      o[2] - pos[2])
    dl = _quat_rotate(-qx, -qy, -qz, qw, *d)
    divide = dl[2] != 0.0 if mask is None else mask & (dl[2] != 0.0)
    t = -ol[2] / torch.where(divide, dl[2], 1.0)
    return t, ol, dl


def rect_test(o, d, geo, t_min):
    """t of rays o, d (3-tuples of rows) against pack_aux_tables' rect geo
    rows (columns: quat | pos | xy_from | xy_to), broadcast; BIG where the
    ray misses, faces away from the front (+Z) side or hits at or before
    t_min."""
    col = [geo[:, k:k + 1] for k in range(11)]
    t, ol, dl = rect_parts(o, d, col[0:4], col[4:7])
    hx = _fma(t, dl[0], ol[0])
    hy = _fma(t, dl[1], ol[1])
    ok = ((dl[2] < 0.0) & (t > t_min) & (hx >= col[7]) & (hx <= col[9])
          & (hy >= col[8]) & (hy <= col[10]))
    return torch.where(ok, t, BIG)


def box_parts(o, d, q, pos, ext, t_min, mask=None):
    """(t, hit) of the Majercik box test (HitTests.cs:81-113) for rays o, d
    and oriented boxes (unit quaternion q, position pos, half extents ext;
    each a tuple of broadcastable tensors): the ray in the box frame,
    offset by t_min along it, then the face planes' distances with the
    inside/outside winding; t is the first face whose hit lies within the
    other two extents, plus t_min.  A face distance divides by the
    direction where it is not 0 and `mask` (if given) holds, by 1e-30 where
    it is 0, and by 1 elsewhere.  The tape replay runs it with
    gradients."""
    qx, qy, qz, qw = q
    bo = _quat_rotate(-qx, -qy, -qz, qw, o[0] - pos[0], o[1] - pos[1],
                      o[2] - pos[2])
    bd = _quat_rotate(-qx, -qy, -qz, qw, *d)
    bo = tuple(_fma(bd[k], t_min, bo[k]) for k in range(3))
    rel = [torch.abs(bo[k]) / torch.clamp(ext[k], min=1e-30)
           for k in range(3)]
    inside = torch.maximum(rel[0], torch.maximum(rel[1], rel[2])) < 1.0
    winding = torch.where(inside, -1.0, 1.0)
    dp = [(ext[k] * winding * -_sign(bd[k]) - bo[k])
          / torch.where(bd[k] == 0.0, 1e-30,
                        bd[k] if mask is None
                        else torch.where(mask, bd[k], 1.0))
          for k in range(3)]

    def face(a):
        u, v = (a + 1) % 3, (a + 2) % 3
        return ((dp[a] >= 0.0)
                & (torch.abs(_fma(bd[u], dp[a], bo[u])) < ext[u])
                & (torch.abs(_fma(bd[v], dp[a], bo[v])) < ext[v]))

    test_x, test_y, test_z = face(0), face(1), face(2)
    t = torch.where(test_x, dp[0], torch.where(test_y, dp[1], dp[2])) + t_min
    return t, test_x | test_y | test_z


def box_exit(o, d, q, pos, ext, t_min, parallel_inf: bool = True):
    """The slab exit of rays o, d from oriented boxes (unit quaternion q,
    position pos, half extents ext): the JAX kernel's `b_far` (:637-660),
    the least far slab distance in the box frame (offset by t_min as in
    `box_parts`), BIG where the ray leaves the slabs at or before t_min or
    misses them.  An axis the ray runs parallel to (dl == 0) has the
    inverse inf (the kernel's), or without `parallel_inf` 1 / 1e-30 (the
    tape replay's, as the JAX replay's, so that its backward stays
    finite); either way the other axes decide."""
    qx, qy, qz, qw = q
    bo = _quat_rotate(-qx, -qy, -qz, qw, o[0] - pos[0], o[1] - pos[1],
                      o[2] - pos[2])
    bd = _quat_rotate(-qx, -qy, -qz, qw, *d)
    bo = tuple(_fma(bd[k], t_min, bo[k]) for k in range(3))
    near = far = None
    for k in reversed(range(3)):
        inv = 1.0 / torch.where(bd[k] == 0.0, 1e-30, bd[k])
        if parallel_inf:
            inv = torch.where(bd[k] == 0.0, float("inf"), inv)
        t0 = (-ext[k] - bo[k]) * inv
        t1 = (ext[k] - bo[k]) * inv
        lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        near = lo if near is None else torch.maximum(lo, near)
        far = hi if far is None else torch.minimum(hi, far)
    b_far = far + t_min
    ok = (b_far > t_min) & ((near + t_min) < b_far)
    return torch.where(ok, b_far, BIG)


def box_test(o, d, geo, t_min):
    """t of rays o, d against pack_aux_tables' box geo rows (quat | pos |
    extents), broadcast; BIG where the ray misses."""
    col = [geo[:, k:k + 1] for k in range(10)]
    t, hit = box_parts(o, d, col[0:4], col[4:7], col[7:10], t_min)
    return torch.where(hit, t, BIG)


def box_normal(p, q, pos, ext):
    """World normal of an oriented box at its surface point p (each a
    tuple of tensors): the local face of the dominant |p_local| / extent
    axis (extents floored at 1e-12; the first axis on a tie), sign(0) = 0,
    rotated back to the world (intersect._shading_attributes)."""
    qx, qy, qz, qw = q
    pl = _quat_rotate(-qx, -qy, -qz, qw, p[0] - pos[0], p[1] - pos[1],
                      p[2] - pos[2])
    re = [torch.abs(pl[k]) / torch.clamp(ext[k], min=1e-12)
          for k in range(3)]
    is_x = (re[0] >= re[1]) & (re[0] >= re[2])
    is_y = ~is_x & (re[1] >= re[2])
    is_z = ~is_x & ~is_y
    ln = [torch.where(sel, _sign(pl[k]), 0.0)
          for k, sel in enumerate((is_x, is_y, is_z))]
    return _quat_rotate(qx, qy, qz, qw, *ln)


def tri_normal(n0, n1, n2, u, v):
    """Barycentric lerp of the three vertex normals (each a 3-tuple),
    normalised after the lerp (Entity.cs:65): correctly rounded rsqrt of
    the squared length floored at 1e-24."""
    w0 = 1.0 - u - v
    tn = [_fma(n2[k], v, _fma(n0[k], w0, n1[k] * u)) for k in range(3)]
    inv = _rsqrt(torch.clamp(_dot3(*tn, *tn), min=1e-24))
    return tn[0] * inv, tn[1] * inv, tn[2] * inv


PI_F32 = torch.tensor(math.pi, dtype=torch.float32)


def sphere_uv(nx, ny, nz):
    """The Shirley Book-2 spherical uv of a sphere hit from its unit
    outward normal: u = (atan2(-z, x) + pi) / 2pi, v = acos(-y) / pi (the
    JAX kernel's :1157-1175 in its float32 order, with the correctly
    rounded atan2 and acos)."""
    su = (_atan2(-nz, nx) + PI_F32) * (0.5 / math.pi)
    sv = _acos(torch.clamp(-ny, -1.0, 1.0)) * (1.0 / math.pi)
    return su, sv


def _falloff(t):
    """Surflet falloff 1 - (3 - 2|t|) t^2, 0 from |t| = 1 on
    (PerlinNoise.cs:24-28), the last product fused into the difference as
    the JAX kernel's CPU compile fuses it."""
    t = torch.abs(t)
    return torch.where(t >= 1.0, 0.0, _fma(-((3.0 - 2.0 * t) * t), t, 1.0))


def perlin_rows(perlin, px, py, pz):
    """Surflet gradient noise at points (px, py, pz) (the JAX kernel's
    `_perlin_rows`, PerlinNoise.cs:36-52): per axis the permutation at the
    cell and the next, the corner hash their XOR, its gradient from the
    vector rows, summed over the 8 corners and clipped to [0, 1]."""
    perm, frac, fall = [], [], []
    for row, p in enumerate((px, py, pz)):
        cf = torch.floor(p)
        ci = cf.to(torch.int64)
        pv = [perlin[row][(c & 255)].to(torch.int64) for c in (ci, ci + 1)]
        f0 = p - cf
        f1 = f0 - 1.0
        perm.append(pv)
        frac.append((f0, f1))
        fall.append((_falloff(f0), _falloff(f1)))
    result = torch.zeros_like(px)
    for dk in (0, 1):
        for dj in (0, 1):
            for di in (0, 1):
                h = perm[0][di] ^ perm[1][dj] ^ perm[2][dk]
                dot = _dot3(frac[0][di], frac[1][dj], frac[2][dk],
                            perlin[3][h], perlin[4][h], perlin[5][h])
                result = _fma(fall[0][di] * fall[1][dj] * fall[2][dk], dot,
                              result)
    return torch.clamp(result, 0.0, 1.0)


def turbulence_rows(perlin, px, py, pz, depth: int = 7):
    """`depth`-octave fBm of perlin_rows (PerlinNoise.cs:54-68)."""
    acc = torch.zeros_like(px)
    weight = 1.0
    for _ in range(depth):
        acc = acc + weight * perlin_rows(perlin, px, py, pz)
        weight *= 0.5
        px, py, pz = px * 2.0, py * 2.0, pz * 2.0
    return torch.clamp(acc, 0.0, 1.0)


def bounce_textures(tex: TexTables, tx, alb, n, p, uv):
    """The winner's albedo after its material's texture (the JAX kernel's
    `_bounce_textures`, :2207-2295): the checker by the dominant normal
    axis's projection, the Perlin marble 0.5 (1 + sin(f z + 10
    turbulence(p))) main, the nearest atlas texel at `uv` times main;
    other types keep the packed albedo `alb`.  `tx` holds each lane's
    texture record (C, TEX_COLS), `tex` the Perlin rows, the atlas and its
    dims (its records are not read).  Differentiable with respect to the
    records' colours and the atlas (the texel index is a decision)."""
    ttype, freq = tx[:, 0], tx[:, 7]
    main = (tx[:, 1], tx[:, 2], tx[:, 3])
    nx, ny, nz = n
    ax, ay, az = torch.abs(nx), torch.abs(ny), torch.abs(nz)
    use_x = (ax > ay) & (ax > az)
    use_y = ~use_x & (ay > ax) & (ay > az)
    v0 = torch.where(use_x, nx, torch.where(use_y, ny, nz))
    v1 = torch.where(use_x, ny, torch.where(use_y, nz, nx))
    v2 = torch.where(use_x, nz, torch.where(use_y, nx, ny))
    safe0 = torch.where(v0 == 0.0, 1.0, v0)
    cu = _fma(0.5, v1 / safe0, 0.5)
    cv = _fma(0.5, v2 / safe0, 0.5)
    pif = PI_F32 * freq
    chk_main = _sin(pif * cu) * _sin(pif * cv) < 0.0
    is_chk = (ttype > 1.5) & (ttype < 2.5)
    out = [torch.where(is_chk & chk_main, main[c],
                       torch.where(is_chk & ~chk_main, tx[:, 4 + c], alb[c]))
           for c in range(3)]
    if tex.perlin is not None:
        is_per = (ttype > 2.5) & (ttype < 3.5)
        sel = torch.nonzero(is_per, as_tuple=True)[0]
        if sel.numel():
            turb = turbulence_rows(tex.perlin, p[0][sel], p[1][sel],
                                   p[2][sel])
            marble = 0.5 * (1.0 + _sin(_fma(freq[sel], p[2][sel],
                                            10.0 * turb)))
            for c in range(3):
                out[c] = out[c].index_put((sel,), marble * main[c][sel])
    if tex.atlas is not None:
        w, h = tex.dims
        is_img = (ttype > 3.5) & (ttype < 4.5)
        cx = torch.clamp((uv[0] * w).to(torch.int64), 0, w - 1)
        cy = torch.clamp((uv[1] * h).to(torch.int64), 0, h - 1)
        texel = tex.atlas[tx[:, 8].to(torch.int64) + cy, cx]
        out = [torch.where(is_img, texel[:, c] * main[c], out[c])
               for c in range(3)]
    return tuple(out)


STATE_KEYS = ("ox", "oy", "oz", "dx", "dy", "dz", "thx", "thy", "thz",
              "rx", "ry", "rz", "anx", "any", "anz", "aax", "aay", "aaz",
              "events", "active", "valid", "got")


VOL_KEYS = ("in_id", "in_den", "in_ar", "in_ag", "in_ab", "in_er", "in_eg",
            "in_eb")  # the medium state, camera_containment_row's order


def _bounce(p, u, sph, rec, depth, *, t_min, has_dielectrics, sky_on,
            sky, tri=None, aux=None, med=None, move=None, ptime=None,
            tex=None):
    """One bounce of every active path in `p` (a dict of (C,) rows keyed
    by STATE_KEYS, updated in place): the dense sphere sweep, then with
    `aux` (`_aux_arg`) the rect sweep and the box sweep (each wins only
    with a strictly smaller t, the first row on a tie), then with
    `tri` = (sweep, records (T_pad, 32), code base) the triangle sweep
    (`_tri_arg`: a triangle wins only with a strictly smaller t),
    with `med` (the medium, a dict of (C,) rows keyed by VOL_KEYS, updated
    in place) the convex volume walk, with `move` ((S, 3) move offsets)
    and `ptime` ((C,) shutter times) the spheres moved to each lane's
    time, with `tex` (TexTables) the winner's albedo textured,
    Lambert / GGX-metal / dielectric or
    the volume's isotropic scatter, the gradient sky, the fold, AOV
    capture, events and the advance.  `u` holds the bounce's six uniform
    rows (seven with `med`: the free path's draw), `depth` the path's
    bounce count ((C,) float or a number).  Returns (hit, winner code) for
    the winner tape: the sphere row, or the code base plus the rect, box
    or triangle row.  Shared by the batch kernel's and the per-ray
    megatrace's plain versions, as the CUDA kernels share
    csrc/megatrace_bounce.cuh."""
    ua, ub, uc, ud, u_choice, u_choice2 = u[:6]
    ox, oy, oz, dx, dy, dz = (p[k] for k in ("ox", "oy", "oz", "dx", "dy",
                                              "dz"))
    pactive, got = p["active"], p["got"]
    sky_b, sky_t = sky[0:3], sky[3:6]
    # sweep the active lanes only (idle lanes' results go unused)
    live = torch.nonzero(pactive, as_tuple=True)[0]
    best_t = torch.full_like(ox, BIG)
    best_idx = torch.zeros_like(ox, dtype=torch.int64)
    o_live = (ox[live], oy[live], oz[live])
    d_live = (dx[live], dy[live], dz[live])
    pt_live = None if move is None else ptime[live]
    best_t[live], best_idx[live] = _sweep(o_live, d_live, sph, t_min, move,
                                          pt_live)
    aux_wins = []  # (lanes won, row per lane, kind) of the rects and boxes
    if aux is not None:
        for kind, (geo, krec, base) in enumerate(aux):
            if geo is None:
                continue
            test = rect_test if kind == 0 else box_test
            k_t = torch.full_like(ox, BIG)
            k_idx = torch.zeros_like(ox, dtype=torch.int64)
            k_t[live], k_idx[live] = torch.min(
                test(o_live, d_live, geo, t_min), dim=0)
            wins = k_t < best_t
            best_t = torch.where(wins, k_t, best_t)
            aux_wins.append((wins, k_idx, kind))
    if tri is not None:
        sweep, trec, code_base = tri
        tri_t, tri_idx, tri_u, tri_v = _no_tri_hit(ox)
        tri_t[live], tri_idx[live], tri_u[live], tri_v[live] = sweep(
            o_live, d_live, best_t[live], t_min=t_min)
        tri_wins = tri_t < best_t
        best_t = torch.where(tri_wins, tri_t, best_t)
    hit = best_t < BIG
    scatter_mask = pactive & hit
    miss = pactive & ~hit

    w = rec[best_idx]  # (C, 16) winner records
    t_hit = torch.where(hit, best_t, 0.0)
    px = _fma(t_hit, dx, ox)
    py = _fma(t_hit, dy, oy)
    pz = _fma(t_hit, dz, oz)
    inv_r = w[:, 15]
    wc = (w[:, 12], w[:, 13], w[:, 14])
    wm = None
    if move is not None and sph.shape[0] > 0:
        # the winner's centre at the lane's time (the JAX kernel's
        # :1103-1106)
        wm = tuple(move[best_idx, k] for k in range(3))
        wc = tuple(moved_center(c, m, ptime) for c, m in zip(wc, wm))
    nx = (px - wc[0]) * inv_r
    ny = (py - wc[1]) * inv_r
    nz = (pz - wc[2]) * inv_r
    if med is not None:
        # the winner's exit distance for the volume walk: a sphere's far
        # root, a box's slab exit, BIG for a rect (no interior) and on a
        # miss (the JAX kernel's t_exit, :428-431, :570, :637-660)
        t_exit = torch.full_like(ox, BIG)
        if sph.shape[0] > 0:
            t_exit = torch.where(hit, sphere_exit(
                (ox, oy, oz), (dx, dy, dz),
                tuple(sph[best_idx, k] for k in range(4)), t_min, wm,
                ptime), BIG)
    for wins, k_idx, kind in aux_wins:
        geo, krec, base = aux[kind]
        # the boxes come second: a box winner overwrites a rect's
        kw = krec[k_idx]  # (C, 16) the kind's winner records
        w = torch.where(wins[:, None], kw, w)
        if kind == 0:  # a rect's normal is constant: the packed one
            knx, kny, knz = kw[:, 12], kw[:, 13], kw[:, 14]
            if med is not None:
                t_exit = torch.where(wins, BIG, t_exit)
        else:
            g = geo[k_idx]
            q, pos, ext = (tuple(g[:, k] for k in range(4)),
                           tuple(g[:, k] for k in range(4, 7)),
                           tuple(g[:, k] for k in range(7, 10)))
            knx, kny, knz = box_normal((px, py, pz), q, pos, ext)
            if med is not None:
                t_exit = torch.where(wins, box_exit(
                    (ox, oy, oz), (dx, dy, dz), q, pos, ext, t_min), t_exit)
        nx = torch.where(wins, knx, nx)
        ny = torch.where(wins, kny, ny)
        nz = torch.where(wins, knz, nz)
        best_idx = torch.where(wins, base + k_idx, best_idx)
    if tri is not None:
        tw = trec[tri_idx]  # (C, 32) triangle winner records
        w = torch.where(tri_wins[:, None], tw[:, :16], w)
        tnx, tny, tnz = tri_normal(
            (tw[:, 12], tw[:, 13], tw[:, 14]), (tw[:, 15], tw[:, 16],
                                                tw[:, 17]),
            (tw[:, 18], tw[:, 19], tw[:, 20]), tri_u, tri_v)
        nx = torch.where(tri_wins, tnx, nx)
        ny = torch.where(tri_wins, tny, ny)
        nz = torch.where(tri_wins, tnz, nz)
        best_idx = torch.where(tri_wins, code_base + tri_idx, best_idx)
    mtype = w[:, 0]
    alb_r, alb_g, alb_b = w[:, 1], w[:, 2], w[:, 3]
    if tex is not None:
        # spheres take the spherical uv, rects and boxes 0 (the JAX
        # kernel's :1157-1175)
        uv = (torch.zeros_like(ox), torch.zeros_like(ox))
        if tex.atlas is not None:
            sph_wins = hit
            for wins, _, _ in aux_wins:
                sph_wins = sph_wins & ~wins
            su, sv = sphere_uv(nx, ny, nz)
            uv = (torch.where(sph_wins, su, 0.0),
                  torch.where(sph_wins, sv, 0.0))
        alb_r, alb_g, alb_b = bounce_textures(
            tex, tex.rec[w[:, 11].long()], (alb_r, alb_g, alb_b),
            (nx, ny, nz), (px, py, pz), uv)
    em_r, em_g, em_b = w[:, 4], w[:, 5], w[:, 6]
    gloss, metallic, parameter = w[:, 7], w[:, 8], w[:, 9]
    perfect_f = w[:, 10]

    if med is not None:
        # Probabilistic volume walk (SampleBatchJob.cs:212-303): inside a
        # medium the segment up to the hit, at a volume's entry the segment
        # to its exit, ends in a Beer-Lambert scatter when the free path is
        # shorter; an entry without a scatter passes through the volume, an
        # exit from the own medium leaves it (both skip: advance, no
        # scatter)
        in_vol = med["in_id"] >= 0.0
        hit_is_vol = hit & (mtype > 1.5)  # PROBABILISTIC_VOLUME == 2
        entering = _dot3(dx, dy, dz, nx, ny, nz) < 0.0
        v = {k: torch.where(in_vol, med[k], own) for k, own in (
            ("in_id", w[:, 11]), ("in_den", parameter), ("in_ar", alb_r),
            ("in_ag", alb_g), ("in_ab", alb_b), ("in_er", em_r),
            ("in_eg", em_g), ("in_eb", em_b))}
        # free path d = -ln(u) / density (Material.cs:49-65)
        free_path = -_log(torch.clamp(u[6], min=1e-12)) / torch.clamp(
            v["in_den"], min=1e-12)
        seg_len = torch.where(in_vol, best_t, t_exit - best_t)
        vol_candidate = hit & (in_vol | (hit_is_vol & entering))
        vol_scatter = vol_candidate & (free_path < seg_len)
        vol_t = torch.where(in_vol, free_path, best_t + free_path)
        pass_through = hit & ~in_vol & hit_is_vol & entering & ~vol_scatter
        exits_own = (in_vol & hit & hit_is_vol & ~entering & ~vol_scatter
                     & (torch.abs(w[:, 11] - med["in_id"]) < 0.5))
        skip = pass_through | exits_own
        skip_t = torch.where(pass_through, t_exit, best_t)
        scatter_mask = scatter_mask & ~skip
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
        perfect_f = torch.where(vol_scatter, 0.0, perfect_f)

    # Standard scatter (Material.cs:75-119)
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
    incident_cos = -_dot3(dx, dy, dz, rnx, rny, rnz)
    std_ior = _fma(torch.full_like(metallic, METAL_IOR - PLASTIC_IOR),
                   metallic, PLASTIC_IOR)
    fresnel = _schlick(incident_cos, std_ior)
    masking = _smith_masking(_dot3(dx, dy, dz, nx, ny, nz), roughness)
    refl_chance = torch.clamp(fresnel * gloss * masking, 0.0, 1.0)
    spec_dot = _dot3(dx, dy, dz, rnx, rny, rnz)
    spx = _fma(-(2.0 * spec_dot), rnx, dx)
    spy = _fma(-(2.0 * spec_dot), rny, dy)
    spz = _fma(-(2.0 * spec_dot), rnz, dz)
    lmx, lmy, lmz = _cosine_hemisphere(uc, ud, nx, ny, nz)
    take_spec = (refl_chance > 0.0) & (u_choice < refl_chance)
    take_metal = (metallic > 0.0) & (u_choice2 < metallic)
    spec_like = take_spec | take_metal
    sdx = torch.where(spec_like, spx, lmx)
    sdy = torch.where(spec_like, spy, lmy)
    sdz = torch.where(spec_like, spz, lmz)
    srr = torch.where(take_spec, 1.0, alb_r)
    srg = torch.where(take_spec, 1.0, alb_g)
    srb = torch.where(take_spec, 1.0, alb_b)
    std_events = (
        torch.where((refl_chance > 0.0) & (refl_chance < 1.0), 1.0, 0.0)
        + torch.where((metallic > 0.0) & (metallic < 1.0), 1.0, 0.0)
        + roughness * (refl_chance + (1.0 - refl_chance) * metallic)
        + (1.0 - refl_chance) * (1.0 - metallic)
    )

    if has_dielectrics:
        # Dielectric (Material.cs:121-161)
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
        ior = parameter
        ni_over_nt = torch.where(exiting, ior, 1.0 / ior)
        cosine = torch.where(exiting, ior * ddot, -ddot)
        dt = _dot3(dx, dy, dz, onx, ony, onz)
        disc_r = _fma(-(ni_over_nt * ni_over_nt), _fma(-dt, dt, 1.0), 1.0)
        can_refract = disc_r > 0.0
        sq_r = _sqrt(torch.where(can_refract, disc_r, 0.0))
        rfx = _fma(ni_over_nt, _fma(-onx, dt, dx), -(onx * sq_r))
        rfy = _fma(ni_over_nt, _fma(-ony, dt, dy), -(ony * sq_r))
        rfz = _fma(ni_over_nt, _fma(-onz, dt, dz), -(onz * sq_r))
        refl_prob = _schlick(cosine, ior)
        do_refract = can_refract & (u_choice > refl_prob)
        dlx = torch.where(do_refract, rfx, _fma(-(2.0 * ddot), drx, dx))
        dly = torch.where(do_refract, rfy, _fma(-(2.0 * ddot), dry, dy))
        dlz = torch.where(do_refract, rfz, _fma(-(2.0 * ddot), drz, dz))
        is_diel = mtype > 0.5
        sdx = torch.where(is_diel, dlx, sdx)
        sdy = torch.where(is_diel, dly, sdy)
        sdz = torch.where(is_diel, dlz, sdz)
        srr = torch.where(is_diel, torch.where(do_refract, alb_r, 1.0), srr)
        srg = torch.where(is_diel, torch.where(do_refract, alb_g, 1.0), srg)
        srb = torch.where(is_diel, torch.where(do_refract, alb_b, 1.0), srb)
        std_events = torch.where(is_diel, 1.0 + d_roughness, std_events)
        perfect_f = torch.where(is_diel, 1.0, perfect_f)

    if med is not None:
        # isotropic in-medium scatter (Material.cs:163-168): the medium's
        # albedo, 2 random events
        vsx, vsy, vsz = _unit_sphere(uc, ud)
        sdx = torch.where(vol_scatter, vsx, sdx)
        sdy = torch.where(vol_scatter, vsy, sdy)
        sdz = torch.where(vol_scatter, vsz, sdz)
        srr = torch.where(vol_scatter, v["in_ar"], srr)
        srg = torch.where(vol_scatter, v["in_ag"], srg)
        srb = torch.where(vol_scatter, v["in_ab"], srb)
        std_events = torch.where(vol_scatter, 2.0, std_events)

    # Gradient sky (SampleBatchJob.cs:352-354)
    if sky_on:
        tsky = 0.5 * (dy + 1.0)
        skr = _fma(sky_t[0] - sky_b[0], tsky, sky_b[0])
        skg = _fma(sky_t[1] - sky_b[1], tsky, sky_b[1])
        skb = _fma(sky_t[2] - sky_b[2], tsky, sky_b[2])
    else:
        skr = skg = skb = torch.zeros_like(ox)

    # Fold
    emr = torch.where(scatter_mask, em_r, torch.where(miss, skr, 0.0))
    emg = torch.where(scatter_mask, em_g, torch.where(miss, skg, 0.0))
    emb = torch.where(scatter_mask, em_b, torch.where(miss, skb, 0.0))
    thx, thy, thz = p["thx"], p["thy"], p["thz"]
    p["rx"] = _fma(thx, emr, p["rx"])
    p["ry"] = _fma(thy, emg, p["ry"])
    p["rz"] = _fma(thz, emb, p["rz"])
    p["thx"] = torch.where(scatter_mask, thx * srr, thx)
    p["thy"] = torch.where(scatter_mask, thy * srg, thy)
    p["thz"] = torch.where(scatter_mask, thz * srb, thz)

    # AOV capture
    cap0 = scatter_mask & (depth == 0) & ~got
    first_nonspec = scatter_mask & ~got & (perfect_f < 0.5)
    capn = cap0 | first_nonspec
    sky_first = miss & ~got
    for k, sky_v, n_v in (("anx", -dx, nx), ("any", -dy, ny),
                          ("anz", -dz, nz)):
        p[k] = torch.where(sky_first, sky_v, torch.where(capn, n_v, p[k]))
    for k, sky_v, a_v in (("aax", skr, em_r + srr), ("aay", skg, em_g + srg),
                          ("aaz", skb, em_b + srb)):
        p[k] = torch.where(sky_first, sky_v,
                           torch.where(first_nonspec, a_v, p[k]))
    p["got"] = got | first_nonspec | sky_first

    # Events (adaptive-sampling noise weight)
    depth_weight = (torch.exp2(-depth) if isinstance(depth, torch.Tensor)
                    else 2.0 ** -depth)
    step_events = torch.where(scatter_mask, std_events, 0.0)
    if med is not None:
        # a probabilistic hit costs one event (SampleBatchJob.cs:332)
        step_events = step_events + torch.where(pactive & vol_candidate,
                                                1.0, 0.0)
    p["events"] = p["events"] + step_events * depth_weight

    # Advance
    off = SELF_EPS * torch.where(
        _dot3(sdx, sdy, sdz, nx, ny, nz) >= 0.0, 1.0, -1.0
    )
    p["ox"] = torch.where(scatter_mask, _fma(off, nx, px), ox)
    p["oy"] = torch.where(scatter_mask, _fma(off, ny, py), oy)
    p["oz"] = torch.where(scatter_mask, _fma(off, nz, pz), oz)
    p["dx"] = torch.where(scatter_mask, sdx, dx)
    p["dy"] = torch.where(scatter_mask, sdy, dy)
    p["dz"] = torch.where(scatter_mask, sdz, dz)
    if med is not None:
        # a skip advances past the boundary without scattering; the medium
        # is entered on a scatter, left on a skip and kept on a scatter off
        # a surface inside it
        adv = pactive & skip
        for k, o_k, d_k in (("ox", ox, dx), ("oy", oy, dy), ("oz", oz, dz)):
            p[k] = torch.where(adv, _fma(skip_t + SELF_EPS, d_k, o_k), p[k])
        take = pactive & vol_scatter
        for k in VOL_KEYS:
            med[k] = torch.where(take, v[k], med[k])
        med["in_id"] = torch.where(adv, -1.0, med["in_id"])
    p["active"] = pactive & ~miss
    p["valid"] = p["valid"] | miss
    return hit, best_idx


def _trace_chunk(lanes, pixel, per_pixel, count_in, cam, sky, sph, rec,
                 tri, aux, vol0, seed, *, samples, trace_depth, t_min,
                 has_dielectrics, sky_on, jitter, tape, move=None,
                 tex=None):
    """Run one SampleBatchJob over a chunk of lanes; returns the (18, C)
    accumulators and fills `tape` ((samples*trace_depth, C) or None).
    With `vol0` (camera_containment_row) each lane carries its medium,
    reset from vol0 at every regen; with `move` ((S, 3) move offsets) its
    shutter time, drawn at every regen from the camera draws' stream 7
    (the JAX kernel's :2745-2760)."""
    dev = pixel.device
    zero = torch.zeros_like(pixel)
    co, ll, hh, vv, rr, uu = (cam[3 * k:3 * k + 3] for k in range(6))
    lens_radius, width, height = cam[18], cam[19], cam[20]

    py_row = torch.floor(pixel / width)
    px_row = pixel - py_row * width

    p = {k: zero for k in STATE_KEYS}
    p.update(thx=zero + 1.0, thy=zero + 1.0, thz=zero + 1.0)
    for k in ("active", "valid", "got"):
        p[k] = torch.zeros_like(pixel, dtype=torch.bool)
    depth_ct = started = zero
    acc = torch.zeros((OUT_ROWS, pixel.shape[0]), dtype=torch.float32,
                      device=dev)
    med = None
    if vol0 is not None:
        med = {k: zero for k in VOL_KEYS}
        med["in_id"] = zero - 1.0
    ptime = None if move is None else zero

    for it in range(samples * trace_depth):
        started_all = started >= per_pixel
        if not bool(torch.any(p["active"] | ~started_all)):
            break  # every lane done: the rest of the tape stays idle (-2)

        # ---- regenerate: start the next sample on idle lanes ----------
        regen = ~p["active"] & ~started_all
        salt = it * SALT_STEP
        u = uniforms_hash(seed, salt, lanes, 4 if move is None else 8)
        jx, jy = (u[0], u[1]) if jitter else (0.5, 0.5)
        un = (px_row + jx) / width
        vn = (py_row + jy) / height
        theta = u[2] * TWO_PI
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

        for k, value in (("ox", co[0] + offx), ("oy", co[1] + offy),
                         ("oz", co[2] + offz), ("dx", cdx), ("dy", cdy),
                         ("dz", cdz), ("thx", 1.0), ("thy", 1.0),
                         ("thz", 1.0), ("rx", 0.0), ("ry", 0.0),
                         ("rz", 0.0), ("anx", 0.0), ("any", 0.0),
                         ("anz", 0.0), ("aax", 0.0), ("aay", 0.0),
                         ("aaz", 0.0), ("events", 0.0)):
            p[k] = torch.where(regen, value, p[k])
        p["got"] = p["got"] & ~regen
        depth_ct = torch.where(regen, 0.0, depth_ct)
        p["valid"] = p["valid"] & ~regen
        p["active"] = p["active"] | regen
        started = started + torch.where(regen, 1.0, 0.0)
        was_active = p["active"]
        if med is not None:  # the camera's medium
            for k, value in zip(VOL_KEYS, vol0):
                med[k] = torch.where(regen, value, med[k])
        if move is not None:  # the path's shutter time
            ptime = torch.where(regen, u[7], ptime)

        # ---- one bounce ------------------------------------------------
        u = uniforms_hash(seed, salt + SALT_BOUNCE, lanes,
                          6 if med is None else 7)
        hit, best_idx = _bounce(p, u, sph, rec, depth_ct, t_min=t_min,
                                has_dielectrics=has_dielectrics,
                                sky_on=sky_on, sky=sky, tri=tri, aux=aux,
                                med=med, move=move, ptime=ptime, tex=tex)

        if tape is not None:
            tape[it] = torch.where(
                was_active,
                torch.where(hit, best_idx.to(torch.float32), -1.0),
                -2.0,
            )

        # ---- per-lane bookkeeping -----------------------------------------
        fa = was_active.to(torch.float32)
        depth_ct = depth_ct + fa
        acc[11] += fa  # rays
        # depth exhaustion fails the sample (SampleBatchJob.cs:380-381)
        p["active"] = p["active"] & ~(depth_ct > trace_depth - 0.5)
        terminated = was_active & ~p["active"]
        ok = terminated & p["valid"]
        for row, k in ((0, "rx"), (1, "ry"), (2, "rz"), (4, "anx"),
                       (5, "any"), (6, "anz"), (7, "aax"), (8, "aay"),
                       (9, "aaz"), (10, "events")):
            acc[row] += torch.where(ok, p[k], 0.0)
        # fallback AOVs while the pixel has no valid sample yet
        # (SampleBatchJob.cs:146-151; captured valid or not)
        first_ever = terminated & ((count_in + acc[3]) < 0.5)
        for row, k in ((12, "anx"), (13, "any"), (14, "anz"), (15, "aax"),
                       (16, "aay"), (17, "aaz")):
            acc[row] = torch.where(first_ever, p[k], acc[row])
        acc[3] += ok.to(torch.float32)
    return acc


def _tri_arg(tri_tables, tri_stream_tables, s: int):
    """_bounce's `tri` argument from pack_tri_tables' pair or
    pack_tri_stream_tables' tables: the sweep, the records as rows, and
    the tape code of triangle row 0 (after the padded sphere rows, the JAX
    kernel's combined row space)."""
    if tri_stream_tables is not None:
        stream = TriStream(*(t.to(torch.float32) for t in tri_stream_tables))
        return (functools.partial(_tri_stream_sweep, stream=stream),
                stream.rec, sphere_pad_count(s))
    if tri_tables is None:
        return None
    geo, rec = (t.to(torch.float32) for t in tri_tables)
    return (functools.partial(_tri_sweep, geo=geo), rec.T.contiguous(),
            sphere_pad_count(s))


def aux_kernel_records(rect_tables, box_tables):
    """(rect rows (R_pad, 16), box rows (B_pad, 16)) of AUX_KERNEL_REC
    columns from pack_aux_tables' records, each None where the scene has
    none of that kind: material rows 0-10 | material id 11 | a rect's world
    normal 12-14 (boxes: zero)."""
    out = []
    for tables, id_row in ((rect_tables, 14), (box_tables, 21)):
        if tables is None:
            out.append(None)
            continue
        rec = tables[1].detach().to(torch.float32)
        rows = torch.zeros((rec.shape[1], AUX_KERNEL_REC),
                           dtype=torch.float32, device=rec.device)
        rows[:, :11] = rec[:11].T
        rows[:, 11] = rec[id_row]
        if id_row == 14:
            rows[:, 12:15] = rec[11:14].T
        out.append(rows)
    return tuple(out)


def aux_code_bases(s: int, rect_tables) -> tuple[int, int]:
    """The tape codes of rect row 0 and box row 0 in the JAX kernel's
    combined row space: spheres [0, s_pad), then the R_pad rects, then the
    boxes (s_pad is at least SPHERE_PAD, even without spheres)."""
    s_pad = sphere_pad_count(s)
    r_pad = 0 if rect_tables is None else rect_tables[0].shape[0]
    return s_pad, s_pad + r_pad


def _aux_arg(rect_tables, box_tables, s: int):
    """_bounce's `aux` argument: ((rect geo, records, code base), (box geo,
    records, code base)), a kind without tables (None, None, base); None
    without rects and boxes."""
    if rect_tables is None and box_tables is None:
        return None
    rrows, brows = aux_kernel_records(rect_tables, box_tables)
    bases = aux_code_bases(s, rect_tables)
    geos = [None if t is None else t[0].detach().to(torch.float32)
            for t in (rect_tables, box_tables)]
    return tuple(zip(geos, (rrows, brows), bases))


OUTPUT_KEYS = ("color", "count", "normal", "albedo", "weight", "rays",
               "fallback_normal", "fallback_albedo")


def _outputs(acc: torch.Tensor, tape: torch.Tensor | None) -> dict:
    result = {
        "color": acc[0:3].T,
        "count": acc[3],
        "normal": acc[4:7].T,
        "albedo": acc[7:10].T,
        "weight": acc[10],
        "rays": acc[11].to(torch.int32),
        "fallback_normal": acc[12:15].T,
        "fallback_albedo": acc[15:18].T,
    }
    if tape is not None:
        result["tape"] = tape
    return result


def sample_batch_reference(
    lane_count: torch.Tensor,  # (N,) samples to take per lane
    count_in: torch.Tensor,  # (N,) valid samples accumulated before
    camera_row: torch.Tensor,  # (24,) pack_camera_row
    centers: torch.Tensor,  # (S, 3)
    radii: torch.Tensor,  # (S,)
    records: torch.Tensor,  # (S, 11 or 12) pack_sphere_records
    sky_bottom: torch.Tensor,  # (3,)
    sky_top: torch.Tensor,  # (3,)
    seed,  # int32 batch seed
    lane_base: int = 0,  # global id of lane 0 (RNG keying)
    *,
    samples: int,
    trace_depth: int,
    t_min: float = 0.0,
    has_dielectrics: bool = True,
    sky_on: bool = True,
    jitter: bool = True,
    want_tape: bool = False,
    tri_tables: tuple | None = None,
    pixel_index: torch.Tensor | None = None,
    tri_stream_tables: TriStream | None = None,
    rect_tables: tuple | None = None,
    box_tables: tuple | None = None,
    vol0: torch.Tensor | None = None,
    move_offsets: torch.Tensor | None = None,
    tex_tables: TexTables | None = None,
    chunk_lanes: int | None = None,
) -> dict:
    """Plain PyTorch version of the batch kernel (any device).

    `tri_tables` is pack_tri_tables' (geo, rec) pair, `tri_stream_tables`
    pack_tri_stream_tables' tables, or neither; `rect_tables` and
    `box_tables` are pack_aux_tables' pairs (their tape codes follow the
    padded spheres: `aux_code_bases`); `vol0` (camera_containment_row)
    turns on the convex volume walk, `move_offsets` (S, 3) unit-shutter
    sphere motion (each path's time drawn at its regen), `tex_tables`
    (pack_texture_tables) albedo textures.  `pixel_index`
    (N,) is the
    pixel each lane renders (default: lane i renders pixel i); the hash
    PRNG stays keyed by the lane.  Returns per-lane deltas, in lane order: color (N, 3), count (N,), normal (N, 3), albedo
    (N, 3), weight (N,), rays (N,) int32, fallback_normal (N, 3),
    fallback_albedo (N, 3), and with `want_tape` the (samples *
    trace_depth, N) winner tape: -2 idle, -1 sky, else the sphere row, or
    sphere_pad_count(S) plus the triangle row (the JAX kernel's combined
    row space)."""
    dev = centers.device
    n = lane_count.shape[0]
    s = centers.shape[0]
    move = (None if move_offsets is None
            else move_offsets.detach().to(torch.float32))
    sph, rec = sweep_tables(centers, radii, records, move)
    if s == 0:  # a sphere-free scene: one record row for the missed lanes
        rec = torch.zeros((1, KERNEL_REC), dtype=torch.float32, device=dev)
    tri = _tri_arg(tri_tables, tri_stream_tables, s)
    aux = _aux_arg(rect_tables, box_tables, s)
    cam = camera_row.to(torch.float32)
    sky = _pack_sky_row(sky_bottom, sky_top)[0]
    lanes_all = (
        torch.arange(n, dtype=torch.float32, device=dev)
        + torch.tensor(float(lane_base), dtype=torch.float32)
    ).to(torch.int64)
    pixel_all = (torch.arange(n, dtype=torch.float32, device=dev)
                 if pixel_index is None else pixel_index.to(torch.float32))
    per_pixel_all = lane_count.to(torch.float32)
    count_in_all = count_in.to(torch.float32)
    iters = samples * trace_depth
    tape = (torch.full((iters, n), -2.0, dtype=torch.float32, device=dev)
            if want_tape else None)
    if chunk_lanes is None:
        budget = (1 << 25) if dev.type == "cuda" else (1 << 22)
        width = max(s, 1 if tri is None else TRI_BLOCK)
        for t in (rect_tables, box_tables):
            width = max(width, 0 if t is None else t[0].shape[0])
        chunk_lanes = max(1024, budget // width)
    acc = torch.empty((OUT_ROWS, n), dtype=torch.float32, device=dev)
    for c0 in range(0, n, chunk_lanes):
        c1 = min(n, c0 + chunk_lanes)
        acc[:, c0:c1] = _trace_chunk(
            lanes_all[c0:c1], pixel_all[c0:c1], per_pixel_all[c0:c1],
            count_in_all[c0:c1], cam, sky, sph, rec, tri, aux,
            None if vol0 is None else vol0.detach().to(torch.float32),
            int(seed),
            samples=samples, trace_depth=trace_depth, t_min=t_min,
            has_dielectrics=has_dielectrics, sky_on=sky_on, jitter=jitter,
            tape=None if tape is None else tape[:, c0:c1], move=move,
            tex=None if tex_tables is None else TexTables(
                *(None if t is None else t.detach().to(torch.float32)
                  for t in tex_tables[:3]), tuple(tex_tables[3])),
        )
    return _outputs(acc, tape)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

_KERNEL = None  # the loaded library, built at first use
BUILD_LOG = ""  # nvcc's output of the build this process made, if any


def load_kernel() -> ctypes.CDLL:
    """Build (at first use) and load csrc/megatrace_batch.cu."""
    global _KERNEL, BUILD_LOG
    if _KERNEL is None:
        from raytracing_in_one_weekend_tpu_torch.ops import cuda_build

        lib, BUILD_LOG = cuda_build.build_library("megatrace_batch.cu")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rtiw_megatrace_batch.argtypes = [
            p, p, p, p, p, p,  # lane_count count_in pixel consts sph rec
            p, p, p, p, p, p,  # tri_geo tri_aabb tri_sup tri_rec out tape
            i, i, i, i, i, i,  # n s tri_rows tri_blocks tri_supers code_base
            i, i, i, i,  # seed lane_base samples trace_depth
            ctypes.c_float, i, i, i,  # t_min has_diel sky_on jitter
            p,  # stream
        ]
        lib.rtiw_megatrace_batch.restype = ctypes.c_int
        lib.rtiw_megatrace_ext.argtypes = [
            p, p, p, p, p,  # lane_count count_in consts sph rec
            p, p, p, p,  # aux_geo aux_rec out tape
            i, i, i, i, i, i,  # n s rect_rows box_rows rect_code box_code
            i, i, i, i,  # seed lane_base samples trace_depth
            ctypes.c_float, i, i, i,  # t_min has_diel sky_on jitter
            i, p, p, p, p,  # has_vol move tex_rec perlin atlas
            i, i, p,  # img_w img_h stream
        ]
        lib.rtiw_megatrace_ext.restype = ctypes.c_int
        lib.rtiw_megatrace_ext_info.argtypes = [i, i, i, i, i, p]
        lib.rtiw_megatrace_ext_info.restype = ctypes.c_int
        lib.rtiw_tile_lanes.argtypes = [i, i, p, p]
        lib.rtiw_tile_lanes.restype = ctypes.c_int
        _KERNEL = lib
    return _KERNEL


def sphere_kernel_info(s: int, aux_rows: int = 0, has_vol: bool = False,
                       has_motion: bool = False,
                       has_tex: bool = False) -> dict:
    """The sphere kernel's occupancy with an s-sphere table on the
    current card: blocks an SM (the occupancy API), registers a thread and
    local memory (stack and spills) a thread in bytes; of its build for
    aux_rows rect and box rows (0: none) and the flags (all unset: the
    sphere build)."""
    info = (ctypes.c_int * 3)()
    err = load_kernel().rtiw_megatrace_ext_info(
        int(s), int(aux_rows), int(has_vol), int(has_motion), int(has_tex),
        info)
    if err != 0:
        raise RuntimeError(f"megatrace_sphere_kernel info: cudaError {err}")
    return dict(blocks=info[0], registers=info[1], local_bytes=info[2])


def kernel_tex_tables(tex_tables: TexTables, dev):
    """The texture builds' tables after checking them: the records (M,
    TEX_COLS), the Perlin rows (PERLIN_ROWS, 256) or None and the atlas
    ((A * H), W, 3) or None, float32 and contiguous on `dev`, and (W,
    H)."""
    rec, perlin, atlas, dims = tex_tables
    want = dict(rec=(rec.shape[0], TEX_COLS), perlin=(PERLIN_ROWS, 256))
    if atlas is not None:
        want["atlas"] = (atlas.shape[0], dims[0], 3)
        if atlas.shape[0] % max(dims[1], 1):
            raise ValueError(f"sample_batch: the atlas has {atlas.shape[0]} "
                             f"rows, not a multiple of the image height "
                             f"{dims[1]}")
    out = []
    for name, t in (("rec", rec), ("perlin", perlin), ("atlas", atlas)):
        if t is None:
            out.append(None)
            continue
        if tuple(t.shape) != want[name] or t.device != dev:
            raise ValueError(f"sample_batch: tex_tables.{name} has shape "
                             f"{tuple(t.shape)} on {t.device}; want "
                             f"pack_texture_tables' {want[name]} on {dev}")
        out.append(t.detach().to(torch.float32).contiguous())
    return (*out, tuple(int(d) for d in dims))


def kernel_consts(camera_row, sky_bottom, sky_top, vol0=None):
    """The batch kernel's constant row: camera row 0-23 | sky bottom 24-26
    | sky top 27-29 | pad, and with `vol0` the camera's medium in 32-39
    (the volume builds)."""
    consts = torch.zeros(32 if vol0 is None else 32 + VOL_ROWS,
                         dtype=torch.float32, device=camera_row.device)
    consts[:24] = camera_row
    consts[24:27] = sky_bottom
    consts[27:30] = sky_top
    if vol0 is not None:
        consts[32:] = vol0
    return consts


def kernel_aux_tables(rect_tables, box_tables):
    """The aux build's tables from pack_aux_tables' pairs: the geometry
    rows (R_pad + B_pad, 16), rects first, the records (R_pad + B_pad,
    16) (`aux_kernel_records`), and R_pad, B_pad."""
    geos = [t[0].detach().to(torch.float32) for t in (rect_tables, box_tables)
            if t is not None]
    recs = [r for r in aux_kernel_records(rect_tables, box_tables)
            if r is not None]
    rows = [0 if t is None else t[0].shape[0]
            for t in (rect_tables, box_tables)]
    return (torch.cat(geos).contiguous(), torch.cat(recs).contiguous(),
            *rows)


def kernel_tile_lanes(n: int, width: int, device) -> torch.Tensor:
    """(n,) int64: the lane of each thread as the sphere kernel's threads
    compute it (csrc/megatrace_batch.cu::tile_lane), read back from the
    card; `tile_lane_order` is its plain twin."""
    lanes = torch.empty(n, dtype=torch.int32, device=device)
    err = load_kernel().rtiw_tile_lanes(
        int(n), int(width), lanes.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tile_lane_kernel launch failed: cudaError {err}")
    return lanes.to(torch.int64)


def kernel_tri_tables(tri_tables):
    """The batch kernel's triangle tables from pack_tri_tables' pair:
    geometry rows (T_pad, 12) = edge_a | edge_b | vert0 | 0, the block
    AABBs (blocks, 8) = lo | 0 | hi | 0, the records (T_pad, 32)."""
    geo, rec = (t.detach().to(torch.float32) for t in tri_tables)
    rows = geo.shape[0]
    tri_geo = torch.zeros((rows, 12), dtype=torch.float32, device=geo.device)
    tri_geo[:, :9] = geo[:, :9]
    firsts = geo[::TRI_BLOCK]
    aabb = torch.zeros((firsts.shape[0], 8), dtype=torch.float32,
                       device=geo.device)
    aabb[:, 0:3] = firsts[:, 9:12]
    aabb[:, 4:7] = firsts[:, 12:15]
    return tri_geo, aabb, rec.T.contiguous()


def _kernel_stream_args(stream_tables, dev, s, name="sample_batch"):
    """The streamed kernels' table pointers and dimensions, after checking
    pack_tri_stream_tables' shapes, the count of supers and the 16-byte
    alignment of the rows (the kernels copy them with TMA)."""
    geo, rec, aabb, sup = stream_tables
    rows, n_sup = geo.shape[0], sup.shape[0]
    n_blk = n_sup * TRI_SUP
    want = dict(geo=(rows, 12), rec=(rows, TRI_REC_ROWS), aabb=(n_blk, 8),
                sup=(n_sup, 8))
    for field, t in zip(TriStream._fields, stream_tables):
        if (tuple(t.shape) != want[field] or t.device != dev
                or t.dtype != torch.float32 or not t.is_contiguous()):
            raise ValueError(
                f"{name}: tri_stream_tables.{field} has shape "
                f"{tuple(t.shape)} ({t.dtype}, {t.device}); want "
                f"pack_tri_stream_tables' {want[field]} float32 on {dev}")
    if rows != n_blk * TRI_BLOCK:
        raise ValueError(f"{name}: tri_stream_tables hold {rows} rows "
                         f"for {n_sup} supers")
    if n_sup > MAX_SUPERS:
        raise ValueError(f"{name}: {n_sup} supers; the kernels order at "
                         f"most {MAX_SUPERS}")
    if geo.data_ptr() % 16:
        raise ValueError(f"{name}: the triangle rows are not 16-byte "
                         "aligned (the kernels copy them with TMA)")
    return ((geo.data_ptr(), aabb.data_ptr(), sup.data_ptr(),
             rec.data_ptr()), (rows, n_blk, n_sup, sphere_pad_count(s)))


def _check_aux_tables(rect_tables, box_tables, dev) -> None:
    for name, tables in (("rect_tables", rect_tables),
                         ("box_tables", box_tables)):
        if tables is None:
            continue
        geo, rec = tables
        rows = geo.shape[0]
        if (geo.device != dev or rec.device != dev
                or tuple(geo.shape) != (rows, 16)
                or tuple(rec.shape) != (AUX_REC_ROWS, rows)
                or rows % AUX_PAD or geo.dtype != torch.float32
                or rec.dtype != torch.float32):
            raise ValueError(
                f"sample_batch: {name} have shapes {tuple(geo.shape)}, "
                f"{tuple(rec.shape)} ({geo.dtype}) on {geo.device}; want "
                f"pack_aux_tables' float32 (K_pad, 16), ({AUX_REC_ROWS}, "
                f"K_pad) on {dev}")
    rows = sum(t[0].shape[0] for t in (rect_tables, box_tables)
               if t is not None)
    if rows > AUX_MAX + 2 * AUX_PAD:
        raise ValueError(f"sample_batch: {rows} rect and box rows; the "
                         f"kernel stages at most {AUX_MAX} (padded) in "
                         "shared memory")


def _sample_batch_cuda(lane_count, count_in, camera_row, centers, radii,
                       records, sky_bottom, sky_top, seed, lane_base, *,
                       samples, trace_depth, t_min, has_dielectrics, sky_on,
                       jitter, want_tape, tri_tables, pixel_index=None,
                       tri_stream_tables=None, rect_tables=None,
                       box_tables=None, vol0=None, move_offsets=None,
                       tex_tables=None):
    global LAUNCHES, AUX_LAUNCHES, VOL_LAUNCHES, MOTION_LAUNCHES
    global TEX_LAUNCHES
    dev = centers.device
    tensors = dict(lane_count=lane_count, count_in=count_in,
                   camera_row=camera_row, centers=centers, radii=radii,
                   records=records, sky_bottom=sky_bottom, sky_top=sky_top)
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"sample_batch: {name} is on {t.device}, "
                             f"centers on {dev}")
    n, s = lane_count.shape[0], centers.shape[0]
    shapes = dict(count_in=(n,), camera_row=(24,), centers=(s, 3),
                  radii=(s,), sky_bottom=(3,), sky_top=(3,))
    for name, shape in shapes.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"sample_batch: {name} has shape "
                             f"{tuple(tensors[name].shape)}, want {shape}")
    if records.dim() != 2 or records.shape[0] != s or records.shape[1] < 11:
        raise ValueError(f"sample_batch: records has shape "
                         f"{tuple(records.shape)}, want ({s}, 11 or 12)")
    if s > SPH_CULL_MIN:
        raise ValueError(f"sample_batch: {s} spheres; the kernel stages at "
                         f"most {SPH_CULL_MIN} in shared memory")
    for name in ("centers", "radii", "records", "sky_bottom", "sky_top",
                 "camera_row"):
        if tensors[name].dtype != torch.float32:
            raise ValueError(f"sample_batch: {name} must be float32")

    if tri_tables is not None:
        geo, trec = tri_tables
        rows = geo.shape[0]
        if (geo.device != dev or trec.device != dev
                or tuple(geo.shape) != (rows, 16)
                or tuple(trec.shape) != (TRI_REC_ROWS, rows)
                or rows % TRI_PAD or rows > TRI_MAX):
            raise ValueError(
                f"sample_batch: tri_tables have shapes {tuple(geo.shape)}, "
                f"{tuple(trec.shape)} on {geo.device}; want pack_tri_tables' "
                f"(T_pad, 16), ({TRI_REC_ROWS}, T_pad), T_pad <= {TRI_MAX}, "
                f"on {dev}")
        tri_geo, tri_aabb, tri_rec = kernel_tri_tables(tri_tables)
        tri_args = (tri_geo.data_ptr(), tri_aabb.data_ptr(), 0,
                    tri_rec.data_ptr())
        tri_dims = (rows, tri_aabb.shape[0], 0, sphere_pad_count(s))
    elif tri_stream_tables is not None:
        tri_args, tri_dims = _kernel_stream_args(tri_stream_tables, dev, s)
    else:
        tri_args, tri_dims = (0, 0, 0, 0), (0, 0, 0, 0)
    pixel = None
    if pixel_index is not None:
        if tri_stream_tables is None:
            raise ValueError("sample_batch: the kernel takes pixel_index "
                             "with tri_stream_tables only")
        if tuple(pixel_index.shape) != (n,) or pixel_index.device != dev:
            raise ValueError(f"sample_batch: pixel_index has shape "
                             f"{tuple(pixel_index.shape)} on "
                             f"{pixel_index.device}; want ({n},) on {dev}")
        pixel = pixel_index.to(torch.float32).contiguous()

    if vol0 is not None and (tuple(vol0.shape) != (VOL_ROWS,)
                             or vol0.device != dev
                             or vol0.dtype != torch.float32):
        raise ValueError(f"sample_batch: vol0 has shape {tuple(vol0.shape)} "
                         f"({vol0.dtype}) on {vol0.device}; want "
                         f"camera_containment_row's ({VOL_ROWS},) float32 "
                         f"on {dev}")

    if move_offsets is not None and (
            tuple(move_offsets.shape) != (s, 3) or move_offsets.device != dev
            or move_offsets.dtype != torch.float32):
        raise ValueError(f"sample_batch: move_offsets has shape "
                         f"{tuple(move_offsets.shape)} "
                         f"({move_offsets.dtype}) on {move_offsets.device}; "
                         f"want ({s}, 3) float32 on {dev}")

    lib = load_kernel()
    sph, rec = sweep_tables(
        centers, radii, records,
        None if move_offsets is None else move_offsets.detach())
    consts = kernel_consts(camera_row, sky_bottom, sky_top,
                           None if vol0 is None else vol0.detach())
    per_pixel = lane_count.to(torch.float32).contiguous()
    cin = count_in.to(torch.float32).contiguous()
    out = torch.empty((OUT_ROWS, n), dtype=torch.float32, device=dev)
    tape = (torch.empty((samples * trace_depth, n), dtype=torch.float32,
                        device=dev) if want_tape else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    has_aux = rect_tables is not None or box_tables is not None
    if (has_aux or vol0 is not None or move_offsets is not None
            or tex_tables is not None):
        aux_geo = aux_rec = None
        rect_rows = box_rows = 0
        if has_aux:
            _check_aux_tables(rect_tables, box_tables, dev)
            aux_geo, aux_rec, rect_rows, box_rows = kernel_aux_tables(
                rect_tables, box_tables)
        rect_code, box_code = aux_code_bases(s, rect_tables)
        args = (per_pixel.data_ptr(), cin.data_ptr(), consts.data_ptr(),
                sph.data_ptr(), rec.data_ptr(),
                0 if aux_geo is None else aux_geo.data_ptr(),
                0 if aux_rec is None else aux_rec.data_ptr(), out.data_ptr(),
                0 if tape is None else tape.data_ptr(), n, s, rect_rows,
                box_rows, rect_code, box_code, int(seed), int(lane_base),
                samples, trace_depth, float(t_min), int(has_dielectrics),
                int(sky_on), int(jitter))
        move = None if move_offsets is None else move_table(move_offsets)
        trec, perlin, atlas, (img_w, img_h) = (
            (None, None, None, (0, 0)) if tex_tables is None
            else kernel_tex_tables(tex_tables, dev))
        build = ("texture" if tex_tables is not None
                 else "motion" if move_offsets is not None
                 else "aux" if vol0 is None else "volume")
        err = lib.rtiw_megatrace_ext(
            *args, int(vol0 is not None),
            *(0 if t is None else t.data_ptr()
              for t in (move, trec, perlin, atlas)), img_w, img_h, stream)
        if err != 0:
            raise RuntimeError(f"megatrace_batch {build} build launch "
                               f"failed: cudaError {err}")
        LAUNCHES += 1
        if tex_tables is not None:
            TEX_LAUNCHES += 1
        elif move_offsets is not None:
            MOTION_LAUNCHES += 1
        elif vol0 is None:
            AUX_LAUNCHES += 1
        else:
            VOL_LAUNCHES += 1
        return _outputs(out, tape)
    err = lib.rtiw_megatrace_batch(
        per_pixel.data_ptr(), cin.data_ptr(),
        0 if pixel is None else pixel.data_ptr(), consts.data_ptr(),
        sph.data_ptr(), rec.data_ptr(), *tri_args, out.data_ptr(),
        0 if tape is None else tape.data_ptr(),
        n, s, *tri_dims, int(seed), int(lane_base), samples, trace_depth,
        float(t_min), int(has_dielectrics), int(sky_on), int(jitter),
        stream,
    )
    if err != 0:
        raise RuntimeError(f"megatrace_batch launch failed: cudaError {err}")
    LAUNCHES += 1
    return _outputs(out, tape)


def sample_batch(
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
    want_tape: bool = False,
    tri_tables: tuple | None = None,
    pixel_index: torch.Tensor | None = None,
    tri_stream_tables: TriStream | None = None,
    rect_tables: tuple | None = None,
    box_tables: tuple | None = None,
    vol0: torch.Tensor | None = None,
    move_offsets: torch.Tensor | None = None,
    tex_tables: TexTables | None = None,
) -> dict:
    """Fused SampleBatchJob: per-lane accumulation deltas for one batch
    (see `sample_batch_reference` for the outputs; `tri_tables` is
    pack_tri_tables' pair for a mesh scene of at most TRI_MAX triangles,
    `tri_stream_tables` pack_tri_stream_tables' tables for a bigger one,
    `pixel_index` the pixel of each lane, `rect_tables` and `box_tables`
    pack_aux_tables' pairs, `vol0` camera_containment_row for a scene
    with convex volumes: the volume builds, VOL_LAUNCHES; `move_offsets`
    (S, 3) the spheres' unit-shutter motion: the motion builds,
    MOTION_LAUNCHES; `tex_tables` pack_texture_tables' albedo textures:
    the texture builds, TEX_LAUNCHES).

    The device of `centers` decides: CUDA tensors launch the kernel
    (csrc/megatrace_batch.cu) or raise; CPU tensors run the plain
    version.  No tape with streamed tables (JAX asserts so too): the tape
    replay covers meshes of at most TRI_MAX triangles."""
    if want_tape and tri_stream_tables is not None:
        raise ValueError("sample_batch: no winner tape with streamed "
                         "triangle tables (not replay-eligible)")
    if tri_tables is not None and tri_stream_tables is not None:
        raise ValueError("sample_batch: tri_tables and tri_stream_tables "
                         "clash")
    if ((rect_tables is not None or box_tables is not None)
            and (tri_tables is not None or tri_stream_tables is not None)):
        raise NotImplementedError(f"sample_batch: {RECTS_IN_MESHES}")
    if vol0 is not None and (tri_tables is not None
                             or tri_stream_tables is not None):
        raise NotImplementedError(f"sample_batch: {VOLUMES_IN_MESHES}")
    if move_offsets is not None and (tri_tables is not None
                                     or tri_stream_tables is not None):
        raise NotImplementedError(f"sample_batch: {MOTION_IN_MESHES}")
    if tex_tables is not None and (tri_tables is not None
                                   or tri_stream_tables is not None):
        raise NotImplementedError(f"sample_batch: {TEXTURES_IN_MESHES}")
    kwargs = dict(samples=samples, trace_depth=trace_depth, t_min=t_min,
                  has_dielectrics=has_dielectrics, sky_on=sky_on,
                  jitter=jitter, want_tape=want_tape, tri_tables=tri_tables,
                  pixel_index=pixel_index,
                  tri_stream_tables=tri_stream_tables,
                  rect_tables=rect_tables, box_tables=box_tables, vol0=vol0,
                  move_offsets=move_offsets, tex_tables=tex_tables)
    args = (lane_count, count_in, camera_row, centers, radii, records,
            sky_bottom, sky_top, seed, lane_base)
    if centers.device.type == "cuda":
        return _sample_batch_cuda(*args, **kwargs)
    if centers.device.type == "cpu":
        return sample_batch_reference(*args, **kwargs)
    raise ValueError(f"sample_batch: unsupported device {centers.device}")


# ---------------------------------------------------------------------------
# Per-ray fused trace (the wavefront's `mega` arm)
# ---------------------------------------------------------------------------

WAVE_KEYS = ("radiance", "valid", "aov_normal", "aov_albedo", "events",
             "pixel_rays")


def _wave_outputs(out: torch.Tensor) -> dict:
    return {
        "radiance": out[0:3].T,
        "valid": out[3] > 0.5,
        "aov_normal": out[4:7].T,
        "aov_albedo": out[7:10].T,
        "events": out[10],
        "pixel_rays": out[11].to(torch.int32),
    }


def megatrace_reference(
    origin: torch.Tensor,  # (N, 3)
    direction: torch.Tensor,  # (N, 3)
    active: torch.Tensor,  # (N,) bool
    centers: torch.Tensor,  # (S, 3)
    radii: torch.Tensor,  # (S,)
    records: torch.Tensor,  # (S, 11) packed material rows
    sky_bottom: torch.Tensor,  # (3,)
    sky_top: torch.Tensor,  # (3,)
    seed,  # int32
    *,
    trace_depth: int,
    t_min: float = 0.0,
    has_dielectrics: bool = True,
    sky_on: bool = True,
    chunk_lanes: int | None = None,
) -> dict:
    """Plain PyTorch version of `megatrace` (any device).

    Every active ray bounces until it leaves to the sky or `trace_depth`
    bounces are spent (then it stays invalid).  Bounce `depth` draws its
    uniforms from the hash of (seed, lane, stream, depth * SALT_DEPTH),
    the lane being the ray's index.  Returns radiance (N, 3), zero where
    invalid; valid (N,) bool; aov_normal, aov_albedo (N, 3); events (N,);
    pixel_rays (N,) int32, the bounces each ray took."""
    dev = centers.device
    n, s = origin.shape[0], centers.shape[0]
    sph, rec = sweep_tables(centers, radii, records)
    sky = _pack_sky_row(sky_bottom, sky_top)[0]
    lanes_all = torch.arange(n, dtype=torch.float32, device=dev).to(
        torch.int64)
    if chunk_lanes is None:
        budget = (1 << 25) if dev.type == "cuda" else (1 << 22)
        chunk_lanes = max(1024, budget // max(s, 1))
    out = torch.empty((WAVE_ROWS, n), dtype=torch.float32, device=dev)
    for c0 in range(0, n, chunk_lanes):
        c1 = min(n, c0 + chunk_lanes)
        o, d = origin[c0:c1].to(torch.float32), direction[c0:c1].to(
            torch.float32)
        zero = torch.zeros(c1 - c0, dtype=torch.float32, device=dev)
        p = {k: zero for k in STATE_KEYS}
        p.update(ox=o[:, 0], oy=o[:, 1], oz=o[:, 2], dx=d[:, 0],
                 dy=d[:, 1], dz=d[:, 2], thx=zero + 1.0, thy=zero + 1.0,
                 thz=zero + 1.0, active=active[c0:c1].to(torch.bool),
                 valid=torch.zeros_like(zero, dtype=torch.bool),
                 got=torch.zeros_like(zero, dtype=torch.bool))
        rays = zero
        for depth in range(trace_depth):
            if not bool(torch.any(p["active"])):
                break  # every lane has terminated
            was_active = p["active"]
            u = uniforms_hash(int(seed), depth * SALT_DEPTH,
                              lanes_all[c0:c1], 6)
            _bounce(p, u, sph, rec, depth, t_min=t_min,
                    has_dielectrics=has_dielectrics, sky_on=sky_on, sky=sky)
            rays = rays + was_active.to(torch.float32)
        valid = p["valid"]
        rows = (torch.where(valid, p["rx"], 0.0),
                torch.where(valid, p["ry"], 0.0),
                torch.where(valid, p["rz"], 0.0), valid.to(torch.float32),
                p["anx"], p["any"], p["anz"], p["aax"], p["aay"], p["aaz"],
                p["events"], rays)
        out[:, c0:c1] = torch.stack(rows)
    return _wave_outputs(out)


_WAVE_KERNEL = None
WAVE_BUILD_LOG = ""


def load_wave_kernel() -> ctypes.CDLL:
    """Build (at first use) and load csrc/megatrace_wave.cu."""
    global _WAVE_KERNEL, WAVE_BUILD_LOG
    if _WAVE_KERNEL is None:
        from raytracing_in_one_weekend_tpu_torch.ops import cuda_build

        lib, WAVE_BUILD_LOG = cuda_build.build_library("megatrace_wave.cu")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rtiw_megatrace_wave.argtypes = [
            p, p, p, p, p, p, p,  # origin direction active sky sph rec out
            i, i, i, i,  # n s seed trace_depth
            ctypes.c_float, i, i,  # t_min has_diel sky_on
            p,  # stream
        ]
        lib.rtiw_megatrace_wave.restype = ctypes.c_int
        _WAVE_KERNEL = lib
    return _WAVE_KERNEL


def _megatrace_cuda(origin, direction, active, centers, radii, records,
                    sky_bottom, sky_top, seed, *, trace_depth, t_min,
                    has_dielectrics, sky_on):
    global WAVE_LAUNCHES
    dev = centers.device
    n, s = origin.shape[0], centers.shape[0]
    tensors = dict(origin=(origin, (n, 3)), direction=(direction, (n, 3)),
                   active=(active, (n,)), centers=(centers, (s, 3)),
                   radii=(radii, (s,)), sky_bottom=(sky_bottom, (3,)),
                   sky_top=(sky_top, (3,)))
    for name, (t, shape) in tensors.items():
        if t.device != dev:
            raise ValueError(f"megatrace: {name} is on {t.device}, "
                             f"centers on {dev}")
        if tuple(t.shape) != shape:
            raise ValueError(f"megatrace: {name} has shape "
                             f"{tuple(t.shape)}, want {shape}")
        if name != "active" and t.dtype != torch.float32:
            raise ValueError(f"megatrace: {name} must be float32")
    if records.shape[0] != s or records.shape[1] < 11 or records.device != dev:
        raise ValueError(f"megatrace: records has shape "
                         f"{tuple(records.shape)}, want ({s}, 11 or 12)")
    if s > SPH_CULL_MIN:
        raise ValueError(f"megatrace: {s} spheres; the kernel stages at "
                         f"most {SPH_CULL_MIN} in shared memory")
    lib = load_wave_kernel()
    sph, rec = sweep_tables(centers, radii, records)
    sky = _pack_sky_row(sky_bottom, sky_top)[0].contiguous()
    out = torch.empty((WAVE_ROWS, n), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.rtiw_megatrace_wave(
        origin.contiguous().data_ptr(), direction.contiguous().data_ptr(),
        active.to(torch.uint8).contiguous().data_ptr(), sky.data_ptr(),
        sph.data_ptr(), rec.data_ptr(), out.data_ptr(), n, s, int(seed),
        trace_depth, float(t_min), int(has_dielectrics), int(sky_on),
        stream,
    )
    if err != 0:
        raise RuntimeError(f"megatrace_wave launch failed: cudaError {err}")
    WAVE_LAUNCHES += 1
    return _wave_outputs(out)


def megatrace(
    origin: torch.Tensor,
    direction: torch.Tensor,
    active: torch.Tensor,
    centers: torch.Tensor,
    radii: torch.Tensor,
    records: torch.Tensor,
    sky_bottom: torch.Tensor,
    sky_top: torch.Tensor,
    seed,
    *,
    trace_depth: int,
    t_min: float = 0.0,
    has_dielectrics: bool = True,
    sky_on: bool = True,
) -> dict:
    """Per-ray fused trace of a wavefront of rays (see
    `megatrace_reference` for the outputs).  CUDA tensors launch the
    kernel (csrc/megatrace_wave.cu) or raise; CPU tensors run the plain
    version."""
    kwargs = dict(trace_depth=trace_depth, t_min=t_min,
                  has_dielectrics=has_dielectrics, sky_on=sky_on)
    args = (origin, direction, active, centers, radii, records, sky_bottom,
            sky_top, seed)
    with torch.no_grad():
        if centers.device.type == "cuda":
            return _megatrace_cuda(*args, **kwargs)
        if centers.device.type == "cpu":
            return megatrace_reference(*args, **kwargs)
    raise ValueError(f"megatrace: unsupported device {centers.device}")
