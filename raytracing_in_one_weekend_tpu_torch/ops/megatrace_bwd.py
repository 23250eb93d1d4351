"""Backward of the fused batch kernel: the tape replay's VJP (counterpart
of the JAX package's ops/megatrace_bwd.py, its sphere, rect/box, triangle
and convex-volume arms).

* `replay_grad_reference` is the plain version: torch.autograd over
  `ops/megatrace_replay.replay`, the counterpart of the JAX package's
  XLA-replay VJP oracle.
* `csrc/megatrace_bwd.cu` holds the hand-written CUDA kernels for Hopper.
  The adjoint is local to a path (a regen, then one iteration a bounce
  until it ends), so the backward runs path by path: `tape_scan_kernel`
  reads each lane's tape column and emits its paths, grouped by length
  (longest first; `scan_paths`, plain version `scan_paths_reference`),
  then `megatrace_paths_kernel` runs one thread a path: forward from the
  regen state, then the adjoint of `replay_iteration` derived by hand
  (csrc/megatrace_replay_lane.cuh) in reverse, winner-row cotangents
  summed per warp before their atomics.
* `replay_grad` is the wrapper: CPU tensors take the plain version; CUDA
  tensors launch the kernels or raise.  It counts the path kernel's
  launches in `LAUNCHES` and the scan's (count, then scatter when there
  are paths) in `SCAN_LAUNCHES`.

The kernel returns the cotangent of the winner entity rows (the 13
columns that carry gradients; in a mesh scene 28, megatrace_replay.
TRI_GRAD_COLS) and of the camera and sky constants; the entity-row
cotangent goes back to centers, radii, records and the triangle tables
through torch.autograd of `build_entity_rows`, as the JAX package does
with jax.vjp.  Mesh scenes take the kernel's triangle instantiation
(`MESH`): sphere rows sum in shared memory, triangle rows (up to TRI_MAX)
in device memory.  Scenes with rects or boxes take its aux instantiation
(`AUX`): their rows (19 columns, megatrace_replay.AUX_GRAD_COLS) in
device memory, and the cotangents of pack_aux_tables' four tables come
back through build_entity_rows (the JAX kernel's rect_geo, rect_rec,
box_geo and box_rec cotangents).  Scenes with convex volumes take its
volume instantiations (`VOL` beside spheres, `AUX_VOL` beside rects and
boxes): the medium rides eight more state floats, and the cotangent of
the camera's medium row `vol0` comes back with the camera and sky ones
(the JAX kernel's `aux_cot["vol0"]`), N_SCAL_VOL scalars in all.  Scenes
with moving spheres (and neither rects, boxes nor volumes) take its
motion instantiation (`MOTION`): a path carries its shutter time, and a
sphere row's cotangent grows by its move offset's (the centre's times the
time; 16 columns, GRAD_COLS then MOVE_COLS), which comes back through
build_entity_rows (the JAX kernel's `aux_cot["move"]`).  Sphere scenes
with checker or image albedos (no Perlin marble, which the replay does
not mirror) take its texture instantiation (`TEX`): a sphere row's
cotangent grows by its texture record's main and secondary colours (19
columns, GRAD_COLS then those), which go back to pack_texture_tables'
records, and the fetched atlas texels take theirs in a texel plane the
atlas's shape (the JAX kernel's texel-plane cotangent).

`replay_step_vjp` exposes the kernel's one-iteration VJP (and
`replay_step_vjp_reference` its autograd counterpart) so that the hand
derivation can be checked iteration by iteration on the card.
"""

from __future__ import annotations

import ctypes

import torch

from raytracing_in_one_weekend_tpu_torch.ops import megatrace as mk
from raytracing_in_one_weekend_tpu_torch.ops import megatrace_replay as mr

MAX_DEPTH = 64  # deepest trace_depth the path table's codes hold
N_SCAL = 30  # camera row (24) | sky bottom (3) | sky top (3)
N_SCAL_VOL = N_SCAL + mk.VOL_ROWS  # ... | vol0 (8): the volume builds

LAUNCHES = 0  # CUDA launches of the path kernel made by replay_grad
SCAN_LAUNCHES = 0  # CUDA launches of the tape scan (count and scatter)

_DIFF_ENV = ("co", "ll", "hh", "vv", "rr", "uu")

# The cotangent tensors of one iteration's VJP, as (name, output, rows) of
# replay_step_vjp's (cot_in, cot_entity, cot_scal): each state vector, each
# scene leaf, the camera row and the two sky colors.  A check holds each
# to its own max abs.
STEP_COTANGENTS = (
    ("origin", 0, slice(0, 3)), ("direction", 0, slice(3, 6)),
    ("throughput", 0, slice(6, 9)), ("radiance", 0, slice(9, 12)),
    ("color_sum", 0, slice(16, 19)), ("count", 0, slice(19, 20)),
    ("lp", 0, slice(20, 21)), ("centers", 1, slice(0, 3)),
    ("radii", 1, slice(3, 4)), ("records", 1, slice(4, 13)),
    ("camera_row", 2, slice(0, 24)), ("sky_bottom", 2, slice(24, 27)),
    ("sky_top", 2, slice(27, 30)),
)
# ... in mesh scenes, where cot_entity follows TRI_GRAD_COLS ("centers"
# then also holds a triangle's edge_a)
TRI_STEP_COTANGENTS = STEP_COTANGENTS + (
    ("edge_b", 1, slice(13, 16)), ("vert0", 1, slice(16, 19)),
    ("vertex_normals", 1, slice(19, 28)),
)
# ... in scenes with rects or boxes, where cot_entity follows
# AUX_GRAD_COLS ("centers" and "radii" then also hold a quaternion)
AUX_STEP_COTANGENTS = STEP_COTANGENTS + (
    ("positions", 1, slice(13, 16)), ("extents", 1, slice(16, 19)),
)
# ... with volumes: the medium's state floats and the camera's medium row
VOL_COTANGENTS = (("medium", 0, slice(21, 29)),
                  ("vol0", 2, slice(N_SCAL, N_SCAL_VOL)))
# ... with moving spheres (after STEP_COTANGENTS' columns)
MOTION_COTANGENTS = (("move", 1, slice(13, 16)),)
# ... with checker or image albedos (after STEP_COTANGENTS' columns)
TEX_COTANGENTS = (("texture_colors", 1, slice(13, 19)),)


def _tail_leaves(vol0, move_offsets, tex_tables) -> list:
    """The optional leaves after the tables, in the order replay_grad
    returns their cotangents: vol0, the move offsets, the texture records,
    the atlas (each only where given)."""
    tex = (() if tex_tables is None else (tex_tables[0],) + (
        () if tex_tables[2] is None else (tex_tables[2],)))
    return [t for t in (vol0, move_offsets) if t is not None] + list(tex)


def _tail_args(tail, vol0, move_offsets, tex_tables) -> dict:
    """_tail_leaves' inverse: replay's vol0, move_offsets and tex_tables
    keyword arguments with the tensors `tail`."""
    it = iter(tail)
    out = dict(vol0=None if vol0 is None else next(it),
               move_offsets=None if move_offsets is None else next(it),
               tex_tables=None)
    if tex_tables is not None:
        rec = next(it)
        atlas = None if tex_tables[2] is None else next(it)
        out["tex_tables"] = mk.TexTables(rec, None, atlas,
                                         tuple(tex_tables[3]))
    return out


def _flat_tables(tri_tables, rect_tables, box_tables) -> tuple:
    """The tables of the kinds a scene has, flat: tri_geo, tri_rec,
    rect_geo, rect_rec, box_geo, box_rec, each pair only where given."""
    return tuple(t for pair in (tri_tables, rect_tables, box_tables)
                 if pair is not None for t in pair)


def _unflat_tables(flat, tri_tables, rect_tables, box_tables) -> tuple:
    """_flat_tables' inverse: (tri_tables, rect_tables, box_tables) of the
    tensors `flat`, in the kinds the given pairs have."""
    out, k = [], 0
    for pair in (tri_tables, rect_tables, box_tables):
        if pair is None:
            out.append(None)
        else:
            out.append(tuple(flat[k:k + 2]))
            k += 2
    return tuple(out)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def replay_grad_reference(tape, lane_count, camera_row, centers, radii,
                          records, sky_bottom, sky_top, seed, cot_color,
                          cot_count, lane_base: int = 0, *, samples: int,
                          trace_depth: int, t_min: float = 0.0,
                          has_dielectrics: bool = True, sky_on: bool = True,
                          jitter: bool = True,
                          tri_tables: tuple | None = None,
                          rect_tables: tuple | None = None,
                          box_tables: tuple | None = None,
                          vol0: torch.Tensor | None = None,
                          move_offsets: torch.Tensor | None = None,
                          tex_tables: tuple | None = None) -> tuple:
    """Cotangents (camera_row, centers, radii, records, sky_bottom,
    sky_top[, tri_geo, tri_rec][, rect_geo, rect_rec][, box_geo,
    box_rec][, vol0][, move_offsets][, tex_rec[, atlas]]) of the replay's
    (color_sum, count) given theirs: autograd over the plain replay."""
    given = (tri_tables, rect_tables, box_tables)
    tail = _tail_leaves(vol0, move_offsets, tex_tables)
    leaves = tuple(t.detach().to(torch.float32).requires_grad_()
                   for t in (camera_row, centers, radii, records,
                             sky_bottom, sky_top, *_flat_tables(*given),
                             *tail))
    n_tab = len(leaves) - 6 - len(tail)
    tri, rect, box = _unflat_tables(leaves[6:6 + n_tab], *given)
    with torch.enable_grad():
        csum, cnt = mr.replay(
            tape, lane_count, *leaves[:6], seed, lane_base, samples=samples,
            trace_depth=trace_depth, t_min=t_min,
            has_dielectrics=has_dielectrics, sky_on=sky_on, jitter=jitter,
            tri_tables=tri, rect_tables=rect, box_tables=box,
            **_tail_args(leaves[6 + n_tab:], vol0, move_offsets, tex_tables),
        )
        grads = torch.autograd.grad(
            (csum, cnt), leaves,
            (cot_color.to(torch.float32), cot_count.to(torch.float32)),
            allow_unused=True,
        )
    return tuple(torch.zeros_like(leaf) if g is None else g
                 for g, leaf in zip(grads, leaves))


def scan_paths_reference(tape, lane_count, trace_depth: int):
    """The paths of a tape, (P, 3) int64 rows (lane, first iteration,
    length), longest first, then by lane and first iteration: the plain
    replay's regen and termination rules (`replay_iteration`) on the codes
    alone.  A path starts at a regen (an idle lane with started <
    lane_count), ends at a miss (code < -0.5) or when its depth reaches
    trace_depth, and a path cut by the tape's end is a path too."""
    iters, n = tape.shape
    dev = tape.device
    per_pixel = lane_count.to(torch.float32)
    active = torch.zeros(n, dtype=torch.bool, device=dev)
    started = torch.zeros(n, dtype=torch.float32, device=dev)
    depth = torch.zeros(n, dtype=torch.int64, device=dev)
    it0 = torch.zeros(n, dtype=torch.int64, device=dev)
    lanes = torch.arange(n, device=dev)
    found = []
    for it in range(iters):
        regen = ~active & (started < per_pixel)
        if not bool((active | regen).any()):
            break
        it0 = torch.where(regen, it, it0)
        started = started + regen.to(torch.float32)
        depth = torch.where(regen, 0, depth)
        active = active | regen
        depth = depth + active.to(torch.int64)
        end = active & ((tape[it] < -0.5) | (depth >= trace_depth))
        found.append(torch.stack([lanes[end], it0[end], it - it0[end] + 1], 1))
        active = active & ~end
    found.append(torch.stack([lanes[active], it0[active],
                              iters - it0[active]], 1))
    return canonical_paths(torch.cat(found))


def canonical_paths(paths):
    """(P, 3) path rows sorted longest first, then by lane and first
    iteration (the kernel's order within a length is its scan's)."""
    key = ((-paths[:, 2]) * (paths[:, 0].max() + 1 if len(paths) else 1)
           + paths[:, 0]) * (paths[:, 1].max() + 1 if len(paths) else 1) \
        + paths[:, 1]
    return paths[torch.argsort(key)]


def _lane_env(lane_count, cam_rows, sky_rows, seed, lane_base,
              vol_rows=None):
    """make_env with per-lane camera (24, n), sky (6, n) and camera-medium
    (8, n) rows."""
    env = mr.make_env(lane_count, cam_rows[:, 0], sky_rows[0:3, 0],
                      sky_rows[3:6, 0], seed, lane_base)
    if vol_rows is not None:
        env["vol0"] = tuple(vol_rows)
    for j, k in enumerate(_DIFF_ENV):
        env[k] = tuple(cam_rows[3 * j + c] for c in range(3))
    env.update(lens_radius=cam_rows[18], width=cam_rows[19],
               height=cam_rows[20],
               sky_b=tuple(sky_rows[c] for c in range(3)),
               sky_t=tuple(sky_rows[3 + c] for c in range(3)))
    return env


def replay_step_vjp_reference(state, tape_row, it: int, cot_out,
                              lane_count, camera_row, centers, radii,
                              records, sky_bottom, sky_top, seed,
                              lane_base: int = 0, *, trace_depth: int,
                              t_min: float = 0.0, has_dielectrics: bool = True,
                              sky_on: bool = True, jitter: bool = True,
                              tri_tables: tuple | None = None,
                              rect_tables: tuple | None = None,
                              box_tables: tuple | None = None,
                              vol0: torch.Tensor | None = None,
                              move_offsets: torch.Tensor | None = None,
                              tex_tables: tuple | None = None):
    """Per-lane VJP of one `replay_iteration`: autograd with every lane's
    state, winner row, camera, sky and camera medium as leaves of their
    own (with `move_offsets`, the state ends with the shutter time and
    cot_entity with the move columns; with `tex_tables`, cot_entity ends
    with the texture colours' columns; the atlas is not a leaf here).

    state, cot_out: (21, n) in STATE_KEYS order, (29, n) in VOL_STATE_KEYS
    order with `vol0`.  Returns (cot_in of the state's shape, cot_entity
    (13, n) over GRAD_COLS, or (28, n) over TRI_GRAD_COLS with
    `tri_tables`, or (19, n) over AUX_GRAD_COLS with `rect_tables` or
    `box_tables`, cot_scal (30, n): camera row, sky bottom, sky top, and
    with `vol0` (38, n): then vol0)."""
    n = lane_count.shape[0]
    has_motion = move_offsets is not None
    keys = mr.state_keys(vol0 is not None, has_motion)
    has_aux = rect_tables is not None or box_tables is not None
    table = mr.build_entity_rows(
        centers, radii, records, tri_tables, rect_tables, box_tables,
        move_offsets, None if tex_tables is None else tex_tables[0]).detach()
    winners = torch.clamp(tape_row, min=0.0).to(torch.int64)
    with torch.enable_grad():
        st = state.detach().clone().requires_grad_()
        wt = table[winners].T.contiguous().requires_grad_()
        cam = camera_row.detach().to(torch.float32)[:, None].expand(24, n) \
            .contiguous().requires_grad_()
        sky = torch.cat([sky_bottom, sky_top]).detach() \
            .to(torch.float32)[:, None].expand(6, n).contiguous() \
            .requires_grad_()
        scal = [cam, sky]
        if vol0 is not None:
            scal.append(vol0.detach().to(torch.float32)[:, None]
                        .expand(mk.VOL_ROWS, n).contiguous()
                        .requires_grad_())
        env = _lane_env(lane_count, cam, sky, seed, lane_base,
                        scal[2] if vol0 is not None else None)
        out = mr.replay_iteration(
            dict(zip(keys, st)), wt, tape_row, it, env,
            jitter=jitter, has_dielectrics=has_dielectrics, sky_on=sky_on,
            trace_depth=trace_depth, t_min=t_min,
            has_tris=tri_tables is not None, has_aux=has_aux,
            has_volumes=vol0 is not None, has_motion=has_motion,
            tex=None if tex_tables is None else (
                None if tex_tables[2] is None
                else tex_tables[2].detach().to(torch.float32),
                tuple(tex_tables[3])),
        )
        outs = [out[k] for k in keys]
        keep = [j for j, o in enumerate(outs) if o.requires_grad]
        g_st, g_wt, *g_scal = torch.autograd.grad(
            [outs[j] for j in keep], (st, wt, *scal),
            [cot_out[j] for j in keep], allow_unused=True,
        )

    def dense(g, like):
        return torch.zeros_like(like) if g is None else g

    cols = mr.grad_cols(tri_tables is not None, has_aux, has_motion,
                     tex_tables is not None)
    return (dense(g_st, st).detach(), dense(g_wt, wt).detach()[list(cols)],
            torch.cat([dense(g, leaf) for g, leaf in zip(g_scal, scal)])
            .detach())



# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

_KERNEL = None  # the loaded library, built at first use
BUILD_LOG = ""  # nvcc's output of the build this process made, if any


def load_kernel() -> ctypes.CDLL:
    """Build (at first use) and load csrc/megatrace_bwd.cu."""
    global _KERNEL, BUILD_LOG
    if _KERNEL is None:
        from raytracing_in_one_weekend_tpu_torch.ops import cuda_build

        lib, BUILD_LOG = cuda_build.build_library("megatrace_bwd.cu")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rtiw_bwd_scan.argtypes = [
            p, p, p, p, p,  # tape lane_count counts offsets paths
            i, i, i,  # n samples trace_depth
            p,  # stream
        ]
        lib.rtiw_bwd_scan.restype = i
        lib.rtiw_bwd_paths.argtypes = [
            p, p, i, p,  # tape paths total next_warp
            p, p, p, p, p, p, p,  # lane_count consts ent cot dent dscal
            #                       dent_rows
            i, i, i, i, i, i,  # row_base n s seed lane_base trace_depth
            f, i, i, i, i,  # t_min has_diel sky_on jitter kind
            p, p, i, i,  # atlas datlas img_w img_h
            p,  # stream
        ]
        lib.rtiw_bwd_paths.restype = i
        lib.rtiw_replay_step_vjp.argtypes = [
            p, p, p, p, p, p,  # state codes cot_out lane_count consts ent
            p, p, p,  # cot_in cot_ent cot_scal
            i, i, i, i, i,  # n it seed lane_base trace_depth
            f, i, i, i, i,  # t_min has_diel sky_on jitter kind
            p, i, i,  # atlas img_w img_h
            p,  # stream
        ]
        lib.rtiw_replay_step_vjp.restype = i
        _KERNEL = lib
    return _KERNEL


def _consts(camera_row, sky_bottom, sky_top, vol0=None):
    """The kernels' constants: camera row | sky bottom | sky top, then two
    pad floats, or with `vol0` the camera's medium row."""
    tail = (camera_row.new_zeros(2, dtype=torch.float32) if vol0 is None
            else vol0.detach().to(torch.float32))
    return torch.cat([camera_row.to(torch.float32),
                      sky_bottom.to(torch.float32),
                      sky_top.to(torch.float32), tail])


def _check(name: str, tensors: dict, shapes: dict, dev) -> None:
    for key, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, want {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {key} must be float32, is {t.dtype}")
        if key in shapes and tuple(t.shape) != shapes[key]:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"want {shapes[key]}")


def _scan_launch(tape, per_pixel, samples: int, trace_depth: int, *,
                 counts=None, offsets=None, paths=None) -> None:
    """One launch of the scan kernel: count mode fills `counts` (blocks,
    trace_depth), each block's path count per length; scatter mode writes
    each path to `paths` at `offsets` (the same shape) plus its rank in the
    block."""
    global SCAN_LAUNCHES
    err = load_kernel().rtiw_bwd_scan(
        tape.data_ptr(), per_pixel.data_ptr(),
        *(0 if t is None else t.data_ptr() for t in (counts, offsets, paths)),
        per_pixel.shape[0], samples, trace_depth,
        torch.cuda.current_stream(tape.device).cuda_stream)
    if err != 0:
        mode = "count" if paths is None else "scatter"
        raise RuntimeError(f"tape scan ({mode}) launch failed: cudaError {err}")
    SCAN_LAUNCHES += 1


def _scan_offsets(counts):
    """Each block's offset per length in the path table, lengths longest
    first, and the number of paths: the glue between the scan's two
    launches."""
    c = counts.to(torch.int64)
    per_length = c.sum(0)
    longer = per_length.flip(0).cumsum(0).flip(0) - per_length
    offsets = (c.cumsum(0) - c + longer).to(torch.int32).contiguous()
    return offsets, int(per_length.sum())


def _scan_cuda(tape, per_pixel, samples: int, trace_depth: int):
    """The scan kernel's path table: (P, 2) int32 rows (lane, first
    iteration * MAX_DEPTH + length - 1), longest first.  Two launches: the
    count per block and length, then (after the offsets) the scatter."""
    n = per_pixel.shape[0]
    dev = tape.device
    _check("tape scan", dict(tape=tape, per_pixel=per_pixel),
           dict(tape=(samples * trace_depth, n)), dev)
    if (not 0 < trace_depth <= MAX_DEPTH
            or samples * trace_depth * MAX_DEPTH >= 2**31):
        raise ValueError(f"tape scan: trace_depth {trace_depth}, "
                         f"{samples * trace_depth} iterations; the path "
                         f"table's int32 codes hold depths up to {MAX_DEPTH} "
                         f"and {2**31 // MAX_DEPTH} iterations")
    counts = torch.empty((-(-n // 128), trace_depth), dtype=torch.int32,
                         device=dev)
    _scan_launch(tape, per_pixel, samples, trace_depth, counts=counts)
    offsets, total = _scan_offsets(counts)
    paths = torch.empty((total, 2), dtype=torch.int32, device=dev)
    if total:
        _scan_launch(tape, per_pixel, samples, trace_depth, offsets=offsets,
                     paths=paths)
    return paths


def decode_paths(paths):
    """The scan kernel's (P, 2) table as (P, 3) int64 rows (lane, first
    iteration, length), in its order."""
    code = paths[:, 1].to(torch.int64)
    return torch.stack([paths[:, 0].to(torch.int64), code // MAX_DEPTH,
                        code % MAX_DEPTH + 1], 1)


def scan_paths(tape, lane_count, *, samples: int, trace_depth: int):
    """The paths of a tape, (P, 3) int64 rows (lane, first iteration,
    length), longest first.  CUDA tensors launch the scan kernel (its
    order within a length is the scan's); CPU tensors run the plain
    version."""
    if tape.device.type == "cpu":
        return scan_paths_reference(tape, lane_count, trace_depth)
    if tape.device.type != "cuda":
        raise ValueError(f"scan_paths: unsupported device {tape.device}")
    return decode_paths(_scan_cuda(
        tape.contiguous(), lane_count.to(torch.float32).contiguous(),
        samples, trace_depth))


# the kernels' builds: sphere scenes, mesh scenes, scenes with rects or
# boxes, the first and third with convex volumes, and sphere scenes with
# moving spheres (csrc/megatrace_bwd.cu's `kind` argument)
SPHERES, MESH, AUX, VOL, AUX_VOL, MOTION, TEX = 0, 1, 2, 3, 4, 5, 6
MOTION_BESIDE = ("the backward kernel's motion and texture adjoints beside "
                 "rects, boxes, volumes or each other (ROADMAP queue 1, step "
                 "7.3c)")


def build_kind(has_tris: bool, has_aux: bool, has_volumes: bool,
               has_motion: bool = False, has_tex: bool = False) -> int:
    if has_tris and has_volumes:
        raise NotImplementedError(f"replay_grad: {mk.VOLUMES_IN_MESHES}")
    if has_tris and has_motion:
        raise NotImplementedError(f"replay_grad: {mk.MOTION_IN_MESHES}")
    if has_tris and has_tex:
        raise NotImplementedError(f"replay_grad: {mk.TEXTURES_IN_MESHES}")
    if has_motion or has_tex:
        if has_aux or has_volumes or (has_motion and has_tex):
            raise NotImplementedError(f"replay_grad: {MOTION_BESIDE}")
        return MOTION if has_motion else TEX
    if has_volumes:
        return AUX_VOL if has_aux else VOL
    return MESH if has_tris else AUX if has_aux else SPHERES


def _replay_grad_cuda(tape, lane_count, camera_row, centers, radii, records,
                      sky_bottom, sky_top, seed, cot_color, cot_count,
                      lane_base, *, samples, trace_depth, t_min,
                      has_dielectrics, sky_on, jitter, tri_tables,
                      rect_tables, box_tables, vol0, move_offsets=None,
                      tex_tables=None):
    dev = centers.device
    n, s = lane_count.shape[0], centers.shape[0]
    # the tape's shape, the lane counts and the depth: _scan_cuda's checks
    _check("replay_grad", dict(
        tape=tape, camera_row=camera_row, centers=centers, radii=radii,
        records=records, sky_bottom=sky_bottom, sky_top=sky_top,
        cot_color=cot_color, cot_count=cot_count,
    ), dict(camera_row=(24,), centers=(s, 3), radii=(s,), sky_bottom=(3,),
            sky_top=(3,), cot_color=(n, 3), cot_count=(n,)), dev)
    if s > mk.SPH_CULL_MIN:
        raise ValueError(f"replay_grad: {s} spheres; the kernel's shared "
                         f"cotangent table holds at most {mk.SPH_CULL_MIN}")
    given = (tri_tables, rect_tables, box_tables)
    has_aux = rect_tables is not None or box_tables is not None
    has_motion, has_tex = move_offsets is not None, tex_tables is not None
    kind = build_kind(tri_tables is not None, has_aux, vol0 is not None,
                      has_motion, has_tex)
    cols = mr.grad_cols(tri_tables is not None, has_aux, has_motion, has_tex)
    tri = tuple(tri_tables or ())
    if tri:
        t_pad = tri[0].shape[0]
        _check("replay_grad", dict(tri_geo=tri[0], tri_rec=tri[1]),
               dict(tri_geo=(t_pad, 16), tri_rec=(mk.TRI_REC_ROWS, t_pad)),
               dev)
        if t_pad % mk.TRI_PAD or t_pad > mk.TRI_MAX:
            raise ValueError(f"replay_grad: {t_pad} triangle rows; want a "
                             f"multiple of {mk.TRI_PAD} up to {mk.TRI_MAX}")
    if has_aux:
        mk._check_aux_tables(rect_tables, box_tables, dev)
    if vol0 is not None:
        _check("replay_grad", dict(vol0=vol0), dict(vol0=(mk.VOL_ROWS,)),
               dev)
    if has_motion:
        _check("replay_grad", dict(move_offsets=move_offsets),
               dict(move_offsets=(s, 3)), dev)
    atlas, dims = None, (0, 0)
    if has_tex:
        _, perlin, atlas, dims = mk.kernel_tex_tables(tex_tables, dev)
        if perlin is not None:
            raise ValueError("replay_grad: the tape replay has no Perlin "
                             "marble (replay_eligible)")
    # the leaves build_entity_rows takes: spheres, tables, move offsets and
    # texture records
    extra = ([move_offsets] if has_motion else []) + (
        [tex_tables[0]] if has_tex else [])
    with torch.enable_grad():
        leaves = tuple(t.detach().requires_grad_()
                       for t in (centers, radii, records,
                                 *_flat_tables(*given), *extra))
        rest = iter(leaves[len(leaves) - len(extra):])
        entity_rows = mr.build_entity_rows(
            *leaves[:3],
            *_unflat_tables(leaves[3:len(leaves) - len(extra)], *given),
            next(rest) if has_motion else None,
            next(rest) if has_tex else None)
    args = kernel_args(tape, lane_count,
                       _consts(camera_row, sky_bottom, sky_top, vol0),
                       entity_rows, s, cot_color, cot_count, kind=kind,
                       atlas=atlas, dims=dims)
    paths = _scan_cuda(args["tape"], args["per_pixel"], samples, trace_depth)
    dent, dscal, dent_rows, datlas = _paths_cuda(
        paths, args, seed, lane_base, trace_depth=trace_depth, t_min=t_min,
        has_dielectrics=has_dielectrics, sky_on=sky_on, jitter=jitter)
    s_pad = mk.sphere_pad_count(s)
    dtable = torch.zeros_like(entity_rows)
    dtable[:s, list(mr.grad_cols(False, False, has_motion, has_tex))] = dent
    if dent_rows is not None:
        dtable[s_pad:, list(cols)] = dent_rows
    grads = torch.autograd.grad(entity_rows, leaves, dtable)
    n_tab = len(grads) - 3 - len(extra)
    vol = () if vol0 is None else (dscal[N_SCAL:],)
    return (dscal[:24], *grads[:3], dscal[24:27], dscal[27:30],
            *grads[3:3 + n_tab], *vol, *grads[3 + n_tab:],
            *(() if datlas is None else (datlas,)))


def kernel_args(tape, lane_count, consts, entity_rows, s: int, cot_color,
                cot_count, *, kind: int, atlas=None, dims=(0, 0)) -> dict:
    """The path kernel's inputs: the contiguous tape, per-pixel counts as
    floats, the entity table it indexes (sphere scenes, volumes, motion
    and textures among them: the s real sphere rows; mesh scenes and
    scenes with rects or boxes: the whole padded table, which their tape
    codes, s_pad + row, index), the constants (_consts), the (4, N) color
    and count cotangents, the build (`kind`: SPHERES, MESH, AUX, VOL,
    AUX_VOL, MOTION or TEX) and the texture build's atlas ((A * H, W, 3)
    or None) and its (W, H)."""
    return dict(
        tape=tape.contiguous(),
        per_pixel=lane_count.to(torch.float32).contiguous(),
        ent=entity_rows.detach()[:s if kind in (SPHERES, VOL, MOTION, TEX)
                                 else None].contiguous(),
        consts=consts,
        cot=torch.cat([cot_color.T, cot_count[None]]).contiguous(),
        s=s, kind=kind, atlas=atlas, dims=tuple(dims))


def _paths_cuda(paths, args: dict, seed, lane_base, *, trace_depth: int,
                t_min: float, has_dielectrics: bool, sky_on: bool,
                jitter: bool):
    """The path kernel over the scan's table: (dent (s, 13; 16 in the
    motion build, the move offsets' last; 19 in the texture build, the
    texture colours' last), dscal (30; 38 in the volume builds, vol0's
    last), dent_rows: the cotangents of the rows past the padded spheres,
    (T_pad, 28) in mesh scenes, (R_pad + B_pad, 19) with rects or boxes,
    else None; the texel plane's, the atlas's shape, in the texture build
    with an atlas, else None)."""
    global LAUNCHES
    lib = load_kernel()
    dev = args["tape"].device
    s, n, kind = args["s"], args["per_pixel"].shape[0], args["kind"]
    s_pad = mk.sphere_pad_count(s)
    f32 = dict(dtype=torch.float32, device=dev)
    dent = torch.zeros((s, len(mr.grad_cols(False, False, kind == MOTION,
                                             kind == TEX))), **f32)
    atlas = args["atlas"]
    datlas = None if atlas is None else torch.zeros_like(atlas)
    dscal = torch.zeros(N_SCAL_VOL if kind in (VOL, AUX_VOL) else N_SCAL,
                        **f32)
    next_warp = torch.zeros(1, dtype=torch.int32, device=dev)
    dent_rows = (None if kind in (SPHERES, VOL, MOTION, TEX) else torch.zeros(
        (args["ent"].shape[0] - s_pad,
         len(mr.TRI_GRAD_COLS if kind == MESH else mr.AUX_GRAD_COLS)), **f32))
    if paths.shape[0]:
        err = lib.rtiw_bwd_paths(
            args["tape"].data_ptr(), paths.data_ptr(), paths.shape[0],
            next_warp.data_ptr(), args["per_pixel"].data_ptr(),
            args["consts"].data_ptr(), args["ent"].data_ptr(),
            args["cot"].data_ptr(), dent.data_ptr(), dscal.data_ptr(),
            0 if dent_rows is None else dent_rows.data_ptr(), s_pad, n, s,
            int(seed), int(lane_base), trace_depth, float(t_min),
            int(has_dielectrics), int(sky_on), int(jitter), kind,
            0 if atlas is None else atlas.data_ptr(),
            0 if datlas is None else datlas.data_ptr(), *args["dims"],
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"megatrace_bwd path kernel launch failed: "
                               f"cudaError {err}")
        LAUNCHES += 1
    return dent, dscal, dent_rows, datlas


def replay_grad(tape, lane_count, camera_row, centers, radii, records,
                sky_bottom, sky_top, seed, cot_color, cot_count,
                lane_base: int = 0, *, samples: int, trace_depth: int,
                t_min: float = 0.0, has_dielectrics: bool = True,
                sky_on: bool = True, jitter: bool = True,
                tri_tables: tuple | None = None,
                rect_tables: tuple | None = None,
                box_tables: tuple | None = None,
                vol0: torch.Tensor | None = None,
                move_offsets: torch.Tensor | None = None,
                tex_tables: tuple | None = None) -> tuple:
    """Cotangents (camera_row, centers, radii, records, sky_bottom,
    sky_top[, tri_geo, tri_rec][, rect_geo, rect_rec][, box_geo,
    box_rec][, vol0][, move_offsets][, tex_rec[, atlas]]) of one batch's
    (color_sum (N, 3), count (N,)) given
    the color and count cotangents, replaying the tape
    (samples*trace_depth, N); `tri_tables` is pack_tri_tables' pair of a
    mesh scene, `rect_tables` and `box_tables` pack_aux_tables' pairs (the
    JAX kernel's rect_geo, rect_rec, box_geo and box_rec cotangents),
    `vol0` camera_containment_row of a scene with convex volumes (the JAX
    kernel's aux_cot["vol0"]), `move_offsets` the spheres' unit-shutter
    motion (its aux_cot["move"]), `tex_tables` pack_texture_tables'
    tables of checker and image albedos (the texture records' and the
    texel plane's cotangents).

    The device of `centers` decides: CUDA tensors launch the kernels
    (csrc/megatrace_bwd.cu: the tape scan, then the path kernel) or raise;
    CPU tensors run the plain version."""
    args = (tape, lane_count, camera_row, centers, radii, records,
            sky_bottom, sky_top, seed, cot_color, cot_count, lane_base)
    kwargs = dict(samples=samples, trace_depth=trace_depth, t_min=t_min,
                  has_dielectrics=has_dielectrics, sky_on=sky_on,
                  jitter=jitter, tri_tables=tri_tables,
                  rect_tables=rect_tables, box_tables=box_tables, vol0=vol0,
                  move_offsets=move_offsets, tex_tables=tex_tables)
    if centers.device.type == "cuda":
        return _replay_grad_cuda(*args, **kwargs)
    if centers.device.type == "cpu":
        return replay_grad_reference(*args, **kwargs)
    raise ValueError(f"replay_grad: unsupported device {centers.device}")


def replay_step_vjp(state, tape_row, it: int, cot_out, lane_count,
                    camera_row, centers, radii, records, sky_bottom,
                    sky_top, seed, lane_base: int = 0, *, trace_depth: int,
                    t_min: float = 0.0, has_dielectrics: bool = True,
                    sky_on: bool = True, jitter: bool = True,
                    tri_tables: tuple | None = None,
                    rect_tables: tuple | None = None,
                    box_tables: tuple | None = None,
                    vol0: torch.Tensor | None = None,
                    move_offsets: torch.Tensor | None = None,
                    tex_tables: tuple | None = None):
    """The backward kernel's one-iteration VJP on every lane (see
    `replay_step_vjp_reference` for the arguments and outputs).  CUDA
    tensors launch the kernel's step entry point; CPU tensors run the plain
    version."""
    kwargs = dict(trace_depth=trace_depth, t_min=t_min,
                  has_dielectrics=has_dielectrics, sky_on=sky_on,
                  jitter=jitter, tri_tables=tri_tables,
                  rect_tables=rect_tables, box_tables=box_tables, vol0=vol0,
                  move_offsets=move_offsets, tex_tables=tex_tables)
    args = (state, tape_row, it, cot_out, lane_count, camera_row, centers,
            radii, records, sky_bottom, sky_top, seed, lane_base)
    if centers.device.type == "cpu":
        return replay_step_vjp_reference(*args, **kwargs)
    if centers.device.type != "cuda":
        raise ValueError(f"replay_step_vjp: unsupported device "
                         f"{centers.device}")
    dev = centers.device
    n = lane_count.shape[0]
    has_motion = move_offsets is not None
    keys = mr.state_keys(vol0 is not None, has_motion)
    _check("replay_step_vjp", dict(state=state, tape_row=tape_row,
                                   cot_out=cot_out),
           dict(state=(len(keys), n), tape_row=(n,),
                cot_out=(len(keys), n)), dev)
    lib = load_kernel()
    has_tex = tex_tables is not None
    ent = mr.build_entity_rows(
        centers, radii, records, tri_tables, rect_tables, box_tables,
        move_offsets, tex_tables[0] if has_tex else None
    ).detach().contiguous()
    atlas, dims = None, (0, 0)
    if has_tex:
        _, _, atlas, dims = mk.kernel_tex_tables(tex_tables, dev)
    consts = _consts(camera_row, sky_bottom, sky_top, vol0)
    f32 = dict(dtype=torch.float32, device=dev)
    has_aux = rect_tables is not None or box_tables is not None
    cols = mr.grad_cols(tri_tables is not None, has_aux, has_motion, has_tex)
    cot_in = torch.empty((len(keys), n), **f32)
    cot_ent = torch.empty((len(cols), n), **f32)
    cot_scal = torch.empty((N_SCAL if vol0 is None else N_SCAL_VOL, n),
                           **f32)
    # keep every buffer the launch reads bound until it is enqueued
    state, tape_row, cot_out = (t.contiguous()
                                for t in (state, tape_row, cot_out))
    per_pixel = lane_count.to(torch.float32).contiguous()
    err = lib.rtiw_replay_step_vjp(
        state.data_ptr(), tape_row.data_ptr(), cot_out.data_ptr(),
        per_pixel.data_ptr(), consts.data_ptr(), ent.data_ptr(),
        cot_in.data_ptr(), cot_ent.data_ptr(), cot_scal.data_ptr(), n,
        int(it), int(seed), int(lane_base), trace_depth, float(t_min),
        int(has_dielectrics), int(sky_on), int(jitter),
        build_kind(tri_tables is not None, has_aux, vol0 is not None,
                   has_motion, has_tex),
        0 if atlas is None else atlas.data_ptr(), *dims,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"replay_step_vjp launch failed: cudaError {err}")
    return cot_in, cot_ent, cot_scal
