"""Bounce-synchronous streamed-mesh sampler: the CUDA kernels and their
plain versions (counterpart of the JAX package's ops/pallas_meshtrace.py).

Reference: the per-ray BVH walk of FindHitCandidates
(SampleBatchJob.cs:403-448).  The JAX package renders meshes of more than
SYNC_TRI_MIN triangles with the bounce loop outside the kernel: each wave
of `wave_spp` samples per pixel starts its camera rays on the host side
(threefry, `camera.generate_rays`), then makes one launch per bounce over
every lane, whose path state lives in device memory between launches
((ST_ROWS, N) float32: the 23 carry rows of the bounce, then the lane id).
Lanes are Morton-ordered pixels with the wave's samples adjacent.  Between
bounces a stable partition inside each pair of RAY_TILE-lane tiles sorts
the live lanes by direction octant and moves the dead ones last (the phase
of the pairs alternates from bounce to bounce); at the end of the wave the
lane-id row undoes the permutation.

* `bounce_sync`: one bounce of every live lane, `megatrace._bounce` with
  the streamed-triangle arm, uniforms keyed by the lane-id row
  (csrc/meshtrace_sync.cu; launches counted in SYNC_LAUNCHES).  The
  kernel sweeps the triangles group by group of SYNC_GROUP lanes, in the
  near-to-far super order of `tile_super_order` (which each thread block
  computes for itself; `kernel_visit_order` reads it back);
  `sync_traversal` is the plain model of that sweep.
* `pair_compact`: the stable 9-class partition of each 2048-lane pair
  (csrc/meshtrace_permute.cu; COMPACT_LAUNCHES).
* `restore`: the inverse permutation by the lane-id row, as an inverse
  index and a gather (csrc/meshtrace_permute.cu; RESTORE_LAUNCHES).
* `sample_batch_sync`: the wave loop, the per-pixel reduction and the
  Morton -> pixel un-permute.

Each wrapper takes its plain version exactly when its tensors lie on the
CPU; on CUDA tensors it launches its kernel or raises.  The lane-id row is
float32, exact below 2^24 lanes, as in the JAX package.  The JAX module's
measurement switches (MESH_SYNC, MESH_SYNC_NOMESH, MESH_LOCKSTEP,
MESH_COUNT, MESH_FORCE_SWEEP, MESH_SUP_ONLY, FORCE_INTERPRET) are not
ported.
"""

from __future__ import annotations

import ctypes

import torch

from raytracing_in_one_weekend_tpu_torch.core import camera as camera_mod
from raytracing_in_one_weekend_tpu_torch.core import rng
from raytracing_in_one_weekend_tpu_torch.ops import megatrace as mk

RAY_TILE = 1024  # lanes of a JAX tile: the unit of the compaction's pairs
PAIR = 2 * RAY_TILE  # lanes per pair-compaction block
SYNC_TRI_MIN = 65536  # the renderer takes this path above it (JAX's
# threshold, measured on the TPU; PERF.md has the H100's two routes)
ST_ROWS = 24
LANE_ROW = 23
RAYS_ROW = 22
_MASK32 = 0xFFFFFFFF
_SALT_WAVE = 1640531527  # per-(wave, bounce) salt of the hash PRNG
_SALT_BOUNCE = 40503
_HALF_BAND = 8  # compaction passes per wave (JAX's restore band)
# state rows 0-21, in order: megatrace._bounce's keys (JAX's carry slots)
ROW_KEYS = ("ox", "oy", "oz", "dx", "dy", "dz", "thx", "thy", "thz",
            "rx", "ry", "rz", "active", "valid", "anx", "any", "anz",
            "aax", "aay", "aaz", "got", "events")
_FLAGS = ("active", "valid", "got")

SYNC_GROUP = 128  # lanes of a thread block of the group traversal
# (bounce_sync and the batch kernel's streamed build: csrc/group_sweep.cuh's
# kGroup, checked when meshtrace_sync.cu loads; PERF.md has the readings
# that chose it)
_UNREACHED = 1e29  # tile_super_order's distances at or above: unreachable

SYNC_LAUNCHES = 0  # CUDA launches made by bounce_sync
COMPACT_LAUNCHES = 0  # ... by pair_compact
RESTORE_LAUNCHES = 0  # ... by restore


def scene_tables(centers, radii, records, sky_bottom, sky_top):
    """(sph (S, 4), rec (S, 16), sky (8,)): the sphere and sky tables of
    `bounce_sync`, packed once per batch."""
    sph, rec = mk.sweep_tables(centers, radii, records)
    return sph, rec, mk._pack_sky_row(sky_bottom, sky_top)[0].contiguous()


def wave_salt(wave: int, bounce: int) -> int:
    """The hash salt of (wave, bounce), mod 2^32 (JAX's wrapping int32)."""
    return (wave * _SALT_WAVE + bounce * _SALT_BOUNCE) & _MASK32


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def bounce_sync_reference(state, seed, salt, bounce, tables, stream, *,
                          t_min=0.0, has_dielectrics=True, sky_on=True):
    """One bounce of every live lane of `state` (rows 12 > 0), in place:
    `megatrace._bounce` at depth `bounce` with the uniforms of hash base
    seed + lane * 9781 + salt (the lane from row 23), the sweep over the
    streamed triangles `stream` (pack_tri_stream_tables), the ray count
    (row 22) plus one.  Dead lanes keep every bit.  Returns `state`."""
    sph, rec, sky = tables
    live = torch.nonzero(state[12] > 0.0, as_tuple=True)[0]
    if live.numel() == 0:
        return state
    if rec.shape[0] == 0:  # no spheres: a record row the winners never read
        rec = rec.new_zeros((1, mk.KERNEL_REC))
    rows = state[:, live]
    p = {k: rows[i] for i, k in enumerate(ROW_KEYS)}
    for k in _FLAGS:
        p[k] = p[k] > 0.5
    lanes = rows[LANE_ROW].to(torch.int64)
    u = mk.uniforms_hash(int(seed), int(salt), lanes, 6)
    mk._bounce(p, u, sph, rec, bounce, t_min=t_min,
               has_dielectrics=has_dielectrics, sky_on=sky_on, sky=sky,
               tri=mk._tri_arg(None, stream, sph.shape[0]))
    for i, k in enumerate(ROW_KEYS):
        rows[i] = p[k].to(torch.float32)
    rows[RAYS_ROW] += 1.0
    state[:, live] = rows
    return state


def _octant_class(state):
    """9-way class of each lane: the direction octant 4(dx > 0) + 2(dy > 0)
    + (dz > 0) of a live lane (row 12 > 0.5), 8 for a dead one."""
    octant = ((state[3] > 0.0).to(torch.int64) * 4
              + (state[4] > 0.0).to(torch.int64) * 2
              + (state[5] > 0.0).to(torch.int64))
    return torch.where(state[12] > 0.5, octant, 8)


def pair_compact_reference(state):
    """Stable partition of each PAIR-lane block of `state` (ST_ROWS, N) by
    class (`_octant_class`): a lane goes after every lane of a lower class
    in its pair and after the lanes of its own class before it.  Lanes
    past the last whole pair stay where they are.  Returns a new tensor."""
    n = state.shape[1]
    m = n // PAIR * PAIR
    out = state.clone()
    if m == 0:
        return out
    cls = _octant_class(state[:, :m]).reshape(-1, PAIR)
    pos = torch.arange(PAIR, device=state.device)
    src = torch.argsort(cls * PAIR + pos, dim=1)  # src[p, dest]
    src = src + torch.arange(m // PAIR, device=state.device)[:, None] * PAIR
    out[:, :m] = state[:, src.reshape(-1)]
    return out


def restore_reference(state):
    """The inverse of the wave's permutation: column j of `state` moves to
    column state[LANE_ROW, j].  Returns a new tensor."""
    out = torch.empty_like(state)
    out[:, state[LANE_ROW].to(torch.int64)] = state
    return out


# ---------------------------------------------------------------------------
# The triangle sweep's visit order, and a plain model of the kernel's sweep
# ---------------------------------------------------------------------------


def tile_super_order(state, sup, group: int):
    """Per group of `group` lanes of `state` (the last one padded with dead
    lanes), the supers of `sup` ((n_sup, 8): lo | 0 | hi | 0) near to far:
    (order (groups, n_sup) int32, dist (groups, n_sup) float32), JAX's
    `_tile_super_order` with the group size a parameter.  From the AABB of
    the live lanes' origins (row 12 >= 0.5), dist is 0.999 x the Euclidean
    gap between it and the super, a lower bound on the t at which a ray of
    unit direction enters it.  A super wholly on one side of the origins
    that no live direction points towards is unreachable: +inf, sorted
    last (stable).  The CUDA kernel computes the same order per thread
    block (csrc/meshtrace_sync.cu `visit_order`)."""
    n = state.shape[1]
    groups = -(-n // group)
    rows = state[[0, 1, 2, 3, 4, 5, 12]]
    if groups * group != n:
        rows = torch.cat([rows, rows.new_zeros((7, groups * group - n))], 1)
    rows = rows.reshape(7, groups, group)
    act = (rows[6] >= 0.5)[None]
    o, d = rows[0:3], rows[3:6]
    big = 1e30
    olo = torch.where(act, o, big).amin(dim=2).T[:, None]  # (G, 1, 3)
    ohi = torch.where(act, o, -big).amax(dim=2).T[:, None]
    dlo = torch.where(act, d, big).amin(dim=2).T[:, None]
    dhi = torch.where(act, d, -big).amax(dim=2).T[:, None]
    slo, shi = sup[None, :, 0:3], sup[None, :, 4:7]  # (1, S, 3)
    gap = torch.clamp(torch.maximum(slo - ohi, olo - shi), min=0.0)
    dist = torch.sqrt(gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1]
                      + gap[..., 2] * gap[..., 2]) * 0.999
    unreach = (((slo > ohi) & (dhi <= 0.0))
               | ((shi < olo) & (dlo >= 0.0))).any(dim=2)
    key = torch.where(unreach, float("inf"), dist)
    order = torch.argsort(key, dim=1, stable=True)
    return (order.to(torch.int32).contiguous(),
            torch.gather(key, 1, order).contiguous())


def _rows_lexmin(o, d, lanes, blk, geo, hit, t_min, chunk=1 << 15):
    """Test each lane of `lanes` against the TRI_BLOCK rows of its block
    `blk` (geo: (blocks, TRI_BLOCK, 12)) and take a hit whose (t, row) is
    lexicographically below hit = [t, row, u, v]'s, in place."""
    tri_t, tri_idx, tri_u, tri_v = hit
    for c in range(0, lanes.numel(), chunk):
        ln, b = lanes[c:c + chunk], blk[c:c + chunk]
        rows = geo[b]
        t, u, v = mk.moller_trumbore(
            tuple(x[ln, None] for x in o), tuple(x[ln, None] for x in d),
            tuple(rows[..., k] for k in range(0, 3)),
            tuple(rows[..., k] for k in range(3, 6)),
            tuple(rows[..., k] for k in range(6, 9)), t_min)
        blk_t, blk_i = torch.min(t, dim=1)  # the first row on a tie
        row = b * mk.TRI_BLOCK + blk_i
        best = tri_t[ln]
        win = (blk_t < best) | ((blk_t == best) & (row < tri_idx[ln]))
        lw, bi = ln[win], blk_i[win]
        tri_t[lw] = blk_t[win]
        tri_idx[lw] = row[win]
        pos = torch.nonzero(win, as_tuple=True)[0]
        tri_u[lw] = u[pos, bi]
        tri_v[lw] = v[pos, bi]


def sync_traversal(o, d, best_t, live, stream: mk.TriStream, group: int,
                   order, dist, t_min: float = 0.0):
    """The triangle sweep of csrc/meshtrace_sync.cu, step for step, over
    lanes o, d (3-tuples of (n,) rows), their sphere hits best_t and the
    live mask, in groups of `group` lanes visiting the supers in `order`
    with lower-bound distances `dist` (tile_super_order's).  Per group and
    super, in its order: stop when no live lane's best hit so far,
    min(tri_t, best_t), lies beyond the super's distance; else one vote
    over the live lanes within reach (each: the super's slab test, then its
    16 blocks') picks the blocks to stage, and in index order every live
    lane of the group tests each staged block's slab against its bound
    then, if it passes, the block's rows, taking a hit only if (t, row) is
    lexicographically smaller.  Returns ((t, row, u, v), counts): BIG, 0,
    0, 0 where no triangle is hit; counts of the lanes' own triangle and
    AABB tests (`lane_pairs`, `lane_slabs`), of the triangle tests of the
    warps that run a staged block for at least one lane (`warp_pairs`,
    32 lanes each) and of every live lane of a group against every block
    it stages (`group_pairs`), and `staged` blocks."""
    dev = o[0].device
    n = o[0].shape[0]
    n_sup = stream.sup.shape[0]
    inv = [mk._inv_d(c) for c in d]
    hit = mk._no_tri_hit(o[0])
    tri_t = hit[0]
    lane_group = torch.arange(n, device=dev) // group
    warp = torch.arange(n, device=dev) // 32
    n_live = torch.bincount(lane_group[live], minlength=order.shape[0])
    geo = stream.geo.reshape(-1, mk.TRI_BLOCK, 12)
    counts = dict(lane_pairs=0, lane_slabs=0, warp_pairs=0, group_pairs=0,
                  staged=0)
    going = torch.ones(order.shape[0], dtype=torch.bool, device=dev)

    def slab(lanes, boxes, bound):
        counts["lane_slabs"] += lanes.numel()
        return mk._slab_may(boxes[:, 0:3].T, boxes[:, 4:7].T,
                            [c[lanes] for c in o], [c[lanes] for c in inv],
                            t_min, bound)

    for k in range(n_sup):
        sup = order[:, k].long()
        going &= dist[:, k] < _UNREACHED
        within = live & going[lane_group] & (
            dist[:, k][lane_group] < torch.minimum(tri_t, best_t))
        going &= torch.zeros_like(going).index_fill_(
            0, lane_group[within], True)
        if not bool(going.any()):
            break
        # the vote: the blocks some lane within reach may hit before its bound
        lanes = torch.nonzero(within, as_tuple=True)[0]
        bound = torch.minimum(tri_t[lanes], best_t[lanes])
        sup_l = sup[lane_group[lanes]]
        ok = slab(lanes, stream.sup[sup_l], bound)
        lanes, bound, sup_l = lanes[ok], bound[ok], sup_l[ok]
        staged = torch.zeros((order.shape[0], mk.TRI_SUP), dtype=torch.bool,
                             device=dev)
        for j in range(mk.TRI_SUP):
            reach = slab(lanes, stream.aabb[sup_l * mk.TRI_SUP + j], bound)
            staged[lane_group[lanes[reach]], j] = True
        for j in range(mk.TRI_SUP):
            counts["staged"] += int(staged[:, j].sum())
            counts["group_pairs"] += int(n_live[staged[:, j]].sum()) \
                * mk.TRI_BLOCK
            lanes = torch.nonzero(live & staged[lane_group, j],
                                  as_tuple=True)[0]
            if lanes.numel() == 0:
                continue
            blk = sup[lane_group[lanes]] * mk.TRI_SUP + j
            ok = slab(lanes, stream.aabb[blk],
                      torch.minimum(tri_t[lanes], best_t[lanes]))
            lanes, blk = lanes[ok], blk[ok]
            counts["lane_pairs"] += lanes.numel() * mk.TRI_BLOCK
            counts["warp_pairs"] += (torch.unique(warp[lanes]).numel() * 32
                                     * mk.TRI_BLOCK)
            _rows_lexmin(o, d, lanes, blk, geo, hit, t_min)
    return tuple(hit), counts


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_SYNC_KERNEL = None
_PERMUTE_KERNEL = None
SYNC_BUILD_LOG = ""
PERMUTE_BUILD_LOG = ""


def load_sync_kernel() -> ctypes.CDLL:
    """Build (at first use) and load csrc/meshtrace_sync.cu."""
    global _SYNC_KERNEL, SYNC_BUILD_LOG
    if _SYNC_KERNEL is None:
        from raytracing_in_one_weekend_tpu_torch.ops import cuda_build

        lib, SYNC_BUILD_LOG = cuda_build.build_library("meshtrace_sync.cu")
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        lib.rtiw_meshtrace_sync_group.argtypes = []
        lib.rtiw_meshtrace_sync_group.restype = ctypes.c_int
        if lib.rtiw_meshtrace_sync_group() != SYNC_GROUP:
            raise RuntimeError(
                f"meshtrace_sync.cu works in groups of "
                f"{lib.rtiw_meshtrace_sync_group()} lanes, SYNC_GROUP is "
                f"{SYNC_GROUP}")
        lib.rtiw_meshtrace_sync.argtypes = [
            p, i,  # state n
            p, i, p, p,  # sph s rec sky
            p, p, p, p,  # tri_geo tri_aabb tri_sup tri_rec
            i, i, i,  # tri_rows tri_blocks tri_supers
            u, u, i,  # seed salt depth
            ctypes.c_float, i, i,  # t_min has_diel sky_on
            p,  # stream
        ]
        lib.rtiw_meshtrace_sync.restype = ctypes.c_int
        lib.rtiw_meshtrace_visit_order.argtypes = [p, i, p, i, p, p, p]
        lib.rtiw_meshtrace_visit_order.restype = ctypes.c_int
        _SYNC_KERNEL = lib
    return _SYNC_KERNEL


def load_permute_kernel() -> ctypes.CDLL:
    """Build (at first use) and load csrc/meshtrace_permute.cu."""
    global _PERMUTE_KERNEL, PERMUTE_BUILD_LOG
    if _PERMUTE_KERNEL is None:
        from raytracing_in_one_weekend_tpu_torch.ops import cuda_build

        lib, PERMUTE_BUILD_LOG = cuda_build.build_library(
            "meshtrace_permute.cu")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rtiw_pair_compact.argtypes = [p, i, p, i, i, p]
        lib.rtiw_pair_compact.restype = ctypes.c_int
        lib.rtiw_restore.argtypes = [p, p, p, i, p]
        lib.rtiw_restore.restype = ctypes.c_int
        _PERMUTE_KERNEL = lib
    return _PERMUTE_KERNEL


def _check_state(name, state, contiguous=True):
    if (state.dim() != 2 or state.shape[0] != ST_ROWS
            or state.dtype != torch.float32 or state.stride(1) != 1
            or (contiguous and not state.is_contiguous())):
        raise ValueError(f"{name}: state has shape {tuple(state.shape)}, "
                         f"{state.dtype}, strides {state.stride()}; want "
                         f"({ST_ROWS}, N) float32 with unit column stride")
    if state.shape[1] >= 1 << 24:
        raise ValueError(f"{name}: {state.shape[1]} lanes; the float32 "
                         "lane-id row is exact below 2^24")


def _bounce_sync_cuda(state, seed, salt, bounce, tables, stream, *, t_min,
                      has_dielectrics, sky_on):
    global SYNC_LAUNCHES
    _check_state("bounce_sync", state)
    dev = state.device
    sph, rec, sky = tables
    s = sph.shape[0]
    if (tuple(sph.shape) != (s, 4) or tuple(rec.shape) != (s, mk.KERNEL_REC)
            or tuple(sky.shape) != (8,)
            or any(t.device != dev or not t.is_contiguous()
                   for t in (sph, rec, sky))):
        raise ValueError("bounce_sync: tables are not scene_tables' (S, 4), "
                         f"(S, 16), (8,) on {dev}")
    if s > mk.SPH_CULL_MIN:
        raise NotImplementedError(
            f"bounce_sync: {s} spheres; the kernel stages at most "
            f"{mk.SPH_CULL_MIN} in shared memory (ROADMAP queue 1, step "
            f"7.7b)")
    tri_args, tri_dims = mk._kernel_stream_args(stream, dev, "bounce_sync")
    lib = load_sync_kernel()
    err = lib.rtiw_meshtrace_sync(
        state.data_ptr(), state.shape[1], sph.data_ptr(), s, rec.data_ptr(),
        sky.data_ptr(), *tri_args, *tri_dims, int(seed) & _MASK32,
        int(salt) & _MASK32, int(bounce), float(t_min), int(has_dielectrics),
        int(sky_on), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"meshtrace_sync launch failed: cudaError {err}")
    SYNC_LAUNCHES += 1
    return state


def kernel_visit_order(state, sup):
    """The super order that each thread block of bounce_sync's kernel
    computes for its SYNC_GROUP lanes of `state` (on the card), read back
    by csrc/meshtrace_sync.cu's meshtrace_visit_order_kernel, which calls
    the same device function: (order, dist) as `tile_super_order(state,
    sup, SYNC_GROUP)` gives them.  For checks; not counted in
    SYNC_LAUNCHES."""
    _check_state("kernel_visit_order", state)
    if sup.shape[0] > mk.MAX_SUPERS:
        raise ValueError(f"kernel_visit_order: {sup.shape[0]} supers; the "
                         f"kernel orders at most {mk.MAX_SUPERS}")
    if (state.device.type != "cuda" or sup.device != state.device
            or sup.dim() != 2 or sup.shape[1] != 8
            or sup.dtype != torch.float32 or not sup.is_contiguous()):
        raise ValueError("kernel_visit_order: want the state and the (n_sup, "
                         "8) float32 super boxes on the same card")
    shape = (-(-state.shape[1] // SYNC_GROUP), sup.shape[0])
    order = torch.empty(shape, dtype=torch.int32, device=state.device)
    dist = torch.empty(shape, dtype=torch.float32, device=state.device)
    err = load_sync_kernel().rtiw_meshtrace_visit_order(
        state.data_ptr(), state.shape[1], sup.data_ptr(), sup.shape[0],
        order.data_ptr(), dist.data_ptr(),
        torch.cuda.current_stream(state.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"meshtrace_visit_order launch failed: cudaError "
                           f"{err}")
    return order, dist


def _pair_compact_cuda(state):
    global COMPACT_LAUNCHES
    _check_state("pair_compact", state, contiguous=False)
    n = state.shape[1]
    out = torch.empty((ST_ROWS, n), dtype=torch.float32, device=state.device)
    lib = load_permute_kernel()
    err = lib.rtiw_pair_compact(
        state.data_ptr(), state.stride(0), out.data_ptr(), n, n,
        torch.cuda.current_stream(state.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pair_compact launch failed: cudaError {err}")
    COMPACT_LAUNCHES += 1
    return out


def _restore_cuda(state):
    global RESTORE_LAUNCHES
    _check_state("restore", state)
    out = torch.empty_like(state)
    inv = torch.empty(state.shape[1], dtype=torch.int32, device=state.device)
    lib = load_permute_kernel()
    err = lib.rtiw_restore(
        state.data_ptr(), inv.data_ptr(), out.data_ptr(), state.shape[1],
        torch.cuda.current_stream(state.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"restore launch failed: cudaError {err}")
    RESTORE_LAUNCHES += 1
    return out


def _dispatch(name, state, cuda_fn, plain_fn, *args, **kwargs):
    if state.device.type == "cuda":
        return cuda_fn(state, *args, **kwargs)
    if state.device.type == "cpu":
        return plain_fn(state, *args, **kwargs)
    raise ValueError(f"{name}: unsupported device {state.device}")


def bounce_sync(state, seed, salt, bounce, tables, stream, *, t_min=0.0,
                has_dielectrics=True, sky_on=True):
    """One bounce of every live lane, in place (see
    `bounce_sync_reference`); `tables` from `scene_tables`, `stream` from
    megatrace.pack_tri_stream_tables.  CUDA: csrc/meshtrace_sync.cu."""
    return _dispatch("bounce_sync", state, _bounce_sync_cuda,
                     bounce_sync_reference, seed, salt, bounce, tables,
                     stream, t_min=t_min, has_dielectrics=has_dielectrics,
                     sky_on=sky_on)


def pair_compact(state):
    """The stable pair partition (see `pair_compact_reference`) into a new
    tensor; `state` may be a column slice.  CUDA: pair_compact_kernel of
    csrc/meshtrace_permute.cu."""
    return _dispatch("pair_compact", state, _pair_compact_cuda,
                     pair_compact_reference)


def restore(state):
    """The inverse permutation by the lane-id row (see
    `restore_reference`) into a new tensor.  CUDA: restore_index_kernel and
    the gather of csrc/meshtrace_permute.cu, which stop the device (the
    next synchronise raises) when the lane-id row is not a permutation."""
    return _dispatch("restore", state, _restore_cuda, restore_reference)


# ---------------------------------------------------------------------------
# The sampler
# ---------------------------------------------------------------------------


def _compact_pass(state, bounce: int):
    """The compaction after `bounce`: pairs from lane 0 after even bounces,
    from lane RAY_TILE after odd ones (the first tile and the tail stay),
    so that live lanes drift across pair boundaries (JAX :540-563)."""
    n = state.shape[1]
    if bounce % 2 == 0 or n < 3 * RAY_TILE:
        return pair_compact(state)
    inner = (n // RAY_TILE - 1) // 2 * PAIR
    return torch.cat([state[:, :RAY_TILE],
                      pair_compact(state[:, RAY_TILE:RAY_TILE + inner]),
                      state[:, RAY_TILE + inner:]], dim=1)


def sample_batch_sync(
    lane_count: torch.Tensor,  # (N,) pixel-order samples to take per pixel
    count_in: torch.Tensor,  # (N,) valid samples accumulated before
    camera,  # core.camera.Camera
    key: torch.Tensor,  # the batch's threefry key
    centers: torch.Tensor,  # (S, 3)
    radii: torch.Tensor,  # (S,)
    records: torch.Tensor,  # (S, 11 or 12) pack_sphere_records
    sky_bottom: torch.Tensor,
    sky_top: torch.Tensor,
    tri_stream_tables: mk.TriStream,
    *,
    width: int,
    height: int,
    samples: int,
    trace_depth: int,
    t_min: float = 0.0,
    has_dielectrics: bool = True,
    sky_on: bool = True,
    jitter: bool = True,
    wave_spp: int = 8,
    compact: bool = True,
) -> dict:
    """Accumulation deltas for one batch in PIXEL order, the contract of
    megatrace.sample_batch (color, count, normal, albedo, weight, rays,
    fallback AOVs), computed by the bounce-synchronous wave loop: waves of
    `wave_spp` samples per pixel, each with its camera rays (the wave key
    fold_in(key, wave): PIXEL_JITTER jitter, generate_rays' lens draws),
    `trace_depth` bounce launches and, with `compact`, the pair
    compaction after the first min(trace_depth - 1, 8) bounces and a
    restore.  A sample still alive after trace_depth bounces fails (valid
    stays 0).  The fallback AOVs are those of each pixel's sample of wave
    0, slot 0.  compact=False gives the same deltas bit for bit."""
    dev = centers.device
    n = width * height
    k_spp = max(1, min(wave_spp, samples))
    n_waves = -(-samples // k_spp)
    order, rank = (t.to(dev) for t in mk.morton_order(width, height))
    nw = n * k_spp
    nw_pad = -(-nw // RAY_TILE) * RAY_TILE

    pix = torch.repeat_interleave(order, k_spp)  # (nw,) pixel of each lane
    px_f = (pix % width).to(torch.float32)
    py_f = (pix // width).to(torch.float32)
    per_lane_cap = lane_count[pix].to(torch.int64)
    s_local = torch.arange(nw, device=dev) % k_spp
    lanes_pad = torch.arange(nw_pad, dtype=torch.float32, device=dev)
    seed = int(rng.randint(rng.purpose_key(key, rng.Purpose.SCATTER_A), (),
                           0, 2**31 - 1))
    tables = scene_tables(centers, radii, records, sky_bottom, sky_top)
    kw = dict(t_min=t_min, has_dielectrics=has_dielectrics, sky_on=sky_on)

    f32 = dict(dtype=torch.float32, device=dev)
    color, nsum, asum, fn, fa = (torch.zeros((3, n), **f32)
                                 for _ in range(5))
    cnt, wsum, rays_pix = (torch.zeros(n, **f32) for _ in range(3))
    n_passes = min(trace_depth - 1, _HALF_BAND) if compact else 0
    for w in range(n_waves):
        wkey = rng.fold_in(key, w)
        if jitter:
            ju = rng.uniform(rng.purpose_key(wkey, rng.Purpose.PIXEL_JITTER),
                             (nw, 2), device=dev)
            jx, jy = ju[:, 0], ju[:, 1]
        else:
            jx = jy = 0.5
        coords = torch.stack([(px_f + jx) / width, (py_f + jy) / height],
                             dim=-1)
        rays = camera_mod.generate_rays(camera, coords, wkey)
        state = torch.zeros((ST_ROWS, nw_pad), **f32)
        state[0:3, :nw] = rays.origin.T
        state[3:6, :nw] = rays.direction.T
        state[6:9] = 1.0  # throughput
        state[12, :nw] = (w * k_spp + s_local < per_lane_cap).to(
            torch.float32)
        state[LANE_ROW] = lanes_pad
        for b in range(trace_depth):
            state = bounce_sync(state, seed, wave_salt(w, b), b, tables,
                                tri_stream_tables, **kw)
            if b < n_passes:
                state = _compact_pass(state, b)
        if n_passes > 0:
            state = restore(state)

        res = state[:, :nw].reshape(ST_ROWS, n, k_spp)
        valid = res[13]
        color += torch.sum(res[9:12] * valid[None], dim=2)
        cnt += torch.sum(valid, dim=1)
        nsum += torch.sum(res[14:17] * valid[None], dim=2)
        asum += torch.sum(res[17:20] * valid[None], dim=2)
        wsum += torch.sum(res[21] * valid, dim=1)
        rays_pix += torch.sum(res[RAYS_ROW], dim=1)
        if w == 0:
            # each pixel's first sample of this batch, valid or not
            # (SampleBatchJob.cs:146-151)
            first = ((count_in[order] < 0.5) & (lane_count[order] > 0)).to(
                torch.float32)[None]
            fn += first * res[14:17, :, 0]
            fa += first * res[17:20, :, 0]

    # Morton -> pixel order
    return {
        "color": color[:, rank].T,
        "count": cnt[rank],
        "normal": nsum[:, rank].T,
        "albedo": asum[:, rank].T,
        "weight": wsum[rank],
        "rays": rays_pix[rank].to(torch.int32),
        "fallback_normal": fn[:, rank].T,
        "fallback_albedo": fa[:, rank].T,
    }
