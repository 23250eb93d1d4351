"""Nearest-sphere selection: the CUDA kernels and their plain versions.

Counterpart of the JAX package's `ops/pallas_sphere.py`:

* `sphere_select` (its `_kernel`): per ray the nearest entry distance,
  the winner's index and its exit distance.  A detached selection: the
  wavefront's `intersect.nearest_hit` re-evaluates the winner with
  gradients (ops/geometry.sphere_hit_single).
* `sphere_select_full` (its `_kernel_full`): the nearest entry and exit
  distances, the winner's normal and its 16-column record (the payload
  columns, the centre, 1/r), for the forward wavefront's fast arm.
  Blocks of `BLOCK` rays with no active ray get the miss sentinels and a
  zero record; on a miss in a live block the record is sphere 0's (the
  argmin of an all-BIG row), as in the JAX kernel.

Each has a plain PyTorch version (`*_reference`), a hand-written CUDA
kernel in `csrc/sphere_select.cu`, and a wrapper that runs the plain
version on CPU tensors and launches the kernel (or raises) on CUDA
tensors, counting launches in `LAUNCHES`.  The plain versions compute the
kernels' operations in the kernels' order, so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from raytracing_in_one_weekend_tpu_torch.ops.megatrace import sweep_tables

BIG = 1e30
REC_COLS = 16  # payload 0-11 | centre 12-14 | 1/r 15
PAYLOAD_COLS = 12
BLOCK = 128  # rays per CUDA block: the granularity of the inactive skip

LAUNCHES = {"sphere_select": 0, "sphere_select_full": 0}


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _sweep_reference(origin, direction, sph, t_min, chunk_lanes=None):
    """(best_t, best_idx, exit_of_best) per ray: the kernels' quadratic,
    first index on ties, index 0 and BIG on a miss."""
    n, s = origin.shape[0], sph.shape[0]
    if chunk_lanes is None:
        budget = (1 << 25) if origin.device.type == "cuda" else (1 << 22)
        chunk_lanes = max(256, budget // max(s, 1))
    cx, cy, cz, cmr2 = (sph[:, k:k + 1] for k in range(4))  # (S, 1)
    best_t = torch.empty(n, dtype=torch.float32, device=origin.device)
    best_idx = torch.empty(n, dtype=torch.int64, device=origin.device)
    best_exit = torch.empty_like(best_t)
    for c0 in range(0, n, chunk_lanes):
        o = origin[c0:c0 + chunk_lanes]
        d = direction[c0:c0 + chunk_lanes]
        ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
        dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
        a = (dx * dx + dy * dy) + dz * dz
        o_dot_d = (ox * dx + oy * dy) + oz * dz
        o_sq = (ox * ox + oy * oy) + oz * oz
        inv_a = 1.0 / a
        b = o_dot_d - ((dx * cx + dy * cy) + dz * cz)  # (S, C)
        c = (o_sq - 2.0 * ((ox * cx + oy * cy) + oz * cz)) + cmr2
        disc = b * b - a * c
        del c
        # roots only where the discriminant is positive (few pairs); every
        # other entry stays BIG
        s_idx, l_idx = torch.nonzero(disc > 0.0, as_tuple=True)
        bb = b[s_idx, l_idx]
        sq = torch.sqrt(disc[s_idx, l_idx])
        ia = inv_a[l_idx]
        t_near = (-bb - sq) * ia
        t_far = (-bb + sq) * ia
        far_ok = t_far > t_min
        t_entry = torch.full_like(disc, BIG)
        t_exit = torch.full_like(disc, BIG)
        t_entry[s_idx, l_idx] = torch.where(
            t_near > t_min, t_near, torch.where(far_ok, t_far, BIG))
        t_exit[s_idx, l_idx] = torch.where(far_ok, t_far, BIG)
        bt, bi = torch.min(t_entry, dim=0)
        best_t[c0:c0 + chunk_lanes] = bt
        best_idx[c0:c0 + chunk_lanes] = bi
        best_exit[c0:c0 + chunk_lanes] = torch.gather(t_exit, 0,
                                                      bi[None])[0]
    return best_t, best_idx, best_exit


def sphere_select_reference(origin, direction, centers, radii,
                            t_min: float = 0.0):
    """Plain version of `sphere_select`: (best_t, best_idx int32,
    exit_t), each (N,)."""
    t, idx, exit_t = _sweep_reference(
        origin, direction, sweep_tables(centers, radii)[0], t_min)
    exit_t = torch.where(t < BIG, exit_t, BIG)
    return t, idx.to(torch.int32), exit_t


def _block_active(active: torch.Tensor) -> torch.Tensor:
    """Per ray: does its block of BLOCK rays hold an active ray?"""
    n = active.shape[0]
    pad = -n % BLOCK
    a = torch.nn.functional.pad(active.to(torch.bool), (0, pad))
    return a.reshape(-1, BLOCK).any(dim=1).repeat_interleave(BLOCK)[:n]


def sphere_select_full_reference(origin, direction, centers, radii, records,
                                 active=None, t_min: float = 0.0,
                                 want_exit: bool = False):
    """Plain version of `sphere_select_full` without the normal: (best_t,
    exit_t, rec (N, 16))."""
    n = origin.shape[0]
    sph, rec_tab = sweep_tables(centers, radii, records)
    t, idx, exit_t = _sweep_reference(origin, direction, sph, t_min)
    exit_t = (torch.where(t < BIG, exit_t, BIG) if want_exit
              else torch.full_like(t, BIG))
    rec = rec_tab[idx]
    if active is not None:
        live = _block_active(active)
        t = torch.where(live, t, BIG)
        exit_t = torch.where(live, exit_t, BIG)
        rec = torch.where(live[:, None], rec, 0.0)
    assert rec.shape == (n, REC_COLS)
    return t, exit_t, rec


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_KERNEL = None
BUILD_LOG = ""


def load_kernel() -> ctypes.CDLL:
    """Build (at first use) and load csrc/sphere_select.cu."""
    global _KERNEL, BUILD_LOG
    if _KERNEL is None:
        from raytracing_in_one_weekend_tpu_torch.ops import cuda_build

        lib, BUILD_LOG = cuda_build.build_library("sphere_select.cu")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rtiw_sphere_select.argtypes = [p, p, p, p, p, p, i, i, f, p]
        lib.rtiw_sphere_select.restype = ctypes.c_int
        lib.rtiw_sphere_select_full.argtypes = [p, p, p, p, p, p, p, p,
                                                i, i, f, i, p]
        lib.rtiw_sphere_select_full.restype = ctypes.c_int
        _KERNEL = lib
    return _KERNEL


def _rays_f32(name, origin, direction, centers, radii):
    n, s = origin.shape[0], centers.shape[0]
    shapes = dict(origin=(origin, (n, 3)), direction=(direction, (n, 3)),
                  centers=(centers, (s, 3)), radii=(radii, (s,)))
    for what, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, "
                             f"want {shape}")
        if t.device != centers.device:
            raise ValueError(f"{name}: {what} is on {t.device}, centers "
                             f"on {centers.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {what} must be float32")
    return origin.contiguous(), direction.contiguous()


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _sphere_select_cuda(origin, direction, centers, radii, t_min):
    origin, direction = _rays_f32("sphere_select", origin, direction,
                                  centers, radii)
    n, s = origin.shape[0], centers.shape[0]
    dev = centers.device
    lib = load_kernel()
    sph, _ = sweep_tables(centers, radii)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    exit_t = torch.empty(n, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _check(lib.rtiw_sphere_select(
        origin.data_ptr(), direction.data_ptr(), sph.data_ptr(),
        t.data_ptr(), idx.data_ptr(), exit_t.data_ptr(), n, s,
        float(t_min), stream), "sphere_select")
    LAUNCHES["sphere_select"] += 1
    return t, idx, exit_t


def _sphere_select_full_cuda(origin, direction, centers, radii, records,
                             active, t_min, want_exit):
    origin, direction = _rays_f32("sphere_select_full", origin, direction,
                                  centers, radii)
    n, s = origin.shape[0], centers.shape[0]
    dev = centers.device
    if (records.shape[0] != s or records.shape[1] > PAYLOAD_COLS
            or records.device != dev):
        raise ValueError("sphere_select_full: records must be (S, <=12) "
                         "on the centers' device")
    lib = load_kernel()
    sph, rec_tab = sweep_tables(centers, radii, records.to(torch.float32))
    if active is None:
        act = torch.ones(n, dtype=torch.uint8, device=dev)
    else:
        if tuple(active.shape) != (n,) or active.device != dev:
            raise ValueError("sphere_select_full: active must be (N,) on "
                             "the centers' device")
        act = active.to(torch.uint8).contiguous()
    t = torch.empty(n, dtype=torch.float32, device=dev)
    exit_t = torch.empty(n, dtype=torch.float32, device=dev)
    rec = torch.empty((n, REC_COLS), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _check(lib.rtiw_sphere_select_full(
        origin.data_ptr(), direction.data_ptr(), act.data_ptr(),
        sph.data_ptr(), rec_tab.data_ptr(), t.data_ptr(), exit_t.data_ptr(),
        rec.data_ptr(), n, s, float(t_min), int(want_exit), stream),
        "sphere_select_full")
    LAUNCHES["sphere_select_full"] += 1
    return t, exit_t, rec


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def sphere_select(
    origin: torch.Tensor,  # (N, 3)
    direction: torch.Tensor,  # (N, 3)
    centers: torch.Tensor,  # (S, 3)
    radii: torch.Tensor,  # (S,)
    t_min: float = 0.0,
):
    """Nearest-sphere selection: (best_t, best_idx int32, exit_t), each
    (N,); BIG, 0 and BIG on a miss.  Selection only: no gradients."""
    with torch.no_grad():
        if centers.device.type == "cuda":
            return _sphere_select_cuda(origin, direction, centers, radii,
                                       t_min)
        if centers.device.type == "cpu":
            return sphere_select_reference(origin, direction, centers, radii,
                                           t_min)
    raise ValueError(f"sphere_select: unsupported device {centers.device}")


def sphere_select_full(
    origin: torch.Tensor,  # (N, 3)
    direction: torch.Tensor,  # (N, 3)
    centers: torch.Tensor,  # (S, 3)
    radii: torch.Tensor,  # (S,)
    records: torch.Tensor,  # (S, R <= 12) per-sphere payload
    active: torch.Tensor | None = None,  # (N,) bool
    t_min: float = 0.0,
    want_exit: bool = False,
):
    """Nearest-sphere selection with the winner's record and normal:
    (best_t (N,), exit_t (N,), normal (N, 3), rec (N, 16)).  Not
    differentiable; the normal is (p - centre) / r with p = o + t d,
    computed here from the record."""
    with torch.no_grad():
        if centers.device.type == "cuda":
            t, exit_t, rec = _sphere_select_full_cuda(
                origin, direction, centers, radii, records, active, t_min,
                want_exit)
        elif centers.device.type == "cpu":
            t, exit_t, rec = sphere_select_full_reference(
                origin, direction, centers, radii, records, active, t_min,
                want_exit)
        else:
            raise ValueError(
                f"sphere_select_full: unsupported device {centers.device}")
        point = origin + t[:, None] * direction
        normal = (point - rec[:, 12:15]) * rec[:, 15:16]
    return t, exit_t, normal, rec
