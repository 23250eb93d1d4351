"""Nearest-triangle selection: the CUDA kernel and its plain version
(counterpart of the JAX package's ops/pallas_triangle.py).

`triangle_select` is its `_kernel`: per ray the nearest Möller–Trumbore
hit t and the triangle's row, detached from the gradient; the
differentiable wavefront's `intersect.nearest_hit` then evaluates the
winner again with gradients (ops/geometry.triangle_hit_single).  It takes
at most MAX_TRI_PAD triangles (`fits_vmem`), as the JAX kernel does; the
wavefront takes the brute force above that.

Rays go in tiles of RAY_TILE: a tile with no active ray gets (BIG, 0), and
the inactive rays of a live tile are swept like the others, as in the JAX
kernel, so the outputs match it lane for lane.  On a miss the row is 0.

* `triangle_select_reference` is the plain PyTorch version, chunked over
  rays so the (triangles, rays) temporaries stay bounded;
* `csrc/triangle_select.cu` is the hand-written CUDA kernel;
* `triangle_select` is the wrapper: the plain version on CPU tensors, the
  kernel (or an error) on CUDA tensors, launches counted in `LAUNCHES`.
Both compute `ops/megatrace.moller_trumbore`'s operations in its order,
so they agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from raytracing_in_one_weekend_tpu_torch.ops.megatrace import (
    BIG,
    moller_trumbore,
)

RAY_TILE = 256  # the JAX kernel's tile: the granularity of the inactive skip
TRI_PAD = 128
MAX_TRI_PAD = 4096

LAUNCHES = 0  # CUDA launches made by triangle_select


def fits_vmem(triangle_count: int) -> bool:
    """Does the selection kernel take this many triangles (the JAX
    package's rule: at most MAX_TRI_PAD after padding)?"""
    return -(-triangle_count // TRI_PAD) * TRI_PAD <= MAX_TRI_PAD


def _tile_active(active: torch.Tensor) -> torch.Tensor:
    """Per ray: does its tile of RAY_TILE rays hold an active ray?"""
    n = active.shape[0]
    a = torch.nn.functional.pad(active.to(torch.bool), (0, -n % RAY_TILE))
    return a.reshape(-1, RAY_TILE).any(dim=1).repeat_interleave(
        RAY_TILE)[:n]


def triangle_select_reference(origin, direction, edge_a, edge_b, vert0,
                              active=None, t_min: float = 0.0,
                              chunk_rays: int | None = None):
    """Plain version of `triangle_select`: (best_t (N,), best_idx (N,)
    int32)."""
    n, t_rows = origin.shape[0], edge_a.shape[0]
    dev = origin.device
    if chunk_rays is None:
        budget = (1 << 25) if dev.type == "cuda" else (1 << 21)
        chunk_rays = max(RAY_TILE, budget // max(t_rows, 1))
    cols = [tab[:, k:k + 1] for tab in (edge_a, edge_b, vert0)
            for k in range(3)]  # (T, 1) columns
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    best_idx = torch.zeros(n, dtype=torch.int64, device=dev)
    for c0 in range(0, n if t_rows else 0, chunk_rays):
        o = origin[c0:c0 + chunk_rays]
        d = direction[c0:c0 + chunk_rays]
        t, _, _ = moller_trumbore(
            (o[:, 0], o[:, 1], o[:, 2]), (d[:, 0], d[:, 1], d[:, 2]),
            cols[0:3], cols[3:6], cols[6:9], t_min)
        best_t[c0:c0 + chunk_rays], best_idx[c0:c0 + chunk_rays] = \
            torch.min(t, dim=0)
    if active is not None:
        live = _tile_active(active)
        best_t = torch.where(live, best_t, BIG)
        best_idx = torch.where(live, best_idx, 0)
    return best_t, best_idx.to(torch.int32)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

_KERNEL = None
BUILD_LOG = ""


def load_kernel() -> ctypes.CDLL:
    """Build (at first use) and load csrc/triangle_select.cu."""
    global _KERNEL, BUILD_LOG
    if _KERNEL is None:
        from raytracing_in_one_weekend_tpu_torch.ops import cuda_build

        lib, BUILD_LOG = cuda_build.build_library("triangle_select.cu")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rtiw_triangle_select.argtypes = [p, p, p, p, p, p, i, i,
                                             ctypes.c_float, p]
        lib.rtiw_triangle_select.restype = ctypes.c_int
        _KERNEL = lib
    return _KERNEL


def _triangle_select_cuda(origin, direction, edge_a, edge_b, vert0, active,
                          t_min):
    global LAUNCHES
    dev = edge_a.device
    n, t_rows = origin.shape[0], edge_a.shape[0]
    shapes = dict(origin=(origin, (n, 3)), direction=(direction, (n, 3)),
                  edge_a=(edge_a, (t_rows, 3)), edge_b=(edge_b, (t_rows, 3)),
                  vert0=(vert0, (t_rows, 3)))
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"triangle_select: {name} has shape "
                             f"{tuple(t.shape)}, want {shape}")
        if t.device != dev:
            raise ValueError(f"triangle_select: {name} is on {t.device}, "
                             f"edge_a on {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"triangle_select: {name} must be float32")
    if not fits_vmem(t_rows):
        raise ValueError(f"triangle_select: {t_rows} triangles; the kernel "
                         f"takes at most {MAX_TRI_PAD}")
    if active is None:
        act = torch.ones(n, dtype=torch.uint8, device=dev)
    else:
        if tuple(active.shape) != (n,) or active.device != dev:
            raise ValueError("triangle_select: active must be (N,) on the "
                             "triangles' device")
        act = active.to(torch.uint8).contiguous()
    lib = load_kernel()
    tri = torch.cat([edge_a, edge_b, vert0], dim=1).contiguous()
    origin, direction = origin.contiguous(), direction.contiguous()
    t = torch.empty(n, dtype=torch.float32, device=dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    err = lib.rtiw_triangle_select(
        origin.data_ptr(), direction.data_ptr(), act.data_ptr(),
        tri.data_ptr(), t.data_ptr(), idx.data_ptr(), n, t_rows,
        float(t_min), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"triangle_select launch failed: cudaError {err}")
    LAUNCHES += 1
    return t, idx


def triangle_select(
    origin: torch.Tensor,  # (N, 3)
    direction: torch.Tensor,  # (N, 3)
    edge_a: torch.Tensor,  # (T, 3)
    edge_b: torch.Tensor,  # (T, 3)
    vert0: torch.Tensor,  # (T, 3)
    active: torch.Tensor | None = None,  # (N,) bool
    t_min: float = 0.0,
):
    """Nearest-triangle selection: (best_t (N,), best_idx (N,) int32);
    BIG and 0 on a miss.  Selection only: no gradients."""
    args = (origin, direction, edge_a, edge_b, vert0, active, t_min)
    with torch.no_grad():
        if edge_a.device.type == "cuda":
            return _triangle_select_cuda(*args)
        if edge_a.device.type == "cpu":
            return triangle_select_reference(*args)
    raise ValueError(f"triangle_select: unsupported device {edge_a.device}")
