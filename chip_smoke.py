"""GPU smoke run of the PyTorch port's main paths: the forward render, the
differentiable render (forward with tape, backward kernel, trainer) and
the wavefront integrator (per-ray megatrace, fused sphere selection, the
AOV-gradient graft), on the book cover and on the `mesh_showcase` mesh
scene (triangle selection, the triangle arms of the batch and backward
kernels), and the streamed meshes `mesh_large` and `mesh_huge` (the batch
kernel's streamed arm with Morton lanes, the bounce-synchronous sampler's
bounce, pair compaction and restore).

    python3 chip_smoke.py

Needs one CUDA card.  Phases, each of which raises on failure:
  1. report the card (nvidia-smi name and power limit) and versions;
  2. build the seven kernel sources (csrc/megatrace_batch.cu,
     csrc/megatrace_bwd.cu, csrc/sphere_select.cu, csrc/megatrace_wave.cu,
     csrc/triangle_select.cu, csrc/meshtrace_sync.cu,
     csrc/meshtrace_permute.cu), one nvcc each, all at once; print
     ptxas's register and spill lines;
  3. compare the batch kernel with its plain PyTorch version on the card
     (cover, 128x128, 8 spp, depth 8, two seeds): lanes whose winner tape,
     sample count and ray count are identical and whose float channels
     agree within atol=rtol=1e-4 must be >= 99%;
  4. drive the forward main path, `render.renderer.render_batch` on the
     book cover at 512x512, depth 8, 64 spp per batch (1 warm-up + 5 timed
     batches, median MRays/s); the image must be finite with mean > 0.2,
     and the batch kernel's launch count over the run must be > 0.  Then
     compare kernel and plain version, with the same criterion, on the
     inputs two main-path batches give the kernel: a first batch (count_in
     0) and an adaptive one (per-pixel lane counts, count_in > 0).  Then
     the depth-35, 128 spp forward;
  5. time the batch kernel and its plain version at 512x512, depth 8,
     4 spp, and compare their outputs (count, rays, floats) lane by lane;
  6. per-iteration adjoint check: on the states the plain replay passes
     through (cover, 64x64, 4 spp, depth 8), every live iteration (printed
     in full: the first, the first later one with regen, dielectric and
     sky lanes, and the last live one), the backward kernel's
     one-iteration VJP against torch.autograd of the plain
     replay_iteration on every lane; each cotangent tensor
     (megatrace_bwd.STEP_COTANGENTS: every state vector, leaf, the camera
     row and the sky colors) within 5e-4 of its max abs;
  7. backward kernel vs plain version (autograd over the plain replay) on
     the cover, 128x128: 8 spp, depth 8, two seeds, and 4 spp, depth 35
     (blocks of 35 iterations through the kernel's history); probe loss
     sum(color / max(count, 1) * cos(0.37 i)): camera_row, centers,
     radii, records, sky_bottom and sky_top each within 5e-4 of the leaf's
     max abs; the replay's primal equal to the kernel's within 1e-4 on
     >= 99% of lanes (replay drift);
  8. the differentiable main path, bench.py's training reading through
     the port's entry points: render_image(differentiable=True),
     mean((color - target)^2), .backward() to the sphere centers, on the
     cover at 512x512, 64 spp, depth 8 (1 warm-up + 3 timed steps, median
     MRays/s counting the forward rays of the same seed, as bench.py
     does), then at depth 35, 128 spp; gradients finite and nonzero, both
     kernels launched, peak device memory printed.  The backward kernel is
     also held to its plain version, as in phase 7, on the inputs the last
     depth-8 step gave it;
  9. the trainer: diff.inverse.optimize, 10 Adam steps on three_spheres
     with perturbed centers at 128x128 (finite losses, backward kernel
     launched), then 10 steps on its albedos from 0.5: the last loss
     below half the first, the albedo error below half its start;
 10. time the backward kernel and its plain version at 512x512, depth 8,
     4 spp, and compare their gradients;
 11. the wavefront's kernels against their plain versions on the card:
     sphere_select and sphere_select_full on random cases (512x37, 256x21,
     1024x5 with inactive blocks) and on one bounce of 512x512 cover
     camera rays (t, index, exit and record identical on >= 99% of lanes,
     expected 1.0), timed there; the per-ray megatrace on 512x512 cover
     camera rays at depth 8 and 35 (valid and ray count identical, floats
     within 1e-4, >= 99% of lanes), timed at depth 8.  Their kernel times
     are the kernels' own device time under torch.profiler (`kernel_ms`);
     a wrapper call, timed by CUDA events, also pays its host's packing;
 12. the wavefront's full-width paths, each with its launch counts set to
     0 just before and read just after (each must be > 0), finite outputs
     and MRays/s: (a) integrator.trace(differentiable=False) on 512x512
     cover camera rays, depth 8: the `mega` arm (megatrace_wave.cu);
     (b) render_batch(differentiable=False) on the cover at 512x512, 64 spp,
     depth 8 with the batch kernel refused as `bench_matrix.py --wavefront`
     refuses it (megatrace.scene_eligible patched to False): the `fast`
     arm, sphere_select_full on every bounce, median of 3 batches after a
     warm-up, and the device's busy share of a 1-sample batch under
     torch.profiler; (c) the AOV step: render_image(differentiable=True)
     on the cover at 512x512, 64 spp, depth 8, loss mean((color -
     target)^2) + mean(normal^2) + mean(albedo^2), .backward() to the
     sphere centers and the texture colors (the albedos): step time, peak
     memory and sphere_select launches (the graft's nearest_hit); then a
     photometric step, in which sphere_select must not launch; the
     backward of a gather of 90%-equal rows by advanced indexing and by
     index_select (why the graft uses the latter); the device's busy share
     of a 1-sample AOV step; then the AOV gradient at 128x128, 8 spp
     against the same computed by the plain versions (the same inputs on
     the CPU), each leaf within 5e-4 of its max abs;
 13. triangle_select against its plain version on the card: random cases
     (with inactive 256-ray tiles, up to TRI_MAX triangles) and 512x512
     mesh_showcase camera rays and one bounce of them (t and row identical
     on >= 99% of lanes), timed on the camera rays (`kernel_ms`);
 14. the batch kernel's triangle arm against its plain version, by phase
     3's criterion: mesh_showcase at 128x128, 8 spp, depth 8, two seeds,
     and a two-block mesh (icosphere(2) and a cube, 332 triangles); then
     both timed at 512x512, depth 8, 4 spp;
 15. the forward mesh path: render_batch on mesh_showcase at 512x512,
     depth 8, 64 spp per batch, 1 warm-up and 5 timed batches (median
     MRays/s), the image finite and the batch kernel launched;
 16. the wavefront mesh path: the batch kernel refused as in phase 12b,
     512x512, depth 8, 16 spp per batch, median of 3 after a warm-up;
     triangle_select and sphere_select must launch;
 17. the differentiable mesh path: (a) render_image(differentiable=True)
     on mesh_showcase at 512x512, 64 spp, depth 8, gradients to the soup
     vertices (set_triangle_vertices) and the sphere centres, median
     fwd+bwd MRays/s of 3 steps after a warm-up; (b) the one-iteration
     VJP on every live iteration of a 64x64 batch with triangle winners;
     (c) the backward kernel against its plain version at 128x128, depth 8
     and depth 35, each leaf (the triangle tables too) within 5e-4; (d)
     an AOV step (normal and albedo terms, 512x512, 16 spp, depth 8) whose
     graft launches triangle_select; (e) 10 optimize steps on the vertices
     of one smooth triangle (finite losses; without the silhouette term,
     ROADMAP step 12, they need not converge), then 10 on its albedo from
     0.5, which must (last loss below half the first, the albedo error
     below half its start); (f) the backward kernel and its plain version
     timed at 512x512, depth 8, 4 spp;
 18. the CLI (`python -m raytracing_in_one_weekend_tpu_torch`'s `main`)
     renders `--scene triangle` and `--scene mesh_showcase` on the card at
     256x256, 16 spp, depth 8 into a temporary directory of the checkout:
     exit code 0, a PNG, the batch kernel launched; then `--scene
     mesh_large` (the batch kernel) and `--scene mesh_huge` (the sync
     sampler's three kernels) at 256x256, 8 spp;
 19. the sync sampler's kernels against their plain versions:
     pair_compact and restore on random (24, N) states (2, 3, 4 and 1024
     tiles; all, half and no lanes alive; +-0.0 in the directions) and on
     the states of a mesh_huge wave, bit-identical; bounce_sync on bounces
     0 and 3 of 128x128 mesh_huge lanes (8 spp) and bounce 1 of the
     512x512 wave: the flags, ray count and lane id identical and the
     floats within 1e-4 on >= 99% of lanes.  Each timed on the 512x512
     wave (2,097,152 lanes) by CUDA events: bounce_sync one launch at a
     time on fresh copies, on every bounce of the wave, beside the
     triangle and AABB tests of its traversal model per lane, per warp and
     per group (the model's visit order first held equal to the one the
     kernel's blocks compute, read back); its bound the lower of those
     from the model's and from the plain version's counts, the plain
     version's index-order bound printed beside it; the permutes over 20
     launches, restore and `index_copy_` in turns;
 20. the batch kernel's streamed arm against its plain version by phase
     3's criterion (no tape: streamed meshes have none): mesh_large at
     128x128, 8 spp, depth 8, two seeds, Morton lanes; then both timed at
     512x512, depth 8, 4 spp;
 21. the forward streamed-mesh paths: render_batch at 512x512, depth 8, 64
     spp per batch, 1 warm-up and 5 timed batches (median MRays/s), image
     finite, on mesh_large (the batch kernel's streamed arm, no sync
     kernel) and on mesh_huge (bounce_sync, pair_compact and restore, no
     batch kernel); then the other route on each scene, 3 batches, by
     calling megatrace.sample_batch and meshtrace.sample_batch_sync
     directly; then sample_batch_sync with its kernels against it with
     its plain versions, mesh_huge 128x128, 8 spp, depth 8: count and
     rays identical and floats within 1e-4 on >= 99% of pixels.
MRays/s counts every bounce of every sample as one ray, with the ray
count the kernels themselves report.  Each kernel's bound is the larger of
its operations over the FP32 peak (67 TFLOP/s) and its bytes (each input
read once, each output written once) over 3.35 TB/s, counted from this
run's inputs (see `bound`).  The last line is the JSON status.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from raytracing_in_one_weekend_tpu_torch import __main__ as cli
from raytracing_in_one_weekend_tpu_torch.core import camera as camera_mod
from raytracing_in_one_weekend_tpu_torch.core import materials, rng
from raytracing_in_one_weekend_tpu_torch.diff import inverse
from raytracing_in_one_weekend_tpu_torch.diff import params as params_mod
from raytracing_in_one_weekend_tpu_torch.models import book_scenes, meshes
from raytracing_in_one_weekend_tpu_torch.ops import megatrace
from raytracing_in_one_weekend_tpu_torch.ops import megatrace_bwd
from raytracing_in_one_weekend_tpu_torch.ops import megatrace_replay
from raytracing_in_one_weekend_tpu_torch.ops import meshtrace
from raytracing_in_one_weekend_tpu_torch.ops import sphere_select
from raytracing_in_one_weekend_tpu_torch.ops import triangle_select
from raytracing_in_one_weekend_tpu_torch.render import (
    film, integrator, renderer,
)
from raytracing_in_one_weekend_tpu_torch.scene.scene import SceneBuilder
from raytracing_in_one_weekend_tpu_torch.utils.config import CameraSettings

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = 5e-4  # of each cotangent's / leaf's max abs
LEAVES = ("camera_row", "centers", "radii", "records", "sky_bottom",
          "sky_top")
FLOAT_CHANNELS = ("color", "normal", "albedo", "weight", "fallback_normal",
                  "fallback_albedo")
WAVE_FLOATS = ("radiance", "aov_normal", "aov_albedo", "events")

# Roofline of an H100 SXM (NVIDIA's data sheet, at the 700 W limit)
PEAK_FP32 = 67e12  # FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12  # B/s of HBM3
# Operation counts, from the kernels' code (a fused multiply-add counts 2):
SWEEP_FLOPS = 18  # per (ray, sphere) pair of the sweep: two 3-dots (10),
#   b (1), c (3), the discriminant (3), its test (1); the roots only where
#   it is positive, which is rare
SHADE_FLOPS = 250  # per bounce of a lane: winner normal, scatter (two
#   hemisphere draws, rough normal, Fresnel, Smith masking, reflection,
#   dielectric), sky, fold, AOV capture, events and advance
BWD_FLOPS = 3 * SHADE_FLOPS  # per live iteration of the backward: the
#   step once forward and its VJP (about twice the forward), the least a
#   reverse sweep from the winner tape needs
MT_FLOPS = 56  # per (ray, triangle) pair of Möller–Trumbore
#   (megatrace_common.cuh): two cross products (18), three 3-dots and
#   their scalings (18), det and its guarded division (5), the edge vector
#   (3), the hit test (7), the select (1) and the running minimum (1)
SLAB_FLOPS = 26  # per (ray, AABB) slab test (megatrace_bounce.cuh
#   slab_may): 6 differences, 6 products, 10 min/max, the bound's min and
#   max and the two comparisons


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """(least milliseconds on the card, "operations" or "bytes")."""
    t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def batch_inputs(scene, cs, width, height, dev):
    cam = camera_mod.make_camera(
        cs.origin, cs.look_at, cs.up, cs.vertical_fov, width / height,
        aperture=cs.aperture, focus_distance=cs.focus_distance, device=dev,
    )
    records = megatrace.pack_sphere_records(
        scene, materials.pack_materials(scene)
    )
    return cam, (
        megatrace.pack_camera_row(cam, width, height),
        scene.spheres.center, scene.spheres.radius, records,
        scene.environment.sky_bottom, scene.environment.sky_top,
    )


def lane_agreement(a: dict, b: dict) -> tuple[float, float]:
    """(share of agreeing lanes, max abs float error on those lanes).

    A lane agrees when its winner tape (where both carry one), sample
    count and ray count are identical and its float channels agree within
    TOL."""
    same = (a["count"] == b["count"]) & (a["rays"] == b["rays"])
    if "tape" in a and "tape" in b:
        same &= torch.all(a["tape"] == b["tape"], dim=0)
    for k in FLOAT_CHANNELS:
        close = torch.isclose(a[k], b[k], **TOL)
        same &= close.reshape(close.shape[0], -1).all(dim=1)
    if not bool(same.any()):
        return 0.0, float("inf")
    err = max(float((a[k] - b[k]).abs().reshape(same.shape[0], -1)[same]
                    .max()) for k in FLOAT_CHANNELS)
    return float(same.float().mean()), err


def check_parity(label: str, args: tuple, kwargs: dict,
                 tape: bool = True) -> tuple[float, float]:
    """Run the kernel and the plain version on the same inputs, with the
    winner tape unless `tape` is False; raise unless >= 99% of lanes
    agree."""
    kwargs = dict(kwargs, want_tape=tape)
    before = megatrace.LAUNCHES
    got = megatrace.sample_batch(*args, **kwargs)
    torch.cuda.synchronize()
    if megatrace.LAUNCHES != before + 1:
        raise RuntimeError("sample_batch did not launch the kernel")
    want = megatrace.sample_batch_reference(*args, **kwargs)
    share, err = lane_agreement(got, want)
    print(f"parity {label}: {share:.6f} of lanes identical "
          f"({'tape, ' if tape else ''}count, rays; floats within 1e-4), "
          f"max abs err {err:.3g}")
    if share < 0.99:
        raise RuntimeError(f"kernel/plain agreement {share} < 0.99 ({label})")
    return share, err


@contextlib.contextmanager
def recorded_calls(module, name: str, copy: bool = True):
    """Keep the inputs (a copy of each tensor when `copy`) and the result
    of every `module.name` call made inside the block (callers read the
    name at call time)."""
    calls = []
    inner = getattr(module, name)

    def recording(*args, **kwargs):
        kept = tuple(a.clone() if copy and torch.is_tensor(a) else a
                     for a in args)
        result = inner(*args, **kwargs)
        calls.append((kept, dict(kwargs), result))
        return result

    setattr(module, name, recording)
    try:
        yield calls
    finally:
        setattr(module, name, inner)


def time_batch(fn, *args, repeats: int, **kwargs) -> tuple[float, dict]:
    """(milliseconds per call from CUDA events after one warm-up call,
    the last call's outputs)."""
    fn(*args, **kwargs)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        out = fn(*args, **kwargs)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats, out


def probe_cotangents(color, count):
    """Cotangents of (color_sum, count) for the probe loss
    sum(color / max(count, 1) * cos(0.37 i))."""
    n = color.shape[0]
    i = torch.arange(n * 3, dtype=torch.float32, device=color.device)
    probe = torch.cos(i.reshape(n, 3) * 0.37)
    safe = torch.clamp(count, min=1.0)
    cot_count = torch.where(count >= 1.0,
                            -(color * probe).sum(1) / (safe * safe), 0.0)
    return probe / safe[:, None], cot_count


def leaf_errors(got, want, names=LEAVES) -> tuple[float, float]:
    """(max abs error, max error relative to the leaf's max abs) over the
    leaves `names`; raises unless each is within GRAD_TOL."""
    if not len(got) == len(want) == len(names):
        raise RuntimeError(f"{len(got)} gradients for {len(names)} leaves")
    max_abs = max_rel = 0.0
    for name, g, w in zip(names, got, want):
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        if not (err <= GRAD_TOL * scale) or scale == 0.0:
            raise RuntimeError(f"backward kernel vs plain: {name} error "
                               f"{err} against max abs {scale}")
        max_abs, max_rel = max(max_abs, err), max(max_rel, err / scale)
    return max_abs, max_rel


def tri_tables_of(scene):
    """pack_tri_tables' pair of a mesh scene, None without triangles."""
    return megatrace.pack_tri_tables(scene, materials.pack_materials(scene))


def step_vjp_check(dev, scene, cs, label: str = "cover") -> float:
    """Phase 6 (17b on a mesh scene): the kernel's one-iteration VJP
    against autograd of the plain replay_iteration on every lane, at every
    live iteration (three of them printed in full: the first, the first
    later one with regen, sky lanes and the scene's other winner kind,
    dielectric on the cover, triangle on a mesh, and the last)."""
    w, spp, depth, seed = 64, 4, 8, 21
    n = w * w
    _, tables = batch_inputs(scene, cs, w, w, dev)
    tri = tri_tables_of(scene)
    s_pad = megatrace.sphere_pad_count(tables[1].shape[0])
    lane_count = torch.full((n,), spp, dtype=torch.int32, device=dev)
    kw = dict(samples=spp, trace_depth=depth,
              has_dielectrics=scene.flags.has_dielectrics, sky_on=True)
    tape = megatrace.sample_batch(lane_count, torch.zeros(n, device=dev),
                                  *tables, seed, want_tape=True,
                                  tri_tables=tri, **kw)["tape"]
    ent = megatrace_replay.build_entity_rows(*tables[1:4], tri).detach()
    env = megatrace_replay.make_env(lane_count, tables[0], tables[4],
                                    tables[5], seed)
    keys = megatrace_replay.STATE_KEYS
    state = megatrace_replay.initial_state(n, dev)
    states, mixed, last = [], None, 0
    with torch.no_grad():
        for it in range(spp * depth):
            codes = tape[it]
            states.append(torch.stack([state[k] for k in keys]))
            regen = (state["active"] < 0.5) & (state["started"] < lane_count)
            winner = ent[torch.clamp(codes, min=0).long()]
            other = ((codes >= s_pad) if tri is not None
                     else (codes >= 0) & (winner[:, 10] > 0.5))
            if (mixed is None and it > 0 and bool(regen.any())
                    and bool(other.any()) and bool((codes == -1).any())):
                mixed = it
            if bool((codes > -1.5).any()):
                last = it
            state = megatrace_replay.replay_iteration(
                state, winner.T, codes, it, env, jitter=True,
                has_dielectrics=kw["has_dielectrics"], sky_on=True,
                trace_depth=depth, has_tris=tri is not None)
    if mixed is None:
        raise RuntimeError(f"{label}: no iteration with regen, sky lanes and "
                           f"{'triangle' if tri is not None else 'dielectric'}"
                           f" winners")
    rng = np.random.default_rng(0)
    worst, worst_it = 0.0, 0
    for it in range(last + 1):
        cot = torch.from_numpy(rng.standard_normal((len(keys), n))
                               .astype(np.float32)).to(dev)
        cot[12:16] = 0.0  # decisions and counters carry no cotangent
        args = (states[it], tape[it].contiguous(), it, cot, lane_count,
                *tables, seed)
        vkw = dict(trace_depth=depth, tri_tables=tri,
                   has_dielectrics=kw["has_dielectrics"])
        got = megatrace_bwd.replay_step_vjp(*args, **vkw)
        torch.cuda.synchronize()
        want = megatrace_bwd.replay_step_vjp_reference(*args, **vkw)
        errs = []
        for name, k, rows in (megatrace_bwd.STEP_COTANGENTS if tri is None
                              else megatrace_bwd.TRI_STEP_COTANGENTS):
            g, r = got[k][rows], want[k][rows]
            scale = float(r.abs().max())
            err = float((g - r).abs().max())
            if not err <= GRAD_TOL * scale:
                raise RuntimeError(f"step VJP iteration {it}: {name} error "
                                   f"{err} against max abs {scale}")
            rel = err / scale if scale > 0 else 0.0
            errs.append(f"{name} {rel:.2e}")
            if rel > worst:
                worst, worst_it = rel, it
        if it in (0, mixed, last):
            print(f"step VJP, {label} {w}x{w} iteration {it}: "
                  + ", ".join(errs))
    print(f"step VJP, {label} {w}x{w}: every iteration 0..{last} within "
          f"{GRAD_TOL:g}; worst {worst:.3e} of a cotangent's max abs "
          f"(iteration {worst_it})")
    return worst


def fwd_bwd_steps(scene, camera, target, width, height, samples, depth,
                  seeds):
    """Forward+backward steps through render_image(differentiable=True):
    (median MRays/s of the timed steps, last gradient, launches of both
    kernels, peak GB).  The first seed is the warm-up."""
    dev = target.device
    rays = []
    for seed in seeds:  # forward rays of each step's seed, as bench.py
        _, m = renderer.render_batch(
            scene, camera, film.zero_accumulators(width * height, device=dev),
            width=width, height=height, samples=samples, trace_depth=depth,
            seed=seed, differentiable=False)
        rays.append(float(m.total_rays))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    megatrace.LAUNCHES = megatrace_bwd.LAUNCHES = 0
    rates = []
    with recorded_calls(megatrace_bwd, "replay_grad", copy=False) as calls:
        for seed, r in zip(seeds, rays):
            calls.clear()  # keep the last step's call only
            centers = scene.spheres.center.clone().requires_grad_()
            torch.cuda.synchronize()
            t = time.perf_counter()
            img = renderer.render_image(
                params_mod.set_sphere_centers(scene, centers), camera,
                width=width, height=height, samples_per_pixel=samples,
                trace_depth=depth, seed=seed, differentiable=True)
            torch.mean((img.color - target) ** 2).backward()
            torch.cuda.synchronize()
            rates.append(r / (time.perf_counter() - t) / 1e6)
    launches = (megatrace.LAUNCHES, megatrace_bwd.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    grad = centers.grad
    if not bool(torch.isfinite(grad).all()) or float(grad.abs().max()) == 0:
        raise RuntimeError(f"bad gradient at depth {depth}")
    if min(launches) == 0:
        raise RuntimeError(f"fwd+bwd at depth {depth}: kernel launches "
                           f"{launches}")
    return statistics.median(rates[1:]), rays[-1], launches, peak, calls[0]


def differentiable_phases(dev, card, scene, cs, camera, target) -> dict:
    out = {}
    # ---- 6. per-iteration adjoint check ---------------------------------
    out["step_vjp_rel_err"] = step_vjp_check(dev, scene, cs)

    # ---- 7. backward kernel vs plain version ----------------------------
    w = h = 128
    n = w * h
    _, tables = batch_inputs(scene, cs, w, h, dev)
    max_abs = max_rel = 0.0
    shares = []
    # depth 35 runs blocks of 35 iterations through the per-lane history
    for spp, depth, seed in ((8, 8, 11), (8, 8, 12), (4, 35, 13)):
        lane_count = torch.full((n,), spp, dtype=torch.int32, device=dev)
        kw = dict(samples=spp, trace_depth=depth,
                  has_dielectrics=scene.flags.has_dielectrics, sky_on=True)
        fwd = megatrace.sample_batch(lane_count, torch.zeros(n, device=dev),
                                     *tables, seed, want_tape=True, **kw)
        cots = probe_cotangents(fwd["color"], fwd["count"])
        got = megatrace_bwd.replay_grad(fwd["tape"], lane_count, *tables,
                                        seed, *cots, **kw)
        torch.cuda.synchronize()
        want = megatrace_bwd.replay_grad_reference(
            fwd["tape"], lane_count, *tables, seed, *cots, **kw)
        a, r = leaf_errors(got, want)
        max_abs, max_rel = max(max_abs, a), max(max_rel, r)
        with torch.no_grad():
            csum, cnt = megatrace_replay.replay(fwd["tape"], lane_count,
                                                *tables, seed, **kw)
        same = (torch.isclose(csum, fwd["color"], **TOL).all(1)
                & (cnt == fwd["count"]))
        shares.append(float(same.float().mean()))
        print(f"backward kernel vs plain, cover {w}x{h} {spp} spp depth "
              f"{depth} seed {seed}: max error {r:.3e} of the leaf's max "
              f"abs ({a:.3g} abs); replay primal = kernel on "
              f"{shares[-1]:.6f} of lanes")
        if shares[-1] < 0.99:
            raise RuntimeError(f"replay primal share {shares[-1]} < 0.99")
    out["replay_primal_share"] = min(shares)

    # ---- 8. differentiable main path --------------------------------------
    width = height = 512
    gen = torch.Generator().manual_seed(1)
    peaks = {}
    rates = {}
    for samples, d, key in ((64, 8, "fwd_bwd_mrays"),
                            (128, 35, "depth35_fwd_bwd_mrays")):
        seeds = [int(torch.randint(0, renderer.SEED_RANGE, (), generator=gen))
                 for _ in range(4)]
        rate, rays, launches, peak, call = fwd_bwd_steps(
            scene, camera, target, width, height, samples, d, seeds)
        rates[key], peaks[d] = rate, peak
        tape_gb = samples * d * width * height * 4 / 1e9
        ckpt_gb = samples * 21 * width * height * 4 / 1e9
        print(f"fwd+bwd: cover {width}x{height} depth {d}, {samples} spp: "
              f"median {rate:.3f} MRays/s over 3 steps ({rays:.0f} forward "
              f"rays/step; launches batch {launches[0]}, backward "
              f"{launches[1]}); peak {peak:.3f} GB (tape {tape_gb:.3f} GB, "
              f"checkpoints {ckpt_gb:.3f} GB) [{card}]")
        if d == 8:
            out["launches"] = launches[1]
            # the plain version on the inputs the main path gave the
            # backward kernel (the last timed step)
            args, kwargs, got = call
            t = time.perf_counter()
            want = megatrace_bwd.replay_grad_reference(*args, **kwargs)
            torch.cuda.synchronize()
            a, r = leaf_errors(got, want)
            max_abs, max_rel = max(max_abs, a), max(max_rel, r)
            print(f"backward kernel vs plain on a main-path step ({width}x"
                  f"{height}, {samples} spp, depth {d}): max error {r:.3e} "
                  f"of the leaf's max abs ({a:.3g} abs); plain version "
                  f"{time.perf_counter() - t:.1f} s")
            del call, args, got, want  # free the step's tape
    out.update(rates)
    out["peak_gb"] = {str(d): p for d, p in peaks.items()}

    # ---- 9. trainer --------------------------------------------------------
    ts, tcs = book_scenes.three_spheres()
    ts = ts.to(dev)
    tcam = camera_mod.make_camera(
        tcs.origin, tcs.look_at, tcs.up, tcs.vertical_fov, 1.0,
        aperture=tcs.aperture, focus_distance=tcs.focus_distance, device=dev)
    cfg = inverse.InverseRenderConfig(width=128, height=128,
                                      samples_per_pixel=8, trace_depth=8,
                                      learning_rate=1e-2, steps=10)
    ttarget = renderer.render_image(ts, tcam, width=128, height=128,
                                    samples_per_pixel=64, trace_depth=8,
                                    seed=5, differentiable=False).color
    shift = torch.tensor([0.05, 0.0, -0.05], device=dev)
    init = {"sphere_centers": ts.spheres.center + shift}
    megatrace.LAUNCHES = megatrace_bwd.LAUNCHES = 0
    _, losses = inverse.optimize(ts, tcam, ttarget, init, cfg, seed=0)
    torch.cuda.synchronize()
    print(f"trainer: three_spheres 128x128, 8 spp, depth 8, 10 Adam steps: "
          f"losses {[round(x, 6) for x in losses]} (kernel launches batch "
          f"{megatrace.LAUNCHES}, backward {megatrace_bwd.LAUNCHES})")
    if not all(np.isfinite(losses)) or megatrace_bwd.LAUNCHES == 0:
        raise RuntimeError("the trainer failed")
    out["trainer_losses"] = losses
    # albedos reach the image without silhouettes, so their fit must
    # converge: a gradient of the wrong sign or scale fails here
    rows = [1, 3, 4]  # the Lambert center and ground, the metal sphere
    true = ts.textures.main_color
    start = true.clone()
    start[rows] = 0.5
    megatrace_bwd.LAUNCHES = 0
    fit, losses = inverse.optimize(
        ts, tcam, ttarget, {"texture_colors": start},
        cfg._replace(learning_rate=5e-2), seed=0,
        project=lambda p: {"texture_colors": p["texture_colors"].clamp(0, 1)})
    err0 = float((start - true)[rows].abs().max())
    err = float((fit["texture_colors"] - true)[rows].abs().max())
    print(f"trainer: three_spheres albedos from 0.5, 10 Adam steps at lr "
          f"5e-2: losses {[round(x, 6) for x in losses]}; albedo max error "
          f"{err0:.3f} -> {err:.4f} (backward launches "
          f"{megatrace_bwd.LAUNCHES})")
    if (not all(np.isfinite(losses)) or losses[-1] >= 0.5 * losses[0]
            or err >= 0.5 * err0 or megatrace_bwd.LAUNCHES == 0):
        raise RuntimeError("the albedo fit did not converge")
    out["albedo_fit_losses"] = losses

    # ---- 10. backward kernel vs plain time, 512x512, depth 8, 4 spp ---------
    _, tables = batch_inputs(scene, cs, width, height, dev)
    n = width * height
    lane_count = torch.full((n,), 4, dtype=torch.int32, device=dev)
    kw = dict(samples=4, trace_depth=8,
              has_dielectrics=scene.flags.has_dielectrics, sky_on=True)
    fwd = megatrace.sample_batch(lane_count, torch.zeros(n, device=dev),
                                 *tables, 7, want_tape=True, **kw)
    cots = probe_cotangents(fwd["color"], fwd["count"])
    args = (fwd["tape"], lane_count, *tables, 7, *cots)
    ms, got = time_batch(megatrace_bwd.replay_grad, *args, repeats=5, **kw)
    plain_ms, want = time_batch(megatrace_bwd.replay_grad_reference, *args,
                                repeats=1, **kw)
    a, r = leaf_errors(got, want)
    max_abs, max_rel = max(max_abs, a), max(max_rel, r)
    live = float(fwd["rays"].sum())  # live iterations of the tape
    s_count = tables[1].shape[0]
    bound_ms, bound_by = bound(
        live * BWD_FLOPS,
        fwd["tape"].numel() * 4 + n * 4 * 5 + s_count * 4 * 16 + 4 * 30)
    print(f"512x512 depth 8, 4 spp backward: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by} "
          f"({live:.0f} live iterations); max error {r:.3e} of the leaf's "
          f"max abs [{card}]")
    out.update(ms=ms, plain_ms=plain_ms, max_abs_err=max_abs,
               max_rel_err=max_rel, bound_ms=bound_ms, bound_by=bound_by)
    return out

def random_rays(n, s, seed, dev):
    """tests/test_pallas.py's random case: rays, spheres (centres, radii)."""
    g = np.random.default_rng(seed)
    o = g.normal(size=(n, 3)) * 2
    d = g.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    c = g.normal(size=(s, 3)) * 2
    r = g.uniform(0.4, 1.5, s)
    return tuple(torch.tensor(v, dtype=torch.float32, device=dev)
                 for v in (o, d, c, r))


def camera_rays(camera, width, height, seed, dev):
    key = rng.PRNGKey(seed)
    coords = camera_mod.pixel_coords(width, height, key, True, device=dev)
    return camera_mod.generate_rays(camera, coords, key)


def select_parity(label, o, d, c, r, rec, active) -> tuple[float, float]:
    """sphere_select and sphere_select_full against their plain versions on
    the card: (share of lanes identical in both, max abs error)."""
    got = sphere_select.sphere_select(o, d, c, r)
    torch.cuda.synchronize()
    want = sphere_select.sphere_select_reference(o, d, c, r)
    same = (got[0] == want[0]) & (got[1] == want[1]) & (got[2] == want[2])
    hit = (got[0] < sphere_select.BIG) & (want[0] < sphere_select.BIG)
    err = max(float((got[k] - want[k])[hit].abs().max()) if bool(hit.any())
              else 0.0 for k in (0, 2))
    share4 = float(same.float().mean())
    got = sphere_select.sphere_select_full(o, d, c, r, rec, active=active,
                                           want_exit=True)
    torch.cuda.synchronize()
    want = sphere_select.sphere_select_full_reference(
        o, d, c, r, rec, active=active, want_exit=True)
    same = ((got[0] == want[0]) & (got[1] == want[1])
            & (got[3] == want[2]).all(dim=1))
    share3 = float(same.float().mean())
    hit = (got[0] < sphere_select.BIG) & (want[0] < sphere_select.BIG)
    if bool(hit.any()):
        err = max(err, float((got[0] - want[0])[hit].abs().max()),
                  float((got[3] - want[2])[hit].abs().max()))
    print(f"sphere selection vs plain, {label}: sphere_select "
          f"{share4:.6f}, sphere_select_full {share3:.6f} of lanes "
          f"identical; max abs err {err:.3g}")
    if min(share4, share3) < 0.99:
        raise RuntimeError(f"sphere selection kernel/plain agreement "
                           f"{min(share4, share3)} < 0.99 ({label})")
    return min(share4, share3), err


def wave_agreement(a: dict, b: dict) -> tuple[float, float]:
    """Per-ray megatrace outputs: (share of lanes with identical valid and
    ray count and floats within TOL, max abs float error on those)."""
    same = (a["valid"] == b["valid"]) & (a["pixel_rays"] == b["pixel_rays"])
    for k in WAVE_FLOATS:
        close = torch.isclose(a[k], b[k], **TOL)
        same &= close.reshape(close.shape[0], -1).all(dim=1)
    if not bool(same.any()):
        return 0.0, float("inf")
    err = max(float((a[k] - b[k]).abs().reshape(same.shape[0], -1)[same]
                    .max()) for k in WAVE_FLOATS)
    return float(same.float().mean()), err


def aov_gradient(scene, cs, dev, width, samples, key_seed):
    """Gradients of the AOV loss (phase 12c) to the sphere centres and the
    texture colors, rendered on `dev`."""
    sc = scene.to(dev)
    cam = camera_mod.make_camera(
        cs.origin, cs.look_at, cs.up, cs.vertical_fov, 1.0,
        aperture=cs.aperture, focus_distance=cs.focus_distance, device=dev)
    centers = sc.spheres.center.clone().requires_grad_()
    colors = sc.textures.main_color.clone().requires_grad_()
    img = renderer.render_image(
        params_mod.set_texture_colors(
            params_mod.set_sphere_centers(sc, centers), colors),
        cam, width=width, height=width, samples_per_pixel=samples,
        trace_depth=8, key=rng.PRNGKey(key_seed))
    loss = (torch.mean((img.color - 0.5) ** 2) + torch.mean(img.normal ** 2)
            + torch.mean(img.albedo ** 2))
    return [g.cpu() for g in torch.autograd.grad(loss, [centers, colors])]


def device_busy_share(fn, refuse_batch_kernel: bool = False) -> float:
    """Device time over wall time of one call of `fn` under torch.profiler
    (kernel self time summed; the rest of the window the card idles).  The
    profiler's own host overhead lengthens the window, so this is a lower
    bound of the untraced share."""
    from torch.profiler import ProfilerActivity, profile

    eligible = megatrace.scene_eligible
    if refuse_batch_kernel:
        megatrace.scene_eligible = lambda *a, **k: False
    try:
        fn()  # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t) * 1e6
    finally:
        megatrace.scene_eligible = eligible
    # the kernels' own events, as the profiler table's device total counts
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    if busy_us <= 0:
        raise RuntimeError("the profiler saw no device time")
    return busy_us / wall_us


def kernel_ms(fn, kernel: str, repeats: int) -> float:
    """Device milliseconds per launch of the kernel whose name contains
    `kernel`, over `repeats` calls of `fn` under torch.profiler: the
    kernel alone, without the gaps a host-bound wrapper leaves between
    launches (CUDA events around the calls would count those).  A
    profiler run after earlier ones in the process may lose an event of
    its first launches, so the mean is over the launches the profiler
    saw, at least half of `repeats`."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and kernel in e.key]
    launches = sum(e.count for e in events)
    if not repeats / 2 <= launches <= repeats:
        raise RuntimeError(f"profiled {launches} launches of {kernel}, "
                           f"expected {repeats}")
    return sum(e.self_device_time_total for e in events) / 1e3 / launches


def reset_launches() -> None:
    megatrace.LAUNCHES = megatrace.WAVE_LAUNCHES = megatrace_bwd.LAUNCHES = 0
    triangle_select.LAUNCHES = 0
    meshtrace.SYNC_LAUNCHES = meshtrace.COMPACT_LAUNCHES = 0
    meshtrace.RESTORE_LAUNCHES = 0
    for k in sphere_select.LAUNCHES:
        sphere_select.LAUNCHES[k] = 0


def wavefront_phases(dev, card, scene, cs, camera, target,
                     width: int = 512) -> dict:
    """Phases 11 and 12 on a square image of `width` (the main path's 512;
    `camera` and `target` at that size)."""
    s_count = scene.spheres.center.shape[0]
    height = width
    n = width * height
    kernels, paths = {}, {}

    # ---- 11. kernels vs plain versions ---------------------------------------
    shares, errs = [], []
    for label, (nn, ss, seed) in (("random 512x37", (512, 37, 0)),
                                  ("random 256x21", (256, 21, 3)),
                                  ("random 1024x5", (1024, 5, 7))):
        o, d, c, r = random_rays(nn, ss, seed, dev)
        rec = torch.randn((ss, 12), generator=torch.Generator().manual_seed(
            1)).to(dev)
        active = torch.ones(nn, dtype=torch.bool, device=dev)
        if nn == 1024:
            active[:512] = False  # four blocks of inactive rays
        share, err = select_parity(label, o, d, c, r, rec, active)
        shares.append(share)
        errs.append(err)
    cam_rays = camera_rays(camera, width, height, 1, dev)
    o, d = cam_rays.origin, cam_rays.direction
    c, r = scene.spheres.center, scene.spheres.radius
    packed = materials.pack_materials(scene)
    mat = scene.spheres.material.long()
    rec = torch.cat([packed[mat][:, :11], mat[:, None].float()], dim=1)
    active = (torch.arange(n, device=dev) // 4096) % 4 != 3
    share, err = select_parity(f"cover {width}x{height} camera rays", o, d, c, r, rec,
                               active)
    shares.append(share)
    errs.append(err)
    sel_ms = kernel_ms(lambda: sphere_select.sphere_select(o, d, c, r),
                       "sphere_select_kernel", repeats=20)
    sel_call_ms, _ = time_batch(sphere_select.sphere_select, o, d, c, r,
                                repeats=20)
    sel_plain_ms, _ = time_batch(sphere_select.sphere_select_reference, o, d,
                                 c, r, repeats=1)
    full_ms = kernel_ms(lambda: sphere_select.sphere_select_full(
        o, d, c, r, rec, active=active), "sphere_select_full_kernel",
        repeats=20)
    full_call_ms, _ = time_batch(sphere_select.sphere_select_full, o, d, c,
                                 r, rec, active=active, repeats=20)
    full_plain_ms, _ = time_batch(sphere_select.sphere_select_full_reference,
                                  o, d, c, r, rec, active=active, repeats=1)
    live = float(sphere_select._block_active(active).sum())
    sel_bound = bound(n * s_count * SWEEP_FLOPS, n * (24 + 12) + s_count * 16)
    full_bound = bound(live * s_count * SWEEP_FLOPS,
                       n * (24 + 1 + 8 + 64) + s_count * (16 + 64))
    print(f"sphere_select, cover {width}x{height} camera rays x {s_count} "
          f"spheres: "
          f"kernel {sel_ms:.4f} ms (a wrapper call {sel_call_ms:.4f} ms), "
          f"plain {sel_plain_ms:.3f} ms, bound {sel_bound[0]:.4f} ms by "
          f"{sel_bound[1]} [{card}]")
    print(f"sphere_select_full, same rays, {live:.0f} in live blocks: "
          f"kernel {full_ms:.4f} ms (a wrapper call {full_call_ms:.4f} ms), "
          f"plain {full_plain_ms:.3f} ms, bound {full_bound[0]:.4f} ms by "
          f"{full_bound[1]} [{card}]")

    records = packed[mat][:, :11]
    sky = (scene.environment.sky_bottom, scene.environment.sky_top)
    all_on = torch.ones(n, dtype=torch.bool, device=dev)
    wave_args = (o, d, all_on, c, r, records, *sky, 5)
    wshares, werrs = [], []
    for depth in (8, 35):
        got = megatrace.megatrace(*wave_args, trace_depth=depth)
        torch.cuda.synchronize()
        want = megatrace.megatrace_reference(*wave_args, trace_depth=depth)
        share, err = wave_agreement(got, want)
        print(f"megatrace vs plain, cover {width}x{height} camera rays, "
              f"depth {depth}: {share:.6f} of lanes identical (valid, rays; "
              f"floats within 1e-4), max abs err {err:.3g}")
        if share < 0.99:
            raise RuntimeError(f"megatrace kernel/plain agreement {share} "
                               f"< 0.99 (depth {depth})")
        wshares.append(share)
        werrs.append(err)
    wave_ms = kernel_ms(lambda: megatrace.megatrace(*wave_args,
                                                    trace_depth=8),
                        "megatrace_wave_kernel", repeats=5)
    wave_call_ms, wout = time_batch(megatrace.megatrace, *wave_args,
                                    trace_depth=8, repeats=5)
    wave_plain_ms, _ = time_batch(megatrace.megatrace_reference, *wave_args,
                                  trace_depth=8, repeats=1)
    bounces = float(wout["pixel_rays"].sum())
    wave_bound = bound(bounces * (s_count * SWEEP_FLOPS + SHADE_FLOPS),
                       n * (24 + 1 + 48) + s_count * (16 + 64) + 24)
    print(f"megatrace, cover {width}x{height} depth 8 ({bounces:.0f} "
          f"bounces): "
          f"kernel {wave_ms:.3f} ms ({bounces / wave_ms / 1e3:.3f} MRays/s; "
          f"a wrapper call {wave_call_ms:.3f} ms), "
          f"plain {wave_plain_ms:.3f} ms, bound {wave_bound[0]:.4f} ms by "
          f"{wave_bound[1]} [{card}]")

    # ---- 12a. integrator.trace, the mega arm ---------------------------------
    key = rng.PRNGKey(3)
    cam_rays = camera_rays(camera, width, height, 3, dev)
    integrator.trace(scene, cam_rays, key, 8,
                     differentiable=False)  # warm-up
    reset_launches()
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = integrator.trace(scene, cam_rays, key, 8, differentiable=False)
        count = int(res.ray_count)  # waits for the device
        runs.append(count / (time.perf_counter() - t) / 1e6)
    mega_launches = megatrace.WAVE_LAUNCHES
    if (mega_launches == 0 or megatrace.LAUNCHES != 0
            or sum(sphere_select.LAUNCHES.values()) != 0):
        raise RuntimeError("trace(differentiable=False) did not take the "
                           "mega arm alone")
    if (not bool(torch.isfinite(res.radiance).all())
            or float(res.valid.float().mean()) < 0.5):
        raise RuntimeError("bad mega-arm trace")
    paths["mega_mrays"] = statistics.median(runs)
    print(f"(a) trace, mega arm: cover {width}x{height} camera rays, depth "
          f"8: median "
          f"{paths['mega_mrays']:.3f} MRays/s over 3 ({count} rays, "
          f"{mega_launches} megatrace launches) [{card}]")

    # ---- 12b. render_batch with the batch kernel refused: the fast arm -----
    eligible = megatrace.scene_eligible
    megatrace.scene_eligible = lambda *a, **k: False
    try:
        acc = film.zero_accumulators(n, device=dev)

        def wave_batch(i):
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, m = renderer.render_batch(
                scene, camera, acc, key=rng.PRNGKey(100 + i), width=width,
                height=height, samples=64, trace_depth=8,
                differentiable=False)
            total = float(m.total_rays)  # waits for the device
            torch.cuda.synchronize()
            return total, time.perf_counter() - t

        wave_batch(0)  # warm-up
        reset_launches()
        runs = [wave_batch(i) for i in (1, 2, 3)]
        fast_launches = sphere_select.LAUNCHES["sphere_select_full"]
        if (fast_launches == 0 or megatrace.LAUNCHES != 0
                or megatrace.WAVE_LAUNCHES != 0):
            raise RuntimeError("the refused batch did not take the fast arm")
    finally:
        megatrace.scene_eligible = eligible
    paths["fast_mrays"] = statistics.median(r / t / 1e6 for r, t in runs)
    paths["fast_device_busy"] = device_busy_share(
        lambda: renderer.render_batch(
            scene, camera, film.zero_accumulators(n, device=dev),
            key=rng.PRNGKey(7), width=width, height=height, samples=1,
            trace_depth=8, differentiable=False),
        refuse_batch_kernel=True)
    img = film.combine(acc, width, height).color
    if not bool(torch.isfinite(img).all()) or float(img.mean()) <= 0.2:
        raise RuntimeError(f"bad fast-arm image: mean {float(img.mean())}")
    print(f"(b) render_batch, batch kernel refused (fast arm): cover "
          f"{width}x{height} depth 8, 64 spp/batch: median "
          f"{paths['fast_mrays']:.3f} MRays/s over 3 batches "
          f"({runs[0][0]:.0f} rays/batch, {fast_launches} sphere_select_full "
          f"launches); image mean {float(img.mean()):.4f}; device busy "
          f"{paths['fast_device_busy']:.3f} of a 1-sample batch [{card}]")

    # ---- 12c. the AOV step --------------------------------------------------
    def step(aov: bool):
        centers = scene.spheres.center.clone().requires_grad_()
        colors = scene.textures.main_color.clone().requires_grad_()
        torch.cuda.synchronize()
        t = time.perf_counter()
        img = renderer.render_image(
            params_mod.set_texture_colors(
                params_mod.set_sphere_centers(scene, centers), colors),
            camera, width=width, height=height, samples_per_pixel=64,
            trace_depth=8, key=rng.PRNGKey(11))
        loss = torch.mean((img.color - target) ** 2)
        if aov:
            loss = loss + torch.mean(img.normal ** 2) + torch.mean(
                img.albedo ** 2)
        loss.backward()
        torch.cuda.synchronize()
        for g in (centers.grad, colors.grad):
            if not bool(torch.isfinite(g).all()) or float(g.abs().max()) == 0:
                raise RuntimeError(f"bad gradient in the AOV step ({aov})")
        return time.perf_counter() - t

    def step_small():
        centers = scene.spheres.center.clone().requires_grad_()
        img = renderer.render_image(
            params_mod.set_sphere_centers(scene, centers), camera,
            width=width, height=height, samples_per_pixel=1, trace_depth=8,
            key=rng.PRNGKey(12))
        torch.mean(img.normal ** 2).backward()

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    runs_before = renderer.AOV_GRAFT_RUNS
    aov_s = step(True)
    aov_peak = torch.cuda.max_memory_allocated() / 1e9
    select_launches = sphere_select.LAUNCHES["sphere_select"]
    if (select_launches == 0 or megatrace.LAUNCHES == 0
            or megatrace_bwd.LAUNCHES == 0
            or renderer.AOV_GRAFT_RUNS != runs_before + 1):
        raise RuntimeError("the AOV step did not run the graft's kernels")
    print(f"(c) AOV step: cover {width}x{height}, 64 spp, depth 8: "
          f"{aov_s:.3f} s, peak {aov_peak:.3f} GB, launches sphere_select "
          f"{select_launches}, batch {megatrace.LAUNCHES}, backward "
          f"{megatrace_bwd.LAUNCHES} [{card}]")
    photo_s = step(False)
    if (sphere_select.LAUNCHES["sphere_select"] != select_launches
            or renderer.AOV_GRAFT_RUNS != runs_before + 1):
        raise RuntimeError("a photometric step ran the wavefront")
    print(f"    photometric step: {photo_s:.3f} s, no sphere_select launch")
    # why the graft gathers rows with index_select (ops/intersect.py)
    table = torch.randn((s_count, 3), device=dev, requires_grad=True)
    rows = torch.randint(1, s_count, (n,), device=dev)
    rows[: n * 9 // 10] = 0  # most rays hit one sphere, as the ground
    for label, gather in (("advanced indexing", lambda: table[rows]),
                          ("index_select", lambda: torch.index_select(
                              table, 0, rows))):
        ms_back, _ = time_batch(
            lambda: torch.autograd.grad(gather().sum(), table), repeats=10)
        paths[f"gather_backward_ms_{label.split()[0]}"] = ms_back
        print(f"    gather backward, {n} rows of ({s_count}, 3), 90% one "
              f"row: {label} {ms_back:.3f} ms")
    paths["aov_device_busy"] = device_busy_share(lambda: step_small())
    paths.update(aov_step_s=aov_s, aov_peak_gb=aov_peak,
                 photometric_step_s=photo_s)

    t = time.perf_counter()
    got = aov_gradient(scene, cs, dev, 128, 8, 4)
    want = aov_gradient(scene, cs, torch.device("cpu"), 128, 8, 4)
    rel = 0.0
    for name, g, w in zip(("centers", "texture colors"), got, want):
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        if not (err <= GRAD_TOL * scale) or scale == 0.0:
            raise RuntimeError(f"AOV gradient, card vs plain: {name} error "
                               f"{err} against max abs {scale}")
        rel = max(rel, err / scale)
    print(f"    device busy {paths['aov_device_busy']:.3f} of a 1-sample AOV "
          f"step")
    print(f"    AOV gradient, cover 128x128, 8 spp: card vs plain versions "
          f"on the CPU within {rel:.3e} of each leaf's max abs "
          f"({time.perf_counter() - t:.1f} s)")
    paths["aov_grad_rel_err"] = rel

    kernels = [{
        "name": "megatrace_wave",
        "route": "cuda",
        "source": "raytracing_in_one_weekend_tpu_torch/csrc/megatrace_wave.cu",
        "replaces": "raytracing_in_one_weekend_tpu/ops/pallas_megatrace.py:1585",
        "launches": mega_launches,
        "max_abs_err": max(werrs),
        "ms": wave_ms,
        "plain_ms": wave_plain_ms,
        "bound_ms": wave_bound[0],
        "bound_by": wave_bound[1],
        "library_ms": None,
    }, {
        "name": "sphere_select_full",
        "route": "cuda",
        "source": "raytracing_in_one_weekend_tpu_torch/csrc/sphere_select.cu",
        "replaces": "raytracing_in_one_weekend_tpu/ops/pallas_sphere.py:161",
        "launches": fast_launches,
        "max_abs_err": max(errs),
        "ms": full_ms,
        "plain_ms": full_plain_ms,
        "bound_ms": full_bound[0],
        "bound_by": full_bound[1],
        "library_ms": None,
    }, {
        "name": "sphere_select",
        "route": "cuda",
        "source": "raytracing_in_one_weekend_tpu_torch/csrc/sphere_select.cu",
        "replaces": "raytracing_in_one_weekend_tpu/ops/pallas_sphere.py:41",
        "launches": select_launches,
        "max_abs_err": max(errs),
        "ms": sel_ms,
        "plain_ms": sel_plain_ms,
        "bound_ms": sel_bound[0],
        "bound_by": sel_bound[1],
        "library_ms": None,
    }]
    paths.update(select_share=min(shares), wave_share=min(wshares))
    return {"kernels": kernels, "paths": paths}


def random_triangles(n, t, seed, dev):
    """Random rays and triangles (5 degenerate rows) with whole inactive
    256-ray tiles: (origin, direction, edge_a, edge_b, vert0, active)."""
    g = np.random.default_rng(seed)
    v0 = g.uniform(-2, 2, (t, 3))
    ea = g.normal(0, 0.6, (t, 3))
    eb = g.normal(0, 0.6, (t, 3))
    ea[:5] = 0.0
    o = g.uniform(-4, 4, (n, 3))
    d = g.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    active = g.random(n) < 0.7
    active[256:512] = False
    return (*(torch.tensor(v, dtype=torch.float32, device=dev)
              for v in (o, d, ea, eb, v0)),
            torch.tensor(active, device=dev))


def triangle_parity(label, o, d, ea, eb, v0, active) -> tuple[float, float]:
    """triangle_select against its plain version on the card: (share of
    lanes with identical t and row, max abs t error on hit lanes)."""
    got = triangle_select.triangle_select(o, d, ea, eb, v0, active)
    torch.cuda.synchronize()
    want = triangle_select.triangle_select_reference(o, d, ea, eb, v0, active)
    same = (got[0] == want[0]) & (got[1] == want[1])
    hit = (got[0] < megatrace.BIG) & (want[0] < megatrace.BIG)
    err = (float((got[0] - want[0])[hit].abs().max()) if bool(hit.any())
           else 0.0)
    share = float(same.float().mean())
    print(f"triangle_select vs plain, {label}: {share:.6f} of lanes "
          f"identical (t, row), {float(hit.float().mean()):.4f} hit; max abs "
          f"t err {err:.3g}")
    if share < 0.99:
        raise RuntimeError(f"triangle_select kernel/plain agreement {share} "
                           f"< 0.99 ({label})")
    return share, err


def two_block_mesh(dev):
    """tests/test_torch_mesh_megatrace.py's two-block mesh: a ground
    sphere, icosphere(2) and a cube, 332 triangles (T_pad 384)."""
    b = SceneBuilder()
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, b.lambert((0.5, 0.5, 0.5)))
    v, f, nrm, _ = meshes.icosphere(2)
    b.add_mesh(v, f, b.metal((0.8, 0.7, 0.5), glossiness=0.9), normals=nrm,
               translation=(-1.2, 1.0, 0.0))
    v, f, _, _ = meshes.cube()
    b.add_mesh(v, f, b.lambert((0.8, 0.3, 0.2)), translation=(1.2, 0.5, 0.0),
               face_normals=True)
    b.set_gradient_sky()
    cs = CameraSettings(origin=(0.0, 2.0, 6.0), look_at=(0.0, 0.7, 0.0),
                        vertical_fov=35.0, focus_distance=6.0)
    return b.build().to(dev), cs


def smooth_triangle(dev):
    """One triangle with distinct vertex normals over a ground sphere
    (tests/test_replay.py:483): its interior vertex gradients are smooth."""
    b = SceneBuilder()
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, b.lambert((0.1, 0.7, 0.1)))
    v = np.asarray([[-1.5, 0.3, 0.0], [1.5, 0.5, 0.0], [0.0, 2.2, -1.0]],
                   np.float32)
    nrm = np.asarray([[0.6, 0.6, 0.52], [-0.6, 0.6, 0.52], [0.0, 0.2, 0.98]],
                     np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    b.add_mesh(v, np.asarray([[0, 1, 2]]), b.lambert((0.8, 0.4, 0.2)),
               normals=nrm)
    b.set_gradient_sky()
    cam = camera_mod.make_camera((0.0, 2.0, 6.0), (0.0, 0.9, 0.0),
                                 (0.0, 1.0, 0.0), 35.0, 1.0, device=dev)
    return b.build().to(dev), cam


def mesh_phases(dev, card) -> dict:
    """Phases 13-17 on mesh_showcase (908 triangles over a ground sphere)."""
    scene, cs = meshes.mesh_showcase()
    scene = scene.to(dev)
    if (not megatrace.scene_eligible(scene, allow_triangles=True)
            or megatrace.scene_eligible(scene)):
        raise RuntimeError("mesh_showcase left the batch kernel's scope, or "
                           "entered the sphere-only per-ray megatrace's")
    tri = tri_tables_of(scene)
    tris = scene.triangles
    t_count, t_pad = tris.vert0.shape[0], tri[0].shape[0]
    s_count = scene.spheres.center.shape[0]
    width = height = 512
    n = width * height
    camera, _ = batch_inputs(scene, cs, width, height, dev)
    out, kernel = {}, {}

    # ---- 13. triangle_select vs plain ----------------------------------------
    shares, errs = [], []
    for label, (nn, tt, seed) in (("random 4096x1000", (4096, 1000, 7)),
                                  ("random 1024x4096", (1024, 4096, 3)),
                                  ("random 768x130", (768, 130, 5))):
        share, err = triangle_parity(label, *random_triangles(nn, tt, seed,
                                                              dev))
        shares.append(share)
        errs.append(err)
    rays = camera_rays(camera, width, height, 1, dev)
    o, d = rays.origin, rays.direction
    geo = (tris.edge_a, tris.edge_b, tris.vert0)
    share, err = triangle_parity(f"mesh_showcase {width}x{height} camera "
                                 "rays", o, d, *geo, None)
    shares.append(share)
    errs.append(err)
    # one bounce: from each hit point, a direction about the face normal
    t, idx = triangle_select.triangle_select(o, d, *geo)
    hit = t < megatrace.BIG
    fn = torch.linalg.cross(tris.edge_b[idx.long()], tris.edge_a[idx.long()])
    fn = fn / fn.norm(dim=1, keepdim=True).clamp(min=1e-12)
    fn = fn * -torch.sign((fn * d).sum(1, keepdim=True))
    g = torch.Generator().manual_seed(4)
    rd = torch.randn((n, 3), generator=g).to(dev) + fn
    rd = rd / rd.norm(dim=1, keepdim=True)
    o2 = torch.where(hit[:, None], o + t[:, None] * d + 1e-3 * fn, o)
    d2 = torch.where(hit[:, None], rd, d)
    share, err = triangle_parity("one bounce of them", o2, d2, *geo, hit)
    shares.append(share)
    errs.append(err)
    sel_ms = kernel_ms(lambda: triangle_select.triangle_select(o, d, *geo),
                       "triangle_select_kernel", repeats=20)
    sel_plain_ms, _ = time_batch(triangle_select.triangle_select_reference,
                                 o, d, *geo, repeats=1)
    sel_bound = bound(n * t_count * MT_FLOPS, n * (24 + 8) + t_count * 36)
    print(f"triangle_select, mesh_showcase {width}x{height} camera rays x "
          f"{t_count} triangles: kernel {sel_ms:.4f} ms, plain "
          f"{sel_plain_ms:.3f} ms, bound {sel_bound[0]:.4f} ms by "
          f"{sel_bound[1]} [{card}]")
    out["select_share"] = min(shares)

    # ---- 14. the batch kernel's triangle arm vs plain --------------------------
    w = h = 128
    kw = dict(has_dielectrics=scene.flags.has_dielectrics, sky_on=True)
    zeros = torch.zeros(w * h, device=dev)
    _, tables = batch_inputs(scene, cs, w, h, dev)
    lanes8 = torch.full((w * h,), 8, dtype=torch.int32, device=dev)
    max_err = 0.0
    for seed in (11, 12):
        share, err = check_parity(
            f"mesh_showcase {w}x{h} 8 spp depth 8 seed {seed}",
            (lanes8, zeros, *tables, seed),
            dict(kw, samples=8, trace_depth=8, tri_tables=tri))
        shares.append(share)
        max_err = max(max_err, err)
    scene2, cs2 = two_block_mesh(dev)
    tri2 = tri_tables_of(scene2)
    if tri2[0].shape[0] != 384:
        raise RuntimeError("the two-block mesh does not pad to 384 rows")
    _, tables2 = batch_inputs(scene2, cs2, w, h, dev)
    share, err = check_parity(
        f"two-block mesh (332 triangles) {w}x{h} 4 spp depth 6",
        (torch.full((w * h,), 4, dtype=torch.int32, device=dev), zeros,
         *tables2, 13),
        dict(kw, samples=4, trace_depth=6, tri_tables=tri2))
    shares.append(share)
    max_err = max(max_err, err)
    _, tables = batch_inputs(scene, cs, width, height, dev)
    args4 = (torch.full((n,), 4, dtype=torch.int32, device=dev),
             torch.zeros(n, device=dev), *tables, 7)
    kw4 = dict(kw, samples=4, trace_depth=8, tri_tables=tri)
    batch_ms, got = time_batch(megatrace.sample_batch, *args4, repeats=5,
                               **kw4)
    megatrace.TRI_PAIRS = 0
    batch_plain_ms, want = time_batch(megatrace.sample_batch_reference,
                                      *args4, repeats=1, **kw4)
    pairs = megatrace.TRI_PAIRS / 2  # time_batch made two calls
    share, err = lane_agreement(got, want)
    if share < 0.99:
        raise RuntimeError(f"triangle arm agreement {share} < 0.99 in the "
                           "timed 4 spp batch")
    max_err = max(max_err, err)
    bounces = float(got["rays"].sum())
    blocks = -(-t_pad // megatrace.TRI_BLOCK)
    batch_bound = bound(
        bounces * (s_count * SWEEP_FLOPS + SHADE_FLOPS) + pairs * MT_FLOPS,
        n * 4 * (2 + megatrace.OUT_ROWS) + s_count * 4 * 20 + 4 * 32
        + t_pad * 4 * (12 + megatrace.TRI_REC_ROWS) + blocks * 32)
    print(f"batch kernel, triangle arm, mesh_showcase 512x512 depth 8, 4 spp "
          f"({bounces:.0f} bounces, {pairs / bounces:.1f} triangles tested "
          f"per bounce of {t_count}): kernel {batch_ms:.3f} ms "
          f"({bounces / batch_ms / 1e3:.3f} MRays/s), plain "
          f"{batch_plain_ms:.3f} ms, bound {batch_bound[0]:.4f} ms by "
          f"{batch_bound[1]}; {share:.6f} of lanes agree, max abs err "
          f"{err:.3g} [{card}]")

    # ---- 15. the forward mesh path ---------------------------------------------
    gen = torch.Generator().manual_seed(0)
    acc = film.zero_accumulators(n, device=dev)

    def forward():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = renderer.render_batch(scene, camera, acc, gen, width=width,
                                     height=height, samples=64, trace_depth=8)
        rays_ = float(m.total_rays)  # waits for the device
        torch.cuda.synchronize()
        return rays_, time.perf_counter() - t0

    forward()  # warm-up
    reset_launches()
    runs = [forward() for _ in range(5)]
    fwd_launches = megatrace.LAUNCHES
    if fwd_launches == 0 or megatrace_bwd.LAUNCHES or triangle_select.LAUNCHES:
        raise RuntimeError("the forward mesh path did not take the batch "
                           "kernel alone")
    img = film.combine(acc, width, height).color
    if not bool(torch.isfinite(img).all()) or float(img.mean()) <= 0.1:
        raise RuntimeError(f"bad mesh image: mean {float(img.mean())}")
    out["fwd_mrays"] = statistics.median(r / s / 1e6 for r, s in runs)
    print(f"forward mesh path: mesh_showcase {width}x{height} depth 8, 64 "
          f"spp/batch: median {out['fwd_mrays']:.3f} MRays/s over 5 batches "
          f"({runs[0][0]:.0f} rays/batch, {fwd_launches} kernel launches); "
          f"image mean {float(img.mean()):.4f} [{card}]")
    target = img.detach()

    # ---- 16. the wavefront mesh path -------------------------------------------
    eligible = megatrace.scene_eligible
    megatrace.scene_eligible = lambda *a, **k: False
    try:
        wacc = film.zero_accumulators(n, device=dev)

        def wave_batch(i, samples):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, m = renderer.render_batch(
                scene, camera, wacc, key=rng.PRNGKey(200 + i), width=width,
                height=height, samples=samples, trace_depth=8,
                differentiable=False)
            total = float(m.total_rays)  # waits for the device
            torch.cuda.synchronize()
            return total, time.perf_counter() - t0

        wave_batch(0, 1)  # warm-up
        reset_launches()
        runs = [wave_batch(i, 16) for i in (1, 2, 3)]
        tri_launches = triangle_select.LAUNCHES
        sph_launches = sphere_select.LAUNCHES["sphere_select"]
        if (tri_launches == 0 or sph_launches == 0 or megatrace.LAUNCHES
                or megatrace.WAVE_LAUNCHES
                or sphere_select.LAUNCHES["sphere_select_full"]):
            raise RuntimeError("the refused mesh batch did not take the "
                               "general arm's selections")
    finally:
        megatrace.scene_eligible = eligible
    wimg = film.combine(wacc, width, height).color
    if not bool(torch.isfinite(wimg).all()):
        raise RuntimeError("bad wavefront mesh image")
    out["wave_mrays"] = statistics.median(r / s / 1e6 for r, s in runs)
    print(f"wavefront mesh path (batch kernel refused): mesh_showcase "
          f"{width}x{height} depth 8, 16 spp/batch: median "
          f"{out['wave_mrays']:.3f} MRays/s over 3 batches ({runs[0][0]:.0f} "
          f"rays/batch; launches triangle_select {tri_launches}, "
          f"sphere_select {sph_launches}); image mean "
          f"{float(wimg.mean()):.4f} [{card}]")

    # ---- 17a. fwd+bwd to the soup vertices and the sphere centres -------------
    verts0 = params_mod.soup_vertices(scene)
    seeds = [int(torch.randint(0, renderer.SEED_RANGE, (), generator=gen))
             for _ in range(4)]
    rays_per = []
    for seed in seeds:
        _, m = renderer.render_batch(
            scene, camera, film.zero_accumulators(n, device=dev),
            width=width, height=height, samples=64, trace_depth=8, seed=seed,
            differentiable=False)
        rays_per.append(float(m.total_rays))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    rates = []
    for seed, r in zip(seeds, rays_per):
        verts = verts0.clone().requires_grad_()
        centers = scene.spheres.center.clone().requires_grad_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = renderer.render_image(
            params_mod.apply_params(scene, {"triangle_vertices": verts,
                                            "sphere_centers": centers}),
            camera, width=width, height=height, samples_per_pixel=64,
            trace_depth=8, seed=seed, differentiable=True)
        torch.mean((img.color - target) ** 2).backward()
        torch.cuda.synchronize()
        rates.append(r / (time.perf_counter() - t0) / 1e6)
    fb_launches = (megatrace.LAUNCHES, megatrace_bwd.LAUNCHES)
    for name, grad in (("vertices", verts.grad), ("centres", centers.grad)):
        if not bool(torch.isfinite(grad).all()) or float(grad.abs().max()) == 0:
            raise RuntimeError(f"bad mesh gradient to the {name}")
    if min(fb_launches) == 0 or triangle_select.LAUNCHES:
        raise RuntimeError(f"fwd+bwd mesh path: launches {fb_launches}, "
                           f"triangle_select {triangle_select.LAUNCHES}")
    out["fwd_bwd_mrays"] = statistics.median(rates[1:])
    out["fwd_bwd_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"fwd+bwd mesh path: mesh_showcase {width}x{height} depth 8, 64 "
          f"spp, gradients to {t_count} soup triangles' vertices and the "
          f"sphere centres: median {out['fwd_bwd_mrays']:.3f} MRays/s over 3 "
          f"steps ({rays_per[-1]:.0f} forward rays/step; launches batch "
          f"{fb_launches[0]}, backward {fb_launches[1]}); peak "
          f"{out['fwd_bwd_peak_gb']:.3f} GB [{card}]")

    # ---- 17b. the one-iteration VJP on triangle winners -----------------------
    out["step_vjp_rel_err"] = step_vjp_check(dev, scene, cs, "mesh_showcase")

    # ---- 17c. backward kernel vs plain, 128x128 ---------------------------------
    names = LEAVES + ("tri_geo", "tri_rec")
    _, tables = batch_inputs(scene, cs, w, h, dev)
    bwd_abs = bwd_rel = 0.0
    for spp, depth, seed in ((8, 8, 11), (4, 35, 13)):
        lane_count = torch.full((w * h,), spp, dtype=torch.int32, device=dev)
        bkw = dict(kw, samples=spp, trace_depth=depth)
        fwd = megatrace.sample_batch(lane_count, zeros, *tables, seed,
                                     want_tape=True, tri_tables=tri, **bkw)
        cots = probe_cotangents(fwd["color"], fwd["count"])
        got = megatrace_bwd.replay_grad(fwd["tape"], lane_count, *tables,
                                        seed, *cots, tri_tables=tri, **bkw)
        torch.cuda.synchronize()
        want = megatrace_bwd.replay_grad_reference(
            fwd["tape"], lane_count, *tables, seed, *cots, tri_tables=tri,
            **bkw)
        a, r = leaf_errors(got, want, names)
        bwd_abs, bwd_rel = max(bwd_abs, a), max(bwd_rel, r)
        print(f"backward kernel vs plain, mesh_showcase {w}x{h} {spp} spp "
              f"depth {depth}: max error {r:.3e} of the leaf's max abs "
              f"({a:.3g} abs), triangle leaves included")

    # ---- 17d. the AOV step -----------------------------------------------------
    reset_launches()
    runs_before = renderer.AOV_GRAFT_RUNS
    verts = verts0.clone().requires_grad_()
    centers = scene.spheres.center.clone().requires_grad_()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    img = renderer.render_image(
        params_mod.apply_params(scene, {"triangle_vertices": verts,
                                        "sphere_centers": centers}),
        camera, width=width, height=height, samples_per_pixel=16,
        trace_depth=8, key=rng.PRNGKey(11))
    (torch.mean((img.color - target) ** 2) + torch.mean(img.normal ** 2)
     + torch.mean(img.albedo ** 2)).backward()
    torch.cuda.synchronize()
    out["aov_step_s"] = time.perf_counter() - t0
    aov_tri = triangle_select.LAUNCHES
    if (aov_tri == 0 or renderer.AOV_GRAFT_RUNS != runs_before + 1
            or not bool(torch.isfinite(verts.grad).all())
            or float(verts.grad.abs().max()) == 0):
        raise RuntimeError("the mesh AOV step did not graft through "
                           "triangle_select")
    print(f"AOV step, mesh_showcase {width}x{height}, 16 spp, depth 8: "
          f"{out['aov_step_s']:.3f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB, launches "
          f"triangle_select {aov_tri}, sphere_select "
          f"{sphere_select.LAUNCHES['sphere_select']} [{card}]")

    # ---- 17e. the trainer on a small mesh's vertices --------------------------
    small, scam = smooth_triangle(dev)
    true = params_mod.soup_vertices(small)
    starget = renderer.render_image(small, scam, width=128, height=128,
                                    samples_per_pixel=64, trace_depth=8,
                                    seed=5, differentiable=False).color
    cfg = inverse.InverseRenderConfig(width=128, height=128,
                                      samples_per_pixel=8, trace_depth=8,
                                      learning_rate=1e-2, steps=10)
    init = true + torch.tensor([0.0, 0.1, 0.0], device=dev)
    megatrace_bwd.LAUNCHES = 0
    fit, losses = inverse.optimize(small, scam, starget,
                                   {"triangle_vertices": init}, cfg, seed=0)
    err0 = float((init - true).abs().max())
    err = float((fit["triangle_vertices"] - true).abs().max())
    print(f"trainer: one smooth triangle 128x128, 8 spp, depth 8, 10 Adam "
          f"steps on its vertices: losses {[round(x, 6) for x in losses]}; "
          f"vertex max error {err0:.3f} -> {err:.4f} (backward launches "
          f"{megatrace_bwd.LAUNCHES})")
    if not all(np.isfinite(losses)) or megatrace_bwd.LAUNCHES == 0:
        raise RuntimeError("the mesh trainer failed")
    out["trainer_losses"] = losses
    # the triangle's albedo reaches the image through its record rows and
    # needs no silhouette term, so its fit must converge
    row = int(small.triangles.material[0])
    true = small.textures.main_color
    start = true.clone()
    start[row] = 0.5
    megatrace_bwd.LAUNCHES = 0
    fit, losses = inverse.optimize(
        small, scam, starget, {"texture_colors": start},
        cfg._replace(learning_rate=5e-2), seed=0,
        project=lambda p: {"texture_colors": p["texture_colors"].clamp(0, 1)})
    err0 = float((start - true)[row].abs().max())
    err = float((fit["texture_colors"] - true)[row].abs().max())
    print(f"trainer: the smooth triangle's albedo from 0.5, 10 Adam steps at "
          f"lr 5e-2: losses {[round(x, 6) for x in losses]}; albedo max "
          f"error {err0:.3f} -> {err:.4f} (backward launches "
          f"{megatrace_bwd.LAUNCHES})")
    if (not all(np.isfinite(losses)) or losses[-1] >= 0.5 * losses[0]
            or err >= 0.5 * err0 or megatrace_bwd.LAUNCHES == 0):
        raise RuntimeError("the triangle albedo fit did not converge")
    out["albedo_fit_losses"] = losses

    # ---- 17f. backward kernel vs plain time, 512x512, depth 8, 4 spp ---------
    fwd = megatrace.sample_batch(*args4, want_tape=True, **kw4)
    cots = probe_cotangents(fwd["color"], fwd["count"])
    bargs = (fwd["tape"], args4[0], *args4[2:8], 7, *cots)
    bwd_ms, got = time_batch(megatrace_bwd.replay_grad, *bargs, repeats=5,
                             **kw4)
    bwd_plain_ms, want = time_batch(megatrace_bwd.replay_grad_reference,
                                    *bargs, repeats=1, **kw4)
    a, r = leaf_errors(got, want, names)
    bwd_abs, bwd_rel = max(bwd_abs, a), max(bwd_rel, r)
    live = float(fwd["rays"].sum())
    s_pad = megatrace.sphere_pad_count(s_count)
    tri_iters = float((fwd["tape"] >= s_pad).sum())
    bwd_bound = bound(
        live * BWD_FLOPS + tri_iters * 3 * MT_FLOPS,
        fwd["tape"].numel() * 4 + n * 4 * 5 + s_count * 4 * 16
        + t_pad * 4 * (16 + megatrace.TRI_REC_ROWS) + 4 * 30)
    print(f"backward kernel, triangle arm, mesh_showcase 512x512 depth 8, "
          f"4 spp ({live:.0f} live iterations, {tri_iters:.0f} at triangle "
          f"winners): kernel {bwd_ms:.3f} ms, plain {bwd_plain_ms:.3f} ms, "
          f"bound {bwd_bound[0]:.4f} ms by {bwd_bound[1]}; max error "
          f"{r:.3e} of the leaf's max abs [{card}]")

    # ---- 18. the CLI on the mesh scenes ----------------------------------------
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        for name, spp in (("triangle", 16), ("mesh_showcase", 16),
                          ("mesh_large", 8), ("mesh_huge", 8)):
            png = os.path.join(tmp, f"{name}.png")
            reset_launches()
            t0 = time.perf_counter()
            rc = cli.main(["--scene", name, "--width", "256", "--height",
                           "256", "--spp", str(spp), "--depth", "8",
                           "--output", png, "--quiet"])
            seconds = time.perf_counter() - t0
            with open(png, "rb") as f:
                header = f.read(8)
            sync = (meshtrace.SYNC_LAUNCHES, meshtrace.COMPACT_LAUNCHES,
                    meshtrace.RESTORE_LAUNCHES)
            took = (min(sync) > 0 and megatrace.LAUNCHES == 0
                    if name == "mesh_huge"
                    else megatrace.LAUNCHES > 0 and max(sync) == 0)
            if rc != 0 or header != b"\x89PNG\r\n\x1a\n" or not took:
                raise RuntimeError(f"the CLI did not render --scene {name} "
                                   f"through its kernels (rc {rc}, batch "
                                   f"{megatrace.LAUNCHES}, sync {sync})")
            print(f"CLI: --scene {name} 256x256, {spp} spp, depth 8 on the "
                  f"card: PNG written in {seconds:.2f} s, launches batch "
                  f"kernel {megatrace.LAUNCHES}, bounce_sync / pair_compact "
                  f"/ restore {sync}")
    print(f"phase 18: {time.perf_counter() - t_phase:.1f} s")

    kernel = {
        "name": "triangle_select",
        "route": "cuda",
        "source": "raytracing_in_one_weekend_tpu_torch/csrc/triangle_select.cu",
        "replaces": "raytracing_in_one_weekend_tpu/ops/pallas_triangle.py:42",
        "launches": tri_launches,
        "max_abs_err": max(errs),
        "ms": sel_ms,
        "plain_ms": sel_plain_ms,
        "bound_ms": sel_bound[0],
        "bound_by": sel_bound[1],
        "library_ms": None,
    }
    out["batch_triangle_arm"] = dict(
        launches=fwd_launches, max_abs_err=max_err, ms=batch_ms,
        plain_ms=batch_plain_ms, bound_ms=batch_bound[0],
        bound_by=batch_bound[1], parity_share=min(shares[-4:]))
    out["bwd_triangle_arm"] = dict(
        launches=fb_launches[1], max_abs_err=bwd_abs, max_rel_err=bwd_rel,
        ms=bwd_ms, plain_ms=bwd_plain_ms, bound_ms=bwd_bound[0],
        bound_by=bwd_bound[1])
    return {"kernel": kernel, "paths": out}


# ---------------------------------------------------------------------------
# Phases 19-21: streamed meshes
# ---------------------------------------------------------------------------

FLAG_ROWS = (12, 13, 20, meshtrace.RAYS_ROW, meshtrace.LANE_ROW)
STATE_FLOATS = tuple(r for r in range(meshtrace.ST_ROWS) if r not in FLAG_ROWS)


def launch_ms(fn, inputs: list) -> float:
    """Median milliseconds of `fn(x)` over the inputs after the first (a
    warm-up), each call alone between two CUDA events.  The inputs are
    made beforehand, so an in-place kernel's fresh copy is not timed."""
    fn(inputs[0])
    times = []
    for x in inputs[1:]:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn(x)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_once(fn) -> tuple[float, object]:
    """(milliseconds of one call from CUDA events, its result): for the
    plain versions, which need no warm-up."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    result = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), result


def random_state(tiles: int, alive_share: float, seed: int, dev):
    """A (24, tiles * 1024) state for the permutes: normal rows, lane ids
    0..n-1, `alive_share` of the lanes alive, a fifth of the direction
    components +0.0 and a fifth -0.0."""
    g = torch.Generator().manual_seed(seed)
    n = tiles * meshtrace.RAY_TILE
    state = torch.randn((meshtrace.ST_ROWS, n), generator=g)
    d = state[3:6]
    d.masked_fill_(torch.rand(d.shape, generator=g) < 0.2, 0.0)
    d.masked_fill_(torch.rand(d.shape, generator=g) < 0.2, -0.0)
    state[12] = 0.0
    state[12, torch.randperm(n, generator=g)[:round(n * alive_share)]] = 1.0
    state[meshtrace.LANE_ROW] = torch.arange(n, dtype=torch.float32)
    return state.to(dev)


def same_bits(a, b) -> bool:
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def check_permutes(label: str, state, restore: bool = True) -> None:
    """pair_compact (and restore of its result) against the plain versions,
    bit for bit; raises otherwise."""
    got = meshtrace.pair_compact(state)
    ok = same_bits(got, meshtrace.pair_compact_reference(state))
    if restore:
        back = meshtrace.restore(got)
        ok = (ok and same_bits(back, meshtrace.restore_reference(got))
              and same_bits(back[:, :state.shape[1]], state))
    torch.cuda.synchronize()
    print(f"permutes {label}: {'bit-identical' if ok else 'DIFFER'}")
    if not ok:
        raise RuntimeError(f"pair_compact/restore differ from their plain "
                           f"versions ({label})")


def state_agreement(a, b) -> tuple[float, float]:
    """(share of lanes whose flags, ray count and lane id are identical and
    whose float rows agree within TOL, max abs float error on them)."""
    fa, fb = a[list(STATE_FLOATS)], b[list(STATE_FLOATS)]
    same = (a[list(FLAG_ROWS)] == b[list(FLAG_ROWS)]).all(dim=0)
    same &= torch.isclose(fa, fb, **TOL).all(dim=0)
    if not bool(same.any()):
        return 0.0, float("inf")
    return (float(same.float().mean()),
            float((fa - fb).abs()[:, same].max()))


def sync_args(scene):
    """sample_batch_sync's scene arguments, streamed tables included."""
    packed = materials.pack_materials(scene)
    return (scene.spheres.center, scene.spheres.radius,
            megatrace.pack_sphere_records(scene, packed),
            scene.environment.sky_bottom, scene.environment.sky_top,
            megatrace.pack_tri_stream_tables(scene, packed))


def run_sync(scene, camera, width, height, samples, key):
    n = width * height
    dev = scene.spheres.center.device
    return meshtrace.sample_batch_sync(
        torch.full((n,), samples, dtype=torch.int32, device=dev),
        torch.zeros(n, device=dev), camera, key, *sync_args(scene),
        width=width, height=height, samples=samples, trace_depth=8,
        has_dielectrics=scene.flags.has_dielectrics, sky_on=True)


@contextlib.contextmanager
def plain_sync_kernels():
    """sample_batch_sync with the plain versions of its three kernels."""
    names = ("bounce_sync", "pair_compact", "restore")
    saved = {k: getattr(meshtrace, k) for k in names}
    for k in names:
        setattr(meshtrace, k, getattr(meshtrace, f"{k}_reference"))
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(meshtrace, k, v)


def recorded_wave(scene, cs, width, height, dev):
    """The inputs and results of every bounce_sync, pair_compact and
    restore call of one 8-spp wave of `scene` at width x height."""
    cam, _ = batch_inputs(scene, cs, width, height, dev)
    with recorded_calls(meshtrace, "bounce_sync") as bounces, \
            recorded_calls(meshtrace, "pair_compact") as compacts, \
            recorded_calls(meshtrace, "restore") as restores:
        run_sync(scene, cam, width, height, 8, rng.PRNGKey(5))
    torch.cuda.synchronize()
    if len(bounces) != 8 or len(compacts) != 7 or len(restores) != 1:
        raise RuntimeError(f"a depth-8 wave made {len(bounces)} bounces, "
                           f"{len(compacts)} compactions, {len(restores)} "
                           "restores")
    return bounces, compacts, restores


def stream_bytes(stream) -> int:
    return sum(t.numel() * 4 for t in stream)


def traversal_counts(state, args) -> dict:
    """The triangle and AABB tests of bounce_sync's sweep on `state`, from
    its plain model (meshtrace.sync_traversal) in groups of SYNC_GROUP
    lanes: the lanes' own, the warps' (32 lanes per warp that runs a
    staged block) and the groups' (every live lane against every staged
    block).  Raises unless the visit order the kernel's blocks compute
    (meshtrace.kernel_visit_order) is the model's, bit for bit."""
    sph, stream = args[4][0], args[5]
    group = meshtrace.SYNC_GROUP
    o = tuple(state[i] for i in range(3))
    d = tuple(state[i] for i in range(3, 6))
    best_t, _ = megatrace._sweep(o, d, sph, 0.0)
    order, dist = meshtrace.tile_super_order(state, stream.sup, group)
    k_order, k_dist = meshtrace.kernel_visit_order(state, stream.sup)
    if not (torch.equal(order, k_order) and same_bits(dist, k_dist)):
        raise RuntimeError("the kernel's visit order differs from "
                           "tile_super_order's")
    _, counts = meshtrace.sync_traversal(o, d, best_t, state[12] > 0.0,
                                         stream, group, order, dist)
    return counts


def streamed_phases(dev, card, width: int = 512, small: int = 128,
                    spp: int = 64) -> dict:
    """Phases 19-21 on mesh_large (20,748 triangles: the batch kernel's
    streamed arm) and mesh_huge (102,656: the sync sampler), at width x
    width and small x small, `spp` samples per main-path batch."""
    scenes = {}
    for name in ("mesh_large", "mesh_huge"):
        scene, cs = getattr(meshes, name)()
        scene = scene.to(dev)
        if (not megatrace.scene_eligible(scene, allow_triangles=True)
                or megatrace_replay.replay_eligible(scene)):
            raise RuntimeError(f"{name} left the streamed arm's scope")
        scenes[name] = (scene, cs)
    huge, huge_cs = scenes["mesh_huge"]
    large, large_cs = scenes["mesh_large"]
    height = width
    n = width * height
    out = {}

    # ---- 19. the sync sampler's kernels vs plain --------------------------------
    t_phase = time.perf_counter()
    for tiles in (2, 3, 4, 1024):
        for share in (0.0, 0.5, 1.0):
            check_permutes(f"random {tiles} tiles, {share:.0%} alive",
                           random_state(tiles, share, 100 + tiles, dev))
    wave = recorded_wave(huge, huge_cs, small, small, dev)
    for i, (args, _, _) in enumerate(wave[1]):
        check_permutes(f"mesh_huge {small}x{small} wave, compaction {i}",
                       args[0], restore=False)
    (args, _, _), = wave[2]
    if not same_bits(meshtrace.restore(args[0]),
                     meshtrace.restore_reference(args[0])):
        raise RuntimeError("restore differs from its plain version on the "
                           "mesh_huge wave")
    sync_err = 0.0
    for b in (0, 3):
        args, kw, _ = wave[0][b]
        got = meshtrace.bounce_sync(args[0].clone(), *args[1:], **kw)
        want = meshtrace.bounce_sync_reference(args[0].clone(), *args[1:],
                                               **kw)
        share, err = state_agreement(got, want)
        sync_err = max(sync_err, err)
        print(f"bounce_sync vs plain, mesh_huge {small}x{small} 8 spp, "
              f"bounce {b} "
              f"({int((args[0][12] > 0).sum())} live lanes): {share:.6f} of "
              f"lanes identical (flags, rays, lane; floats within 1e-4), max "
              f"abs err {err:.3g}")
        if share < 0.99:
            raise RuntimeError(f"bounce_sync agreement {share} < 0.99")

    full = recorded_wave(huge, huge_cs, width, height, dev)
    for i, (args, _, _) in enumerate(full[1]):
        check_permutes(f"mesh_huge {width}x{height} wave, compaction {i}",
                       args[0], restore=False)
    huge_stream = full[0][0][0][5]
    group = meshtrace.SYNC_GROUP

    # every bounce of the wave, by CUDA events (after the earlier phases'
    # profiler sessions, torch.profiler once saw none of this kernel's
    # launches), and the traversal model's counts
    per_bounce = []
    for b, (args, kw, _) in enumerate(full[0]):
        st = args[0]
        live_b = int((st[12] > 0).sum())
        k_ms = launch_ms(lambda x: meshtrace.bounce_sync(x, *args[1:], **kw),
                         [st.clone() for _ in range(4)])
        counts = traversal_counts(st, args)
        per_bounce.append(dict(bounce=b, live=live_b, kernel_ms=k_ms,
                               **counts))
        print(f"bounce_sync, mesh_huge {width}x{height} 8 spp, bounce {b}: "
              f"{live_b} live lanes, kernel {k_ms:.3f} ms; per live lane "
              f"{counts['lane_pairs'] / max(live_b, 1):.1f} triangles and "
              f"{counts['lane_slabs'] / max(live_b, 1):.1f} AABBs tested; "
              f"the lanes' share of the triangle tests of warps of one "
              f"lane a thread "
              f"{counts['lane_pairs'] / max(counts['warp_pairs'], 1):.3f}, "
              f"of {group}-lane groups testing every staged block "
              f"{counts['lane_pairs'] / max(counts['group_pairs'], 1):.3f} "
              f"[{card}]")
    args, kw, _ = full[0][1]
    st1 = args[0]
    n_pad = st1.shape[1]
    live = int((st1[12] > 0).sum())
    sync_ms = per_bounce[1]["kernel_ms"]
    megatrace.TRI_PAIRS = megatrace.SLAB_TESTS = 0
    sync_plain_ms, want = time_once(
        lambda: meshtrace.bounce_sync_reference(st1.clone(), *args[1:], **kw))
    pairs, slabs = megatrace.TRI_PAIRS, megatrace.SLAB_TESTS
    got = meshtrace.bounce_sync(st1.clone(), *args[1:], **kw)
    share, err = state_agreement(got, want)
    if share < 0.99:
        raise RuntimeError(f"bounce_sync agreement {share} < 0.99 at "
                           f"{width}x{height}")
    sync_err = max(sync_err, err)
    s_count = huge.spheres.center.shape[0]
    own = per_bounce[1]

    def sync_bound_of(pairs_, slabs_):
        return bound(
            live * (s_count * SWEEP_FLOPS + SHADE_FLOPS) + pairs_ * MT_FLOPS
            + slabs_ * SLAB_FLOPS,
            2 * meshtrace.ST_ROWS * 4 * n_pad + stream_bytes(huge_stream))

    # the least work: the kernel's own tests (the model's, in the order the
    # kernel computes) or the plain version's index order's, whichever
    # bound is lower
    index_bound = sync_bound_of(pairs, slabs)
    sync_bound = min(sync_bound_of(own["lane_pairs"], own["lane_slabs"]),
                     index_bound)
    print(f"bounce_sync, mesh_huge {width}x{height} 8 spp, bounce 1 "
          f"({n_pad} lanes, "
          f"{live} live; the plain version's index order tests "
          f"{pairs / live:.1f} triangles and {slabs / live:.1f} AABBs per "
          f"live lane, the kernel {own['lane_pairs'] / live:.1f} and "
          f"{own['lane_slabs'] / live:.1f}): kernel "
          f"{sync_ms:.3f} ms, plain {sync_plain_ms:.3f} ms, bound "
          f"{sync_bound[0]:.4f} ms by {sync_bound[1]} (by the index order's "
          f"counts {index_bound[0]:.4f} ms); {share:.6f} of lanes agree, "
          f"max abs err {err:.3g} [{card}]")

    perm_bound = bound(0.0, 2 * meshtrace.ST_ROWS * 4 * n_pad)
    cst = full[1][0][0][0]
    compact_ms, _ = time_batch(meshtrace.pair_compact, cst, repeats=20)
    compact_plain_ms, _ = time_once(
        lambda: meshtrace.pair_compact_reference(cst))
    rst = full[2][0][0][0]
    restore_plain_ms, want = time_once(
        lambda: meshtrace.restore_reference(rst))
    ids = rst[meshtrace.LANE_ROW].long()
    lib_out = torch.empty_like(rst)
    # in turns: restore, index_copy_, index_copy_, restore
    turns = {"restore": [], "index_copy_": []}
    calls = {"restore": lambda: meshtrace.restore(rst),
             "index_copy_": lambda: lib_out.index_copy_(1, ids, rst)}
    for name in ("restore", "index_copy_", "index_copy_", "restore"):
        turns[name].append(time_batch(calls[name], repeats=20)[0])
    restore_ms, index_copy_ms = (statistics.mean(turns[k])
                                 for k in ("restore", "index_copy_"))
    if not (same_bits(meshtrace.restore(rst), want)
            and same_bits(lib_out, want)):
        raise RuntimeError("restore, its plain version and index_copy_ "
                           "differ on the full-width wave")
    print(f"pair_compact, {width}x{height} wave ({n_pad} lanes): kernel "
          f"{compact_ms:.4f} ms, plain {compact_plain_ms:.3f} ms; restore "
          f"(in turns, ms: {turns}): kernel {restore_ms:.4f} ms, "
          f"index_copy_ {index_copy_ms:.4f} ms, plain "
          f"{restore_plain_ms:.3f} ms; bound "
          f"{perm_bound[0]:.4f} ms by {perm_bound[1]} each [{card}]")
    if restore_ms > index_copy_ms:
        print(f"NOTE: restore ({restore_ms:.4f} ms) is slower than "
              f"index_copy_ ({index_copy_ms:.4f} ms)")
    out["sync_bounces"] = per_bounce
    out["restore_turns"] = turns
    del wave, full, st1, cst, rst, lib_out, want, got
    torch.cuda.empty_cache()
    print(f"phase 19: {time.perf_counter() - t_phase:.1f} s")

    # ---- 20. the batch kernel's streamed arm vs plain -------------------------
    t_phase = time.perf_counter()
    large_stream = megatrace.pack_tri_stream_tables(
        large, materials.pack_materials(large))
    kw = dict(has_dielectrics=large.flags.has_dielectrics, sky_on=True,
              tri_stream_tables=large_stream)
    w = h = small
    _, tables = batch_inputs(large, large_cs, w, h, dev)
    order, _ = (t.to(dev) for t in megatrace.morton_order(w, h))
    lanes8 = torch.full((w * h,), 8, dtype=torch.int32, device=dev)
    zeros = torch.zeros(w * h, device=dev)
    arm_shares, arm_err = [], 0.0
    for seed in (11, 12):
        share, err = check_parity(
            f"streamed arm, mesh_large {w}x{h} 8 spp depth 8 seed {seed}, "
            "Morton lanes", (lanes8, zeros, *tables, seed),
            dict(kw, samples=8, trace_depth=8, pixel_index=order), tape=False)
        arm_shares.append(share)
        arm_err = max(arm_err, err)
    camera, tables = batch_inputs(large, large_cs, width, height, dev)
    order, _ = (t.to(dev) for t in megatrace.morton_order(width, height))
    args4 = (torch.full((n,), 4, dtype=torch.int32, device=dev),
             torch.zeros(n, device=dev), *tables, 7)
    kw4 = dict(kw, samples=4, trace_depth=8, pixel_index=order)
    arm_ms, got = time_batch(megatrace.sample_batch, *args4, repeats=5,
                             **kw4)
    megatrace.TRI_PAIRS = megatrace.SLAB_TESTS = 0
    arm_plain_ms, want = time_once(
        lambda: megatrace.sample_batch_reference(*args4, **kw4))
    pairs, slabs = megatrace.TRI_PAIRS, megatrace.SLAB_TESTS
    share, err = lane_agreement(got, want)
    if share < 0.99:
        raise RuntimeError(f"streamed arm agreement {share} < 0.99 in the "
                           "timed 4 spp batch")
    arm_shares.append(share)
    arm_err = max(arm_err, err)
    bounces = float(got["rays"].sum())
    s_count = large.spheres.center.shape[0]
    arm_bound = bound(
        bounces * (s_count * SWEEP_FLOPS + SHADE_FLOPS) + pairs * MT_FLOPS
        + slabs * SLAB_FLOPS,
        n * 4 * (3 + megatrace.OUT_ROWS) + s_count * 4 * 20 + 4 * 32
        + stream_bytes(large_stream))
    print(f"batch kernel, streamed arm, mesh_large {width}x{height} depth 8, "
          f"4 spp, "
          f"Morton lanes ({bounces:.0f} bounces, {pairs / bounces:.1f} "
          f"triangles and {slabs / bounces:.1f} AABBs tested per bounce of "
          f"{large.triangles.vert0.shape[0]}): kernel {arm_ms:.3f} ms "
          f"({bounces / arm_ms / 1e3:.3f} MRays/s), plain {arm_plain_ms:.3f} "
          f"ms, bound {arm_bound[0]:.4f} ms by {arm_bound[1]}; {share:.6f} "
          f"of lanes agree, max abs err {err:.3g} [{card}]")
    print(f"phase 20: {time.perf_counter() - t_phase:.1f} s")

    # ---- 21. the forward streamed-mesh paths ------------------------------------
    t_phase = time.perf_counter()
    launches = {}
    for name, (scene, cs) in scenes.items():
        camera, _ = batch_inputs(scene, cs, width, height, dev)
        acc = film.zero_accumulators(n, device=dev)
        gen = torch.Generator().manual_seed(0)

        def forward():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, m = renderer.render_batch(scene, camera, acc, gen,
                                         width=width, height=height,
                                         samples=spp, trace_depth=8)
            rays_ = float(m.total_rays)  # waits for the device
            torch.cuda.synchronize()
            return rays_, time.perf_counter() - t0

        forward()  # warm-up
        reset_launches()
        runs = [forward() for _ in range(5)]
        counts = dict(batch=megatrace.LAUNCHES,
                      bounce_sync=meshtrace.SYNC_LAUNCHES,
                      pair_compact=meshtrace.COMPACT_LAUNCHES,
                      restore=meshtrace.RESTORE_LAUNCHES,
                      backward=megatrace_bwd.LAUNCHES)
        sync_counts = [counts[k] for k in ("bounce_sync", "pair_compact",
                                           "restore")]
        took = (min(sync_counts) > 0 and counts["batch"] == 0
                if name == "mesh_huge"
                else counts["batch"] > 0 and max(sync_counts) == 0)
        if not took or counts["backward"]:
            raise RuntimeError(f"the forward {name} path took the wrong "
                               f"kernels: {counts}")
        launches[name] = counts
        img = film.combine(acc, width, height).color
        if not bool(torch.isfinite(img).all()) or float(img.mean()) <= 0.05:
            raise RuntimeError(f"bad {name} image: mean {float(img.mean())}")
        out[f"{name}_mrays"] = statistics.median(r / s / 1e6 for r, s in runs)
        route = "sync sampler" if name == "mesh_huge" else "streamed arm"
        print(f"forward {name} ({route}): {width}x{height} depth 8, {spp} "
              f"spp/batch: median {out[f'{name}_mrays']:.3f} MRays/s over 5 "
              f"batches ({runs[0][0]:.0f} rays/batch; launches {counts}); "
              f"image mean {float(img.mean()):.4f} [{card}]")

    # the other route on each scene, called directly
    camera, tables = batch_inputs(large, large_cs, width, height, dev)
    runs = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = run_sync(large, camera, width, height, spp, rng.PRNGKey(300 + i))
        runs.append(float(d["rays"].sum()) / (time.perf_counter() - t0) / 1e6)
    out["mesh_large_sync_mrays"] = statistics.median(runs)
    camera, tables = batch_inputs(huge, huge_cs, width, height, dev)
    huge_stream = megatrace.pack_tri_stream_tables(
        huge, materials.pack_materials(huge))
    lanes = torch.full((n,), spp, dtype=torch.int32, device=dev)
    runs = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = megatrace.sample_batch(
            lanes, torch.zeros(n, device=dev), *tables, 400 + i,
            pixel_index=order, tri_stream_tables=huge_stream, samples=spp,
            trace_depth=8, has_dielectrics=huge.flags.has_dielectrics)
        runs.append(float(d["rays"].sum()) / (time.perf_counter() - t0) / 1e6)
    out["mesh_huge_batch_mrays"] = statistics.median(runs)
    print(f"other routes, {width}x{height} depth 8, {spp} spp, median of 3 "
          f"batches: "
          f"mesh_large through the sync sampler "
          f"{out['mesh_large_sync_mrays']:.3f} MRays/s, mesh_huge through "
          f"the batch kernel's streamed arm "
          f"{out['mesh_huge_batch_mrays']:.3f} MRays/s [{card}]")

    # sample_batch_sync with its kernels against it with the plain versions
    w = h = small
    camera, _ = batch_inputs(huge, huge_cs, w, h, dev)
    got = run_sync(huge, camera, w, h, 8, rng.PRNGKey(9))
    with plain_sync_kernels():
        want = run_sync(huge, camera, w, h, 8, rng.PRNGKey(9))
    share, err = lane_agreement(got, want)
    print(f"sample_batch_sync kernels vs plain, mesh_huge {w}x{h} 8 spp "
          f"depth 8: {share:.6f} of pixels identical (count, rays; floats "
          f"within 1e-4), max abs err {err:.3g}")
    if share < 0.99:
        raise RuntimeError(f"sync sampler agreement {share} < 0.99")
    out["sync_pixel_share"] = share
    out["streamed_arm_share"] = min(arm_shares)
    print(f"phase 21: {time.perf_counter() - t_phase:.1f} s")

    def entry(name, source, replaces, launches_, err_, ms, plain_ms, bnd,
              library_ms=None):
        return {"name": name, "route": "cuda",
                "source": f"raytracing_in_one_weekend_tpu_torch/csrc/{source}",
                "replaces": f"raytracing_in_one_weekend_tpu/ops/{replaces}",
                "launches": launches_, "max_abs_err": err_, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": library_ms}

    sync_launches = launches["mesh_huge"]
    kernels = [
        entry("megatrace_batch_streamed_arm", "megatrace_batch.cu",
              "pallas_megatrace.py:2457", launches["mesh_large"]["batch"],
              arm_err, arm_ms, arm_plain_ms, arm_bound),
        entry("meshtrace_sync", "meshtrace_sync.cu", "pallas_meshtrace.py:117",
              sync_launches["bounce_sync"], sync_err, sync_ms,
              sync_plain_ms, sync_bound),
        entry("pair_compact", "meshtrace_permute.cu",
              "pallas_meshtrace.py:174", sync_launches["pair_compact"], 0.0,
              compact_ms, compact_plain_ms, perm_bound),
        entry("restore", "meshtrace_permute.cu", "pallas_meshtrace.py:278",
              sync_launches["restore"], 0.0, restore_ms, restore_plain_ms,
              perm_bound, index_copy_ms),
    ]
    return {"kernels": kernels, "paths": out}


def main() -> int:
    # ---- 1. the card ---------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    loaders = (megatrace.load_kernel, megatrace_bwd.load_kernel,
               sphere_select.load_kernel, megatrace.load_wave_kernel,
               triangle_select.load_kernel, meshtrace.load_sync_kernel,
               meshtrace.load_permute_kernel)
    with ThreadPoolExecutor(max_workers=len(loaders)) as pool:
        for build in [pool.submit(load) for load in loaders]:
            build.result()
    print(f"build: megatrace_batch.cu, megatrace_bwd.cu, sphere_select.cu, "
          f"megatrace_wave.cu, triangle_select.cu, meshtrace_sync.cu and "
          f"meshtrace_permute.cu in {time.perf_counter() - t0:.1f} s")
    for name, log in (("megatrace_batch", megatrace.BUILD_LOG),
                      ("megatrace_bwd", megatrace_bwd.BUILD_LOG),
                      ("sphere_select", sphere_select.BUILD_LOG),
                      ("megatrace_wave", megatrace.WAVE_BUILD_LOG),
                      ("triangle_select", triangle_select.BUILD_LOG),
                      ("meshtrace_sync", meshtrace.SYNC_BUILD_LOG),
                      ("meshtrace_permute", meshtrace.PERMUTE_BUILD_LOG)):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas {name}: {line.strip()}")

    scene, cs = book_scenes.cover_scene()
    scene = scene.to(dev)
    if megatrace.scene_eligible(scene) is not True:
        raise RuntimeError("the cover scene left the ported slice")

    # ---- 3. kernel vs plain version --------------------------------------
    w = h = 128
    spp, depth = 8, 8
    _, tables = batch_inputs(scene, cs, w, h, dev)
    lane_count = torch.full((w * h,), spp, dtype=torch.int32, device=dev)
    count_in = torch.zeros(w * h, device=dev)
    kw = dict(samples=spp, trace_depth=depth,
              has_dielectrics=scene.flags.has_dielectrics, sky_on=True)
    shares, max_err = [], 0.0
    for seed in (11, 12):
        share, err = check_parity(
            f"{w}x{h} {spp} spp seed {seed}",
            (lane_count, count_in, *tables, seed), kw,
        )
        shares.append(share)
        max_err = max(max_err, err)

    # ---- 4. main path ---------------------------------------------------
    width = height = 512
    camera, _ = batch_inputs(scene, cs, width, height, dev)
    gen = torch.Generator().manual_seed(0)

    def forward(samples, trace_depth, acc):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, m = renderer.render_batch(
            scene, camera, acc, gen, width=width, height=height,
            samples=samples, trace_depth=trace_depth,
        )
        rays = float(m.total_rays)  # waits for the device
        torch.cuda.synchronize()
        return rays, time.perf_counter() - t

    acc = film.zero_accumulators(width * height, device=dev)
    megatrace.LAUNCHES = megatrace_bwd.LAUNCHES = 0
    forward(64, 8, acc)  # warm-up
    runs = [forward(64, 8, acc) for _ in range(5)]
    launches = megatrace.LAUNCHES
    if launches == 0:
        raise RuntimeError("the main path launched no kernel")
    if megatrace_bwd.LAUNCHES != 0:
        raise RuntimeError("the forward path launched the backward kernel")
    fwd = statistics.median(r / t / 1e6 for r, t in runs)
    rays8 = runs[0][0]
    print(f"main path: cover {width}x{height} depth 8, 64 spp/batch: "
          f"median {fwd:.3f} MRays/s over 5 batches "
          f"({rays8:.0f} rays/batch, {launches} kernel launches) [{card}]")
    img = film.combine(acc, width, height).color
    if not bool(torch.isfinite(img).all()) or float(img.mean()) <= 0.2:
        raise RuntimeError(f"bad image: mean {float(img.mean())}")
    print(f"image: 6 batches x 64 spp, finite, mean {float(img.mean()):.4f}")

    # kernel vs plain version on the inputs the main path gives the kernel:
    # a first batch (count_in 0, so the fallback AOVs are captured), then
    # an adaptive batch fed the first one's weight extrema (per-pixel lane
    # counts in 1..64, count_in > 0)
    acc = film.zero_accumulators(width * height, device=dev)
    with recorded_calls(megatrace, "sample_batch") as calls:
        _, m = renderer.render_batch(
            scene, camera, acc, gen, width=width, height=height, samples=64,
            trace_depth=8,
        )
        renderer.render_batch(
            scene, camera, acc, gen, width=width, height=height, samples=64,
            trace_depth=8, sample_range=(1, 64),
            weight_extrema=torch.stack([m.weight_min, m.weight_max]),
        )
    (args1, kw1, _), (args2, kw2, _) = calls
    lanes2, count_in2 = args2[0], args2[1]
    if float(count_in2.min()) <= 0 or int(lanes2.min()) == int(lanes2.max()):
        raise RuntimeError("the adaptive batch kept count_in 0 or uniform "
                           "lane counts")
    for label, args, kwargs in (
        (f"{width}x{height} 64 spp, first batch", args1, kw1),
        (f"{width}x{height} adaptive {int(lanes2.min())}..{int(lanes2.max())}"
         f" spp, count_in > 0", args2, kw2),
    ):
        share, err = check_parity(label, args, kwargs)
        shares.append(share)
        max_err = max(max_err, err)

    acc35 = film.zero_accumulators(width * height, device=dev)
    forward(128, 35, acc35)  # warm-up
    runs35 = [forward(128, 35, acc35) for _ in range(3)]
    fwd35 = statistics.median(r / t / 1e6 for r, t in runs35)
    print(f"depth 35: cover {width}x{height}, 128 spp/batch: median "
          f"{fwd35:.3f} MRays/s over 3 batches [{card}]")
    img35 = film.combine(acc35, width, height).color
    if not bool(torch.isfinite(img35).all()) or float(img35.mean()) <= 0.2:
        raise RuntimeError(f"bad depth-35 image: mean {float(img35.mean())}")

    # ---- 5. kernel vs plain time at 512x512, depth 8, 4 spp --------------
    _, tables = batch_inputs(scene, cs, width, height, dev)
    n = width * height
    lane_count = torch.full((n,), 4, dtype=torch.int32, device=dev)
    count_in = torch.zeros(n, device=dev)
    kw = dict(samples=4, trace_depth=8,
              has_dielectrics=scene.flags.has_dielectrics, sky_on=True)
    ms, out = time_batch(megatrace.sample_batch, lane_count, count_in,
                         *tables, 7, repeats=5, **kw)
    plain_ms, plain_out = time_batch(megatrace.sample_batch_reference,
                                     lane_count, count_in, *tables, 7,
                                     repeats=1, **kw)
    rays4 = float(out["rays"].sum())
    share, err = lane_agreement(out, plain_out)
    if share < 0.99:
        raise RuntimeError(f"kernel/plain agreement {share} < 0.99 in the "
                           "timed 4 spp batch")
    max_err = max(max_err, err)
    s_count = scene.spheres.center.shape[0]
    batch_bound = bound(
        rays4 * (s_count * SWEEP_FLOPS + SHADE_FLOPS),
        n * 4 * (2 + megatrace.OUT_ROWS) + s_count * 4 * (4 + 16) + 4 * 32)
    print(f"512x512 depth 8, 4 spp: kernel {ms:.3f} ms "
          f"({rays4 / ms / 1e3:.3f} MRays/s), plain {plain_ms:.3f} ms "
          f"({rays4 / plain_ms / 1e3:.3f} MRays/s), bound "
          f"{batch_bound[0]:.4f} ms by {batch_bound[1]}; {share:.6f} of "
          f"lanes agree, max abs err {err:.3g} [{card}]")

    target = img.detach()  # bench.py's target: the forward image
    bwd = differentiable_phases(dev, card, scene, cs, camera, target)
    wave = wavefront_phases(dev, card, scene, cs, camera, target)
    mesh = mesh_phases(dev, card)
    streamed = streamed_phases(dev, card)

    kernels = [{
        "name": "megatrace_batch",
        "route": "cuda",
        "source": "raytracing_in_one_weekend_tpu_torch/csrc/megatrace_batch.cu",
        "replaces": "raytracing_in_one_weekend_tpu/ops/pallas_megatrace.py:2457",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": batch_bound[0],
        "bound_by": batch_bound[1],
        "library_ms": None,
    }, {
        "name": "megatrace_bwd",
        "route": "cuda",
        "source": "raytracing_in_one_weekend_tpu_torch/csrc/megatrace_bwd.cu",
        "replaces": "raytracing_in_one_weekend_tpu/ops/megatrace_bwd.py:132",
        "launches": bwd["launches"],
        "max_abs_err": bwd["max_abs_err"],
        "max_rel_err": bwd["max_rel_err"],
        "ms": bwd["ms"],
        "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"],
        "bound_by": bwd["bound_by"],
        "library_ms": None,
    }] + wave["kernels"] + [mesh["kernel"]] + streamed["kernels"]
    print(json.dumps({
        "kernels": kernels, "parity_share": min(shares), "fwd_mrays": fwd,
        "depth35_fwd_mrays": fwd35, "fwd_bwd_mrays": bwd["fwd_bwd_mrays"],
        "depth35_fwd_bwd_mrays": bwd["depth35_fwd_bwd_mrays"],
        "step_vjp_rel_err": bwd["step_vjp_rel_err"],
        "replay_primal_share": bwd["replay_primal_share"],
        "peak_gb": bwd["peak_gb"], "trainer_losses": bwd["trainer_losses"],
        "albedo_fit_losses": bwd["albedo_fit_losses"],
        "wavefront": wave["paths"], "mesh": mesh["paths"],
        "streamed": streamed["paths"]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
