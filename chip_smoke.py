"""GPU smoke run of the PyTorch port's main paths: the forward render, the
differentiable render (forward with tape, backward kernel, trainer) and
the wavefront integrator (per-ray megatrace, fused sphere selection, the
AOV-gradient graft), on the book cover and on the `mesh_showcase` mesh
scene (triangle selection, the triangle arms of the batch and backward
kernels), the streamed meshes `mesh_large` and `mesh_huge` (the batch
kernel's streamed arm with Morton lanes, the bounce-synchronous sampler's
bounce, pair compaction and restore), the rect and box scenes
`cornell` and `simple_light` (the aux builds of the batch and backward
kernels) and the convex-volume scenes `volume`, `probabilistic` and
`cornell_volumes` (their volume builds).

    python3 chip_smoke.py
    python3 chip_smoke.py --against DIR

The second form compares this tree with another unpacked at DIR (say,
the parent commit, by `git archive`): the SASS of every kernel of the
seven sources, function by function (the kernels SASS_CHANGED names are
reported as changed on purpose; the sphere build, a template since its
aux build, is compared as its <false> instance), then `turn_readings`
(the sphere build and the streamed arm of the batch kernel, bounce_sync's
bounce 1, the backward at 64 spp on the cover and 4 spp on mesh_showcase,
forward and fwd+bwd MRays/s) in turns, DIR, this, this, DIR, each turn
a process of its own.  The first form needs one CUDA card.  Phases, each of
which raises on failure:
  1. report the card (nvidia-smi name and power limit) and versions;
  2. build the seven kernel sources (csrc/megatrace_batch.cu,
     csrc/megatrace_bwd.cu, csrc/sphere_select.cu, csrc/megatrace_wave.cu,
     csrc/triangle_select.cu, csrc/meshtrace_sync.cu,
     csrc/meshtrace_permute.cu), one nvcc each, all at once; print
     ptxas's register and spill lines (the backward's tape scan and path
     kernel among them);
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
     then the sphere build's map of threads to lanes (8x4 pixel tiles),
     read back from the card, against its plain twin on four shapes, and
     the build's registers, local memory and blocks an SM (ptxas, the
     occupancy API), its time at 64 spp and its lane-use share (the rays
     of the lanes over 32 times the longest lane of each warp) at 4 and
     64 spp, with lane order's beside it;
  6. per-iteration adjoint check: on the states the plain replay passes
     through (cover, 64x64, 4 spp, depth 8), every live iteration (printed
     in full: the first, the first later one with regen, dielectric and
     sky lanes, and the last live one), the backward kernel's
     one-iteration VJP against torch.autograd of the plain
     replay_iteration on every lane; each cotangent tensor
     (megatrace_bwd.STEP_COTANGENTS: every state vector, leaf, the camera
     row and the sky colors) within 5e-4 of its max abs;
  7. backward kernels vs plain versions on the cover, 128x128: 8 spp,
     depth 8, two seeds, and 4 spp, depth 35 (long paths); the tape scan's
     path table equal to `scan_paths_reference`'s; the gradients against
     autograd over the plain replay, probe loss
     sum(color / max(count, 1) * cos(0.37 i)): camera_row, centers,
     radii, records, sky_bottom and sky_top each within 5e-4 of the leaf's
     max abs; the replay's primal equal to the kernel's within 1e-4 on
     >= 99% of lanes (replay drift);
  8. the differentiable main path, bench.py's training reading through
     the port's entry points: render_image(differentiable=True),
     mean((color - target)^2), .backward() to the sphere centers, on the
     cover at 512x512, 64 spp, depth 8 (1 warm-up + 3 timed steps, median
     MRays/s counting the forward rays of the same seed, as bench.py
     does), then at depth 35, 128 spp; gradients finite and nonzero, the
     batch kernel, the tape scan and the path kernel launched, peak device
     memory printed.  The backward is also held to its plain version, as
     in phase 7, on the inputs the last depth-8 step gave it;
  9. the trainer: diff.inverse.optimize, 10 Adam steps on three_spheres
     with perturbed centers at 128x128 (finite losses, backward kernel
     launched), then 10 steps on its albedos from 0.5: the last loss
     below half the first, the albedo error below half its start;
 10. time the backward (replay_grad) and its plain version at 512x512,
     depth 8, 4 spp, and compare their gradients; then, by CUDA events at
     4 and 64 spp, the tape scan's two launches alone (its wrapper's glue,
     the offsets between them, apart) and the path kernel, with the path
     statistics: paths, paths per length, and the share of warp slots the
     grouping leaves idle;
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
     below half its start); (f) the backward and its plain version timed
     at 512x512, depth 8, 4 spp, then the scan and the path kernel apart;
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
     128x128, 8 spp, depth 8, two seeds, Morton lanes, and on 16,339 of
     those lanes with uneven lane counts (0-8 samples, a group with one
     live lane and one with none, a partial last group); the triangle
     tests of its traversal model (meshtrace.sync_traversal over each
     iteration's live lanes in groups of 128, its winners held equal to
     the index-order sweep's) per lane, per warp of one lane a thread and
     per group, and the blocks it stages, on the second 128x128 batch;
     then kernel (CUDA events) and plain version timed at 512x512, depth
     8, 4 spp, the bound the lower of those from the model's and from the
     plain version's counts;
 21. the forward streamed-mesh paths: render_batch at 512x512, depth 8, 64
     spp per batch, 1 warm-up and 5 timed batches (median MRays/s), image
     finite, on mesh_large (the batch kernel's streamed arm, no sync
     kernel) and on mesh_huge (bounce_sync, pair_compact and restore, no
     batch kernel); then the other route on each scene, 3 batches, by
     calling megatrace.sample_batch and meshtrace.sample_batch_sync
     directly; then sample_batch_sync with its kernels against it with
     its plain versions, mesh_huge 128x128, 8 spp, depth 8: count and
     rays identical and floats within 1e-4 on >= 99% of pixels;
 22. rects and boxes (`aux_phases`): render_batch on cornell and
     simple_light at 512x512, depth 8, 64 spp (1 warm-up + 5 timed
     batches, every one through the batch kernel's aux build), the aux
     build against its plain version on a main-path batch's inputs (tape,
     count, rays identical, floats within 1e-4, >= 99% of lanes) and
     alone by CUDA events at 4 and 64 spp; cornell's fwd+bwd step to its
     albedos, rect and box positions and box extents (median MRays/s of 3
     steps), the backward's aux build against the plain replay's autograd
     on that step's inputs (each leaf, rect_geo, rect_rec, box_geo and
     box_rec among them, within 5e-4 of its max abs) and alone at 4 and
     64 spp; the CLI on --scene cornell and --scene simple_light.
 23. convex volumes (`volume_phases`): render_batch on volume,
     probabilistic and cornell_volumes at 512x512, depth 8, 64 spp (1
     warm-up + 5 timed batches, every one through a volume build of the
     batch kernel), the volume build against its plain version on a
     main-path batch's inputs and at 4 spp (tape, count, rays identical,
     floats within 1e-4, >= 99% of lanes), alone by CUDA events at 4 and
     64 spp; the fwd+bwd steps of cornell_volumes (to its material
     parameters and albedos) and volume (to its material parameters and
     sphere centres), the backward's volume builds against the plain
     replay's autograd on each step's inputs (each leaf, vol0 and the
     densities' records among them, within 5e-4 of its max abs) and alone
     at 4 and 64 spp; a camera inside a fog sphere at 128x128, forward and
     backward against their plain versions; the CLI on the three scenes.
 24. unit-shutter motion (`motion_phases`): render_batch on cover_motion
     at 512x512, depth 8, 64 spp (1 warm-up + 3 timed batches, every one
     through the batch kernel's motion build), the build against its
     plain version on the 64 rows at a main-path batch's centre and on
     a whole 4 spp batch, alone by CUDA events at 4 and 64 spp; the
     fwd+bwd step to the sphere centres and move offsets
     (median of 2 steps), the backward's motion build against the plain
     replay's autograd at 128x128, 4 spp, and alone at 4 and 64 spp; the
     CLI on cover_motion.
 25. checker, Perlin and image textures (`texture_phases`): render_batch
     on checkered, perlin, textured_sphere and final_book2 at 512x512,
     depth 8, 64 spp (1 warm-up + 2 timed batches, every one through a
     texture build), each build against its plain version as in 24 and
     alone at 4 and 64 spp; the fwd+bwd steps of checkered and
     textured_sphere to the texture colours (and the atlas) through the
     backward's texture build, held to the plain replay's autograd at
     128x128, 4 spp, and alone at 4 and 64 spp on checkered; one
     differentiable wavefront step on perlin and final_book2 at 128x128
     (no batch kernel: the replay has no marble); the CLI on the four.
MRays/s counts every bounce of every sample as one ray, with the ray
count the kernels themselves report.  Each kernel's bound is the larger of
its operations over the FP32 peak (67 TFLOP/s) and its bytes (each input
read once, each output written once) over 3.35 TB/s, counted from this
run's inputs (see `bound`).  The last line is the JSON status.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import re
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
from raytracing_in_one_weekend_tpu_torch.models import (
    book_scenes, meshes, testbeds,
)
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
FRAME_FLOPS = 63  # the ray into a rect's or box's frame
#   (megatrace_common.cuh aux_frame): o - pos (3) and two quat_rotate (30
#   each: three t components of a fmaf and a product, 3 each, then three
#   of two fmaf, a product and a sum, 6 each)
RECT_FLOPS = FRAME_FLOPS + 12  # per (ray, rect) pair of rect_test: the
#   plane distance (1), the local hit point (two fmaf, 4), six comparisons
#   and the running minimum (1)
BOX_FLOPS = FRAME_FLOPS + 59  # per (ray, box) pair of box_test: the t_min
#   offset (three fmaf, 6), the inside test (three |x| / max(e, 1e-30) and
#   two max, 11, and a comparison), the three face distances (4 each), the
#   three face tests (a comparison and two |fmaf| < e, 9 each), t + t_min
#   and the running minimum (2)
VOL_WALK_FLOPS = 35  # per bounce of the volume builds (megatrace_bounce.cuh
#   shade, kVol): the entry test (a 3-dot, 5), the medium's eight selects
#   (8), the free path (two max, the log, a negation and a division: 5,
#   the log counted once), the segment (2), the decisions (~8 compares),
#   the scatter's distance and point (1 and three fmaf, 7)
SPHERE_EXIT_FLOPS = 25  # per bounce at a sphere winner (sphere_exit): three
#   3-dots (15), b (1), c (3), the discriminant (3), sqrt, the root (3)
BOX_EXIT_FLOPS = FRAME_FLOPS + 35  # per bounce at a box winner (box_exit):
#   the frame, the t_min offsets (three fmaf, 6), three inverses, six slab
#   distances (12), ten min and max, the exit's sum and tests (4)
MOTION_SWEEP_FLOPS = SWEEP_FLOPS + 12  # per (ray, sphere) pair of the
#   motion builds' sweep: the centre at the path's time (three fmaf, 6),
#   |c(t)|^2 (a 3-dot, 5) and its sum (1)
# The texture work, float arithmetic only (abs, min and max count 1, a
# sine, atan2 or acos once; compares, selects, the hash and the loads 0):
CHECKER_FLOPS = 15  # per textured winner of the texture builds' checker
#   (megatrace_bounce.cuh tex_albedo): three |n| (3), two divisions (2),
#   two fmaf (4), the frequency (1), two products and two sines (4) and
#   their product (1)
MARBLE_FLOPS = 7 * (3 * 15 + 8 * 9 + 2 + 6) + 2 + 9  # per winner of the
#   Perlin marble (perlin_noise, perlin_turbulence, tex_albedo): 7 octaves,
#   each three axes (the floor and two fractions, 3; two falloffs, each
#   |t|, two products, a difference and an fmaf, 12), eight corners (the
#   falloff product, 2; the gradient dot, 5; the fmaf into the sum, 2),
#   the clip (2) and the octave's sum, weight and point scalings (6); then
#   the turbulence's clip (2), and the marble's argument (3), sine, sum
#   and half (3) and the three products (3)
TEXEL_FLOPS = 12  # per winner of an image texture: the uv (atan2, its sum
#   and product; the clip, acos and product: 8), the texel's index (2
#   products) and the three products
MOTION_BWD_FLOPS = 2 * 12 + 6  # per live iteration of the backward's
#   motion build at a sphere winner, beyond BWD_FLOPS: the centre at t and
#   |c(t)|^2 twice forward, the move offset's cotangent (3 products)
VOL_BWD_FLOPS = 3 * VOL_WALK_FLOPS  # per live iteration of the backward's
#   volume builds, beyond BWD_FLOPS: the walk twice forward and its adjoint
AUX_BWD_FLOPS = 2 * RECT_FLOPS + 200  # per live iteration of the backward
#   at a rect or box winner, beyond BWD_FLOPS: its frame and distance twice
#   forward (the path's sweep, step_vjp's recompute) and the adjoint of the
#   frame's and the normal's rotations (three quat_rotate_vjp, ~60 flops
#   each) and of the distance


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """(least milliseconds on the card, "operations" or "bytes")."""
    t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def lane_use_share(rays: torch.Tensor, order: torch.Tensor) -> float:
    """The share of a batch's warp slots that run a lane's iteration: the
    rays (iterations) of each lane, summed, over 32 times each warp's
    longest lane summed, with warps of 32 threads and thread t running
    lane order[t] (a partial last warp counts 32 slots)."""
    r = rays.to(torch.float64)[order.to(rays.device)]
    r = torch.cat([r, r.new_zeros((-r.numel()) % 32)]).reshape(-1, 32)
    return float(r.sum() / (32 * r.max(dim=1).values.sum()))


def ptxas_report(log: str, kernel: str) -> str:
    """ptxas's stack/spill and register lines of `kernel` in a build log
    ("" when the library was not compiled by this process)."""
    found, mine = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mine = kernel in line
        elif mine and ("spill" in line or "registers" in line):
            found.append(line.split("ptxas info    :")[-1].strip())
    return "; ".join(found)


def tile_map_check(dev) -> None:
    """The lane each thread of the batch kernel's sphere build runs, as the
    kernel computes it (read back), against its plain twin, and a
    permutation of range(n): 512x512, a ragged last row, a width that is
    not a multiple of the tile, a few lanes."""
    for n, width in ((512 * 512, 512), (512 * 512 - 45, 512),
                     (45 * 37 - 7, 45), (5, 512)):
        got = megatrace.kernel_tile_lanes(n, width, dev).cpu()
        want = megatrace.tile_lane_order(n, width)
        if not torch.equal(got, want):
            raise RuntimeError(f"tile_lane (n {n}, width {width}) is not "
                               "its plain twin")
        if not torch.equal(torch.sort(got).values, torch.arange(n)):
            raise RuntimeError(f"tile_lane (n {n}, width {width}) is not a "
                               "permutation")


def path_stats(paths, trace_depth: int) -> dict:
    """Of the scan's path table (P, 3) in the path kernel's order: the
    paths, the paths of each length 1..trace_depth, and the share of the
    kernel's warp slots (32 consecutive paths a warp, each running its
    warp's longest length in reverse) that no path fills."""
    lengths = paths[:, 2]
    per_length = torch.bincount(lengths, minlength=trace_depth + 1)[1:]
    pad = (-lengths.shape[0]) % 32
    warps = torch.cat([lengths, lengths.new_zeros(pad)]).reshape(-1, 32)
    slots = 32 * float(warps.max(1).values.sum())
    return dict(paths=int(lengths.shape[0]), per_length=per_length.tolist(),
                idle_warp_slots=(1.0 - float(lengths.sum()) / slots
                                 if slots else 0.0))


def bwd_parts_ms(tables, tri, lane_count, tape, cots, seed, kw,
                 repeats: int, rect=None, box=None, vol0=None, move=None,
                 tex=None):
    """The backward's kernels alone by CUDA events after a warm-up: (the
    tape scan's ms, its count and scatter launches alone; its wrapper's
    glue, the offsets and allocations between them; the path kernel's ms;
    the scan's path table, decoded).  `tri` (pack_tri_tables' pair) takes
    the mesh build, `rect` and `box` (pack_aux_tables' pairs) the aux
    build, `vol0` (camera_containment_row) a volume build, `move` (the
    spheres' move offsets) the motion build, `tex` (pack_texture_tables)
    the texture build."""
    s = tables[1].shape[0]
    kind = megatrace_bwd.build_kind(tri is not None,
                                    rect is not None or box is not None,
                                    vol0 is not None, move is not None,
                                    tex is not None)
    if move is None and tex is None:
        rows = megatrace_replay.build_entity_rows(*tables[1:4], tri, rect,
                                                  box)
    else:
        rows = megatrace_replay.build_entity_rows(
            *tables[1:4], tri, rect, box, move,
            None if tex is None else tex.rec)
    args = megatrace_bwd.kernel_args(
        tape, lane_count,
        megatrace_bwd._consts(tables[0], tables[4], tables[5], vol0),
        rows, s, *cots, kind=kind,
        **({} if tex is None else dict(atlas=tex.atlas, dims=tex.dims)))
    scan = (args["tape"], args["per_pixel"], kw["samples"], kw["trace_depth"])
    wrapper_ms, paths = time_batch(megatrace_bwd._scan_cuda, *scan,
                                   repeats=repeats)
    counts = torch.empty((-(-lane_count.shape[0] // 128), kw["trace_depth"]),
                         dtype=torch.int32, device=tape.device)
    count_ms, _ = time_batch(megatrace_bwd._scan_launch, *scan,
                             counts=counts, repeats=repeats)
    offsets, total = megatrace_bwd._scan_offsets(counts)
    into = torch.empty((total, 2), dtype=torch.int32, device=tape.device)
    scatter_ms, _ = time_batch(megatrace_bwd._scan_launch, *scan,
                               offsets=offsets, paths=into, repeats=repeats)
    if not torch.equal(megatrace_bwd.canonical_paths(
            megatrace_bwd.decode_paths(into)),
            megatrace_bwd.canonical_paths(megatrace_bwd.decode_paths(paths))):
        raise RuntimeError("the timed scan launches wrote another path table")
    paths_ms, _ = time_batch(
        megatrace_bwd._paths_cuda, paths, args, seed, 0, repeats=repeats,
        trace_depth=kw["trace_depth"], t_min=0.0,
        has_dielectrics=kw["has_dielectrics"], sky_on=kw.get("sky_on", True),
        jitter=True)
    scan_ms = count_ms + scatter_ms
    return (scan_ms, wrapper_ms - scan_ms, paths_ms,
            megatrace_bwd.decode_paths(paths))


def bwd_bound(live: float, paths: int, n: int, table_bytes: float,
              extra_flops: float = 0.0):
    """The path kernel's bound: its operations (BWD_FLOPS a live
    iteration, plus `extra_flops`) or its bytes (the live tape codes, the
    path table, the lane counts and cotangents, the entity rows it reads,
    `table_bytes`, and the camera and sky)."""
    return bound(live * BWD_FLOPS + extra_flops,
                 live * 4 + paths * 8 + n * 4 * 5 + table_bytes + 4 * 30)


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


def parity_rows(label: str, args: tuple, kwargs: dict, rows: int,
                width: int) -> tuple[float, float]:
    """check_parity on a main-path batch with the plain version run on the
    `rows` image rows at the frame's centre, where each scene's subject
    sits (a 512x512, 64 spp batch takes the plain version about a minute
    whole, and its time goes with its calls' iterations more than with
    their lanes: eight 8-row bands cost eight times one 64-row band): the
    kernel runs the whole batch, the plain version those lanes with their
    own lane ids and pixels, so each computes what it computes in the
    whole batch.  Raise unless >= 99% of them agree."""
    kwargs = dict(kwargs, want_tape=True)
    before = megatrace.LAUNCHES
    got = megatrace.sample_batch(*args, **kwargs)
    torch.cuda.synchronize()
    if megatrace.LAUNCHES != before + 1:
        raise RuntimeError("sample_batch did not launch the kernel")
    height = args[0].shape[0] // width
    base = args[9] if len(args) > 9 else kwargs.pop("lane_base", 0)
    r0 = (height - rows) // 2
    lo, hi = r0 * width, (r0 + rows) * width
    want = megatrace.sample_batch_reference(
        args[0][lo:hi], args[1][lo:hi], *args[2:9], base + lo,
        pixel_index=torch.arange(lo, hi, device=args[0].device), **kwargs)
    share, err = lane_agreement(
        {k: v[:, lo:hi] if k == "tape" else v[lo:hi] for k, v in got.items()},
        want)
    print(f"parity {label} (plain version on rows {r0}-{r0 + rows - 1}, "
          f"{hi - lo} lanes): {share:.6f} of them identical (tape, count, "
          f"rays; floats within 1e-4), max abs err {err:.3g}")
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


def path_table_error(got, want, label: str) -> int:
    """The largest difference between the rows (lane, first iteration,
    length) of two path tables, both sorted longest first, then by lane and
    first iteration; raises unless they are equal."""
    same = got.shape == want.shape
    err = int((got - want).abs().max()) if same and got.shape[0] else 0
    if not same or err != 0:
        raise RuntimeError(f"tape scan vs plain ({label}): {got.shape[0]} "
                           f"paths against {want.shape[0]}, not equal")
    return err


def check_scan(tape, lane_count, samples: int, depth: int,
               label: str) -> int:
    """The tape scan kernel's path table against its plain version's: the
    largest difference of their rows (path_table_error)."""
    got = megatrace_bwd.canonical_paths(megatrace_bwd.scan_paths(
        tape, lane_count, samples=samples, trace_depth=depth))
    want = megatrace_bwd.scan_paths_reference(tape, lane_count, depth)
    err = path_table_error(got, want, label)
    print(f"tape scan vs plain, {label}: {want.shape[0]} paths, equal")
    return err


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
    scan_err = 0
    shares = []
    # depth 35 runs paths longer than any at depth 8
    for spp, depth, seed in ((8, 8, 11), (8, 8, 12), (4, 35, 13)):
        lane_count = torch.full((n,), spp, dtype=torch.int32, device=dev)
        kw = dict(samples=spp, trace_depth=depth,
                  has_dielectrics=scene.flags.has_dielectrics, sky_on=True)
        fwd = megatrace.sample_batch(lane_count, torch.zeros(n, device=dev),
                                     *tables, seed, want_tape=True, **kw)
        cots = probe_cotangents(fwd["color"], fwd["count"])
        scan_err = max(scan_err, check_scan(
            fwd["tape"], lane_count, spp, depth,
            f"cover {w}x{h} {spp} spp depth {depth}"))
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
        megatrace_bwd.SCAN_LAUNCHES = 0
        rate, rays, launches, peak, call = fwd_bwd_steps(
            scene, camera, target, width, height, samples, d, seeds)
        scans = megatrace_bwd.SCAN_LAUNCHES
        if scans == 0:
            raise RuntimeError(f"fwd+bwd at depth {d}: no tape scan launch")
        rates[key], peaks[d] = rate, peak
        tape_gb = samples * d * width * height * 4 / 1e9
        table_gb = samples * width * height * 8 / 1e9
        print(f"fwd+bwd: cover {width}x{height} depth {d}, {samples} spp: "
              f"median {rate:.3f} MRays/s over 3 steps ({rays:.0f} forward "
              f"rays/step; launches batch {launches[0]}, tape scan {scans}, "
              f"path kernel {launches[1]}); peak {peak:.3f} GB (tape "
              f"{tape_gb:.3f} GB, path table {table_gb:.3f} GB) [{card}]")
        if d == 8:
            out["launches"], out["scan_launches"] = launches[1], scans
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

    # ---- 10. backward vs plain time, 512x512, depth 8, 4 and 64 spp ---------
    _, tables = batch_inputs(scene, cs, width, height, dev)
    n = width * height
    s_count = tables[1].shape[0]
    for spp in (4, 64):
        lane_count = torch.full((n,), spp, dtype=torch.int32, device=dev)
        kw = dict(samples=spp, trace_depth=8,
                  has_dielectrics=scene.flags.has_dielectrics, sky_on=True)
        fwd = megatrace.sample_batch(lane_count, torch.zeros(n, device=dev),
                                     *tables, 7, want_tape=True, **kw)
        cots = probe_cotangents(fwd["color"], fwd["count"])
        live = float(fwd["rays"].sum())  # live iterations of the tape
        # the scan and the path kernel alone
        scan_ms, glue_ms, paths_ms, table = bwd_parts_ms(
            tables, None, lane_count, fwd["tape"], cots, 7, kw,
            5 if spp == 4 else 3)
        bnd = bwd_bound(live, table.shape[0], n, s_count * 4 * 16)
        stats = path_stats(table, 8)
        print(f"backward kernels alone, cover 512x512 depth 8, {spp} spp "
              f"(CUDA events): tape scan's two launches {scan_ms:.3f} ms "
              f"(its wrapper's glue {glue_ms:.3f} ms more), path kernel "
              f"{paths_ms:.3f} ms (bound {bnd[0]:.4f} ms by {bnd[1]}, "
              f"{live:.0f} live iterations); {stats['paths']} paths, per "
              f"length 1..8 {stats['per_length']}, idle warp slots "
              f"{stats['idle_warp_slots']:.6f} [{card}]")
        out[f"paths_{spp}spp"] = stats
        if spp == 64:
            out.update(ms_64spp=paths_ms, scan_ms_64spp=scan_ms,
                       scan_glue_ms_64spp=glue_ms, bound_ms_64spp=bnd[0])
            break
        out.update(ms=paths_ms, bound_ms=bnd[0], bound_by=bnd[1])
        # the wrapper and the plain versions, at 4 spp
        args = (fwd["tape"], lane_count, *tables, 7, *cots)
        ms, got = time_batch(megatrace_bwd.replay_grad, *args, repeats=5,
                             **kw)
        plain_ms, want = time_batch(megatrace_bwd.replay_grad_reference,
                                    *args, repeats=1, **kw)
        a, r = leaf_errors(got, want)
        max_abs, max_rel = max(max_abs, a), max(max_rel, r)
        scan_plain_ms, want = time_batch(megatrace_bwd.scan_paths_reference,
                                         fwd["tape"], lane_count, 8,
                                         repeats=1)
        scan_err = max(scan_err, path_table_error(
            megatrace_bwd.canonical_paths(table), want,
            "the timed scan, cover 512x512 4 spp"))
        out["scan"] = dict(ms=scan_ms, glue_ms=glue_ms, plain_ms=scan_plain_ms,
                           max_abs_err=scan_err, bound=bound(
                               0.0, live * 4 + n * 4 + table.shape[0] * 8))
        print(f"512x512 depth 8, 4 spp backward: replay_grad {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms; plain tape scan {scan_plain_ms:.3f}"
              f" ms; max error {r:.3e} of the leaf's max abs [{card}]")
        out.update(replay_grad_ms=ms, plain_ms=plain_ms,
                   max_abs_err=max_abs, max_rel_err=max_rel)
        del fwd, got, want, args, table
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
    megatrace.AUX_LAUNCHES = megatrace.VOL_LAUNCHES = 0
    megatrace.MOTION_LAUNCHES = megatrace.TEX_LAUNCHES = 0
    megatrace_bwd.SCAN_LAUNCHES = 0
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


def mesh_fwd_bwd_steps(scene, camera, target, width, seeds):
    """Forward+backward steps of a mesh scene through render_image(
    differentiable=True), gradients to its soup vertices and sphere
    centres, loss mean((color - target)^2): (median MRays/s of the steps
    after the first seed's, counting the forward rays of each step's seed;
    the last step's forward rays, vertices and centres).  Launch counts
    start at 0."""
    dev = target.device
    n = width * width
    verts0 = params_mod.soup_vertices(scene)
    rays_per = []
    for seed in seeds:
        _, m = renderer.render_batch(
            scene, camera, film.zero_accumulators(n, device=dev),
            width=width, height=width, samples=64, trace_depth=8, seed=seed,
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
            camera, width=width, height=width, samples_per_pixel=64,
            trace_depth=8, seed=seed, differentiable=True)
        torch.mean((img.color - target) ** 2).backward()
        torch.cuda.synchronize()
        rates.append(r / (time.perf_counter() - t0) / 1e6)
    return statistics.median(rates[1:]), rays_per[-1], verts, centers


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
    seeds = [int(torch.randint(0, renderer.SEED_RANGE, (), generator=gen))
             for _ in range(4)]
    fb_mrays, rays_per, verts, centers = mesh_fwd_bwd_steps(
        scene, camera, target, width, seeds)
    fb_launches = (megatrace.LAUNCHES, megatrace_bwd.LAUNCHES,
                   megatrace_bwd.SCAN_LAUNCHES)
    for name, grad in (("vertices", verts.grad), ("centres", centers.grad)):
        if not bool(torch.isfinite(grad).all()) or float(grad.abs().max()) == 0:
            raise RuntimeError(f"bad mesh gradient to the {name}")
    if min(fb_launches) == 0 or triangle_select.LAUNCHES:
        raise RuntimeError(f"fwd+bwd mesh path: launches {fb_launches}, "
                           f"triangle_select {triangle_select.LAUNCHES}")
    out["fwd_bwd_mrays"] = fb_mrays
    out["fwd_bwd_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"fwd+bwd mesh path: mesh_showcase {width}x{height} depth 8, 64 "
          f"spp, gradients to {t_count} soup triangles' vertices and the "
          f"sphere centres: median {out['fwd_bwd_mrays']:.3f} MRays/s over 3 "
          f"steps ({rays_per:.0f} forward rays/step; launches batch "
          f"{fb_launches[0]}, path kernel {fb_launches[1]}, tape scan "
          f"{fb_launches[2]}); peak "
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
        check_scan(fwd["tape"], lane_count, spp, depth,
                   f"mesh_showcase {w}x{h} {spp} spp depth {depth}")
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
    verts = params_mod.soup_vertices(scene).clone().requires_grad_()
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
    scan_ms, glue_ms, paths_ms, table = bwd_parts_ms(
        args4[2:8], tri, args4[0], fwd["tape"], cots, 7, kw4, 5)
    tri_bound = bwd_bound(
        live, table.shape[0], n,
        s_count * 4 * 16 + t_pad * 4 * (16 + megatrace.TRI_REC_ROWS),
        tri_iters * 3 * MT_FLOPS)
    stats = path_stats(table, 8)
    print(f"backward, triangle arm, mesh_showcase 512x512 depth 8, 4 spp "
          f"({live:.0f} live iterations, {tri_iters:.0f} at triangle "
          f"winners): replay_grad {bwd_ms:.3f} ms, plain {bwd_plain_ms:.3f} "
          f"ms; alone (CUDA events) tape scan's two launches {scan_ms:.3f} "
          f"ms (glue {glue_ms:.3f} ms more), path kernel "
          f"{paths_ms:.3f} ms, bound {tri_bound[0]:.4f} ms by "
          f"{tri_bound[1]}; {stats['paths']} paths, per length 1..8 "
          f"{stats['per_length']}, idle warp slots "
          f"{stats['idle_warp_slots']:.6f}; max error {r:.3e} of the leaf's "
          f"max abs [{card}]")

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
        launches=fb_launches[1], scan_launches=fb_launches[2],
        max_abs_err=bwd_abs, max_rel_err=bwd_rel, ms=paths_ms,
        scan_ms=scan_ms, scan_glue_ms=glue_ms, replay_grad_ms=bwd_ms, plain_ms=bwd_plain_ms,
        bound_ms=tri_bound[0], bound_by=tri_bound[1], paths=stats)
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


def forward_mrays(scene, camera, width, batches, samples=64, depth=8):
    """Forward render_batch calls (width x width) into one set of
    accumulators: a warm-up, the launch counts set to 0, then `batches`
    timed calls, host clock to the ray count's arrival.  Returns (their
    median MRays/s, the rays of the first, the accumulators)."""
    dev = scene.spheres.center.device
    acc = film.zero_accumulators(width * width, device=dev)
    gen = torch.Generator().manual_seed(0)

    def one():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = renderer.render_batch(scene, camera, acc, gen, width=width,
                                     height=width, samples=samples,
                                     trace_depth=depth)
        rays = float(m.total_rays)  # waits for the device
        torch.cuda.synchronize()
        return rays, time.perf_counter() - t0

    one()  # warm-up
    reset_launches()
    runs = [one() for _ in range(batches)]
    return statistics.median(r / t / 1e6 for r, t in runs), runs[0][0], acc


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


@contextlib.contextmanager
def recorded_sweeps():
    """Keep, for each bounce of the plain streamed batch run inside the
    block (megatrace.sample_batch_reference with tri_stream_tables): the
    lanes that bounce (the active mask `_bounce` receives; the streamed
    kernel's live lanes) and, on them, the rays, the spheres' best t and
    the (t, row, u, v) of the index-order sweep `_tri_stream_sweep`."""
    calls = []
    bounce, sweep = megatrace._bounce, megatrace._tri_stream_sweep

    def recording_bounce(p, *args, **kwargs):
        calls.append({"live": p["active"]})
        return bounce(p, *args, **kwargs)

    def recording_sweep(o, d, best_t, stream, t_min):
        hit = sweep(o, d, best_t, stream, t_min)
        calls[-1].update(o=o, d=d, best_t=best_t, hit=hit)
        return hit

    megatrace._bounce = recording_bounce
    megatrace._tri_stream_sweep = recording_sweep
    try:
        yield calls
    finally:
        megatrace._bounce, megatrace._tri_stream_sweep = bounce, sweep


def group_traversal(call: dict, stream) -> tuple:
    """The streamed batch kernel's triangle sweep on one recorded bounce
    (`recorded_sweeps`), from its plain model: the live lanes' rays in
    their lane places, in groups of SYNC_GROUP lanes in lane order (the
    last one partial), each visiting the supers in tile_super_order's
    order over its live lanes (meshtrace.sync_traversal).  Returns (the
    model's (t, row, u, v) on the live lanes, the model's counts)."""
    live = call["live"]
    idx = torch.nonzero(live, as_tuple=True)[0]
    state = torch.zeros((meshtrace.ST_ROWS, live.shape[0]),
                        device=live.device)
    for r, x in enumerate((*call["o"], *call["d"])):
        state[r, idx] = x
    state[12] = live.float()
    best_t = torch.zeros(live.shape[0], device=live.device)
    best_t[idx] = call["best_t"]
    group = meshtrace.SYNC_GROUP
    order, dist = meshtrace.tile_super_order(state, stream.sup, group)
    hit, counts = meshtrace.sync_traversal(
        tuple(state[0:3]), tuple(state[3:6]), best_t, live, stream, group,
        order, dist)
    return tuple(h[idx] for h in hit), counts


def batch_traversal_counts(calls: list, stream) -> dict:
    """The model's counts (`group_traversal`) summed over a batch's
    recorded bounces; raises unless the model's winner is the index-order
    sweep's on every live lane of every bounce."""
    total = {}
    for call in calls:
        hit, counts = group_traversal(call, stream)
        want, best_t = call["hit"], call["best_t"]
        wins = want[0] < best_t
        same = (hit[0] < best_t) == wins
        for got_, want_ in zip(hit, want):
            same &= ~wins | (got_ == want_)
        if not bool(same.all()):
            raise RuntimeError("the group traversal's winners differ from "
                               "the index-order sweep's")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


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
    kw8 = dict(kw, samples=8, trace_depth=8, pixel_index=order)
    arm_shares, arm_err = [], 0.0
    for seed in (11, 12):
        with recorded_sweeps() as calls:
            share, err = check_parity(
                f"streamed arm, mesh_large {w}x{h} 8 spp depth 8 seed {seed}, "
                "Morton lanes", (lanes8, zeros, *tables, seed), kw8,
                tape=False)
        arm_shares.append(share)
        arm_err = max(arm_err, err)
    # the traversal model on the last batch: the divergence dealing removes
    model = batch_traversal_counts(calls, large_stream)
    bounces = sum(int(c["live"].sum()) for c in calls)
    per_group = len(calls) * w * h / meshtrace.SYNC_GROUP
    print(f"streamed arm's traversal model, mesh_large {w}x{h} 8 spp depth 8 "
          f"seed 12 ({bounces} bounces in {len(calls)} iterations, groups of "
          f"{meshtrace.SYNC_GROUP} lanes; winners equal to the index-order "
          f"sweep's on every live lane), triangle tests per bounce: the "
          f"lanes' own (lane_pairs) {model['lane_pairs'] / bounces:.1f}, "
          f"their warps' with one thread a lane (warp_pairs) "
          f"{model['warp_pairs'] / bounces:.1f}, every live lane of a group "
          f"against every staged block (group_pairs) "
          f"{model['group_pairs'] / bounces:.1f}; AABB tests "
          f"{model['lane_slabs'] / bounces:.1f}; staged {model['staged']} "
          f"blocks ({model['staged'] / per_group:.2f} per group and "
          f"iteration, "
          f"{model['staged'] * megatrace.TRI_BLOCK * 48 / 1e6:.1f} MB)")
    # uneven lane counts (0 to 8 samples; one group with a single live
    # lane, one with none) and a partial last block
    m = w * h - 45
    g = torch.Generator().manual_seed(13)
    uneven = torch.randint(0, 9, (m,), generator=g, dtype=torch.int32)
    group = meshtrace.SYNC_GROUP
    uneven[2 * group:3 * group] = 0
    uneven[2 * group + 77] = 8
    uneven[5 * group:6 * group] = 0  # a group with no live lane
    share, err = check_parity(
        f"streamed arm, mesh_large {m} lanes of {w}x{h}, 0-8 spp, depth 8, "
        "a group with one live lane and one with none, Morton lanes",
        (uneven.to(dev), zeros[:m], *tables, 13),
        dict(kw8, pixel_index=order[:m]), tape=False)
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
    with recorded_sweeps() as calls:
        arm_plain_ms, want = time_once(
            lambda: megatrace.sample_batch_reference(*args4, **kw4))
    pairs, slabs = megatrace.TRI_PAIRS, megatrace.SLAB_TESTS
    model = batch_traversal_counts(calls, large_stream)
    del calls
    share, err = lane_agreement(got, want)
    if share < 0.99:
        raise RuntimeError(f"streamed arm agreement {share} < 0.99 in the "
                           "timed 4 spp batch")
    arm_shares.append(share)
    arm_err = max(arm_err, err)
    bounces = float(got["rays"].sum())
    s_count = large.spheres.center.shape[0]

    def arm_bound_of(pairs_, slabs_):
        return bound(
            bounces * (s_count * SWEEP_FLOPS + SHADE_FLOPS) + pairs_ * MT_FLOPS
            + slabs_ * SLAB_FLOPS,
            n * 4 * (3 + megatrace.OUT_ROWS) + s_count * 4 * 20 + 4 * 32
            + stream_bytes(large_stream))

    # the least work: the lanes' own tests in the kernel's order (the
    # model's) or in the plain version's index order, whichever is lower
    index_bound = arm_bound_of(pairs, slabs)
    arm_bound = min(arm_bound_of(model["lane_pairs"], model["lane_slabs"]),
                    index_bound)
    print(f"batch kernel, streamed arm, mesh_large {width}x{height} depth 8, "
          f"4 spp, Morton lanes ({bounces:.0f} bounces of "
          f"{large.triangles.vert0.shape[0]} triangles; per bounce the plain "
          f"version's index order tests {pairs / bounces:.1f} triangles and "
          f"{slabs / bounces:.1f} AABBs, the kernel's traversal "
          f"{model['lane_pairs'] / bounces:.1f} and "
          f"{model['lane_slabs'] / bounces:.1f}, its warps of one lane a "
          f"thread would run {model['warp_pairs'] / bounces:.1f} and its "
          f"groups testing every staged block "
          f"{model['group_pairs'] / bounces:.1f}; {model['staged']} blocks "
          f"staged): kernel {arm_ms:.3f} ms "
          f"({bounces / arm_ms / 1e3:.3f} MRays/s), plain {arm_plain_ms:.3f} "
          f"ms, bound {arm_bound[0]:.4f} ms by {arm_bound[1]} (by the index "
          f"order's counts {index_bound[0]:.4f} ms); {share:.6f} of lanes "
          f"agree, max abs err {err:.3g} [{card}]")
    out["streamed_arm_model"] = model
    print(f"phase 20: {time.perf_counter() - t_phase:.1f} s")

    # ---- 21. the forward streamed-mesh paths ------------------------------------
    t_phase = time.perf_counter()
    launches = {}
    for name, (scene, cs) in scenes.items():
        camera, _ = batch_inputs(scene, cs, width, height, dev)
        mrays, rays, acc = forward_mrays(scene, camera, width, 5, spp)
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
        out[f"{name}_mrays"] = mrays
        route = "sync sampler" if name == "mesh_huge" else "streamed arm"
        print(f"forward {name} ({route}): {width}x{height} depth 8, {spp} "
              f"spp/batch: median {out[f'{name}_mrays']:.3f} MRays/s over 5 "
              f"batches ({rays:.0f} rays/batch; launches {counts}); "
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


def aux_errors(got, want, names) -> float:
    """Max error over the leaves `names` relative to each leaf's max abs
    (a leaf whose plain gradient is exactly zero must be zero too);
    raises past GRAD_TOL."""
    worst = 0.0
    for name, g, w in zip(names, got, want):
        if w.numel() == 0:
            continue
        scale, err = float(w.abs().max()), float((g - w).abs().max())
        if scale == 0.0:
            if err != 0.0:
                raise RuntimeError(f"aux backward vs plain: {name} error "
                                   f"{err} where the plain gradient is 0")
            continue
        if not err <= GRAD_TOL * scale:
            raise RuntimeError(f"aux backward vs plain: {name} error {err} "
                               f"against max abs {scale}")
        worst = max(worst, err / scale)
    return worst


AUX_LEAVES = LEAVES + ("rect_geo", "rect_rec", "box_geo", "box_rec")


def aux_launch_ms(tables, rect, box, samples: int, repeats: int,
                  kw: dict, vol0=None, move=None, tex=None) -> float:
    """The aux build (with `vol0`, a volume build; with `move`, the
    spheres' move offsets, a motion build; with `tex`,
    pack_texture_tables' tables, a texture build) alone: CUDA events
    around `repeats` launches of its C entry point on buffers made once
    (sample_batch's own packing, a few small torch ops, would otherwise
    bound a short batch by the host)."""
    camera_row, centers, radii, records, sky_bottom, sky_top = tables
    dev, s = centers.device, centers.shape[0]
    n = int(camera_row[19] * camera_row[20])
    lib = megatrace.load_kernel()
    sph, rec = megatrace.sweep_tables(centers, radii, records, move)
    consts = megatrace.kernel_consts(camera_row, sky_bottom, sky_top, vol0)
    aux_geo = aux_rec = None
    rect_rows = box_rows = 0
    if rect is not None or box is not None:
        aux_geo, aux_rec, rect_rows, box_rows = megatrace.kernel_aux_tables(
            rect, box)
    rect_code, box_code = megatrace.aux_code_bases(s, rect)
    per_pixel = torch.full((n,), float(samples), device=dev)
    cin = torch.zeros(n, device=dev)
    out = torch.empty((megatrace.OUT_ROWS, n), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    table = None if move is None else megatrace.move_table(move)
    trec, perlin, atlas, (img_w, img_h) = (
        (None, None, None, (0, 0)) if tex is None
        else megatrace.kernel_tex_tables(tex, dev))
    extra = (int(vol0 is not None),
             *(0 if t is None else t.data_ptr()
               for t in (table, trec, perlin, atlas)), img_w, img_h)

    def launch():
        err = lib.rtiw_megatrace_ext(
            per_pixel.data_ptr(), cin.data_ptr(), consts.data_ptr(),
            sph.data_ptr(), rec.data_ptr(),
            0 if aux_geo is None else aux_geo.data_ptr(),
            0 if aux_rec is None else aux_rec.data_ptr(), out.data_ptr(), 0,
            n, s, rect_rows, box_rows, rect_code, box_code, 7, 0, samples,
            kw["trace_depth"], 0.0, int(kw["has_dielectrics"]),
            int(kw["sky_on"]), 1, *extra, stream)
        if err != 0:
            raise RuntimeError(f"batch kernel build launch: cudaError {err}")

    launch()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def aux_phases(dev, card, width: int = 512, spp: int = 64) -> dict:
    """Phase 22: rects and boxes, the aux builds of #1 and #2, on
    `cornell` (6 rects, 2 boxes, no sphere, no sky) and `simple_light`
    (3 spheres, an emissive rect, no sky), 512x512, depth 8:
    (a) render_batch at 64 spp, 1 warm-up + 5 timed batches (median
        MRays/s), every batch through the aux build (AUX_LAUNCHES, set to
        0 just before and read just after), the image finite;
    (b) the aux build against its plain version on the inputs of a
        main-path batch: tape, count and rays identical and the floats
        within 1e-4 on >= 99% of lanes;
    (c) the aux build alone by CUDA events at 4 and 64 spp, its plain
        version at 4 spp, registers and blocks an SM, and the bound;
    (d) cornell's fwd+bwd step, render_image(differentiable=True),
        mean((color - target)^2), .backward() to the texture colors (its
        albedos and emission), the rect and box positions and the box
        extents: 1 warm-up + 3 timed steps (median MRays/s, the forward
        rays of each seed), the path kernel's aux build launched, the
        gradients finite; then the backward against the plain replay's
        autograd on the last step's inputs, each leaf (the rect_geo,
        rect_rec, box_geo and box_rec cotangents among them) within 5e-4
        of its max abs;
    (e) #2's aux build alone at cornell 4 and 64 spp (the tape scan's
        launches and the path kernel by CUDA events), replay_grad and its
        plain version at 4 spp;
    (f) the CLI on --scene cornell and --scene simple_light, 256x256, 16
        spp, depth 8.
    (`width` and `spp` shrink it for a rehearsal on the CPU.)"""
    t_phase = time.perf_counter()
    height = width
    n = width * height
    out, fwd_entry, bwd_entry = {}, {}, {}
    kernel_report = ptxas_report(megatrace.BUILD_LOG,
                                 "megatrace_sphere_kernelILb1ELb0ELb0ELb0EE")
    path_report = ptxas_report(megatrace_bwd.BUILD_LOG,
                               "megatrace_paths_kernelILb0ELb1ELb0ELb0ELb0EE")
    print(f"aux builds: ptxas #1 {kernel_report or '(not built here)'}; "
          f"#2 path kernel {path_report or '(not built here)'}")
    max_err, shares = 0.0, []
    for name, (scene, cs) in (("cornell", book_scenes.cornell_box()),
                              ("simple_light", testbeds.simple_light())):
        scene = scene.to(dev)
        if (not megatrace.scene_eligible(scene, allow_triangles=True,
                                         allow_rect_box=True)
                or megatrace.scene_eligible(scene)):
            raise RuntimeError(f"{name} left the batch kernel's scope, or "
                               "entered the sphere-only per-ray megatrace's")
        camera, tables = batch_inputs(scene, cs, width, height, dev)
        rect, box = megatrace.pack_aux_tables(
            scene, materials.pack_materials(scene))
        s_count = scene.spheres.center.shape[0]
        r_count, b_count = (scene.rects.rot.shape[0],
                            scene.boxes.rot.shape[0])
        aux_rows = sum(t[0].shape[0] for t in (rect, box) if t is not None)
        kw = dict(trace_depth=8, has_dielectrics=scene.flags.has_dielectrics,
                  sky_on=scene.flags.sky == 1, rect_tables=rect,
                  box_tables=box)

        # ---- (a) the forward main path ------------------------------------
        gen = torch.Generator().manual_seed(3)
        acc = film.zero_accumulators(n, device=dev)

        def forward():
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, m = renderer.render_batch(scene, camera, acc, gen, width=width,
                                         height=height, samples=spp,
                                         trace_depth=8)
            rays = float(m.total_rays)
            torch.cuda.synchronize()
            return rays, time.perf_counter() - t

        reset_launches()
        runs = [forward() for _ in range(6)]
        launches = (megatrace.LAUNCHES, megatrace.AUX_LAUNCHES)
        if launches != (6, 6):
            raise RuntimeError(f"{name}: batch kernel launches {launches}, "
                               "want 6 of the aux build")
        rate = statistics.median(r / t / 1e6 for r, t in runs[1:])
        img = film.combine(acc, width, height).color
        if not bool(torch.isfinite(img).all()) or float(img.mean()) <= 0.0:
            raise RuntimeError(f"bad {name} image: mean {float(img.mean())}")
        print(f"aux main path: {name} {width}x{height} depth 8, {spp} "
              f"spp/batch:"
              f" median {rate:.3f} MRays/s over 5 batches ({runs[1][0]:.0f} "
              f"rays/batch; launches batch kernel {launches[0]}, aux build "
              f"{launches[1]}); image mean {float(img.mean()):.4f} [{card}]")
        out[f"{name}_fwd_mrays"] = rate
        fwd_entry[f"{name}_launches"] = launches[1]

        # ---- (b) kernel vs plain on a main-path batch's inputs -------------
        with recorded_calls(megatrace, "sample_batch") as calls:
            renderer.render_batch(scene, camera, acc, gen, width=width,
                                  height=height, samples=spp, trace_depth=8)
        (args, kwargs, _), = calls
        t = time.perf_counter()
        share, err = check_parity(f"aux build, {name} {width}x{height} "
                                  f"{spp} spp main-path batch", args, kwargs)
        print(f"  (plain version {time.perf_counter() - t:.1f} s)")
        shares.append(share)
        max_err = max(max_err, err)
        del calls, args, kwargs

        # ---- (c) the aux build alone ---------------------------------------
        zeros = torch.zeros(n, device=dev)
        timed = {}
        for few in (4, spp):
            lane_count = torch.full((n,), few, dtype=torch.int32, device=dev)
            ms, res = time_batch(megatrace.sample_batch, lane_count, zeros,
                                 *tables, 7, samples=few, repeats=5, **kw)
            rays = float(res["rays"].sum())
            bnd = bound(rays * (s_count * SWEEP_FLOPS + r_count * RECT_FLOPS
                                + b_count * BOX_FLOPS + SHADE_FLOPS),
                        n * 4 * (2 + megatrace.OUT_ROWS)
                        + s_count * 4 * (4 + 16) + aux_rows * 4 * 32 + 4 * 32)
            timed[few] = (ms, rays, bnd)
            if few == 4:
                plain_ms, plain = time_batch(
                    megatrace.sample_batch_reference, lane_count, zeros,
                    *tables, 7, samples=few, repeats=1, **kw)
                share4, err4 = lane_agreement(res, plain)
                if share4 < 0.99:
                    raise RuntimeError(f"aux build/plain agreement {share4}")
                max_err = max(max_err, err4)
        info = megatrace.sphere_kernel_info(s_count, aux_rows)
        (wrap4, rays4, bnd4), (wrap64, rays64, bnd64) = timed[4], timed[spp]
        ms4 = aux_launch_ms(tables, rect, box, 4, 20, kw)
        ms64 = aux_launch_ms(tables, rect, box, spp, 5, kw)
        print(f"aux build alone, {name} {width}x{height} depth 8 (CUDA "
              f"events, launches alone): 4 spp {ms4:.3f} ms ({rays4:.0f} "
              f"bounces, bound {bnd4[0]:.4f} ms by {bnd4[1]}, "
              f"{bnd4[0] / ms4:.1%}), {spp} spp {ms64:.3f} ms (bound "
              f"{bnd64[0]:.4f} ms, {bnd64[0] / ms64:.1%}); through "
              f"sample_batch {wrap4:.3f} and {wrap64:.3f} ms; plain "
              f"{plain_ms:.3f} ms at 4 spp ({share4:.6f} of lanes agree); "
              f"{info['registers']} registers, {info['local_bytes']} B local "
              f"a thread, {info['blocks']} blocks of 128 an SM [{card}]")
        fwd_entry[name] = dict(ms=ms4, ms_64spp=ms64, wrapper_ms=wrap4,
                               plain_ms=plain_ms, bound=bnd4,
                               bound_ms_64spp=bnd64[0], **info)
        if name != "cornell":
            continue

        # ---- (d) cornell's fwd+bwd step ------------------------------------
        target = img.detach()
        seeds = [int(torch.randint(0, renderer.SEED_RANGE, (), generator=gen))
                 for _ in range(4)]
        rays = []
        for seed in seeds:  # the forward rays of each step's seed
            _, m = renderer.render_batch(
                scene, camera, film.zero_accumulators(n, device=dev),
                width=width, height=height, samples=spp, trace_depth=8,
                seed=seed, differentiable=False)
            rays.append(float(m.total_rays))
        names = ("texture_colors", "rect_positions", "box_positions",
                 "box_extents")
        reset_launches()
        rates = []
        with recorded_calls(megatrace_bwd, "replay_grad",
                            copy=False) as calls:
            for seed, r in zip(seeds, rays):
                calls.clear()  # keep the last step's call only
                params = {k: v.detach().clone().requires_grad_() for k, v in
                          params_mod.extract_params(scene, names).items()}
                torch.cuda.synchronize()
                t = time.perf_counter()
                step = renderer.render_image(
                    params_mod.apply_params(scene, params), camera,
                    width=width, height=height, samples_per_pixel=spp,
                    trace_depth=8, seed=seed, differentiable=True)
                torch.mean((step.color - target) ** 2).backward()
                torch.cuda.synchronize()
                rates.append(r / (time.perf_counter() - t) / 1e6)
        launches = (megatrace.AUX_LAUNCHES, megatrace_bwd.SCAN_LAUNCHES,
                    megatrace_bwd.LAUNCHES)
        if min(launches) == 0 or megatrace.LAUNCHES != launches[0]:
            raise RuntimeError(f"cornell fwd+bwd: launches {launches}")
        grads = {k: v.grad for k, v in params.items()}
        if (not all(bool(torch.isfinite(g).all()) for g in grads.values())
                or float(grads["texture_colors"].abs().max()) == 0.0):
            raise RuntimeError("cornell fwd+bwd: bad gradients")
        rate = statistics.median(rates[1:])
        out["cornell_fwd_bwd_mrays"] = rate
        print(f"aux fwd+bwd: cornell {width}x{height} depth 8, {spp} spp: "
              f"median {rate:.3f} MRays/s over 3 steps ({rays[-1]:.0f} "
              f"forward rays/step; launches aux build {launches[0]}, tape "
              f"scan {launches[1]}, path kernel {launches[2]}); max |grad| "
              + ", ".join(f"{k} {float(g.abs().max()):.4g}"
                          for k, g in grads.items()) + f" [{card}]")
        bwd_entry["launches"], bwd_entry["scan_launches"] = launches[2], \
            launches[1]
        (args, kwargs, got), = calls
        t = time.perf_counter()
        want = megatrace_bwd.replay_grad_reference(*args, **kwargs)
        torch.cuda.synchronize()
        rel = aux_errors(got, want, AUX_LEAVES)
        print(f"aux backward vs plain on a main-path step (cornell {width}x"
              f"{height}, {spp} spp, depth 8): max error {rel:.3e} of the "
              f"leaf's max abs over {', '.join(AUX_LEAVES)}; plain version "
              f"{time.perf_counter() - t:.1f} s")
        bwd_rel = rel
        del calls, args, kwargs, got, want

        # ---- (e) #2's aux build alone --------------------------------------
        s_pad = megatrace.sphere_pad_count(s_count)
        for few in (4, spp):
            lane_count = torch.full((n,), few, dtype=torch.int32, device=dev)
            fkw = dict(kw, samples=few)
            fwd = megatrace.sample_batch(lane_count, zeros, *tables, 7,
                                         want_tape=True, **fkw)
            cots = probe_cotangents(fwd["color"], fwd["count"])
            live = float(fwd["rays"].sum())
            aux_live = float((fwd["tape"] >= s_pad).sum())
            scan_ms, glue_ms, paths_ms, table = bwd_parts_ms(
                tables, None, lane_count, fwd["tape"], cots, 7, fkw,
                5 if few == 4 else 3, rect=rect, box=box)
            bnd = bwd_bound(live, table.shape[0], n, aux_rows * 4 * 23,
                            aux_live * AUX_BWD_FLOPS)
            stats = path_stats(table, 8)
            print(f"aux backward alone, cornell {width}x{height} depth 8, "
                  f"{few} spp (CUDA events): tape scan's two launches "
                  f"{scan_ms:.3f} ms (glue {glue_ms:.3f} ms more), path "
                  f"kernel {paths_ms:.3f} ms, {paths_ms * 1e6 / live:.3f} ns "
                  f"a live iteration (bound {bnd[0]:.4f} ms by {bnd[1]}, "
                  f"{live:.0f} live iterations, {aux_live:.0f} at rect and "
                  f"box winners); {stats['paths']} paths, per length 1..8 "
                  f"{stats['per_length']}, idle warp slots "
                  f"{stats['idle_warp_slots']:.6f} [{card}]")
            if few == spp:
                bwd_entry.update(ms_64spp=paths_ms, scan_ms_64spp=scan_ms,
                                 bound_ms_64spp=bnd[0])
                break
            bwd_entry.update(ms=paths_ms, scan_ms=scan_ms, bound=bnd)
            args = (fwd["tape"], lane_count, *tables, 7, *cots)
            ms, got = time_batch(megatrace_bwd.replay_grad, *args,
                                 repeats=5, **fkw)
            plain_ms, want = time_batch(megatrace_bwd.replay_grad_reference,
                                        *args, repeats=1, **fkw)
            bwd_rel = max(bwd_rel, aux_errors(got, want, AUX_LEAVES))
            print(f"cornell {width}x{height} depth 8, 4 spp backward: "
                  f"replay_grad "
                  f"{ms:.3f} ms, plain {plain_ms:.3f} ms; max error "
                  f"{bwd_rel:.3e} of the leaf's max abs [{card}]")
            bwd_entry.update(replay_grad_ms=ms, plain_ms=plain_ms,
                             max_rel_err=bwd_rel)
            del fwd, got, want, args, table

    # ---- (f) the CLI ---------------------------------------------------
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        for name in ("cornell", "simple_light"):
            png = os.path.join(tmp, f"{name}.png")
            reset_launches()
            t0 = time.perf_counter()
            rc = cli.main(["--scene", name, "--width", str(width // 2),
                           "--height", str(width // 2), "--spp", "16",
                           "--depth", "8", "--output", png, "--quiet",
                           "--device", dev.type])
            seconds = time.perf_counter() - t0
            with open(png, "rb") as f:
                header = f.read(8)
            if (rc != 0 or header != b"\x89PNG\r\n\x1a\n"
                    or megatrace.AUX_LAUNCHES == 0
                    or megatrace.AUX_LAUNCHES != megatrace.LAUNCHES):
                raise RuntimeError(f"the CLI did not render --scene {name} "
                                   f"through the aux build (rc {rc}, "
                                   f"launches {megatrace.LAUNCHES}, aux "
                                   f"{megatrace.AUX_LAUNCHES})")
            print(f"CLI: --scene {name} {width // 2}x{width // 2}, 16 spp, "
                  f"depth 8 on {dev}: PNG written in {seconds:.2f} s, aux "
                  f"build launches "
                  f"{megatrace.AUX_LAUNCHES}")
    out["aux_parity_share"] = min(shares)
    print(f"phase 22: {time.perf_counter() - t_phase:.1f} s")

    cornell, light = fwd_entry["cornell"], fwd_entry["simple_light"]
    kernels = [{
        "name": "megatrace_batch_aux", "route": "cuda",
        "source": "raytracing_in_one_weekend_tpu_torch/csrc/megatrace_batch.cu",
        "replaces": "raytracing_in_one_weekend_tpu/ops/pallas_megatrace.py:2457",
        "launches": fwd_entry["cornell_launches"]
        + fwd_entry["simple_light_launches"],
        "max_abs_err": max_err, "ms": cornell["ms"],
        "plain_ms": cornell["plain_ms"], "bound_ms": cornell["bound"][0],
        "bound_by": cornell["bound"][1], "library_ms": None,
        "ms_64spp": cornell["ms_64spp"],
        "wrapper_ms": cornell["wrapper_ms"],
        "bound_ms_64spp": cornell["bound_ms_64spp"],
        "simple_light_ms": light["ms"],
        "simple_light_ms_64spp": light["ms_64spp"],
        "simple_light_plain_ms": light["plain_ms"],
        "simple_light_bound_ms": light["bound"][0],
        "registers": cornell["registers"],
        "local_bytes": cornell["local_bytes"],
        "blocks_per_sm": cornell["blocks"],
    }, {
        "name": "megatrace_bwd_aux", "route": "cuda",
        "source": "raytracing_in_one_weekend_tpu_torch/csrc/megatrace_bwd.cu",
        "replaces": "raytracing_in_one_weekend_tpu/ops/megatrace_bwd.py:132",
        "launches": bwd_entry["launches"],
        "scan_launches": bwd_entry["scan_launches"],
        "max_abs_err": bwd_entry["max_rel_err"],
        "ms": bwd_entry["ms"], "scan_ms": bwd_entry["scan_ms"],
        "replay_grad_ms": bwd_entry["replay_grad_ms"],
        "plain_ms": bwd_entry["plain_ms"],
        "bound_ms": bwd_entry["bound"][0], "bound_by": bwd_entry["bound"][1],
        "library_ms": None, "ms_64spp": bwd_entry["ms_64spp"],
        "scan_ms_64spp": bwd_entry["scan_ms_64spp"],
        "bound_ms_64spp": bwd_entry["bound_ms_64spp"],
    }]
    return {"kernels": kernels, "paths": out}


def fog_inside_scene():
    """A camera inside a fog sphere of density 0.8 with a red sphere in
    it (the JAX package's camera-inside testbed, tests/test_megakernel.py
    :255-288) and its camera settings."""
    b = SceneBuilder()
    fog = b.volume(0.8, (0.9, 0.9, 0.9))
    b.add_sphere((0.0, 0.0, 0.0), 3.0, fog)
    b.add_sphere((0.0, 0.0, -2.0), 0.5, b.lambert((0.8, 0.2, 0.2)))
    b.set_gradient_sky()
    return b.build(), CameraSettings(origin=(0.0, 0.0, 0.0),
                                     look_at=(0.0, 0.0, -1.0),
                                     vertical_fov=60.0, focus_distance=2.0)


# the fog scenes (the registries' names: `--against` imports this file
# beside an older package, which may not have them)
VOL_SCENES = ("volume", "probabilistic", "cornell_volumes")
NOISE = 1e-5  # of the largest leaf's max: a leaf below it is zero but for
#   rounding (tests/test_torch_volume_grad.py)


def volume_errors(got, want, names) -> float:
    """aux_errors for the volume builds: each leaf within GRAD_TOL of its
    max abs, a leaf whose plain gradient is below NOISE of the largest
    leaf's held below that on both sides (a skip's derivative to its
    boundary cancels on the next hit, tests/test_torch_volume_grad.py)."""
    largest = max(float(w.abs().max()) for w in want if w.numel())
    worst = 0.0
    for name, g, w in zip(names, got, want):
        if w.numel() == 0:
            continue
        scale, err = float(w.abs().max()), float((g - w).abs().max())
        if scale <= NOISE * largest:
            if float(g.abs().max()) > NOISE * largest:
                raise RuntimeError(f"volume backward vs plain: {name} "
                                   f"{float(g.abs().max())} where the "
                                   "plain gradient is below the noise")
            continue
        if not err <= GRAD_TOL * scale:
            raise RuntimeError(f"volume backward vs plain: {name} error "
                               f"{err} against max abs {scale}")
        worst = max(worst, err / scale)
    return worst


def volume_inputs(scene, cs, width, dev):
    """(camera, the six tables, rect_tables, box_tables, vol0) of a
    width x width batch."""
    camera, tables = batch_inputs(scene, cs, width, width, dev)
    packed = materials.pack_materials(scene)
    rect, box = megatrace.pack_aux_tables(scene, packed)
    vol0 = megatrace.camera_containment_row(scene, packed, camera.origin)
    return camera, tables, rect, box, vol0


def winner_flops(tape, s_count: int, rect, r_count, b_count) -> float:
    """The volume builds' operations on a tape's bounces: every bounce's
    sweep, shading and walk, and the exit of its winner (a sphere's far
    root or a box's slab exit)."""
    rays = float((tape > -1.5).sum())
    s_pad = megatrace.sphere_pad_count(s_count)
    _, box_base = megatrace.aux_code_bases(s_count, rect)
    spheres = float(((tape >= 0) & (tape < s_pad)).sum())
    boxes = float((tape >= box_base).sum()) if b_count else 0.0
    return (rays * (s_count * SWEEP_FLOPS + r_count * RECT_FLOPS
                    + b_count * BOX_FLOPS + SHADE_FLOPS + VOL_WALK_FLOPS)
            + spheres * SPHERE_EXIT_FLOPS + boxes * BOX_EXIT_FLOPS)


def volume_phases(dev, card, width: int = 512, spp: int = 64) -> dict:
    """Phase 23: convex volumes, the volume builds of #1 and #2, on
    `volume` (a fog sphere of density 1.5 beside a solid one),
    `probabilistic` (fog spheres of density 0.5, 2 and 8) and
    `cornell_volumes` (the Cornell box with two volume boxes of density
    8), 512x512, depth 8:
    (a) render_batch at 64 spp, 1 warm-up + 5 timed batches (median
        MRays/s), every batch through a volume build (VOL_LAUNCHES, set to
        0 just before and read just after), the image finite;
    (b) the volume build against its plain version on the inputs of a
        main-path batch: tape, count and rays identical and the floats
        within 1e-4 on >= 99% of lanes; again at 4 spp;
    (c) the build alone by CUDA events at 4 and 64 spp, its plain version
        at 4 spp, registers and blocks an SM, and the bound;
    (d) the fwd+bwd step on cornell_volumes (to its material parameters,
        the two densities among them, and its albedos) and on volume (to
        the material parameters and the sphere centres):
        render_image(differentiable=True), mean((color - target)^2),
        .backward(), 1 warm-up + 3 timed steps (median MRays/s, the
        forward rays of each seed), the path kernel's volume build
        launched, the gradients finite and the densities' nonzero; the
        backward against the plain replay's autograd on the last step's
        inputs, each leaf (vol0 and the records, where the densities sit,
        among them) within 5e-4 of its max abs;
    (e) #2's volume builds alone at 4 and 64 spp (the tape scan's launches
        and the path kernel by CUDA events, ns a live iteration),
        replay_grad and its plain version at 4 spp;
    (f) a camera inside a fog sphere, 128x128, 8 spp, depth 8: forward
        and backward against their plain versions;
    (g) the CLI on --scene cornell_volumes, volume and probabilistic,
        256x256, 16 spp, depth 8.
    (`width` and `spp` shrink it for a rehearsal on the CPU.)"""
    t_phase = time.perf_counter()
    n = width * width
    out, fwd, bwd = {}, {}, {}
    reports = [ptxas_report(megatrace.BUILD_LOG,
                            f"megatrace_sphere_kernelILb{a}ELb1ELb0ELb0EE")
               for a in (0, 1)]
    reports += [ptxas_report(megatrace_bwd.BUILD_LOG,
                             f"megatrace_paths_kernelILb0ELb{a}ELb1ELb0ELb0EE")
                for a in (0, 1)]
    print(f"volume builds: ptxas #1 beside spheres {reports[0] or '-'}; "
          f"beside rects and boxes {reports[1] or '-'}; #2 path kernel "
          f"{reports[2] or '-'}; {reports[3] or '-'}")
    max_err, shares, launches_main = 0.0, [], 0
    registry = {**book_scenes.SCENES, **testbeds.SCENES}
    for name in VOL_SCENES:
        scene, cs = registry[name]()
        scene = scene.to(dev)
        if (not megatrace.scene_eligible(scene, allow_triangles=True,
                                         allow_rect_box=True,
                                         allow_volumes=True)
                or megatrace.scene_eligible(scene, allow_rect_box=True)):
            raise RuntimeError(f"{name} left the batch kernel's scope, or "
                               "entered the per-ray megatrace's")
        camera, tables, rect, box, vol0 = volume_inputs(scene, cs, width,
                                                        dev)
        s_count = scene.spheres.center.shape[0]
        r_count, b_count = (scene.rects.rot.shape[0],
                            scene.boxes.rot.shape[0])
        aux_rows = sum(t[0].shape[0] for t in (rect, box) if t is not None)
        kw = dict(trace_depth=8, has_dielectrics=scene.flags.has_dielectrics,
                  sky_on=scene.flags.sky == 1, rect_tables=rect,
                  box_tables=box, vol0=vol0)

        # ---- (a) the forward main path ------------------------------------
        gen = torch.Generator().manual_seed(5)
        acc = film.zero_accumulators(n, device=dev)

        def forward():
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, m = renderer.render_batch(scene, camera, acc, gen, width=width,
                                         height=width, samples=spp,
                                         trace_depth=8)
            rays = float(m.total_rays)
            torch.cuda.synchronize()
            return rays, time.perf_counter() - t

        reset_launches()
        runs = [forward() for _ in range(6)]
        launches = (megatrace.LAUNCHES, megatrace.VOL_LAUNCHES)
        if launches != (6, 6):
            raise RuntimeError(f"{name}: batch kernel launches {launches}, "
                               "want 6 of the volume build")
        launches_main += launches[1]
        rate = statistics.median(r / t / 1e6 for r, t in runs[1:])
        img = film.combine(acc, width, width).color
        if not bool(torch.isfinite(img).all()) or float(img.mean()) <= 0.0:
            raise RuntimeError(f"bad {name} image: mean {float(img.mean())}")
        print(f"volume main path: {name} {width}x{width} depth 8, {spp} "
              f"spp/batch: median {rate:.3f} MRays/s over 5 batches "
              f"({runs[1][0]:.0f} rays/batch; launches batch kernel "
              f"{launches[0]}, volume build {launches[1]}); image mean "
              f"{float(img.mean()):.4f} [{card}]")
        out[f"{name}_fwd_mrays"] = rate

        # ---- (b) kernel vs plain on a main-path batch's inputs -------------
        with recorded_calls(megatrace, "sample_batch") as calls:
            renderer.render_batch(scene, camera, acc, gen, width=width,
                                  height=width, samples=spp, trace_depth=8)
        (args, kwargs, _), = calls
        if kwargs.get("vol0") is None:
            raise RuntimeError(f"{name}: the main path passed no vol0")
        t = time.perf_counter()
        share, err = check_parity(f"volume build, {name} {width}x{width} "
                                  f"{spp} spp main-path batch", args, kwargs)
        print(f"  (plain version {time.perf_counter() - t:.1f} s)")
        shares.append(share)
        max_err = max(max_err, err)
        del calls, args, kwargs

        # ---- (c) the volume build alone ------------------------------------
        zeros = torch.zeros(n, device=dev)
        timed = {}
        for few in (4, spp):
            lane_count = torch.full((n,), few, dtype=torch.int32, device=dev)
            res = megatrace.sample_batch(lane_count, zeros, *tables, 7,
                                         samples=few, want_tape=True, **kw)
            flops = winner_flops(res["tape"], s_count, rect, r_count,
                                 b_count)
            rays = float(res["rays"].sum())
            bnd = bound(flops, n * 4 * (2 + megatrace.OUT_ROWS)
                        + s_count * 4 * (4 + 16) + aux_rows * 4 * 32
                        + 4 * 40)
            ms = aux_launch_ms(tables, rect, box, few, 20 if few == 4 else 5,
                               kw, vol0=vol0)
            timed[few] = (ms, rays, bnd)
            if few == 4:
                plain_ms, plain = time_batch(
                    megatrace.sample_batch_reference, lane_count, zeros,
                    *tables, 7, samples=few, repeats=1, want_tape=True, **kw)
                share4, err4 = lane_agreement(res, plain)
                if share4 < 0.99:
                    raise RuntimeError(f"{name} volume build/plain agreement "
                                       f"{share4}")
                shares.append(share4)
                max_err = max(max_err, err4)
                del plain
            del res
        info = megatrace.sphere_kernel_info(s_count, aux_rows,
                                            has_vol=True)
        (ms4, rays4, bnd4), (ms64, rays64, bnd64) = timed[4], timed[spp]
        print(f"volume build alone, {name} {width}x{width} depth 8 (CUDA "
              f"events, launches alone): 4 spp {ms4:.3f} ms ({rays4:.0f} "
              f"bounces, bound {bnd4[0]:.4f} ms by {bnd4[1]}, "
              f"{bnd4[0] / ms4:.1%}), {spp} spp {ms64:.3f} ms ({rays64:.0f} "
              f"bounces, bound {bnd64[0]:.4f} ms, {bnd64[0] / ms64:.1%}); "
              f"plain {plain_ms:.3f} ms at 4 spp ({share4:.6f} of lanes "
              f"agree); {info['registers']} registers, "
              f"{info['local_bytes']} B local a thread, {info['blocks']} "
              f"blocks of 128 an SM [{card}]")
        fwd[name] = dict(ms=ms4, ms_64spp=ms64, plain_ms=plain_ms,
                         bound=bnd4, bound_ms_64spp=bnd64[0], **info)
        if name == "probabilistic":
            continue

        # ---- (d) the fwd+bwd step ------------------------------------------
        target = img.detach()
        seeds = [int(torch.randint(0, renderer.SEED_RANGE, (), generator=gen))
                 for _ in range(4)]
        rays = []
        for seed in seeds:  # the forward rays of each step's seed
            _, m = renderer.render_batch(
                scene, camera, film.zero_accumulators(n, device=dev),
                width=width, height=width, samples=spp, trace_depth=8,
                seed=seed, differentiable=False)
            rays.append(float(m.total_rays))
        names = (("material_parameters", "texture_colors")
                 if name == "cornell_volumes"
                 else ("material_parameters", "sphere_centers"))
        reset_launches()
        rates = []
        with recorded_calls(megatrace_bwd, "replay_grad",
                            copy=False) as calls:
            for seed, r in zip(seeds, rays):
                calls.clear()  # keep the last step's call only
                params = {k: v.detach().clone().requires_grad_() for k, v in
                          params_mod.extract_params(scene, names).items()}
                torch.cuda.synchronize()
                t = time.perf_counter()
                step = renderer.render_image(
                    params_mod.apply_params(scene, params), camera,
                    width=width, height=width, samples_per_pixel=spp,
                    trace_depth=8, seed=seed, differentiable=True)
                torch.cuda.synchronize()
                torch.mean((step.color - target) ** 2).backward()
                torch.cuda.synchronize()
                rates.append(r / (time.perf_counter() - t) / 1e6)
        launches = (megatrace.VOL_LAUNCHES, megatrace_bwd.SCAN_LAUNCHES,
                    megatrace_bwd.LAUNCHES)
        if min(launches) == 0 or megatrace.LAUNCHES != launches[0]:
            raise RuntimeError(f"{name} fwd+bwd: launches {launches}")
        grads = {k: v.grad for k, v in params.items()}
        density = grads["material_parameters"][
            (scene.materials.type == 2).nonzero()[:, 0]]
        if (not all(bool(torch.isfinite(g).all()) for g in grads.values())
                or float(density.abs().max()) == 0.0):
            raise RuntimeError(f"{name} fwd+bwd: bad gradients")
        rate = statistics.median(rates[1:])
        out[f"{name}_fwd_bwd_mrays"] = rate
        print(f"volume fwd+bwd: {name} {width}x{width} depth 8, {spp} spp: "
              f"median {rate:.3f} MRays/s over 3 steps ({rays[-1]:.0f} "
              f"forward rays/step; launches volume build {launches[0]}, "
              f"tape scan {launches[1]}, path kernel {launches[2]}); max "
              f"|grad| " + ", ".join(f"{k} {float(g.abs().max()):.4g}"
                                     for k, g in grads.items())
              + f", the densities' {density.tolist()} [{card}]")
        bwd.setdefault("launches", 0)
        bwd.setdefault("scan_launches", 0)
        bwd["launches"] += launches[2]
        bwd["scan_launches"] += launches[1]
        (args, kwargs, got), = calls
        t = time.perf_counter()
        want = megatrace_bwd.replay_grad_reference(*args, **kwargs)
        torch.cuda.synchronize()
        leaves = LEAVES + (("rect_geo", "rect_rec", "box_geo", "box_rec")
                           if rect is not None else ()) + ("vol0",)
        rel = volume_errors(got, want, leaves)
        print(f"volume backward vs plain on a main-path step ({name} "
              f"{width}x{width}, {spp} spp, depth 8): max error {rel:.3e} "
              f"of the leaf's max abs over {', '.join(leaves)}; plain "
              f"version {time.perf_counter() - t:.1f} s")
        bwd_rel = rel
        del calls, args, kwargs, got, want

        # ---- (e) #2's volume build alone -----------------------------------
        for few in (4, spp):
            lane_count = torch.full((n,), few, dtype=torch.int32, device=dev)
            fkw = dict(kw, samples=few)
            res = megatrace.sample_batch(lane_count, zeros, *tables, 7,
                                         want_tape=True, **fkw)
            cots = probe_cotangents(res["color"], res["count"])
            live = float(res["rays"].sum())
            s_pad = megatrace.sphere_pad_count(s_count)
            aux_live = float((res["tape"] >= s_pad).sum())
            scan_ms, glue_ms, paths_ms, table = bwd_parts_ms(
                tables, None, lane_count, res["tape"], cots, 7, fkw,
                5 if few == 4 else 3, rect=rect, box=box, vol0=vol0)
            bnd = bwd_bound(live, table.shape[0], n, aux_rows * 4 * 23
                            + s_count * 4 * 23,
                            aux_live * AUX_BWD_FLOPS + live * VOL_BWD_FLOPS)
            stats = path_stats(table, 8)
            print(f"volume backward alone, {name} {width}x{width} depth 8, "
                  f"{few} spp (CUDA events): tape scan's two launches "
                  f"{scan_ms:.3f} ms (glue {glue_ms:.3f} ms more), path "
                  f"kernel {paths_ms:.3f} ms, {paths_ms * 1e6 / live:.3f} ns "
                  f"a live iteration (bound {bnd[0]:.4f} ms by {bnd[1]}, "
                  f"{bnd[0] / paths_ms:.1%}; {live:.0f} live iterations, "
                  f"{live / max(stats['paths'], 1):.2f} a path); "
                  f"{stats['paths']} paths, per length 1..8 "
                  f"{stats['per_length']}, idle warp slots "
                  f"{stats['idle_warp_slots']:.6f} [{card}]")
            key = "" if few == 4 else "_64spp"
            bwd[f"{name}_ms{key}"] = paths_ms
            bwd[f"{name}_scan_ms{key}"] = scan_ms
            bwd[f"{name}_bound{key}"] = bnd
            bwd[f"{name}_ns_per_iteration{key}"] = paths_ms * 1e6 / live
            if few == spp:
                break
            args = (res["tape"], lane_count, *tables, 7, *cots)
            ms, got = time_batch(megatrace_bwd.replay_grad, *args,
                                 repeats=5, **fkw)
            plain_ms, want = time_batch(megatrace_bwd.replay_grad_reference,
                                        *args, repeats=1, **fkw)
            bwd_rel = max(bwd_rel, volume_errors(got, want, leaves))
            print(f"{name} {width}x{width} depth 8, 4 spp backward: "
                  f"replay_grad {ms:.3f} ms, plain {plain_ms:.3f} ms; max "
                  f"error {bwd_rel:.3e} of the leaf's max abs [{card}]")
            bwd[f"{name}_replay_grad_ms"] = ms
            bwd[f"{name}_plain_ms"] = plain_ms
            bwd["max_rel_err"] = max(bwd.get("max_rel_err", 0.0), bwd_rel)
            del res, got, want, args, table

    # ---- (f) a camera inside a fog sphere ----------------------------------
    scene, cs = fog_inside_scene()
    scene = scene.to(dev)
    small = min(128, width)
    camera, tables, rect, box, vol0 = volume_inputs(scene, cs, small, dev)
    if float(vol0[0]) != 0.0:
        raise RuntimeError(f"the camera is not inside the fog: {vol0}")
    m = small * small
    lane_count = torch.full((m,), 8, dtype=torch.int32, device=dev)
    kw = dict(samples=8, trace_depth=8, has_dielectrics=False, sky_on=True,
              vol0=vol0)
    share, err = check_parity(f"volume build, camera inside a fog sphere "
                              f"{small}x{small} 8 spp", (lane_count,
                              torch.zeros(m, device=dev), *tables, 13), kw)
    shares.append(share)
    max_err = max(max_err, err)
    res = megatrace.sample_batch(lane_count, torch.zeros(m, device=dev),
                                 *tables, 13, want_tape=True, **kw)
    cots = probe_cotangents(res["color"], res["count"])
    args = (res["tape"], lane_count, *tables, 13, *cots)
    got = megatrace_bwd.replay_grad(*args, **kw)
    want = megatrace_bwd.replay_grad_reference(*args, **kw)
    rel = volume_errors(got, want, LEAVES + ("vol0",))
    if float(got[-1].abs().max()) == 0.0:
        raise RuntimeError("camera inside the fog: vol0 has no gradient")
    bwd["max_rel_err"] = max(bwd.get("max_rel_err", 0.0), rel)
    print(f"camera inside a fog sphere, {small}x{small} 8 spp: backward vs "
          f"plain max error {rel:.3e} of the leaf's max abs; vol0's "
          f"cotangent {got[-1].tolist()} [{card}]")
    del res, got, want, args

    # ---- (g) the CLI ---------------------------------------------------
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        for name in VOL_SCENES:
            png = os.path.join(tmp, f"{name}.png")
            reset_launches()
            t0 = time.perf_counter()
            rc = cli.main(["--scene", name, "--width", str(width // 2),
                           "--height", str(width // 2), "--spp", "16",
                           "--depth", "8", "--output", png, "--quiet",
                           "--device", dev.type])
            seconds = time.perf_counter() - t0
            with open(png, "rb") as f:
                header = f.read(8)
            if (rc != 0 or header != b"\x89PNG\r\n\x1a\n"
                    or megatrace.VOL_LAUNCHES == 0
                    or megatrace.VOL_LAUNCHES != megatrace.LAUNCHES):
                raise RuntimeError(f"the CLI did not render --scene {name} "
                                   f"through the volume build (rc {rc}, "
                                   f"launches {megatrace.LAUNCHES}, volume "
                                   f"{megatrace.VOL_LAUNCHES})")
            print(f"CLI: --scene {name} {width // 2}x{width // 2}, 16 spp, "
                  f"depth 8 on {dev}: PNG written in {seconds:.2f} s, volume "
                  f"build launches {megatrace.VOL_LAUNCHES}")
    out["volume_parity_share"] = min(shares)
    print(f"phase 23: {time.perf_counter() - t_phase:.1f} s")

    cv = fwd["cornell_volumes"]
    kernels = [{
        "name": "megatrace_batch_volume", "route": "cuda",
        "source": "raytracing_in_one_weekend_tpu_torch/csrc/megatrace_batch.cu",
        "replaces": "raytracing_in_one_weekend_tpu/ops/pallas_megatrace.py:2457",
        "launches": launches_main, "max_abs_err": max_err,
        "ms": cv["ms"], "plain_ms": cv["plain_ms"],
        "bound_ms": cv["bound"][0], "bound_by": cv["bound"][1],
        "library_ms": None, "ms_64spp": cv["ms_64spp"],
        "bound_ms_64spp": cv["bound_ms_64spp"],
        "registers": cv["registers"], "local_bytes": cv["local_bytes"],
        "blocks_per_sm": cv["blocks"],
        **{f"{k}_{f}": fwd[k][f] for k in ("volume", "probabilistic")
           for f in ("ms", "ms_64spp", "plain_ms", "registers", "blocks")},
        **{f"{k}_bound_ms": fwd[k]["bound"][0]
           for k in ("volume", "probabilistic")},
    }, {
        "name": "megatrace_bwd_volume", "route": "cuda",
        "source": "raytracing_in_one_weekend_tpu_torch/csrc/megatrace_bwd.cu",
        "replaces": "raytracing_in_one_weekend_tpu/ops/megatrace_bwd.py:132",
        "launches": bwd["launches"], "scan_launches": bwd["scan_launches"],
        "max_abs_err": bwd["max_rel_err"],
        "ms": bwd["cornell_volumes_ms"],
        "scan_ms": bwd["cornell_volumes_scan_ms"],
        "replay_grad_ms": bwd["cornell_volumes_replay_grad_ms"],
        "plain_ms": bwd["cornell_volumes_plain_ms"],
        "bound_ms": bwd["cornell_volumes_bound"][0],
        "bound_by": bwd["cornell_volumes_bound"][1], "library_ms": None,
        "ms_64spp": bwd["cornell_volumes_ms_64spp"],
        "bound_ms_64spp": bwd["cornell_volumes_bound_64spp"][0],
        "ns_per_iteration": bwd["cornell_volumes_ns_per_iteration"],
        "ns_per_iteration_64spp":
            bwd["cornell_volumes_ns_per_iteration_64spp"],
        **{f"volume_{f}": bwd[f"volume_{f}"]
           for f in ("ms", "ms_64spp", "replay_grad_ms", "plain_ms",
                     "ns_per_iteration", "ns_per_iteration_64spp")},
        "volume_bound_ms": bwd["volume_bound"][0],
    }]
    return {"kernels": kernels, "paths": out}


# ---------------------------------------------------------------------------
# python3 chip_smoke.py --against DIR: this tree against another on the card
# ---------------------------------------------------------------------------

def motion_phases(dev, card, width: int = 512, spp: int = 64) -> dict:
    """Phase 24: unit-shutter motion, the motion builds of #1 and #2, on
    `cover_motion` (the cover's 485 spheres, its small diffuse ones moving
    up over the shutter), 512x512, depth 8:
    (a) render_batch at 64 spp, 1 warm-up + 3 timed batches (median
        MRays/s), every batch through the motion build (MOTION_LAUNCHES,
        set to 0 just before and read just after), the image finite;
    (b) the motion build against its plain version on the inputs of a
        main-path batch (the plain version on its 64 centre rows,
        `parity_rows`) and on a whole 4 spp batch: tape, count and rays
        identical and the floats within 1e-4 on >= 99% of lanes;
    (c) the build alone by CUDA events at 4 and 64 spp, its plain version
        at 4 spp, registers and blocks an SM, and the bound;
    (d) the fwd+bwd step to the sphere centres and move offsets:
        render_image(differentiable=True), mean((color - target)^2),
        .backward(), 1 warm-up + 2 timed steps (median MRays/s), the path
        kernel's motion build launched, the move offsets' gradient finite
        and nonzero; the backward against the plain replay's autograd on a
        128x128 batch's tape, each leaf within 5e-4 of its max abs;
    (e) #2's motion build alone at 4 and 64 spp (the tape scan's launches
        and the path kernel by CUDA events), replay_grad and its plain
        version at 4 spp on a 128x128 batch;
    (f) the CLI on --scene cover_motion, 256x256, 16 spp, depth 8.
    (`width` and `spp` shrink it for a rehearsal on the CPU.)"""
    t_phase = time.perf_counter()
    n = width * width
    out = {}
    reports = [ptxas_report(megatrace.BUILD_LOG,
                            f"megatrace_sphere_kernelILb{a}ELb{v}ELb1ELb0EE")
               for a, v in ((0, 0), (1, 0), (0, 1), (1, 1))]
    reports.append(ptxas_report(megatrace_bwd.BUILD_LOG,
                                "megatrace_paths_kernelILb0ELb0ELb0ELb1ELb0EE"))
    labels = ("beside spheres", "beside rects and boxes", "with volumes",
              "with rects, boxes and volumes")
    print("motion builds: ptxas #1 " + "; ".join(
        f"{label} {r or '-'}" for label, r in zip(labels, reports))
        + f"; #2 path kernel {reports[4] or '-'}")
    scene, cs = book_scenes.SCENES["cover_motion"]()
    scene = scene.to(dev)
    move = scene.spheres.move_offset
    if (not megatrace.scene_eligible(scene, allow_triangles=True,
                                     allow_rect_box=True, allow_volumes=True,
                                     allow_motion=True)
            or megatrace.scene_eligible(scene, allow_rect_box=True)):
        raise RuntimeError("cover_motion left the batch kernel's scope, or "
                           "entered the per-ray megatrace's")
    camera, tables = batch_inputs(scene, cs, width, width, dev)
    s_count = scene.spheres.center.shape[0]
    kw = dict(trace_depth=8, has_dielectrics=True, sky_on=True,
              move_offsets=move)

    # ---- (a) the forward main path ------------------------------------------
    gen = torch.Generator().manual_seed(5)
    acc = film.zero_accumulators(n, device=dev)

    def forward():
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, m = renderer.render_batch(scene, camera, acc, gen, width=width,
                                     height=width, samples=spp,
                                     trace_depth=8)
        rays = float(m.total_rays)
        torch.cuda.synchronize()
        return rays, time.perf_counter() - t

    reset_launches()
    runs = [forward() for _ in range(4)]
    launches = (megatrace.LAUNCHES, megatrace.MOTION_LAUNCHES)
    if launches != (4, 4):
        raise RuntimeError(f"cover_motion: batch kernel launches {launches}, "
                           "want 4 of the motion build")
    rate = statistics.median(r / t / 1e6 for r, t in runs[1:])
    img = film.combine(acc, width, width).color
    if not bool(torch.isfinite(img).all()) or float(img.mean()) <= 0.2:
        raise RuntimeError(f"bad cover_motion image: mean {float(img.mean())}")
    print(f"motion main path: cover_motion {width}x{width} depth 8, {spp} "
          f"spp/batch: median {rate:.3f} MRays/s over 3 batches "
          f"({runs[1][0]:.0f} rays/batch; launches batch kernel "
          f"{launches[0]}, motion build {launches[1]}); image mean "
          f"{float(img.mean()):.4f} [{card}]")
    out["cover_motion_fwd_mrays"] = rate

    # ---- (b) kernel vs plain on a main-path batch's inputs ------------------
    with recorded_calls(megatrace, "sample_batch") as calls:
        renderer.render_batch(scene, camera, acc, gen, width=width,
                              height=width, samples=spp, trace_depth=8)
    (args, kwargs, _), = calls
    if kwargs.get("move_offsets") is None:
        raise RuntimeError("cover_motion: the main path passed no move "
                           "offsets")
    t = time.perf_counter()
    share, max_err = parity_rows(f"motion build, cover_motion {width}x{width}"
                                 f" {spp} spp main-path batch", args, kwargs,
                                 64, width)
    print(f"  (plain version {time.perf_counter() - t:.1f} s)")
    shares = [share]
    del calls, args, kwargs

    # ---- (c) the motion build alone -------------------------------------------
    zeros = torch.zeros(n, device=dev)
    timed = {}
    for few in (4, spp):
        lane_count = torch.full((n,), few, dtype=torch.int32, device=dev)
        res = megatrace.sample_batch(lane_count, zeros, *tables, 7,
                                     samples=few, want_tape=True, **kw)
        rays = float(res["rays"].sum())
        bnd = bound(rays * (s_count * MOTION_SWEEP_FLOPS + SHADE_FLOPS),
                    n * 4 * (2 + megatrace.OUT_ROWS)
                    + s_count * 4 * (4 + 4 + 16) + 4 * 32)
        ms = aux_launch_ms(tables, None, None, few, 20 if few == 4 else 5,
                           kw, move=move)
        timed[few] = (ms, rays, bnd)
        if few == 4:
            plain_ms, plain = time_batch(
                megatrace.sample_batch_reference, lane_count, zeros,
                *tables, 7, samples=few, repeats=1, want_tape=True, **kw)
            share4, err4 = lane_agreement(res, plain)
            if share4 < 0.99:
                raise RuntimeError(f"cover_motion motion build/plain "
                                   f"agreement {share4}")
            shares.append(share4)
            max_err = max(max_err, err4)
            del plain
        del res
    info = megatrace.sphere_kernel_info(s_count, has_motion=True)
    (ms4, rays4, bnd4), (ms64, rays64, bnd64) = timed[4], timed[spp]
    print(f"motion build alone, cover_motion {width}x{width} depth 8 (CUDA "
          f"events, launches alone): 4 spp {ms4:.3f} ms ({rays4:.0f} "
          f"bounces, bound {bnd4[0]:.4f} ms by {bnd4[1]}, "
          f"{bnd4[0] / ms4:.1%}), {spp} spp {ms64:.3f} ms ({rays64:.0f} "
          f"bounces, bound {bnd64[0]:.4f} ms, {bnd64[0] / ms64:.1%}); "
          f"plain {plain_ms:.3f} ms at 4 spp ({share4:.6f} of lanes "
          f"agree); {info['registers']} registers, {info['local_bytes']} B "
          f"local a thread, {info['blocks']} blocks of 128 an SM [{card}]")
    fwd = dict(ms=ms4, ms_64spp=ms64, plain_ms=plain_ms, bound=bnd4,
               bound_ms_64spp=bnd64[0], **info)

    # ---- (d) the fwd+bwd step -------------------------------------------------
    target = img.detach()
    seeds = [int(torch.randint(0, renderer.SEED_RANGE, (), generator=gen))
             for _ in range(3)]
    rays = []
    for seed in seeds:  # the forward rays of each step's seed
        _, m = renderer.render_batch(
            scene, camera, film.zero_accumulators(n, device=dev),
            width=width, height=width, samples=spp, trace_depth=8, seed=seed,
            differentiable=False)
        rays.append(float(m.total_rays))
    names = ("sphere_centers", "sphere_move_offsets")
    reset_launches()
    rates = []
    for seed, r in zip(seeds, rays):
        params = {k: v.detach().clone().requires_grad_() for k, v in
                  params_mod.extract_params(scene, names).items()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        step = renderer.render_image(
            params_mod.apply_params(scene, params), camera, width=width,
            height=width, samples_per_pixel=spp, trace_depth=8, seed=seed,
            differentiable=True)
        torch.cuda.synchronize()
        torch.mean((step.color - target) ** 2).backward()
        torch.cuda.synchronize()
        rates.append(r / (time.perf_counter() - t) / 1e6)
    launches = (megatrace.MOTION_LAUNCHES, megatrace_bwd.SCAN_LAUNCHES,
                megatrace_bwd.LAUNCHES)
    if min(launches) == 0 or megatrace.LAUNCHES != launches[0]:
        raise RuntimeError(f"cover_motion fwd+bwd: launches {launches}")
    grads = {k: v.grad for k, v in params.items()}
    if (not all(bool(torch.isfinite(g).all()) for g in grads.values())
            or float(grads["sphere_move_offsets"].abs().max()) == 0.0):
        raise RuntimeError("cover_motion fwd+bwd: bad gradients")
    rate = statistics.median(rates[1:])
    out["cover_motion_fwd_bwd_mrays"] = rate
    print(f"motion fwd+bwd: cover_motion {width}x{width} depth 8, {spp} spp: "
          f"median {rate:.3f} MRays/s over 2 steps ({rays[-1]:.0f} forward "
          f"rays/step; launches motion build {launches[0]}, tape scan "
          f"{launches[1]}, path kernel {launches[2]}); max |grad| "
          + ", ".join(f"{k} {float(g.abs().max()):.4g}"
                      for k, g in grads.items()) + f" [{card}]")
    bwd = dict(launches=launches[2], scan_launches=launches[1])

    # ---- (e) #2's motion build alone, and against its plain version -----------
    small = min(128, width)
    camera_s, tables_s = batch_inputs(scene, cs, small, small, dev)
    leaves = LEAVES + ("move_offsets",)
    worst = 0.0
    for few in (4, spp):
        for w_, tabs in ((width, tables), (small, tables_s)):
            m_ = w_ * w_
            if few == spp and w_ == small:
                continue
            lane_count = torch.full((m_,), few, dtype=torch.int32,
                                    device=dev)
            fkw = dict(kw, samples=few)
            res = megatrace.sample_batch(lane_count, torch.zeros(m_,
                                                                 device=dev),
                                         *tabs, 7, want_tape=True, **fkw)
            cots = probe_cotangents(res["color"], res["count"])
            if w_ == small:  # the kernel against its plain version
                args = (res["tape"], lane_count, *tabs, 7, *cots)
                ms, got = time_batch(megatrace_bwd.replay_grad, *args,
                                     repeats=5, **fkw)
                plain_ms_b, want = time_batch(
                    megatrace_bwd.replay_grad_reference, *args, repeats=1,
                    **fkw)
                worst = max(worst, aux_errors(got, want, leaves))
                print(f"cover_motion {small}x{small} depth 8, {few} spp "
                      f"backward: replay_grad {ms:.3f} ms, plain "
                      f"{plain_ms_b:.3f} ms; max error {worst:.3e} of the "
                      f"leaf's max abs over {', '.join(leaves)} [{card}]")
                bwd.update(replay_grad_ms=ms, plain_ms=plain_ms_b)
                del got, want, args
                continue
            live = float(res["rays"].sum())
            scan_ms, glue_ms, paths_ms, table = bwd_parts_ms(
                tabs, None, lane_count, res["tape"], cots, 7, fkw,
                5 if few == 4 else 3, move=move)
            bnd = bwd_bound(live, table.shape[0], n, s_count * 4 * 26,
                            live * MOTION_BWD_FLOPS)
            stats = path_stats(table, 8)
            print(f"motion backward alone, cover_motion {width}x{width} "
                  f"depth 8, {few} spp (CUDA events): tape scan's two "
                  f"launches {scan_ms:.3f} ms (glue {glue_ms:.3f} ms more), "
                  f"path kernel {paths_ms:.3f} ms, "
                  f"{paths_ms * 1e6 / live:.3f} ns a live iteration (bound "
                  f"{bnd[0]:.4f} ms by {bnd[1]}, {bnd[0] / paths_ms:.1%}; "
                  f"{live:.0f} live iterations); {stats['paths']} paths "
                  f"[{card}]")
            key = "" if few == 4 else "_64spp"
            bwd[f"ms{key}"] = paths_ms
            bwd[f"scan_ms{key}"] = scan_ms
            bwd[f"bound{key}"] = bnd
            bwd[f"ns_per_iteration{key}"] = paths_ms * 1e6 / live
            del res, table
    bwd["max_rel_err"] = worst

    # ---- (f) the CLI -------------------------------------------------------------
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        png = os.path.join(tmp, "cover_motion.png")
        reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(["--scene", "cover_motion", "--width", str(width // 2),
                       "--height", str(width // 2), "--spp", "16", "--depth",
                       "8", "--output", png, "--quiet", "--device", dev.type])
        seconds = time.perf_counter() - t0
        with open(png, "rb") as f:
            header = f.read(8)
        if (rc != 0 or header != b"\x89PNG\r\n\x1a\n"
                or megatrace.MOTION_LAUNCHES == 0
                or megatrace.MOTION_LAUNCHES != megatrace.LAUNCHES):
            raise RuntimeError(f"the CLI did not render --scene cover_motion "
                               f"through the motion build (rc {rc}, "
                               f"launches {megatrace.LAUNCHES}, motion "
                               f"{megatrace.MOTION_LAUNCHES})")
        print(f"CLI: --scene cover_motion {width // 2}x{width // 2}, 16 spp, "
              f"depth 8 on {dev}: PNG written in {seconds:.2f} s, motion "
              f"build launches {megatrace.MOTION_LAUNCHES}")
    out["motion_parity_share"] = min(shares)
    print(f"phase 24: {time.perf_counter() - t_phase:.1f} s")

    kernels = [{
        "name": "megatrace_batch_motion", "route": "cuda",
        "source": "raytracing_in_one_weekend_tpu_torch/csrc/megatrace_batch.cu",
        "replaces": "raytracing_in_one_weekend_tpu/ops/pallas_megatrace.py:2457",
        "launches": 4, "max_abs_err": max_err,
        "ms": fwd["ms"], "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound"][0], "bound_by": fwd["bound"][1],
        "library_ms": None, "ms_64spp": fwd["ms_64spp"],
        "bound_ms_64spp": fwd["bound_ms_64spp"],
        "registers": fwd["registers"], "local_bytes": fwd["local_bytes"],
        "blocks_per_sm": fwd["blocks"],
    }, {
        "name": "megatrace_bwd_motion", "route": "cuda",
        "source": "raytracing_in_one_weekend_tpu_torch/csrc/megatrace_bwd.cu",
        "replaces": "raytracing_in_one_weekend_tpu/ops/megatrace_bwd.py:132",
        "launches": bwd["launches"], "scan_launches": bwd["scan_launches"],
        "max_abs_err": bwd["max_rel_err"], "ms": bwd["ms"],
        "scan_ms": bwd["scan_ms"], "replay_grad_ms": bwd["replay_grad_ms"],
        "plain_ms": bwd["plain_ms"], "bound_ms": bwd["bound"][0],
        "bound_by": bwd["bound"][1], "library_ms": None,
        "ms_64spp": bwd["ms_64spp"], "bound_ms_64spp": bwd["bound_64spp"][0],
        "ns_per_iteration": bwd["ns_per_iteration"],
        "ns_per_iteration_64spp": bwd["ns_per_iteration_64spp"],
    }]
    return {"kernels": kernels, "paths": out}


TEX_SCENES = ("checkered", "perlin", "textured_sphere", "final_book2")


def texture_flops(tape, scene, tex, s_count: int, rect, r_count: int,
                  b_count: int) -> float:
    """The texture builds' operations on a tape's bounces: the sweep and
    shading of every bounce (with rects, boxes and volumes, winner_flops';
    with motion, MOTION_SWEEP_FLOPS a sphere) and each textured winner's
    texture (a sphere's material's record type)."""
    rays = float((tape > -1.5).sum())
    if r_count or b_count or scene.flags.has_volumes:
        flops = winner_flops(tape, s_count, rect, r_count, b_count)
    else:
        flops = rays * (s_count * SWEEP_FLOPS + SHADE_FLOPS)
    if scene.flags.has_motion:
        flops += rays * s_count * (MOTION_SWEEP_FLOPS - SWEEP_FLOPS)
    codes = tape[(tape >= 0) & (tape < s_count)].long()
    ttype = tex.rec[scene.spheres.material.long()[codes], 0]
    return (flops + float((ttype == 2).sum()) * CHECKER_FLOPS
            + float((ttype == 3).sum()) * MARBLE_FLOPS
            + float((ttype == 4).sum()) * TEXEL_FLOPS)


def texture_inputs(scene, cs, width, dev):
    """(camera, the six tables, the batch kernel's keyword tables) of a
    width x width batch of a textured scene."""
    camera, tables = batch_inputs(scene, cs, width, width, dev)
    packed = materials.pack_materials(scene)
    rect, box = megatrace.pack_aux_tables(scene, packed)
    vol0 = (megatrace.camera_containment_row(scene, packed, camera.origin)
            if scene.flags.has_volumes else None)
    return camera, tables, dict(
        rect_tables=rect, box_tables=box, vol0=vol0,
        move_offsets=scene.spheres.move_offset,
        tex_tables=megatrace.pack_texture_tables(scene))


def texture_phases(dev, card, width: int = 512, spp: int = 64) -> dict:
    """Phase 25: checker, Perlin and image textures, the texture builds of
    #1 and #2, on `checkered` (two checkered spheres), `perlin` (two
    Perlin-marble spheres), `textured_sphere` (a 64x128 image on a sphere)
    and `final_book2` (Book 2's composite: 64 boxes, a rect light, 71
    spheres, one moving, a fog sphere in a glass shell, an image and a
    Perlin texture), 512x512, depth 8:
    (a) render_batch at 64 spp, 1 warm-up + 2 timed batches (median
        MRays/s), every batch through a texture build (TEX_LAUNCHES, set to
        0 just before and read just after), the image finite;
    (b) the texture build against its plain version on the inputs of a
        main-path batch (the plain version on its 64 centre rows,
        `parity_rows`) and on a whole 4 spp batch: tape, count and rays identical and the floats
        within 1e-4 on >= 99% of lanes;
    (c) the build alone by CUDA events at 4 and 64 spp, its plain version
        at 4 spp, registers and blocks an SM, and the bound;
    (d) on checkered and textured_sphere the fwd+bwd step to the texture
        colours (and the atlas): render_image(differentiable=True),
        mean((color - target)^2), .backward(), 1 warm-up + 2 timed steps,
        the path kernel's texture build launched, the gradients finite and
        nonzero; the backward against the plain replay's autograd on a
        128x128, 4 spp batch, each leaf within 5e-4 of its max abs; #2's
        texture build alone at 4 and 64 spp on checkered;
    (e) on perlin and final_book2 one differentiable step through the
        wavefront at 128x128 (the replay has no marble): no batch kernel
        launched, the gradients finite and nonzero;
    (f) the CLI on each scene, 256x256, 16 spp, depth 8.
    (`width` and `spp` shrink it for a rehearsal on the CPU.)"""
    t_phase = time.perf_counter()
    n = width * width
    out, fwd, bwd = {}, {}, dict(launches=0, scan_launches=0,
                                 max_rel_err=0.0)
    labels = ("beside spheres", "beside rects and boxes", "with volumes",
              "with rects, boxes and volumes", "with motion",
              "with everything")
    reports = [ptxas_report(megatrace.BUILD_LOG,
                            f"megatrace_sphere_kernelILb{a}ELb{v}ELb{m}ELb1EE")
               for a, v, m in ((0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
                               (0, 0, 1), (1, 1, 1))]
    print("texture builds: ptxas #1 " + "; ".join(
        f"{label} {r or '-'}" for label, r in zip(labels, reports))
        + "; #2 path kernel " + (ptxas_report(
            megatrace_bwd.BUILD_LOG,
            "megatrace_paths_kernelILb0ELb0ELb0ELb0ELb1EE") or "-"))
    shares, max_err, launches_main = [], 0.0, 0
    registry = {**book_scenes.SCENES, **testbeds.SCENES}
    zeros = torch.zeros(n, device=dev)
    for name in TEX_SCENES:
        scene, cs = registry[name]()
        scene = scene.to(dev)
        if (not megatrace.scene_eligible(
                scene, allow_triangles=True, allow_rect_box=True,
                allow_volumes=True, allow_motion=True, allow_textures=True)
                or megatrace.scene_eligible(scene, allow_rect_box=True,
                                            allow_volumes=True,
                                            allow_motion=True)):
            raise RuntimeError(f"{name} left the batch kernel's scope, or "
                               "entered the per-ray megatrace's")
        camera, tables, tkw = texture_inputs(scene, cs, width, dev)
        s_count = scene.spheres.center.shape[0]
        r_count, b_count = scene.rects.rot.shape[0], scene.boxes.rot.shape[0]
        aux_rows = sum(t[0].shape[0] for t in (tkw["rect_tables"],
                                               tkw["box_tables"])
                       if t is not None)
        kw = dict(trace_depth=8, has_dielectrics=scene.flags.has_dielectrics,
                  sky_on=scene.flags.sky == 1, **tkw)

        # ---- (a) the forward main path ------------------------------------
        gen = torch.Generator().manual_seed(5)
        acc = film.zero_accumulators(n, device=dev)

        def forward():
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, m = renderer.render_batch(scene, camera, acc, gen, width=width,
                                         height=width, samples=spp,
                                         trace_depth=8)
            rays = float(m.total_rays)
            torch.cuda.synchronize()
            return rays, time.perf_counter() - t

        reset_launches()
        runs = [forward() for _ in range(3)]
        launches = (megatrace.LAUNCHES, megatrace.TEX_LAUNCHES)
        if launches != (3, 3):
            raise RuntimeError(f"{name}: batch kernel launches {launches}, "
                               "want 3 of the texture build")
        launches_main += launches[1]
        rate = statistics.median(r / t / 1e6 for r, t in runs[1:])
        img = film.combine(acc, width, width).color
        if not bool(torch.isfinite(img).all()) or float(img.mean()) <= 0.0:
            raise RuntimeError(f"bad {name} image: mean {float(img.mean())}")
        print(f"texture main path: {name} {width}x{width} depth 8, {spp} "
              f"spp/batch: median {rate:.3f} MRays/s over 2 batches "
              f"({runs[1][0]:.0f} rays/batch; launches batch kernel "
              f"{launches[0]}, texture build {launches[1]}); image mean "
              f"{float(img.mean()):.4f} [{card}]")
        out[f"{name}_fwd_mrays"] = rate

        # ---- (b) kernel vs plain on a main-path batch's inputs -------------
        with recorded_calls(megatrace, "sample_batch") as calls:
            renderer.render_batch(scene, camera, acc, gen, width=width,
                                  height=width, samples=spp, trace_depth=8)
        (args, kwargs, _), = calls
        if kwargs.get("tex_tables") is None:
            raise RuntimeError(f"{name}: the main path passed no texture "
                               "tables")
        t = time.perf_counter()
        share, err = parity_rows(f"texture build, {name} {width}x{width} "
                                 f"{spp} spp main-path batch", args, kwargs,
                                 64, width)
        print(f"  (plain version {time.perf_counter() - t:.1f} s)")
        shares.append(share)
        max_err = max(max_err, err)
        del calls, args, kwargs

        # ---- (c) the texture build alone -----------------------------------
        timed = {}
        tex = tkw["tex_tables"]
        table_bytes = (s_count * 4 * (4 + 4 + 16) + aux_rows * 4 * 32
                       + tex.rec.numel() * 4
                       + (0 if tex.perlin is None else 4 * 8 * 256)
                       + (0 if tex.atlas is None else 4 * tex.atlas.numel()))
        for few in (4, spp):
            lane_count = torch.full((n,), few, dtype=torch.int32, device=dev)
            res = megatrace.sample_batch(lane_count, zeros, *tables, 7,
                                         samples=few, want_tape=True, **kw)
            rays = float(res["rays"].sum())
            bnd = bound(texture_flops(res["tape"], scene, tex, s_count,
                                      tkw["rect_tables"], r_count, b_count),
                        n * 4 * (2 + megatrace.OUT_ROWS) + table_bytes)
            ms = aux_launch_ms(tables, tkw["rect_tables"], tkw["box_tables"],
                               few, 10 if few == 4 else 3, kw,
                               vol0=tkw["vol0"], move=tkw["move_offsets"],
                               tex=tex)
            timed[few] = (ms, rays, bnd)
            if few == 4:
                plain_ms, plain = time_batch(
                    megatrace.sample_batch_reference, lane_count, zeros,
                    *tables, 7, samples=few, repeats=1, want_tape=True, **kw)
                share4, err4 = lane_agreement(res, plain)
                if share4 < 0.99:
                    raise RuntimeError(f"{name} texture build/plain "
                                       f"agreement {share4}")
                shares.append(share4)
                max_err = max(max_err, err4)
                del plain
            del res
        info = megatrace.sphere_kernel_info(
            s_count, aux_rows, has_vol=tkw["vol0"] is not None,
            has_motion=tkw["move_offsets"] is not None, has_tex=True)
        (ms4, rays4, bnd4), (ms64, rays64, bnd64) = timed[4], timed[spp]
        print(f"texture build alone, {name} {width}x{width} depth 8 (CUDA "
              f"events, launches alone): 4 spp {ms4:.3f} ms ({rays4:.0f} "
              f"bounces, bound {bnd4[0]:.4f} ms by {bnd4[1]}, "
              f"{bnd4[0] / ms4:.1%}), {spp} spp {ms64:.3f} ms ({rays64:.0f} "
              f"bounces, bound {bnd64[0]:.4f} ms, {bnd64[0] / ms64:.1%}); "
              f"plain {plain_ms:.3f} ms at 4 spp ({share4:.6f} of lanes "
              f"agree); {info['registers']} registers, "
              f"{info['local_bytes']} B local a thread, {info['blocks']} "
              f"blocks of 128 an SM [{card}]")
        fwd[name] = dict(ms=ms4, ms_64spp=ms64, plain_ms=plain_ms,
                         bound=bnd4, bound_ms_64spp=bnd64[0], **info)

        if name in ("perlin", "final_book2"):
            # ---- (e) one wavefront training step (no marble replay) -------
            small = min(128, width)
            cam_s, _ = batch_inputs(scene, cs, small, small, dev)
            names = (("texture_colors",) if name == "perlin"
                     else ("sphere_centers", "sphere_move_offsets"))
            params = {k: v.detach().clone().requires_grad_() for k, v in
                      params_mod.extract_params(scene, names).items()}
            reset_launches()
            t = time.perf_counter()
            step = renderer.render_image(
                params_mod.apply_params(scene, params), cam_s, width=small,
                height=small, samples_per_pixel=4, trace_depth=8, seed=3)
            torch.mean((step.color - 0.5) ** 2).backward()
            torch.cuda.synchronize()
            grads = {k: v.grad for k, v in params.items()}
            if (megatrace.LAUNCHES != 0
                    or not all(bool(torch.isfinite(g).all())
                               for g in grads.values())
                    or not any(float(g.abs().max()) > 0.0
                               for g in grads.values())):
                raise RuntimeError(f"{name} wavefront step: batch kernel "
                                   f"launches {megatrace.LAUNCHES}, bad "
                                   "gradients")
            print(f"{name} wavefront training step {small}x{small}, 4 spp, "
                  f"depth 8: {time.perf_counter() - t:.2f} s, max |grad| "
                  + ", ".join(f"{k} {float(g.abs().max()):.4g}"
                              for k, g in grads.items()) + f" [{card}]")
            continue

        # ---- (d) the fwd+bwd step through #2's texture build ---------------
        target = img.detach()
        seeds = [int(torch.randint(0, renderer.SEED_RANGE, (), generator=gen))
                 for _ in range(3)]
        names = (("texture_colors",) if tex.atlas is None
                 else ("texture_colors", "texture_atlas"))
        rays = []
        for seed in seeds:  # the forward rays of each step's seed
            _, m = renderer.render_batch(
                scene, camera, film.zero_accumulators(n, device=dev),
                width=width, height=width, samples=spp, trace_depth=8,
                seed=seed, differentiable=False)
            rays.append(float(m.total_rays))
        reset_launches()
        rates = []
        for seed, r in zip(seeds, rays):
            params = {k: v.detach().clone().requires_grad_() for k, v in
                      params_mod.extract_params(scene, names).items()}
            torch.cuda.synchronize()
            t = time.perf_counter()
            step = renderer.render_image(
                params_mod.apply_params(scene, params), camera, width=width,
                height=width, samples_per_pixel=spp, trace_depth=8,
                seed=seed, differentiable=True)
            torch.cuda.synchronize()
            torch.mean((step.color - target) ** 2).backward()
            torch.cuda.synchronize()
            rates.append(r / (time.perf_counter() - t) / 1e6)
        launches = (megatrace.TEX_LAUNCHES, megatrace_bwd.SCAN_LAUNCHES,
                    megatrace_bwd.LAUNCHES)
        if min(launches) == 0 or megatrace.LAUNCHES != launches[0]:
            raise RuntimeError(f"{name} fwd+bwd: launches {launches}")
        grads = {k: v.grad for k, v in params.items()}
        if (not all(bool(torch.isfinite(g).all()) for g in grads.values())
                or not all(float(g.abs().max()) > 0.0
                           for g in grads.values())):
            raise RuntimeError(f"{name} fwd+bwd: bad gradients")
        rate = statistics.median(rates[1:])
        out[f"{name}_fwd_bwd_mrays"] = rate
        print(f"texture fwd+bwd: {name} {width}x{width} depth 8, {spp} spp: "
              f"median {rate:.3f} MRays/s over 2 steps (launches texture "
              f"build {launches[0]}, tape scan {launches[1]}, path kernel "
              f"{launches[2]}); max |grad| " + ", ".join(
                  f"{k} {float(g.abs().max()):.4g}" for k, g in grads.items())
              + f" [{card}]")
        bwd["launches"] += launches[2]
        bwd["scan_launches"] += launches[1]
        small = min(128, width)
        _, tables_s, tkw_s = texture_inputs(scene, cs, small, dev)
        m_ = small * small
        fkw = dict(samples=4, trace_depth=8, sky_on=True,
                   has_dielectrics=scene.flags.has_dielectrics,
                   tex_tables=tkw_s["tex_tables"])
        lane_count = torch.full((m_,), 4, dtype=torch.int32, device=dev)
        res = megatrace.sample_batch(lane_count, torch.zeros(m_, device=dev),
                                     *tables_s, 7, want_tape=True, **fkw)
        cots = probe_cotangents(res["color"], res["count"])
        args = (res["tape"], lane_count, *tables_s, 7, *cots)
        ms, got = time_batch(megatrace_bwd.replay_grad, *args, repeats=5,
                             **fkw)
        plain_ms_b, want = time_batch(megatrace_bwd.replay_grad_reference,
                                      *args, repeats=1, **fkw)
        leaves = LEAVES + ("tex_rec",) + (("atlas",) if tex.atlas is not None
                                          else ())
        rel = aux_errors(got, want, leaves)
        bwd["max_rel_err"] = max(bwd["max_rel_err"], rel)
        print(f"{name} {small}x{small} depth 8, 4 spp backward: replay_grad "
              f"{ms:.3f} ms, plain {plain_ms_b:.3f} ms; max error {rel:.3e} "
              f"of the leaf's max abs over {', '.join(leaves)} [{card}]")
        bwd[f"{name}_replay_grad_ms"] = ms
        bwd[f"{name}_plain_ms"] = plain_ms_b
        del res, got, want, args
        if name != "checkered":
            continue
        for few in (4, spp):
            lane_count = torch.full((n,), few, dtype=torch.int32, device=dev)
            res = megatrace.sample_batch(lane_count, zeros, *tables, 7,
                                         want_tape=True,
                                         **dict(kw, samples=few))
            cots = probe_cotangents(res["color"], res["count"])
            live = float(res["rays"].sum())
            scan_ms, glue_ms, paths_ms, table = bwd_parts_ms(
                tables, None, lane_count, res["tape"], cots, 7,
                dict(kw, samples=few), 5 if few == 4 else 3, tex=tex)
            bnd = bwd_bound(live, table.shape[0], n, s_count * 4 * 39,
                            float((res["tape"] >= 0).sum()) * CHECKER_FLOPS)
            print(f"texture backward alone, checkered {width}x{width} depth "
                  f"8, {few} spp (CUDA events): tape scan's two launches "
                  f"{scan_ms:.3f} ms (glue {glue_ms:.3f} ms more), path "
                  f"kernel {paths_ms:.3f} ms, {paths_ms * 1e6 / live:.3f} ns "
                  f"a live iteration (bound {bnd[0]:.4f} ms by {bnd[1]}, "
                  f"{bnd[0] / paths_ms:.1%}; {live:.0f} live iterations) "
                  f"[{card}]")
            key = "" if few == 4 else "_64spp"
            bwd[f"ms{key}"] = paths_ms
            bwd[f"scan_ms{key}"] = scan_ms
            bwd[f"bound{key}"] = bnd
            bwd[f"ns_per_iteration{key}"] = paths_ms * 1e6 / live
            del res, table

    # ---- (f) the CLI ---------------------------------------------------------
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        for name in TEX_SCENES:
            png = os.path.join(tmp, f"{name}.png")
            reset_launches()
            t0 = time.perf_counter()
            rc = cli.main(["--scene", name, "--width", str(width // 2),
                           "--height", str(width // 2), "--spp", "16",
                           "--depth", "8", "--output", png, "--quiet",
                           "--device", dev.type])
            seconds = time.perf_counter() - t0
            with open(png, "rb") as f:
                header = f.read(8)
            if (rc != 0 or header != b"\x89PNG\r\n\x1a\n"
                    or megatrace.TEX_LAUNCHES == 0
                    or megatrace.TEX_LAUNCHES != megatrace.LAUNCHES):
                raise RuntimeError(f"the CLI did not render --scene {name} "
                                   f"through the texture build (rc {rc}, "
                                   f"launches {megatrace.LAUNCHES}, texture "
                                   f"{megatrace.TEX_LAUNCHES})")
            print(f"CLI: --scene {name} {width // 2}x{width // 2}, 16 spp, "
                  f"depth 8 on {dev}: PNG written in {seconds:.2f} s, "
                  f"texture build launches {megatrace.TEX_LAUNCHES}")
    out["texture_parity_share"] = min(shares)
    print(f"phase 25: {time.perf_counter() - t_phase:.1f} s")

    ch = fwd["checkered"]
    kernels = [{
        "name": "megatrace_batch_texture", "route": "cuda",
        "source": "raytracing_in_one_weekend_tpu_torch/csrc/megatrace_batch.cu",
        "replaces": "raytracing_in_one_weekend_tpu/ops/pallas_megatrace.py:2457",
        "launches": launches_main, "max_abs_err": max_err,
        "ms": ch["ms"], "plain_ms": ch["plain_ms"],
        "bound_ms": ch["bound"][0], "bound_by": ch["bound"][1],
        "library_ms": None, "ms_64spp": ch["ms_64spp"],
        "bound_ms_64spp": ch["bound_ms_64spp"],
        "registers": ch["registers"], "local_bytes": ch["local_bytes"],
        "blocks_per_sm": ch["blocks"],
        **{f"{k}_{f}": fwd[k][f] for k in TEX_SCENES[1:]
           for f in ("ms", "ms_64spp", "plain_ms", "registers", "blocks")},
        **{f"{k}_bound_ms": fwd[k]["bound"][0] for k in TEX_SCENES[1:]},
        **{f"{k}_bound_ms_64spp": fwd[k]["bound_ms_64spp"]
           for k in TEX_SCENES[1:]},
    }, {
        "name": "megatrace_bwd_texture", "route": "cuda",
        "source": "raytracing_in_one_weekend_tpu_torch/csrc/megatrace_bwd.cu",
        "replaces": "raytracing_in_one_weekend_tpu/ops/megatrace_bwd.py:132",
        "launches": bwd["launches"], "scan_launches": bwd["scan_launches"],
        "max_abs_err": bwd["max_rel_err"], "ms": bwd["ms"],
        "scan_ms": bwd["scan_ms"],
        "replay_grad_ms": bwd["checkered_replay_grad_ms"],
        "plain_ms": bwd["checkered_plain_ms"],
        "bound_ms": bwd["bound"][0], "bound_by": bwd["bound"][1],
        "library_ms": None, "ms_64spp": bwd["ms_64spp"],
        "bound_ms_64spp": bwd["bound_64spp"][0],
        "ns_per_iteration": bwd["ns_per_iteration"],
        "ns_per_iteration_64spp": bwd["ns_per_iteration_64spp"],
        "textured_sphere_replay_grad_ms":
            bwd["textured_sphere_replay_grad_ms"],
        "textured_sphere_plain_ms": bwd["textured_sphere_plain_ms"],
    }]
    return {"kernels": kernels, "paths": out}


SASS_SOURCES = ("megatrace_batch", "megatrace_wave", "megatrace_bwd",
                "meshtrace_sync", "meshtrace_permute", "sphere_select",
                "triangle_select")
# kernels this tree changed on purpose, with the kernel that replaced each
# (none: the aux builds are instantiations of their own)
SASS_CHANGED: dict[str, str] = {}

TURN = """
import importlib.util, json, sys
sys.path.insert(0, sys.argv[1])  # the tree whose package is measured
spec = importlib.util.spec_from_file_location("smoke", sys.argv[2])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
print("TURN " + json.dumps(smoke.turn_readings()))
"""


def replay_grad_ms(scene, cs, width: int, samples: int, repeats: int):
    """The backward, megatrace_bwd.replay_grad (its launches and its
    wrapper's glue), by CUDA events after a warm-up, on the tape of one
    forward batch (seed 7) at width x width, depth 8, probe cotangents:
    the same call in this tree and in an older one."""
    dev = torch.device("cuda", 0)
    _, tables = batch_inputs(scene, cs, width, width, dev)
    tri = tri_tables_of(scene)
    n = width * width
    lane_count = torch.full((n,), samples, dtype=torch.int32, device=dev)
    kw = dict(samples=samples, trace_depth=8, tri_tables=tri,
              has_dielectrics=scene.flags.has_dielectrics, sky_on=True)
    fwd = megatrace.sample_batch(lane_count, torch.zeros(n, device=dev),
                                 *tables, 7, want_tape=True, **kw)
    cots = probe_cotangents(fwd["color"], fwd["count"])
    return time_batch(megatrace_bwd.replay_grad, fwd["tape"], lane_count,
                      *tables, 7, *cots, repeats=repeats, **kw)[0]


def turn_readings() -> dict:
    """One turn of `--against`, on the package found first on sys.path, at
    512x512, depth 8: the batch kernel's streamed arm on mesh_large (4
    spp, Morton lanes; CUDA events over 5 launches after a warm-up); its
    sphere build on the cover (4 spp, CUDA events over 10 calls of
    sample_batch after a warm-up);
    bounce_sync at bounce 1 of the mesh_huge wave (median of 5 launches,
    each alone); the backward (`replay_grad_ms`) on the cover at 64 spp
    and on mesh_showcase at 4 spp; the forward MRays/s of render_batch (64
    spp, median of 5 batches) on the cover, mesh_showcase and mesh_huge
    (the sync sampler), and the fwd+bwd MRays/s of phases 8 (cover) and
    17a (mesh_showcase), median of 3 steps."""
    dev = torch.device("cuda", 0)
    for load in (megatrace.load_kernel, megatrace.load_wave_kernel,
                 megatrace_bwd.load_kernel, meshtrace.load_sync_kernel,
                 meshtrace.load_permute_kernel, sphere_select.load_kernel,
                 triangle_select.load_kernel):
        load()  # every source, so that --against reads its SASS
    width = 512
    n = width * width
    out = {}
    large, large_cs = meshes.mesh_large()
    large = large.to(dev)
    _, tables = batch_inputs(large, large_cs, width, width, dev)
    order, _ = (t.to(dev) for t in megatrace.morton_order(width, width))
    out["arm_ms"], _ = time_batch(
        megatrace.sample_batch, torch.full((n,), 4, dtype=torch.int32,
                                           device=dev),
        torch.zeros(n, device=dev), *tables, 7, repeats=5,
        has_dielectrics=large.flags.has_dielectrics, sky_on=True,
        tri_stream_tables=megatrace.pack_tri_stream_tables(
            large, materials.pack_materials(large)),
        samples=4, trace_depth=8, pixel_index=order)
    cover, cover_cs = book_scenes.cover_scene()
    cover = cover.to(dev)
    _, tables = batch_inputs(cover, cover_cs, width, width, dev)
    out["cover_batch_4spp_ms"], _ = time_batch(
        megatrace.sample_batch, torch.full((n,), 4, dtype=torch.int32,
                                           device=dev),
        torch.zeros(n, device=dev), *tables, 7, repeats=10,
        has_dielectrics=cover.flags.has_dielectrics, sky_on=True,
        samples=4, trace_depth=8)
    huge, huge_cs = meshes.mesh_huge()
    huge = huge.to(dev)
    bounces, _, _ = recorded_wave(huge, huge_cs, width, width, dev)
    args, kw, _ = bounces[1]
    out["bounce1_ms"] = launch_ms(
        lambda x: meshtrace.bounce_sync(x, *args[1:], **kw),
        [args[0].clone() for _ in range(6)])
    del bounces, args
    camera, _ = batch_inputs(huge, huge_cs, width, width, dev)
    out["mesh_huge_fwd"] = forward_mrays(huge, camera, width, 5)[0]
    for name, (scene, cs) in (("cover", book_scenes.cover_scene()),
                              ("mesh_showcase", meshes.mesh_showcase())):
        scene = scene.to(dev)
        camera, _ = batch_inputs(scene, cs, width, width, dev)
        out[f"{name}_fwd"], _, acc = forward_mrays(scene, camera, width, 5)
        target = film.combine(acc, width, width).color.detach()
        spp = 64 if name == "cover" else 4
        out[f"{name}_bwd_{spp}spp_ms"] = replay_grad_ms(scene, cs, width,
                                                        spp, 3)
        if name == "cover":
            out["cover_fwd_bwd"] = fwd_bwd_steps(
                scene, camera, target, width, width, 64, 8, [1, 2, 3, 4])[0]
        else:
            out["mesh_showcase_fwd_bwd"] = mesh_fwd_bwd_steps(
                scene, camera, target, width, [1, 2, 3, 4])[0]
    return out


def sass_functions(lib: str) -> dict:
    """{kernel name: its SASS instructions} of a built library, by
    cuobjdump; a template argument list's trailing false flags drop:
    <b, c, false, false> reads as <b, c> and <b, false> as <b> (a flag
    added last with a default, false in every instantiation that existed
    before it: the volume builds' kVol, the motion builds' kMotion, the
    batch kernel's streamed flag of the builds before the streamed kernel
    of its own)."""
    from raytracing_in_one_weekend_tpu_torch.ops import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build.find_nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            # the anonymous namespace's name hashes the file
            name = re.sub(r"_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "_ZN",
                          name)
            name = re.sub(r"(ILb\d(?:ELb\d)*?)(?:ELb0)+EE", r"\1EE", name)
            # the sphere build, a template since its aux build: compare
            # its <false> instance with the kernel it was (their parameter
            # lists differ by the aux build's, which come last)
            name = re.sub(r"(\d+megatrace_sphere_kernel)(?:ILb0EEEv|E)\S*",
                          r"\1<false>", name)
            # every other template kernel by its template arguments (the
            # motion and texture builds added parameters last)
            name = re.sub(r"(I(?:Lb\dE)+E)Ev\S*", r"\1", name)
            funcs[name] = []
        elif name is not None and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            funcs[name].append(" ".join(line.split()))
    return funcs


def against(other: str) -> int:
    """The tree unpacked at `other` (say, the parent commit) against this
    one on the card: the SASS of megatrace_batch's sphere-only and
    triangle builds and of megatrace_wave, function by function; then
    `turn_readings` in turns (other, this, this, other), each turn a
    process of its own importing that tree's package."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    other = os.path.abspath(other)
    readings = {other: [], ROOT: []}
    for root in (other, ROOT, ROOT, other):
        proc = subprocess.run(
            [sys.executable, "-c", TURN, root, os.path.abspath(__file__)],
            capture_output=True, text=True, cwd=root, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"the turn of {root} failed")
        got = json.loads(proc.stdout.split("TURN ")[-1])
        readings[root].append(got)
        print(f"turn {'this tree' if root == ROOT else other}: {got} [{card}]")
    for key in readings[ROOT][0]:
        mine = [r[key] for r in readings[ROOT]]
        theirs = [r[key] for r in readings[other]]
        print(f"{key}: this tree {mine}, {other} {theirs}; means "
              f"{statistics.mean(mine):.3f} against "
              f"{statistics.mean(theirs):.3f} ({card})")
    compare_sass(other)
    return 0


def compare_sass(other: str) -> bool:
    """The SASS of every kernel of SASS_SOURCES as built in the tree at
    `other` (its _build directory) against this tree's, function by
    function; prints each and returns whether every kernel `other` has,
    but those SASS_CHANGED names, is identical here."""
    same = True
    for src in SASS_SOURCES:
        libs = [sorted(glob.glob(os.path.join(
            root, "raytracing_in_one_weekend_tpu_torch", "_build",
            f"lib{src}_*.so")), key=os.path.getmtime)[-1]
            for root in (other, ROOT)]
        theirs, mine = (sass_functions(lib) for lib in libs)
        for name, code in theirs.items():
            if "megatrace_batch_kernelILb" in name and "ELb1EE" in name:
                continue  # the streamed build, now a kernel of its own
            why = [v for k, v in SASS_CHANGED.items() if k in name]
            if why:
                print(f"SASS {src} {name}: {len(code)} instructions, changed "
                      f"on purpose ({why[0]})")
                continue
            equal = mine.get(name) == code
            same &= equal
            print(f"SASS {src} {name}: {len(code)} instructions, "
                  f"{'identical' if equal else 'DIFFERENT'}")
        for name in mine.keys() - theirs.keys():
            print(f"SASS {src} {name}: {len(mine[name])} instructions, new")
    print(f"SASS of every other kernel of the {len(SASS_SOURCES)} sources: "
          f"{'identical' if same else 'not identical'}")
    return same


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
    # the sphere build's occupancy and how much of its warps' time its
    # lanes use, with the map its threads compute (8x4 pixel tiles) and
    # with lane order (one thread a lane, the design before)
    tile_map_check(dev)
    lane_count64 = torch.full((n,), 64, dtype=torch.int32, device=dev)
    ms64, out64 = time_batch(megatrace.sample_batch, lane_count64, count_in,
                             *tables, 7, repeats=3, **dict(kw, samples=64))
    order = megatrace.kernel_tile_lanes(n, width, dev)
    sphere = dict(megatrace.sphere_kernel_info(s_count), ms_64spp=ms64,
                  lane_use=lane_use_share(out["rays"], order),
                  lane_use_64spp=lane_use_share(out64["rays"], order),
                  lane_use_lane_order=lane_use_share(out["rays"],
                                                     torch.arange(n)))
    report = ptxas_report(megatrace.BUILD_LOG,
                          "megatrace_sphere_kernelILb0ELb0ELb0ELb0EE")
    print(f"sphere build: ptxas {report or '(not built here)'}; "
          f"{sphere['registers']} registers, {sphere['local_bytes']} B "
          f"local a thread, {sphere['blocks']} blocks of 128 an SM "
          f"(occupancy API); 4 spp {ms:.3f} ms against a bound of "
          f"{batch_bound[0]:.4f} ms ({batch_bound[0] / ms:.1%}), 64 spp "
          f"{ms64:.3f} ms; lane-use share {sphere['lane_use']:.4f} at 4 spp, "
          f"{sphere['lane_use_64spp']:.4f} at 64 spp (lanes in lane order: "
          f"{sphere['lane_use_lane_order']:.4f} at 4 spp) [{card}]")

    target = img.detach()  # bench.py's target: the forward image
    bwd = differentiable_phases(dev, card, scene, cs, camera, target)
    wave = wavefront_phases(dev, card, scene, cs, camera, target)
    mesh = mesh_phases(dev, card)
    streamed = streamed_phases(dev, card)
    aux = aux_phases(dev, card)
    vol = volume_phases(dev, card)
    motion = motion_phases(dev, card)
    texture = texture_phases(dev, card)

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
        "ms_64spp": sphere["ms_64spp"],
        "registers": sphere["registers"],
        "local_bytes": sphere["local_bytes"],
        "blocks_per_sm": sphere["blocks"],
        "lane_use": sphere["lane_use"],
        "lane_use_64spp": sphere["lane_use_64spp"],
        "library_ms": None,
    }, {
        "name": "megatrace_bwd",
        "route": "cuda",
        "source": "raytracing_in_one_weekend_tpu_torch/csrc/megatrace_bwd.cu",
        "replaces": "raytracing_in_one_weekend_tpu/ops/megatrace_bwd.py:132",
        "launches": bwd["launches"],
        "scan_launches": bwd["scan_launches"],
        "max_abs_err": bwd["max_abs_err"],
        "max_rel_err": bwd["max_rel_err"],
        "ms": bwd["ms"],
        "ms_64spp": bwd["ms_64spp"],
        "replay_grad_ms": bwd["replay_grad_ms"],
        "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"],
        "bound_ms_64spp": bwd["bound_ms_64spp"],
        "bound_by": bwd["bound_by"],
        "library_ms": None,
    }, {
        "name": "megatrace_bwd_scan",
        "route": "cuda",
        "source": "raytracing_in_one_weekend_tpu_torch/csrc/megatrace_bwd.cu",
        "replaces": "raytracing_in_one_weekend_tpu/ops/megatrace_bwd.py:132",
        "launches": bwd["scan_launches"],
        "max_abs_err": bwd["scan"]["max_abs_err"],
        "ms": bwd["scan"]["ms"],
        "glue_ms": bwd["scan"]["glue_ms"],
        "ms_64spp": bwd["scan_ms_64spp"],
        "glue_ms_64spp": bwd["scan_glue_ms_64spp"],
        "plain_ms": bwd["scan"]["plain_ms"],
        "bound_ms": bwd["scan"]["bound"][0],
        "bound_by": bwd["scan"]["bound"][1],
        "library_ms": None,
    }] + wave["kernels"] + [mesh["kernel"]] + streamed["kernels"] \
        + aux["kernels"] + vol["kernels"] + motion["kernels"] \
        + texture["kernels"]
    print(json.dumps({
        "kernels": kernels, "parity_share": min(shares), "fwd_mrays": fwd,
        "depth35_fwd_mrays": fwd35, "fwd_bwd_mrays": bwd["fwd_bwd_mrays"],
        "depth35_fwd_bwd_mrays": bwd["depth35_fwd_bwd_mrays"],
        "step_vjp_rel_err": bwd["step_vjp_rel_err"],
        "replay_primal_share": bwd["replay_primal_share"],
        "peak_gb": bwd["peak_gb"], "trainer_losses": bwd["trainer_losses"],
        "albedo_fit_losses": bwd["albedo_fit_losses"],
        "bwd_paths": {k: bwd[k] for k in ("paths_4spp", "paths_64spp")},
        "wavefront": wave["paths"], "mesh": mesh["paths"],
        "streamed": streamed["paths"], "aux": aux["paths"],
        "volume": vol["paths"], "motion": motion["paths"],
        "texture": texture["paths"]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--against":
        sys.exit(against(sys.argv[2]))
    sys.exit(main())
