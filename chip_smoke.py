"""GPU smoke run of the PyTorch port's main paths: the forward render and
the differentiable render (forward with tape, backward kernel, trainer).

    python3 chip_smoke.py

Needs one CUDA card.  Phases, each of which raises on failure:
  1. report the card (nvidia-smi name and power limit) and versions;
  2. build both kernels (csrc/megatrace_batch.cu, csrc/megatrace_bwd.cu),
     one nvcc each, at once; print ptxas's register and spill lines;
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
     4 spp, and compare their gradients.
MRays/s counts every bounce of every sample as one ray, with the ray
count the kernel itself reports.  The last line is the JSON status.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from raytracing_in_one_weekend_tpu_torch.core import camera as camera_mod
from raytracing_in_one_weekend_tpu_torch.core import materials
from raytracing_in_one_weekend_tpu_torch.diff import inverse
from raytracing_in_one_weekend_tpu_torch.diff import params as params_mod
from raytracing_in_one_weekend_tpu_torch.models import book_scenes
from raytracing_in_one_weekend_tpu_torch.ops import megatrace
from raytracing_in_one_weekend_tpu_torch.ops import megatrace_bwd
from raytracing_in_one_weekend_tpu_torch.ops import megatrace_replay
from raytracing_in_one_weekend_tpu_torch.render import film, renderer

TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = 5e-4  # of each cotangent's / leaf's max abs
LEAVES = ("camera_row", "centers", "radii", "records", "sky_bottom",
          "sky_top")
FLOAT_CHANNELS = ("color", "normal", "albedo", "weight", "fallback_normal",
                  "fallback_albedo")


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


def check_parity(label: str, args: tuple, kwargs: dict) -> tuple[float, float]:
    """Run the kernel and the plain version on the same inputs, with the
    winner tape; raise unless >= 99% of lanes agree."""
    kwargs = dict(kwargs, want_tape=True)
    before = megatrace.LAUNCHES
    got = megatrace.sample_batch(*args, **kwargs)
    torch.cuda.synchronize()
    if megatrace.LAUNCHES != before + 1:
        raise RuntimeError("sample_batch did not launch the kernel")
    want = megatrace.sample_batch_reference(*args, **kwargs)
    share, err = lane_agreement(got, want)
    print(f"parity {label}: {share:.6f} of lanes identical (tape, count, "
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


def leaf_errors(got, want) -> tuple[float, float]:
    """(max abs error, max error relative to the leaf's max abs) over the
    six leaves; raises unless each is within GRAD_TOL."""
    max_abs = max_rel = 0.0
    for name, g, w in zip(LEAVES, got, want):
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        if not (err <= GRAD_TOL * scale) or scale == 0.0:
            raise RuntimeError(f"backward kernel vs plain: {name} error "
                               f"{err} against max abs {scale}")
        max_abs, max_rel = max(max_abs, err), max(max_rel, err / scale)
    return max_abs, max_rel


def step_vjp_check(dev, scene, cs) -> float:
    """Phase 6: the kernel's one-iteration VJP against autograd of the
    plain replay_iteration on every lane, at every live iteration (three
    of them printed in full)."""
    w, spp, depth, seed = 64, 4, 8, 21
    n = w * w
    _, tables = batch_inputs(scene, cs, w, w, dev)
    lane_count = torch.full((n,), spp, dtype=torch.int32, device=dev)
    kw = dict(samples=spp, trace_depth=depth,
              has_dielectrics=scene.flags.has_dielectrics, sky_on=True)
    tape = megatrace.sample_batch(lane_count, torch.zeros(n, device=dev),
                                  *tables, seed, want_tape=True,
                                  **kw)["tape"]
    ent = megatrace_replay.build_entity_rows(*tables[1:4]).detach()
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
            diel = (codes >= 0) & (winner[:, 10] > 0.5)
            if (mixed is None and it > 0 and bool(regen.any())
                    and bool(diel.any()) and bool((codes == -1).any())):
                mixed = it
            if bool((codes > -1.5).any()):
                last = it
            state = megatrace_replay.replay_iteration(
                state, winner.T, codes, it, env, jitter=True,
                has_dielectrics=kw["has_dielectrics"], sky_on=True,
                trace_depth=depth)
    if mixed is None:
        raise RuntimeError("no iteration with regen, dielectric and sky lanes")
    rng = np.random.default_rng(0)
    worst, worst_it = 0.0, 0
    for it in range(last + 1):
        cot = torch.from_numpy(rng.standard_normal((len(keys), n))
                               .astype(np.float32)).to(dev)
        cot[12:16] = 0.0  # decisions and counters carry no cotangent
        args = (states[it], tape[it].contiguous(), it, cot, lane_count,
                *tables, seed)
        got = megatrace_bwd.replay_step_vjp(*args, trace_depth=depth,
                                            has_dielectrics=True)
        torch.cuda.synchronize()
        want = megatrace_bwd.replay_step_vjp_reference(
            *args, trace_depth=depth, has_dielectrics=True)
        errs = []
        for name, k, rows in megatrace_bwd.STEP_COTANGENTS:
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
            print(f"step VJP, cover {w}x{w} iteration {it}: "
                  + ", ".join(errs))
    print(f"step VJP, cover {w}x{w}: every iteration 0..{last} within "
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
    print(f"512x512 depth 8, 4 spp backward: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms; max error {r:.3e} of the leaf's max abs "
          f"[{card}]")
    out.update(ms=ms, plain_ms=plain_ms, max_abs_err=max_abs,
               max_rel_err=max_rel)
    return out


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
    with ThreadPoolExecutor(max_workers=2) as pool:
        for build in [pool.submit(megatrace.load_kernel),
                      pool.submit(megatrace_bwd.load_kernel)]:
            build.result()
    print(f"build: megatrace_batch.cu and megatrace_bwd.cu in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in (("megatrace_batch", megatrace.BUILD_LOG),
                      ("megatrace_bwd", megatrace_bwd.BUILD_LOG)):
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
    print(f"512x512 depth 8, 4 spp: kernel {ms:.3f} ms "
          f"({rays4 / ms / 1e3:.3f} MRays/s), plain {plain_ms:.3f} ms "
          f"({rays4 / plain_ms / 1e3:.3f} MRays/s); {share:.6f} of lanes "
          f"agree, max abs err {err:.3g} [{card}]")

    target = img.detach()  # bench.py's target: the forward image
    bwd = differentiable_phases(dev, card, scene, cs, camera, target)

    print(json.dumps({"kernels": [{
        "name": "megatrace_batch",
        "route": "cuda",
        "source": "raytracing_in_one_weekend_tpu_torch/csrc/megatrace_batch.cu",
        "replaces": "raytracing_in_one_weekend_tpu/ops/pallas_megatrace.py:2457",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
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
    }], "parity_share": min(shares), "fwd_mrays": fwd,
        "depth35_fwd_mrays": fwd35, "fwd_bwd_mrays": bwd["fwd_bwd_mrays"],
        "depth35_fwd_bwd_mrays": bwd["depth35_fwd_bwd_mrays"],
        "step_vjp_rel_err": bwd["step_vjp_rel_err"],
        "replay_primal_share": bwd["replay_primal_share"],
        "peak_gb": bwd["peak_gb"], "trainer_losses": bwd["trainer_losses"],
        "albedo_fit_losses": bwd["albedo_fit_losses"]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
