"""Render step: a batch of samples for every pixel, accumulated
(counterpart of the JAX package's render/renderer.py, its fused forward
arm).

Reference: the ScheduleSample job graph (Unity/Raytracer.cs:602-816):
run SampleBatchJob over W x H pixels, merge into the accumulators, reduce
metrics.  Here one `render_batch` call is one `ops.megatrace.sample_batch`
launch plus the merge and the metric reduction.  The accumulators are
updated in place, which stands in for the JAX renderer's buffer donation.

The fused arm is ported, forward and differentiable.  With
`differentiable=True` the batch goes through
`ops.megatrace_replay.sample_batch_diff`: the same kernel (with its winner
tape) as primal, the tape replay's backward kernel as gradient.  Only the
color sum's and valid count's cotangents propagate; a loss on an AOV
raises NotImplementedError in backward (the AOV graft of the JAX renderer
needs the wavefront, ROADMAP queue 1, step 9).  Sampler flavors and the
scene features `ops.megatrace.unsupported_feature` lists raise
NotImplementedError naming their ROADMAP item.  An explicit refusal, not a
fallback.
"""

from __future__ import annotations

import dataclasses

import torch

from raytracing_in_one_weekend_tpu_torch.core import materials
from raytracing_in_one_weekend_tpu_torch.core.camera import Camera
from raytracing_in_one_weekend_tpu_torch.ops import megatrace
from raytracing_in_one_weekend_tpu_torch.ops import megatrace_replay
from raytracing_in_one_weekend_tpu_torch.render import film
from raytracing_in_one_weekend_tpu_torch.scene.scene import Scene
from raytracing_in_one_weekend_tpu_torch.utils.tensors import TensorGroup

SEED_RANGE = 2**31 - 1  # batch seeds are drawn from [0, SEED_RANGE)


@dataclasses.dataclass(frozen=True)
class BatchMetrics(TensorGroup):
    """Per-batch reduced metrics (reference: Jobs/ReduceMetricsJob.cs)."""

    total_rays: torch.Tensor  # () float32: every bounce of every sample
    total_samples: torch.Tensor  # ()
    min_sample_count: torch.Tensor  # ()
    max_sample_count: torch.Tensor  # ()
    weight_min: torch.Tensor  # () noise-weight extrema -> the next batch's
    weight_max: torch.Tensor  # () adaptive sampler normalization
    pixel_rays: torch.Tensor  # (P,) int32 rays cast this batch per pixel


def _reduce_metrics(acc: film.Accumulators, pixel_rays) -> BatchMetrics:
    count = acc.sample_count
    weight_per_sample = acc.weight / torch.clamp(count, min=1.0)
    inf = torch.tensor(float("inf"), device=count.device)
    return BatchMetrics(
        total_rays=torch.sum(pixel_rays.to(torch.float32)),
        total_samples=torch.sum(count),
        min_sample_count=torch.min(count),
        max_sample_count=torch.max(count),
        weight_min=torch.min(torch.where(count > 0, weight_per_sample, inf)),
        weight_max=torch.max(torch.where(count > 0, weight_per_sample, -inf)),
        pixel_rays=pixel_rays,
    )


def _apply_deltas(acc: film.Accumulators, d: dict, lane_count) -> BatchMetrics:
    """Merge a sample_batch delta dict into `acc`, in place.  Deltas that
    carry gradients make the accumulators carry them too."""
    fb_new = ((acc.sample_count == 0) & (lane_count > 0))[:, None]
    acc.color.add_(d["color"])
    acc.sample_count.add_(d["count"])
    acc.normal.add_(d["normal"])
    acc.albedo.add_(d["albedo"])
    acc.weight.add_(d["weight"])
    acc.fallback_normal.copy_(
        torch.where(fb_new, d["fallback_normal"], acc.fallback_normal)
    )
    acc.fallback_albedo.copy_(
        torch.where(fb_new, d["fallback_albedo"], acc.fallback_albedo)
    )
    return _reduce_metrics(acc, d["rays"])


def check_scope(scene: Scene, noise_color: int = 0) -> None:
    """Raise NotImplementedError for anything outside the ported slice
    (the same scope, forward and differentiable)."""
    if noise_color != 0:
        raise NotImplementedError(
            "blue-noise sampler flavors are not ported yet "
            "(ROADMAP queue 1, step 11)"
        )
    missing = megatrace.unsupported_feature(scene)
    if missing is not None:
        raise NotImplementedError(f"not ported yet: {missing}")


def render_batch(
    scene: Scene,
    camera: Camera,
    acc: film.Accumulators,
    generator: torch.Generator | None = None,
    *,
    width: int,
    height: int,
    samples: int,
    trace_depth: int,
    sub_pixel_jitter: bool = True,
    interlace: tuple[int, int] = (0, 1),
    differentiable: bool = True,
    sample_range: tuple[int, int] | None = None,
    weight_extrema: torch.Tensor | None = None,
    noise_color: int = 0,
    seed: int | None = None,
) -> tuple[film.Accumulators, BatchMetrics]:
    """Accumulate up to `samples` new samples per pixel into `acc` (in
    place; `acc` is also returned).

    The batch's int32 seed is drawn from `generator` (a host
    torch.Generator); `seed=` overrides the draw.

    interlace = (slice_offset, slice_divider): only rows with
    row % divider == offset take samples (SampleBatchJob.cs:69-70).
    Adaptive sampling (SampleBatchJob.cs:118-126): with `sample_range`
    (min, max) and the previous batch's `weight_extrema` (2,), each pixel
    takes round(lerp(min, max, unlerp(extrema, weight))) samples; pixels
    with zero weight take the minimum.

    differentiable (the default, as in the JAX package): the deltas carry
    gradients to the sphere centers, radii, materials, sky and camera
    (whichever of them require grad) through the tape replay's backward
    kernel.  When none does, or grad mode is off, the batch is the forward
    path unchanged.
    """
    check_scope(scene, noise_color)
    if seed is None:
        if generator is None:
            raise ValueError("render_batch needs a generator or a seed")
        seed = int(torch.randint(0, SEED_RANGE, (), generator=generator))
    dev = scene.spheres.center.device
    n = width * height

    row = torch.arange(n, device=dev) // width
    slice_offset, slice_divider = interlace
    row_active = (row % slice_divider) == slice_offset

    if sample_range is not None and weight_extrema is not None:
        lo, hi = sample_range
        wps = acc.weight / torch.clamp(acc.sample_count, min=1.0)
        span = torch.clamp(weight_extrema[1] - weight_extrema[0], min=1e-12)
        norm = torch.clamp((wps - weight_extrema[0]) / span, 0.0, 1.0)
        per_pixel = torch.where(
            wps == 0.0,
            float(lo),
            torch.round(lo + (hi - lo) * norm),
        ).to(torch.int32)
    else:
        per_pixel = torch.full((n,), samples, dtype=torch.int32, device=dev)
    lane_count = torch.where(row_active, per_pixel, 0)

    records = megatrace.pack_sphere_records(
        scene, materials.pack_materials(scene)
    )
    batch = (megatrace_replay.sample_batch_diff if differentiable
             else megatrace.sample_batch)
    d = batch(
        lane_count,
        acc.sample_count,
        megatrace.pack_camera_row(camera, width, height),
        scene.spheres.center,
        scene.spheres.radius,
        records,
        scene.environment.sky_bottom,
        scene.environment.sky_top,
        seed,
        samples=samples,
        trace_depth=trace_depth,
        has_dielectrics=scene.flags.has_dielectrics,
        sky_on=scene.flags.sky == 1,
        jitter=sub_pixel_jitter,
    )
    return acc, _apply_deltas(acc, d, lane_count)


def render_image(
    scene: Scene,
    camera: Camera,
    generator: torch.Generator | None = None,
    *,
    width: int,
    height: int,
    samples_per_pixel: int,
    trace_depth: int,
    sub_pixel_jitter: bool = True,
    differentiable: bool = True,
    seed: int | None = None,
) -> film.CombinedImage:
    """One-shot render: one batch of `samples_per_pixel` samples.  With
    `differentiable` (the default, as in the JAX package) `color` carries
    gradients to whatever scene or camera tensors require grad."""
    acc = film.zero_accumulators(
        width * height, device=scene.spheres.center.device
    )
    render_batch(
        scene, camera, acc, generator,
        width=width, height=height, samples=samples_per_pixel,
        trace_depth=trace_depth, sub_pixel_jitter=sub_pixel_jitter,
        differentiable=differentiable, seed=seed,
    )
    return film.combine(acc, width, height)
