"""Render step: a batch of samples for every pixel, accumulated
(counterpart of the JAX package's render/renderer.py).

Reference: the ScheduleSample job graph (Unity/Raytracer.cs:602-816):
run SampleBatchJob over W x H pixels, merge into the accumulators, reduce
metrics.  The accumulators are updated in place, which stands in for the
JAX renderer's buffer donation.  `render_batch` takes the JAX renderer's
arms on its conditions:

* the fused arm, forward (`differentiable=False`, or nothing requiring
  grad): one `ops.megatrace.sample_batch` launch per batch, with the
  triangle tables of a mesh scene (`pack_tri_tables`) or the rect and box
  tables of a scene with rects or boxes (`pack_aux_tables`, the kernel's
  aux build), with convex volumes the camera's medium
  (`camera_containment_row`, the kernel's volume builds), with moving
  spheres their move offsets (the kernel's motion builds) and with checker,
  Perlin or image albedos the texture tables (`pack_texture_tables`, the
  kernel's texture builds); a mesh of more
  than TRI_MAX triangles takes the streamed
  tables (`pack_tri_stream_tables`) with lanes in Morton order
  (`megatrace.morton_order`, deltas un-permuted by its rank), and above
  `meshtrace.SYNC_TRI_MIN` triangles the bounce-synchronous sampler
  (`ops.meshtrace.sample_batch_sync`, one launch per bounce) on the JAX
  renderer's conditions (no rects, boxes, volumes, motion, procedural
  textures or noise flavor);
* the fused arm, differentiable: `ops.megatrace_replay.sample_batch_diff`
  (the same kernel with its winner tape as primal, the tape replay's
  backward kernel as gradient of the color sum and the valid count, to
  the spheres, their move offsets, rects, boxes, the triangle soup, the
  materials, a volume's density among them, the texture colours and the
  image atlas), plus
  the AOV graft:
  the normal, albedo, weight and fallback AOVs keep the kernel's values,
  and their gradients come from the differentiable wavefront on the batch
  key (`wavefront_pass`, which selects triangles with
  `ops.triangle_select`).  The graft runs only when a loss gives an AOV
  channel a nonzero cotangent, one sample at a time in backward, so a
  photometric loss pays nothing for it (torch removes no dead code,
  unlike XLA);
* the wavefront arm (`wavefront_pass`, render/integrator.py) where the
  batch kernel is refused: a scene outside its scope, a sampler flavor
  asked for without a noise state (which the port does not have yet), or
  something requiring grad in a scene that is not replay-eligible
  (`megatrace_replay.replay_eligible`, as in the JAX package: a Perlin
  texture, which the replay does not mirror, or a mesh of more than
  TRI_MAX triangles, whose brute-force nearest hit fits small images only
  until the BVH of ROADMAP step 9).

Scenes outside the wavefront's scope raise NotImplementedError naming
their ROADMAP item; `check_scope` also refuses meshes of more than
TRI_STREAM_MAX triangles.
"""

from __future__ import annotations

import dataclasses

import torch

from raytracing_in_one_weekend_tpu_torch.core import camera as camera_mod
from raytracing_in_one_weekend_tpu_torch.core import materials, rng
from raytracing_in_one_weekend_tpu_torch.core.camera import Camera
from raytracing_in_one_weekend_tpu_torch.ops import megatrace
from raytracing_in_one_weekend_tpu_torch.ops import megatrace_replay
from raytracing_in_one_weekend_tpu_torch.ops import meshtrace
from raytracing_in_one_weekend_tpu_torch.render import film, integrator
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


AOV_KEYS = megatrace_replay.AOV_OUTPUTS
AOV_GRAFT_RUNS = 0  # backward passes that ran the wavefront for AOV grads


def check_scope(scene: Scene, noise_color: int = 0) -> None:
    """Raise NotImplementedError for anything outside the ported slice:
    scenes the wavefront cannot trace, meshes beyond TRI_STREAM_MAX, and
    sampler flavors (their noise state is not ported)."""
    if scene.triangles.vert0.shape[0] > megatrace.TRI_STREAM_MAX:
        raise NotImplementedError(megatrace.TOO_MANY_TRIANGLES)
    if noise_color != 0:
        raise NotImplementedError(
            "blue-noise sampler flavors are not ported yet "
            "(ROADMAP queue 1, step 11)"
        )
    integrator.check_scope(scene)


def _sample_step(scene, camera, acc, key, sample_index, row_active,
                 per_pixel, *, width, height, trace_depth, sub_pixel_jitter,
                 differentiable):
    """One wavefront sample for every pixel: (new accumulators, pixel
    rays, trace result, valid as float)."""
    dev = row_active.device
    skey = rng.sample_key(key, sample_index)
    coords = camera_mod.pixel_coords(
        width, height, skey if sub_pixel_jitter else None, sub_pixel_jitter,
        device=dev)
    rays = camera_mod.generate_rays(camera, coords, skey)
    lane_active = row_active & (sample_index < per_pixel)
    result = integrator.trace(scene, rays, skey, trace_depth,
                              differentiable=differentiable,
                              active=lane_active)
    fvalid = (result.valid & row_active).to(torch.float32)
    first = ((acc.sample_count == 0.0) & lane_active)[:, None]
    color_add = result.radiance * fvalid[:, None]
    count_add = fvalid
    if differentiable:
        # zero-valued score-function surrogates, one per accumulated
        # product: unbiased gradients of the sampling decisions (material
        # lotteries) on the color sum and on the valid count
        carrier = result.logp - result.logp.detach()
        color_add = color_add + color_add.detach() * carrier[:, None]
        count_add = count_add + count_add.detach() * carrier
    new = film.Accumulators(
        color=acc.color + color_add,
        sample_count=acc.sample_count + count_add,
        normal=acc.normal + result.aov_normal * fvalid[:, None],
        albedo=acc.albedo + result.aov_albedo * fvalid[:, None],
        weight=acc.weight + result.events * fvalid,
        # the first sample's AOVs, valid or not (SampleBatchJob.cs:146-151)
        fallback_normal=torch.where(first, result.aov_normal,
                                    acc.fallback_normal),
        fallback_albedo=torch.where(first, result.aov_albedo,
                                    acc.fallback_albedo),
    )
    return new, result.pixel_rays, result, fvalid


def wavefront_pass(
    scene: Scene,
    camera: Camera,
    acc: film.Accumulators,
    key: torch.Tensor,
    *,
    width: int,
    height: int,
    samples: int,
    trace_depth: int,
    sub_pixel_jitter: bool = True,
    differentiable: bool = True,
    row_active: torch.Tensor | None = None,
    per_pixel: torch.Tensor | None = None,
) -> tuple[film.Accumulators, torch.Tensor]:
    """The wavefront integrator over `samples` samples per pixel (the JAX
    renderer's `_wavefront_pass`): sample s traces camera rays keyed by
    `rng.sample_key(key, s)` through `integrator.trace`.  Lanes of rows
    outside `row_active`, or past their pixel's `per_pixel` count, take no
    sample.  Returns (new accumulators, rays cast per pixel); `acc` is not
    modified.  With `differentiable`, the results carry gradients to the
    scene and camera tensors that require them."""
    n = width * height
    dev = acc.color.device
    if row_active is None:
        row_active = torch.ones(n, dtype=torch.bool, device=dev)
    if per_pixel is None:
        per_pixel = torch.full((n,), samples, dtype=torch.int32, device=dev)
    pixel_rays = torch.zeros(n, dtype=torch.int32, device=dev)
    for sample_index in range(samples):
        if not bool((row_active & (sample_index < per_pixel)).any()):
            continue  # no lane takes this sample: it would change nothing
        acc, rays, _, _ = _sample_step(
            scene, camera, acc, key, sample_index, row_active, per_pixel,
            width=width, height=height, trace_depth=trace_depth,
            sub_pixel_jitter=sub_pixel_jitter,
            differentiable=differentiable)
        pixel_rays = pixel_rays + rays
    return acc, pixel_rays


def _grad_tensors(*groups) -> list[torch.Tensor]:
    """Every tensor of the (nested) TensorGroups that requires grad."""
    found = []

    def walk(value):
        if isinstance(value, torch.Tensor):
            if value.requires_grad:
                found.append(value)
        elif isinstance(value, TensorGroup):
            for f in dataclasses.fields(value):
                walk(getattr(value, f.name))

    for g in groups:
        walk(g)
    return found


def _aov_vjp(wave: dict, cots: dict, inputs: list) -> list:
    """The gradient of sum(cot * AOV) over the graft's AOV channels with
    respect to `inputs`, from the differentiable wavefront, one sample at
    a time (each sample's graph is freed before the next is built).

    The wavefront runs on detached copies of the inputs: an input may be
    computed from another (set_triangle_vertices makes edge_b = v1 -
    vert0), and the gradient to each must be its own partial derivative,
    or autograd would count the shared path twice."""
    global AOV_GRAFT_RUNS
    AOV_GRAFT_RUNS += 1
    leaves = [t.detach().requires_grad_() for t in inputs]
    swap = {id(t): leaf for t, leaf in zip(inputs, leaves)}
    scene, camera = (group.map_tensors(lambda t: swap.get(id(t), t))
                     for group in (wave["scene"], wave["camera"]))
    row_active, per_pixel = wave["row_active"], wave["per_pixel"]
    samples = wave["samples"]
    n = row_active.shape[0]
    acc = film.zero_accumulators(n, device=row_active.device)
    total = [torch.zeros_like(t) for t in inputs]
    for s in range(samples):
        lane_active = row_active & (s < per_pixel)
        if not bool(lane_active.any()):
            continue
        with torch.enable_grad():
            _, _, result, fvalid = _sample_step(
                scene, camera, acc, wave["key"], s,
                row_active, per_pixel, width=wave["width"],
                height=wave["height"], trace_depth=wave["trace_depth"],
                sub_pixel_jitter=wave["jitter"], differentiable=True)
            # this sample owns the fallback AOVs of the lanes where it is
            # the last sample taken while the pixel had no valid sample
            first = (acc.sample_count == 0.0) & lane_active
            count = acc.sample_count + fvalid
            next_first = torch.zeros_like(first)
            if s + 1 < samples:
                next_first = (count == 0.0) & row_active & (s + 1 < per_pixel)
            owner = (first & ~next_first).to(torch.float32)[:, None]
            terms = (
                ("normal", result.aov_normal * fvalid[:, None]),
                ("albedo", result.aov_albedo * fvalid[:, None]),
                ("weight", result.events * fvalid),
                ("fallback_normal", result.aov_normal * owner),
                ("fallback_albedo", result.aov_albedo * owner),
            )
            loss = sum((cots[k] * v).sum() for k, v in terms
                       if cots[k] is not None)
            if isinstance(loss, torch.Tensor) and loss.requires_grad:
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
                for acc_g, g in zip(total, grads):
                    if g is not None:
                        acc_g.add_(g)
        acc = dataclasses.replace(acc, sample_count=count.detach())
    return total


class _AovGraft(torch.autograd.Function):
    """Identity on the kernel's five AOV channels in forward; in backward,
    their cotangents go to the scene and camera tensors `inputs` through
    the differentiable wavefront (`_aov_vjp`), and only when one of them
    is given (set_materialize_grads(False): unused outputs get None)."""

    @staticmethod
    def forward(ctx, wave, *tensors):
        ctx.wave = wave
        ctx.set_materialize_grads(False)
        aovs = tensors[:len(AOV_KEYS)]
        return tuple(a.clone() for a in aovs)

    @staticmethod
    def backward(ctx, *cots):
        wave = ctx.wave
        inputs = wave["inputs"]
        none = (None,) * (1 + len(AOV_KEYS))
        if all(c is None for c in cots):
            return (*none, *(None,) * len(inputs))
        grads = _aov_vjp(wave, dict(zip(AOV_KEYS, cots)), inputs)
        return (*none, *grads)


def _graft_aovs(d: dict, wave: dict) -> dict:
    """d with its AOV channels passed through _AovGraft."""
    inputs = wave["inputs"]
    outs = _AovGraft.apply(wave, *(d[k].detach() for k in AOV_KEYS),
                           *inputs)
    return {**d, **dict(zip(AOV_KEYS, outs))}


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
    key: torch.Tensor | None = None,
) -> tuple[film.Accumulators, BatchMetrics]:
    """Accumulate up to `samples` new samples per pixel into `acc` (in
    place; `acc` is also returned).

    Randomness: with a threefry `key` (core/rng.py, as the JAX package's
    render_batch takes one), the batch kernel's int32 seed is
    `rng.randint(key, (), 0, 2**31 - 1)`, bit for bit the JAX renderer's,
    and the wavefront draws from `key`.  Otherwise the seed is `seed=` or
    drawn from `generator` (a host torch.Generator), and the wavefront's
    key is `rng.PRNGKey(seed)`.

    interlace = (slice_offset, slice_divider): only rows with
    row % divider == offset take samples (SampleBatchJob.cs:69-70).
    Adaptive sampling (SampleBatchJob.cs:118-126): with `sample_range`
    (min, max) and the previous batch's `weight_extrema` (2,), each pixel
    takes round(lerp(min, max, unlerp(extrema, weight))) samples; pixels
    with zero weight take the minimum.

    differentiable (the default, as in the JAX package): the accumulators
    carry gradients to whichever scene or camera tensors require grad
    (color and count through the tape replay's backward kernel, the AOV
    channels through the wavefront graft).  When none does, or grad mode
    is off, the batch is the forward path unchanged.  A `noise_color`
    other than 0 takes the wavefront with white noise, as the JAX renderer
    does without a noise state.
    """
    if key is not None:
        seed = int(rng.randint(key, (), 0, SEED_RANGE))
    elif seed is None:
        if generator is None:
            raise ValueError("render_batch needs a key, a generator or a "
                             "seed")
        seed = int(torch.randint(0, SEED_RANGE, (), generator=generator))
    if key is None:
        key = rng.PRNGKey(seed)
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

    inputs = (_grad_tensors(scene, camera)
              if differentiable and torch.is_grad_enabled() else [])
    streamed = scene.triangles.vert0.shape[0] > megatrace.TRI_MAX
    if (noise_color != 0
            or not megatrace.scene_eligible(scene, allow_triangles=True,
                                            allow_rect_box=True,
                                            allow_volumes=True,
                                            allow_motion=True,
                                            allow_textures=True)
            or (inputs and not megatrace_replay.replay_eligible(scene))):
        # ---- the wavefront arm: the batch kernel is refused ---------------
        integrator.check_scope(scene)
        new, pixel_rays = wavefront_pass(
            scene, camera, acc, key, width=width, height=height,
            samples=samples, trace_depth=trace_depth,
            sub_pixel_jitter=sub_pixel_jitter, differentiable=differentiable,
            row_active=row_active, per_pixel=per_pixel,
        )
        for f in dataclasses.fields(film.Accumulators):
            getattr(acc, f.name).copy_(getattr(new, f.name))
        return acc, _reduce_metrics(acc, pixel_rays)

    lane_count = torch.where(row_active, per_pixel, 0)
    packed = materials.pack_materials(scene)
    records = megatrace.pack_sphere_records(scene, packed)
    sphere_args = (scene.spheres.center, scene.spheres.radius, records,
                   scene.environment.sky_bottom, scene.environment.sky_top)
    statics = dict(samples=samples, trace_depth=trace_depth,
                   has_dielectrics=scene.flags.has_dielectrics,
                   sky_on=scene.flags.sky == 1, jitter=sub_pixel_jitter)
    if streamed:
        # ---- a mesh beyond TRI_MAX: the streamed tables, forward only ------
        stream = megatrace.pack_tri_stream_tables(scene, packed)
        # the JAX renderer's conditions for the sync route (its others,
        # volumes, motion, procedural textures, noise flavors and cubemap
        # skies, are refused above or by the scope: motion in a mesh scene
        # is ROADMAP step 7.3b)
        if (scene.triangles.vert0.shape[0] > meshtrace.SYNC_TRI_MIN
                and not scene.flags.has_volumes
                and scene.rects.rot.shape[0] == 0
                and scene.boxes.rot.shape[0] == 0):
            d = meshtrace.sample_batch_sync(
                lane_count, acc.sample_count, camera, key, *sphere_args,
                stream, width=width, height=height, **statics)
            return acc, _apply_deltas(acc, d, lane_count)
        # Morton lanes: a warp's rays start from neighbouring pixels, so
        # their AABB culls agree; pixel p is rendered by lane rank[p]
        order, rank = (t.to(dev) for t in megatrace.morton_order(width,
                                                                  height))
        d = megatrace.sample_batch(
            lane_count[order], acc.sample_count[order],
            megatrace.pack_camera_row(camera, width, height), *sphere_args,
            seed, pixel_index=order, tri_stream_tables=stream, **statics)
        d = {k: v[rank] for k, v in d.items()}
        return acc, _apply_deltas(acc, d, lane_count)

    batch = (megatrace_replay.sample_batch_diff if differentiable
             else megatrace.sample_batch)
    # gradients to the rects' and boxes' rotations, positions, extents and
    # materials flow through this pack
    rect_tables, box_tables = megatrace.pack_aux_tables(scene, packed)
    # the camera's medium: gradients to its density, albedo and emission
    # flow through this row
    vol0 = (megatrace.camera_containment_row(scene, packed, camera.origin)
            if scene.flags.has_volumes else None)
    d = batch(
        lane_count,
        acc.sample_count,
        megatrace.pack_camera_row(camera, width, height),
        *sphere_args,
        seed,
        # gradients to the soup's vertices, normals and materials flow
        # through this pack
        tri_tables=megatrace.pack_tri_tables(scene, packed),
        rect_tables=rect_tables, box_tables=box_tables, vol0=vol0,
        # gradients to the move offsets flow through this leaf
        move_offsets=(scene.spheres.move_offset if scene.flags.has_motion
                      else None),
        # gradients to the texture colours and the atlas flow through this
        # pack
        tex_tables=megatrace.pack_texture_tables(scene),
        **statics,
    )
    if inputs:
        # the AOV graft: the kernel's AOV values, the wavefront's gradients
        d = _graft_aovs(d, dict(
            scene=scene, camera=camera, key=key, width=width, height=height,
            samples=samples, trace_depth=trace_depth,
            jitter=sub_pixel_jitter, row_active=row_active,
            per_pixel=per_pixel, inputs=inputs,
        ))
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
    key: torch.Tensor | None = None,
) -> film.CombinedImage:
    """One-shot render: one batch of `samples_per_pixel` samples.  With
    `differentiable` (the default, as in the JAX package) the outputs
    carry gradients to whatever scene or camera tensors require grad."""
    acc = film.zero_accumulators(
        width * height, device=scene.spheres.center.device
    )
    render_batch(
        scene, camera, acc, generator,
        width=width, height=height, samples=samples_per_pixel,
        trace_depth=trace_depth, sub_pixel_jitter=sub_pixel_jitter,
        differentiable=differentiable, seed=seed, key=key,
    )
    return film.combine(acc, width, height)
