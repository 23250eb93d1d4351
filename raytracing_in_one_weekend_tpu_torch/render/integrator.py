"""Wavefront path-tracing integrator (counterpart of the JAX package's
render/integrator.py), for scenes of spheres, rects, boxes and triangles.

Reference: the Sample() bounce loop of SampleBatchJob.cs:166-401 — nearest
hit, material scatter, the emission/attenuation fold, AOV capture, sky
termination; depth exhaustion fails the sample (:380-381).  Every ray of
the wavefront advances in lockstep with an active mask; the two-stack fold
is the running pair radiance += throughput * e, throughput *= a.

`trace` takes one of three arms, in the JAX package's order and on its
conditions:

* `mega`: not differentiable, no pre-drawn first-bounce directions, and
  the scene in the per-ray megatrace kernel's scope
  (`ops.megatrace.scene_eligible`, sphere-only): the whole depth loop in
  one launch of `ops.megatrace.megatrace` (CUDA: csrc/megatrace_wave.cu).
* `fast`: not differentiable otherwise, for scenes of spheres only: per
  bounce, the fused selection `ops.sphere_select.sphere_select_full`
  (csrc/sphere_select.cu) hands the winner's record to the scatter,
  which carries no geometry gradients.
* the general arm, differentiable, or a scene with rects, boxes,
  triangles or moving spheres: per bounce, `ops.intersect.nearest_hit`
  (the detached selections `sphere_select` and `triangle_select`, the
  rect and box tests and the moving spheres at each ray's time in plain
  PyTorch, then the winners' tests with gradients).

Convex volumes (spheres and boxes of a ProbabilisticVolume material) take
the general arm's probabilistic walk (SampleBatchJob.cs:212-303): each
path carries the volume it is in (`inside_volume`, from
`intersect.point_inside_volume` at the start), a Beer-Lambert free path
decides between an in-medium scatter and the next surface, and an entry
or an exit without a scatter passes the boundary; the density's gradient
rides the score-function `logp`.

On CPU tensors each kernel runs its plain PyTorch version.  Motion, rects,
boxes or volumes in mesh scenes, procedural textures and cubemap skies
raise NotImplementedError naming their ROADMAP steps, and so does a noise
context (sampler flavors, step 11).
"""

from __future__ import annotations

import dataclasses

import torch

from raytracing_in_one_weekend_tpu_torch.core import (
    environment, materials, math3, rng,
)
from raytracing_in_one_weekend_tpu_torch.core.ray import (
    SELF_INTERSECTION_OFFSET, Rays,
)
from raytracing_in_one_weekend_tpu_torch.ops import (
    intersect, megatrace, sphere_select,
)
from raytracing_in_one_weekend_tpu_torch.scene.scene import (
    EntityKind, MaterialType, Scene,
)
from raytracing_in_one_weekend_tpu_torch.utils.tensors import TensorGroup

SEED_RANGE = 2**31 - 1  # kernel seeds are drawn from [0, SEED_RANGE)


@dataclasses.dataclass(frozen=True)
class PathState(TensorGroup):
    origin: torch.Tensor  # (N, 3)
    direction: torch.Tensor  # (N, 3)
    time: torch.Tensor  # (N,)
    throughput: torch.Tensor  # (N, 3)
    radiance: torch.Tensor  # (N, 3)
    active: torch.Tensor  # (N,) bool: still bouncing
    valid: torch.Tensor  # (N,) bool: terminated at the sky
    inside_volume: torch.Tensor  # (N,) int32 material id or -1
    aov_normal: torch.Tensor  # (N, 3)
    aov_albedo: torch.Tensor  # (N, 3)
    got_nonspecular: torch.Tensor  # (N,) bool
    events: torch.Tensor  # (N,) RandomEvents accumulator
    logp: torch.Tensor  # (N,) log-probability of the path's sampling
    # decisions as a function of the scene parameters (score function)


@dataclasses.dataclass(frozen=True)
class TraceResult(TensorGroup):
    radiance: torch.Tensor  # (N, 3), zero where invalid
    valid: torch.Tensor  # (N,) bool
    logp: torch.Tensor  # (N,) score-function accumulator: consumers that
    # want decision gradients attach the zero-valued surrogate
    # x.detach() * (logp - logp.detach()) once per accumulated product
    aov_normal: torch.Tensor  # (N, 3)
    aov_albedo: torch.Tensor  # (N, 3)
    events: torch.Tensor  # (N,)
    ray_count: torch.Tensor  # () rays cast
    pixel_rays: torch.Tensor  # (N,) int32 rays cast per lane


def check_scope(scene: Scene) -> None:
    missing = megatrace.unported_feature(scene)
    if missing is not None:
        raise NotImplementedError(f"wavefront not ported for {missing}")


def trace(
    scene: Scene,
    rays: Rays,
    key: torch.Tensor,
    trace_depth: int,
    differentiable: bool = True,
    active: torch.Tensor | None = None,
    first_bounce_tsd: torch.Tensor | None = None,  # (N, 3) pre-drawn
    #   tangent-space cosine directions for the first bounce's Lambert draw
    noise_ctx: tuple | None = None,
) -> TraceResult:
    """Trace a wavefront of rays to completion, one path per ray.

    differentiable=False takes the fused kernels, whose hit attributes
    carry no gradients with respect to the scene geometry; keep True under
    autograd.  `active` masks lanes off from the start: they cast no
    counted rays and never become valid."""
    if noise_ctx is not None:
        raise NotImplementedError(
            "flavored-sampler routing (noise_ctx) is not ported yet "
            "(ROADMAP queue 1, step 11)"
        )
    check_scope(scene)
    n = rays.origin.shape[0]
    dev = rays.origin.device
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=dev)
    packed = materials.pack_materials(scene)
    mat = scene.spheres.material.long()

    if (not differentiable and first_bounce_tsd is None
            and megatrace.scene_eligible(scene)):
        seed = int(rng.randint(rng.purpose_key(key, rng.Purpose.SCATTER_A),
                               (), 0, SEED_RANGE))
        out = megatrace.megatrace(
            rays.origin, rays.direction, active, scene.spheres.center,
            scene.spheres.radius, packed[mat][:, :11],
            scene.environment.sky_bottom, scene.environment.sky_top, seed,
            trace_depth=trace_depth,
            has_dielectrics=scene.flags.has_dielectrics,
            sky_on=scene.flags.sky == 1,
        )
        return TraceResult(
            radiance=out["radiance"], valid=out["valid"],
            logp=torch.zeros(n, dtype=torch.float32, device=dev),
            aov_normal=out["aov_normal"], aov_albedo=out["aov_albedo"],
            events=out["events"], ray_count=torch.sum(out["pixel_rays"]),
            pixel_rays=out["pixel_rays"],
        )

    f32 = dict(dtype=torch.float32, device=dev)
    if scene.flags.has_volumes:
        inside0 = intersect.point_inside_volume(scene, rays.origin)
    else:
        inside0 = torch.full((n,), -1, dtype=torch.int32, device=dev)
    state = PathState(
        origin=rays.origin,
        direction=rays.direction,
        time=rays.time,
        throughput=torch.ones((n, 3), **f32),
        radiance=torch.zeros((n, 3), **f32),
        active=active.to(torch.bool),
        valid=torch.zeros(n, dtype=torch.bool, device=dev),
        inside_volume=inside0,
        aov_normal=torch.zeros((n, 3), **f32),
        aov_albedo=torch.zeros((n, 3), **f32),
        got_nonspecular=torch.zeros(n, dtype=torch.bool, device=dev),
        events=torch.zeros(n, **f32),
        logp=torch.zeros(n, **f32),
    )
    # the fast arm's per-sphere records: packed material row + material id
    sph_records = None
    if (not differentiable and scene.spheres.center.shape[0] > 0
            and not scene.flags.has_volumes
            and not scene.flags.has_motion
            and not scene.flags.has_procedural_textures
            and scene.rects.rot.shape[0] == 0
            and scene.boxes.rot.shape[0] == 0
            and scene.triangles.vert0.shape[0] == 0):
        sph_records = torch.cat(
            [packed[mat][:, :11], mat[:, None].to(torch.float32)], dim=1)

    pixel_rays = torch.zeros(n, dtype=torch.int32, device=dev)
    for bounce_index in range(trace_depth):
        if not bool(state.active.any()):
            break  # every path has ended: later bounces change nothing
        pixel_rays = pixel_rays + state.active.to(torch.int32)
        state = _bounce_once(
            scene, state, rng.bounce_key(key, bounce_index), bounce_index,
            packed, sph_records, first_bounce_tsd,
        )

    valid = state.valid
    return TraceResult(
        radiance=torch.where(valid[:, None], state.radiance, 0.0),
        valid=valid,
        logp=state.logp,
        aov_normal=state.aov_normal,
        aov_albedo=state.aov_albedo,
        events=state.events,
        ray_count=torch.sum(pixel_rays),
        pixel_rays=pixel_rays,
    )


def _bounce_once(
    scene: Scene,
    state: PathState,
    key: torch.Tensor,
    bounce_index: int,
    packed: torch.Tensor,
    sph_records: torch.Tensor | None = None,
    first_bounce_tsd: torch.Tensor | None = None,
) -> PathState:
    rays = Rays(state.origin, state.direction, state.time)
    n = state.origin.shape[0]
    row = None  # the winner's material record (fast arm only)
    if sph_records is not None:
        t, t_exit, normal, rec = sphere_select.sphere_select_full(
            rays.origin, rays.direction, scene.spheres.center,
            scene.spheres.radius, sph_records, active=state.active,
        )
        hit_mask = t < intersect.BIG
        hit = intersect.Hit(
            t=t,
            hit=hit_mask,
            point=rays.at(torch.where(hit_mask, t, 0.0)),
            normal=normal,
            uv=torch.zeros((n, 2), dtype=torch.float32, device=t.device),
            material=rec[:, 11].to(torch.int32),
            kind=torch.where(hit_mask, int(EntityKind.SPHERE), -1).to(
                torch.int32),
            index=torch.zeros(n, dtype=torch.int32, device=t.device),
            t_exit=t_exit,
        )
        row = rec[:, :12]
    else:
        hit = intersect.nearest_hit(scene, rays)

    false_n = torch.zeros(n, dtype=torch.bool, device=hit.t.device)
    vol_candidate = skip = false_n
    skip_t = hit.t
    logp = state.logp
    eff_point, eff_normal, eff_material = hit.point, hit.normal, hit.material
    eff_uv = hit.uv
    new_inside = state.inside_volume
    if scene.flags.has_volumes:
        # ---- probabilistic volume walk (SampleBatchJob.cs:212-303) -------
        hit_is_volume = hit.hit & (
            scene.materials.type[hit.material.long()]
            == MaterialType.PROBABILISTIC_VOLUME)
        entering = math3.dot(hit.normal, state.direction) < 0.0
        in_vol = state.inside_volume >= 0
        vol_mat = torch.where(in_vol, state.inside_volume, hit.material)
        density = scene.materials.parameter[torch.clamp(vol_mat, min=0)
                                            .long()]
        u_free = rng.uniform(
            rng.purpose_key(key, rng.Purpose.VOLUME_FREE_PATH), (n,),
            device=hit.t.device)
        # the free-path draw is a sampling decision: its density dependence
        # is detached and carried by the score-function logp below
        free_path = materials.volume_free_path(density.detach(), u_free)
        # inside a volume the whole segment [0, t) is in the medium; at an
        # entry boundary, [t, t_exit) of the hit convex entity
        seg_len = torch.where(in_vol, hit.t, hit.t_exit - hit.t)
        vol_candidate = hit.hit & (in_vol | (hit_is_volume & entering))
        vol_scatter = vol_candidate & (free_path < seg_len)
        vol_t = torch.where(in_vol, free_path, hit.t + free_path)
        pass_through = (hit.hit & ~in_vol & hit_is_volume & entering
                        & ~vol_scatter)
        exits_own = (in_vol & hit.hit & hit_is_volume & ~entering
                     & ~vol_scatter & (hit.material == state.inside_volume))
        skip = pass_through | exits_own
        skip_t = torch.where(pass_through, hit.t_exit, hit.t)
        # score function of the observed decisions as a function of the
        # density: a scatter at d has pdf rho exp(-rho d), surviving a
        # segment L probability exp(-rho L) (observations detached)
        survive = vol_candidate & ~vol_scatter
        rho = torch.clamp(density, min=1e-8)
        logp_inc = (torch.where(vol_scatter,
                                torch.log(rho) - rho * free_path.detach(),
                                0.0)
                    + torch.where(survive, -rho * seg_len.detach(), 0.0))
        logp = logp + torch.where(state.active, logp_inc, 0.0)
        # the in-medium scatter replaces the surface hit
        eff_point = torch.where(
            vol_scatter[:, None],
            state.origin + vol_t[:, None] * state.direction, hit.point)
        eff_normal = torch.where(vol_scatter[:, None], -state.direction,
                                 hit.normal)
        eff_material = torch.where(vol_scatter, vol_mat, hit.material)
        eff_uv = torch.where(vol_scatter[:, None], 0.0, hit.uv)
        # the medium: entered on a scatter, left on a skip, kept on a
        # scatter off a surface inside it
        new_inside = torch.where(
            state.active,
            torch.where(vol_scatter, vol_mat,
                        torch.where(skip, -1, state.inside_volume)),
            state.inside_volume).to(torch.int32)

    scatter_mask = state.active & hit.hit & ~skip
    tsd_on = first_bounce_tsd is not None and bounce_index == 0
    sc = materials.scatter(
        scene, state.direction, eff_normal, eff_point, eff_uv, eff_material,
        key, packed=packed, row=row, lambert_tsd=first_bounce_tsd,
        lambert_tsd_on=tsd_on,
    )
    # material-lottery decisions join the path's score accumulator; zero
    # along deterministic branches
    logp = logp + torch.where(scatter_mask, sc.logp, 0.0)

    # ---- sky termination (SampleBatchJob.cs:341-374) ------------------------
    miss = state.active & ~hit.hit
    sky = environment.sample_sky(scene.environment, state.direction)

    # ---- emission/attenuation running fold ----------------------------------
    emission = torch.where(scatter_mask[:, None], sc.emission,
                           torch.where(miss[:, None], sky, 0.0))
    radiance = state.radiance + state.throughput * emission
    throughput = torch.where(scatter_mask[:, None],
                             state.throughput * sc.reflectance,
                             state.throughput)

    # ---- AOV capture (SampleBatchJob.cs:313-330,366-372) ---------------------
    got = state.got_nonspecular
    aov_normal = torch.where(
        (scatter_mask & (bounce_index == 0) & ~got)[:, None], eff_normal,
        state.aov_normal)
    first_nonspec = scatter_mask & ~got & ~sc.perfect_specular
    aov_normal = torch.where(first_nonspec[:, None], eff_normal, aov_normal)
    aov_albedo = torch.where(first_nonspec[:, None],
                             sc.emission + sc.reflectance, state.aov_albedo)
    sky_first = miss & ~got
    aov_normal = torch.where(sky_first[:, None], -state.direction,
                             aov_normal)
    aov_albedo = torch.where(sky_first[:, None], sky, aov_albedo)
    got_nonspecular = got | first_nonspec | sky_first

    # ---- RandomEvents accumulation (SampleBatchJob.cs:332,363) ---------------
    step_events = (torch.where(scatter_mask, sc.random_events, 0.0)
                   # a probabilistic hit costs one event (:332)
                   + torch.where(state.active & vol_candidate, 1.0, 0.0))
    events = state.events + step_events * 2.0 ** -bounce_index

    # ---- advance -------------------------------------------------------------
    offset_sign = torch.where(math3.dot(sc.direction, eff_normal) >= 0.0,
                              1.0, -1.0)
    new_origin = torch.where(
        scatter_mask[:, None],
        eff_point + SELF_INTERSECTION_OFFSET * offset_sign[:, None]
        * eff_normal,
        torch.where(
            (state.active & skip)[:, None],
            state.origin + (skip_t + SELF_INTERSECTION_OFFSET)[:, None]
            * state.direction,
            state.origin),
    )
    new_direction = torch.where(scatter_mask[:, None], sc.direction,
                                state.direction)
    was = state.active
    return PathState(
        origin=new_origin,
        direction=new_direction,
        time=state.time,
        throughput=torch.where(was[:, None], throughput, state.throughput),
        radiance=torch.where(was[:, None], radiance, state.radiance),
        active=was & ~miss,
        valid=state.valid | miss,
        inside_volume=new_inside,
        aov_normal=torch.where(was[:, None], aov_normal, state.aov_normal),
        aov_albedo=torch.where(was[:, None], aov_albedo, state.aov_albedo),
        got_nonspecular=torch.where(was, got_nonspecular, got),
        events=events,
        logp=logp,
    )
