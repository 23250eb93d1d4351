"""Unit-shutter motion in the port against the JAX package: the batch
kernel's plain version and the wavefront integrator, and the scope.

* The batch kernel's plain version (`megatrace.sample_batch` on CPU
  tensors with `move_offsets=`) against JAX's kernel in interpret mode
  with the hash PRNG and the tape, on `cover_motion` (the cover's 485
  spheres, its small diffuse ones moving up over the shutter) at 32x32
  and on a scene of moving spheres of every material with a fog sphere and
  a box: the winner tapes identical on >= 0.999 of lanes, count and rays
  equal on those lanes and the float channels within atol=rtol=1e-4.
  `cover_motion` keeps the static cover's measured exception
  (tests/test_torch_megatrace.py: XLA's CPU rsqrt is not correctly
  rounded, and the cover's quadratic cancels ~12 bits, so a hit normal
  differs from JAX's by ~1e-4): its tapes are held to the cover's 0.99,
  its normal channels to a share of 0.95 within 1e-4 and every
  tape-identical lane within 1e-2, its other channels to 0.99.  Measured
  at 32x32, 4 spp, depth 8, seeds 1 and 2: tapes identical on 0.9951 and
  0.9971 of cover_motion's lanes against 0.9990 and 1.0 of the static
  cover's, normals within 1e-4 on 0.9617 and 0.9579 of them against
  0.9638 and 0.9590 (largest error 5.8e-3 against 2.9e-3); at 20x20,
  seeds 1-3, every differing lane first differs at iteration 7 or later
  (a bounce after the normal gap), never at a camera ray's hit.
  Motion computes |c(t)|^2 per ray in the JAX kernel's operation order
  (:379-390), so the moving spheres add no gap of their own.
* Each path draws its shutter time at its regen from the camera draws'
  stream 7, and a moving sphere is hit at its centre at that time.
* `integrator.trace` (the general arm, both modes) on `cover_motion`
  against JAX's wavefront with its ray times: valid and ray counts
  identical and the floats within 1e-3 on >= 99% of lanes.
* Scope: cover_motion takes the batch kernel (its motion build) and the
  replay, not the per-ray megatrace nor the fast arm; a motion range other
  than the unit shutter takes the wavefront; motion beside triangles is
  refused naming ROADMAP step 7.3b.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_in_one_weekend_tpu.core import camera as jax_camera
from raytracing_in_one_weekend_tpu.core import materials as jax_materials
from raytracing_in_one_weekend_tpu.models import book_scenes as jax_scenes
from raytracing_in_one_weekend_tpu.ops import pallas_megatrace
from raytracing_in_one_weekend_tpu.render import integrator as jax_integrator
from raytracing_in_one_weekend_tpu.scene import scene as jax_scene_mod
from raytracing_in_one_weekend_tpu_torch.core import camera, materials, rng
from raytracing_in_one_weekend_tpu_torch.core.ray import Rays
from raytracing_in_one_weekend_tpu_torch.models import book_scenes
from raytracing_in_one_weekend_tpu_torch.ops import megatrace
from raytracing_in_one_weekend_tpu_torch.ops import megatrace_replay
from raytracing_in_one_weekend_tpu_torch.render import integrator, renderer
from raytracing_in_one_weekend_tpu_torch.scene import scene as scene_mod
from raytracing_in_one_weekend_tpu_torch.utils.config import CameraSettings

TOL = dict(atol=1e-4, rtol=1e-4)
FLOAT_CHANNELS = ("color", "normal", "albedo", "weight", "fallback_normal",
                  "fallback_albedo")
WAVE_KEYS = ("radiance", "valid", "aov_normal", "aov_albedo", "events",
             "pixel_rays")
TAPE_SHARE = {"cover_motion": 0.99}  # the cover's (see the docstring)
TAPE_SHARE_DEFAULT = 0.999
COVER_NORMAL_SHARE = 0.95  # tests/test_torch_megatrace.py
COVER_NORMAL_MAX_ERR = 1e-2


def moving_scene(mod):
    """Moving spheres of every material (a dielectric, a rough metal, a
    Lambert) over a static ground, a moving fog sphere and a static box,
    a gradient sky: the motion build beside volumes and boxes."""
    b = mod.SceneBuilder()
    b.add_sphere((0.0, -100.5, -1.0), 100.0, b.lambert((0.5, 0.6, 0.5)))
    b.add_sphere((-1.0, 0.0, -1.2), 0.5, b.dielectric(1.5),
                 move_offset=(0.0, 0.4, 0.0))
    b.add_sphere((0.0, 0.0, -1.5), 0.5,
                 b.metal((0.8, 0.7, 0.5), glossiness=0.8),
                 move_offset=(0.3, 0.0, 0.2))
    b.add_sphere((1.0, -0.1, -1.0), 0.4, b.lambert((0.8, 0.2, 0.2)),
                 move_offset=(0.0, 0.3, -0.2))
    b.add_sphere((0.5, 0.3, -0.4), 0.25, b.volume(2.0, (0.9, 0.9, 0.9)),
                 move_offset=(-0.2, 0.0, 0.0))
    b.add_box((-0.3, -0.3, -0.6), (0.3, 0.3, 0.3),
              b.lambert((0.2, 0.3, 0.8)),
              rotation=mod.axis_angle_quat((0, 1, 0), 30.0))
    b.set_gradient_sky()
    return b.build(), CameraSettings(origin=(0.0, 0.3, 1.5),
                                     look_at=(0.0, 0.0, -1.0),
                                     vertical_fov=50.0, focus_distance=2.5)


def port_scene(name):
    if name == "moving":
        return moving_scene(scene_mod)
    return book_scenes.SCENES[name]()


def jax_scene(name):
    if name == "moving":
        return moving_scene(jax_scene_mod)
    return jax_scenes.SCENES[name]()


def port_batch(name, size):
    """(scene, the six sphere/camera/sky tables, the keyword tables:
    rect_tables, box_tables, vol0 where the scene has volumes,
    move_offsets)."""
    scene, cs = port_scene(name)
    cam = camera.make_camera(cs.origin, cs.look_at, cs.up, cs.vertical_fov,
                             1.0, aperture=cs.aperture,
                             focus_distance=cs.focus_distance)
    packed = materials.pack_materials(scene)
    rect, box = megatrace.pack_aux_tables(scene, packed)
    vol0 = (megatrace.camera_containment_row(scene, packed, cam.origin)
            if scene.flags.has_volumes else None)
    return scene, (
        megatrace.pack_camera_row(cam, size, size), scene.spheres.center,
        scene.spheres.radius, megatrace.pack_sphere_records(scene, packed),
        scene.environment.sky_bottom, scene.environment.sky_top,
    ), dict(rect_tables=rect, box_tables=box, vol0=vol0,
            move_offsets=scene.spheres.move_offset)


def jax_batch(name, size):
    scene, cs = jax_scene(name)
    cam = jax_camera.make_camera(cs.origin, cs.look_at, cs.up,
                                 cs.vertical_fov, 1.0, aperture=cs.aperture,
                                 focus_distance=cs.focus_distance)
    packed = jax_materials.pack_materials(scene)
    rect, box = pallas_megatrace.pack_aux_tables(scene, packed)
    vol0 = (pallas_megatrace.camera_containment_row(scene, packed,
                                                    cam.origin)
            if scene.flags.has_volumes else None)
    return scene, (
        pallas_megatrace.pack_camera_row(cam, size, size),
        scene.spheres.center, scene.spheres.radius,
        pallas_megatrace.pack_sphere_records(scene, packed),
        scene.environment.sky_bottom, scene.environment.sky_top,
    ), dict(rect_tables=rect, box_tables=box, vol0=vol0,
            move_offsets=scene.spheres.move_offset)


def run_both(name, size, seed, spp, depth=8):
    """(port outputs, JAX outputs) as numpy dicts, on the same inputs."""
    n = size * size
    lane_count = np.full(n, spp, np.int32)
    js, jtables, jkw = jax_batch(name, size)
    want = pallas_megatrace.sample_batch(
        jnp.asarray(lane_count), jnp.zeros(n), *jtables, jnp.int32(seed),
        samples=spp, trace_depth=depth,
        has_dielectrics=js.flags.has_dielectrics, sky_on=True,
        interpret=True, hw_prng=False, want_tape=True, **jkw)
    ts, ttables, kw = port_batch(name, size)
    got = megatrace.sample_batch(
        torch.from_numpy(lane_count), torch.zeros(n), *ttables, seed,
        samples=spp, trace_depth=depth,
        has_dielectrics=ts.flags.has_dielectrics, sky_on=True,
        want_tape=True, **kw)
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    assert got["tape"].shape == want["tape"].shape == (spp * depth, n)
    return got, want


@pytest.mark.parametrize("name,size,seed,spp", [
    ("cover_motion", 32, 1, 4), ("cover_motion", 32, 2, 4),
    ("moving", 20, 3, 4),
])
def test_plain_version_matches_jax_kernel(name, size, seed, spp):
    got, want = run_both(name, size, seed, spp)
    same = np.all(got["tape"] == want["tape"], axis=0)
    share = TAPE_SHARE.get(name, TAPE_SHARE_DEFAULT)
    assert same.mean() >= share, same.mean()
    np.testing.assert_array_equal(got["count"][same], want["count"][same])
    np.testing.assert_array_equal(got["rays"][same], want["rays"][same])
    for k in FLOAT_CHANNELS:
        close = np.isclose(got[k], want[k], **TOL)
        close = close.all(axis=-1) if close.ndim == 2 else close
        if name == "cover_motion" and k.endswith("normal"):
            assert close[same].mean() >= COVER_NORMAL_SHARE, \
                (k, close[same].mean())
            err = np.abs(got[k] - want[k])[same].max()
            assert err < COVER_NORMAL_MAX_ERR, (k, err)
        else:
            assert close[same].mean() >= share, (k, close[same].mean())
    # moving spheres are hit (their rows are on the tape)
    moving = np.flatnonzero(np.abs(np.asarray(
        port_scene(name)[0].spheres.move_offset)).sum(1) > 0)
    assert np.isin(got["tape"], moving).mean() > 0.002


def test_shutter_time_and_moved_centre():
    """One sphere moving from x = -1 to x = +1 over the shutter, seen
    from the front with one sample a lane: each lane draws its time from
    the camera draws' stream 7 at its regen, and a lane hits the sphere
    exactly when its ray meets the sphere at that time (checked on the
    plain version's tape against the time each lane drew)."""
    b = scene_mod.SceneBuilder()
    b.add_sphere((-1.0, 0.0, -3.0), 0.3, b.lambert((0.7, 0.7, 0.7)),
                 move_offset=(2.0, 0.0, 0.0))
    b.set_no_sky()
    scene = b.build()
    cam = camera.make_camera((0.0, 0.0, 0.0), (0.0, 0.0, -3.0), (0, 1, 0),
                             60.0, 1.0)
    size, seed = 24, 5
    n = size * size
    packed = materials.pack_materials(scene)
    row = megatrace.pack_camera_row(cam, size, size)
    out = megatrace.sample_batch(
        torch.ones(n, dtype=torch.int32), torch.zeros(n), row,
        scene.spheres.center, scene.spheres.radius,
        megatrace.pack_sphere_records(scene, packed),
        scene.environment.sky_bottom, scene.environment.sky_top, seed,
        samples=1, trace_depth=1, want_tape=True, sky_on=False,
        move_offsets=scene.spheres.move_offset)
    lanes = torch.arange(n)
    u = megatrace.uniforms_hash(seed, 0, lanes, 8)
    # the camera ray of each lane (iteration 0, no lens)
    px, py = (lanes % size).float(), (lanes // size).float()
    d = (row[3:6][:, None] + ((px + u[0]) / size) * row[6:9][:, None]
         + ((py + u[1]) / size) * row[9:12][:, None])
    d = d / d.norm(dim=0)
    c = torch.stack([-1.0 + 2.0 * u[7], torch.zeros(n),
                     torch.full((n,), -3.0)])
    # distance of the sphere's centre at the lane's time to the ray
    along = (d * c).sum(0)
    miss_dist = (c - along * d).norm(dim=0)
    hit = out["tape"][0] == 0
    clear = (miss_dist - 0.3).abs() > 1e-3
    assert torch.equal(hit[clear], (miss_dist < 0.3)[clear])
    assert 0.01 < float(hit.float().mean()) < 0.5
    # a static sphere at the shutter's start would be hit elsewhere
    static = megatrace.sample_batch(
        torch.ones(n, dtype=torch.int32), torch.zeros(n), row,
        scene.spheres.center, scene.spheres.radius,
        megatrace.pack_sphere_records(scene, packed),
        scene.environment.sky_bottom, scene.environment.sky_top, seed,
        samples=1, trace_depth=1, want_tape=True, sky_on=False)
    assert not torch.equal(static["tape"], out["tape"])


@pytest.mark.parametrize("differentiable", [True, False])
def test_trace_matches_jax(differentiable):
    w, h, depth, seed = 24, 16, 8, 7
    n = w * h
    js, cs = jax_scene("cover_motion")
    cam = jax_camera.make_camera(cs.origin, cs.look_at, cs.up,
                                 cs.vertical_fov, w / h,
                                 aperture=cs.aperture,
                                 focus_distance=cs.focus_distance)
    key = jax.random.PRNGKey(seed)
    rays = jax_camera.generate_rays(
        cam, jax_camera.pixel_coords(w, h, key, True), key)
    assert float(jnp.std(rays.time)) > 0.1  # the shutter times vary
    active = np.arange(n) % 5 != 2
    want = jax_integrator.trace(js, rays, key, depth,
                                differentiable=differentiable,
                                active=jnp.asarray(active))
    want = {k: np.asarray(getattr(want, k)) for k in WAVE_KEYS}
    scene, _ = port_scene("cover_motion")
    got = integrator.trace(
        scene, Rays(*(torch.tensor(np.asarray(v)) for v in
                      (rays.origin, rays.direction, rays.time))),
        rng.PRNGKey(seed), depth, differentiable=differentiable,
        active=torch.tensor(active))
    got = {k: getattr(got, k).numpy() for k in WAVE_KEYS}
    ok = (got["valid"] == want["valid"]) & (
        got["pixel_rays"] == want["pixel_rays"])
    for k in ("radiance", "aov_albedo", "events", "aov_normal"):
        close = np.isclose(got[k], want[k], atol=1e-3, rtol=1e-3)
        ok &= close.all(axis=-1) if close.ndim == 2 else close
    assert ok.mean() >= 0.99, ok.mean()
    assert float(got["radiance"].mean()) > 0.0


def test_camera_rays_carry_jax_times():
    """The port's camera draws the same shutter times as JAX's."""
    w, h, seed = 16, 8, 3
    _, cs = port_scene("cover_motion")
    pcam = camera.make_camera(cs.origin, cs.look_at, cs.up, cs.vertical_fov,
                              w / h, aperture=cs.aperture,
                              focus_distance=cs.focus_distance)
    jcam = jax_camera.make_camera(cs.origin, cs.look_at, cs.up,
                                  cs.vertical_fov, w / h,
                                  aperture=cs.aperture,
                                  focus_distance=cs.focus_distance)
    key = jax.random.PRNGKey(seed)
    want = jax_camera.generate_rays(
        jcam, jax_camera.pixel_coords(w, h, key, True), key)
    pkey = rng.PRNGKey(seed)
    got = camera.generate_rays(
        pcam, camera.pixel_coords(w, h, pkey, True), pkey)
    np.testing.assert_array_equal(got.time.numpy(), np.asarray(want.time))


def test_scope():
    scene, _ = port_scene("cover_motion")
    assert megatrace.scene_eligible(scene, allow_triangles=True,
                                    allow_rect_box=True, allow_volumes=True,
                                    allow_motion=True)
    assert megatrace_replay.replay_eligible(scene)
    # the per-ray megatrace is static, as the JAX package's
    assert not megatrace.scene_eligible(scene)
    assert "static" in megatrace.unsupported_feature(scene)
    renderer.check_scope(scene)
    # a shutter range other than the unit one: the wavefront only
    b = scene_mod.SceneBuilder()
    b.add_sphere((0.0, 0.0, -1.0), 0.5, b.lambert((0.5, 0.5, 0.5)),
                 move_offset=(0.0, 0.2, 0.0), time_range=(0.2, 0.8))
    odd = b.build()
    assert not odd.flags.motion_unit_time
    assert not megatrace.scene_eligible(odd, allow_rect_box=True,
                                        allow_motion=True)
    renderer.check_scope(odd)
    # motion beside triangles: ROADMAP step 7.3b
    b = scene_mod.SceneBuilder()
    white = b.lambert((0.7, 0.7, 0.7))
    b.add_sphere((0.0, 0.0, -1.0), 0.5, white, move_offset=(0.0, 0.3, 0.0))
    b.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), white)
    mesh = b.build()
    with pytest.raises(NotImplementedError, match="step 7.3b"):
        renderer.check_scope(mesh)
    packed = materials.pack_materials(mesh)
    with pytest.raises(NotImplementedError, match="step 7.3b"):
        megatrace.sample_batch(
            torch.ones(4, dtype=torch.int32), torch.zeros(4),
            torch.zeros(24), mesh.spheres.center, mesh.spheres.radius,
            megatrace.pack_sphere_records(mesh, packed), torch.zeros(3),
            torch.zeros(3), 1, samples=1, trace_depth=1,
            move_offsets=mesh.spheres.move_offset,
            tri_tables=megatrace.pack_tri_tables(mesh, packed))


def test_render_batch_takes_the_motion_build(monkeypatch):
    """render_batch sends cover_motion to the batch kernel with the move
    offsets, and a shutter range other than the unit one to the
    wavefront."""
    seen = []
    real = megatrace.sample_batch

    def spy(*args, **kwargs):
        seen.append(kwargs.get("move_offsets"))
        return real(*args, **kwargs)

    monkeypatch.setattr(megatrace, "sample_batch", spy)
    scene, cs = port_scene("cover_motion")
    cam = camera.make_camera(cs.origin, cs.look_at, cs.up, cs.vertical_fov,
                             1.0, aperture=cs.aperture,
                             focus_distance=cs.focus_distance)
    img = renderer.render_image(scene, cam, width=10, height=10,
                                samples_per_pixel=2, trace_depth=6, seed=1,
                                differentiable=False)
    assert bool(torch.isfinite(img.color).all())
    assert seen and seen[-1] is scene.spheres.move_offset


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cover_motion", "moving"])
def test_cuda_motion_builds_match_plain_version(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    scene, tables, kw = port_batch(name, 64)
    tables = [t.to(dev) for t in tables]
    kw = {k: (None if v is None else tuple(t.to(dev) for t in v)
              if isinstance(v, tuple) else v.to(dev)) for k, v in kw.items()}
    n = 64 * 64
    lane_count = torch.full((n,), 4, dtype=torch.int32, device=dev)
    before = (megatrace.LAUNCHES, megatrace.MOTION_LAUNCHES)
    got = megatrace.sample_batch(lane_count, torch.zeros(n, device=dev),
                                 *tables, 21, samples=4, trace_depth=8,
                                 want_tape=True,
                                 has_dielectrics=scene.flags.has_dielectrics,
                                 **kw)
    assert (megatrace.LAUNCHES, megatrace.MOTION_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    want = megatrace.sample_batch_reference(
        lane_count, torch.zeros(n, device=dev), *tables, 21, samples=4,
        trace_depth=8, want_tape=True,
        has_dielectrics=scene.flags.has_dielectrics, **kw)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
