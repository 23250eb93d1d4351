"""Convex volumes in the port against the JAX package: containment, the
batch kernel's plain version and the wavefront integrator.

* `intersect.point_inside_volume` and `megatrace.camera_containment_row`
  equal JAX's on random points around fog spheres and rotated fog boxes,
  and on cameras inside a fog sphere and inside a rotated fog box.
* The batch kernel's plain version (`megatrace.sample_batch` on CPU
  tensors with `vol0=`) against JAX's kernel in interpret mode with the
  hash PRNG and the tape, on `volume`, `probabilistic`, `cornell_volumes`
  and two camera-inside scenes (tests/test_megakernel.py:233, :255, :290):
  on the lanes whose tape is identical, count and rays equal and the float
  channels within atol=rtol=1e-4.  The tape share: the port takes the free
  path's log correctly rounded (the kernel and its plain version agree
  bit for bit on the card) and XLA's log is not, so an in-medium scatter
  point can differ from JAX's by an ulp.  Only a near-tie notices: the
  free path against the segment, and in `cornell_volumes` the smoke box's
  bottom face, which lies in the floor's plane, so that a ray leaving the
  smoke downwards meets both at one t and a one-ulp shift of its origin
  picks the other (measured at these sizes: every lane of the other
  scenes identical, 0.9878 of cornell_volumes'; bounds 0.999 and 0.97,
  the latter with room for another CPU's vector log).
* `integrator.trace` (both arms) on `volume`, `cornell_volumes` and a
  camera-inside scene against JAX's wavefront: valid and ray counts
  identical and the floats within 1e-3 on >= 99% of lanes (measured:
  every lane but cornell_volumes', 0.9974).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_in_one_weekend_tpu.core import camera as jax_camera
from raytracing_in_one_weekend_tpu.core import materials as jax_materials
from raytracing_in_one_weekend_tpu.models import book_scenes as jax_scenes
from raytracing_in_one_weekend_tpu.models import testbeds as jax_testbeds
from raytracing_in_one_weekend_tpu.ops import intersect as jax_intersect
from raytracing_in_one_weekend_tpu.ops import pallas_megatrace
from raytracing_in_one_weekend_tpu.render import integrator as jax_integrator
from raytracing_in_one_weekend_tpu.scene import scene as jax_scene_mod
from raytracing_in_one_weekend_tpu_torch.core import camera, materials, rng
from raytracing_in_one_weekend_tpu_torch.core.ray import Rays
from raytracing_in_one_weekend_tpu_torch.models import book_scenes, testbeds
from raytracing_in_one_weekend_tpu_torch.ops import intersect, megatrace
from raytracing_in_one_weekend_tpu_torch.ops import megatrace_replay
from raytracing_in_one_weekend_tpu_torch.render import integrator, renderer
from raytracing_in_one_weekend_tpu_torch.scene import scene as scene_mod
from raytracing_in_one_weekend_tpu_torch.utils.config import CameraSettings

TOL = dict(atol=1e-4, rtol=1e-4)
FLOAT_CHANNELS = ("color", "normal", "albedo", "weight", "fallback_normal",
                  "fallback_albedo")
WAVE_KEYS = ("radiance", "valid", "aov_normal", "aov_albedo", "events",
             "pixel_rays")
# the lanes whose tape must equal JAX's (see the module docstring)
TAPE_SHARE = {"cornell_volumes": 0.97}
TAPE_SHARE_DEFAULT = 0.999


def inside_scene(mod):
    """JAX's camera-inside testbed (tests/test_megakernel.py:255-288): a
    fog sphere of density 0.8 around the camera, a red sphere in it."""
    b = mod.SceneBuilder()
    fog = b.volume(0.8, (0.9, 0.9, 0.9))
    b.add_sphere((0.0, 0.0, 0.0), 3.0, fog)
    b.add_sphere((0.0, 0.0, -2.0), 0.5, b.lambert((0.8, 0.2, 0.2)))
    b.set_gradient_sky()
    return b.build()


def box_inside_scene(mod):
    """A camera inside a rotated, emissive fog box (density 1.2), a glass
    sphere in it, a rough metal sphere and a floor rect outside it, a
    gradient sky: every walk branch (entry, exit, pass, a scatter off a
    surface inside the medium) and the box's slab exit, whose geometry
    reaches the image through the metal's reflections."""
    b = mod.SceneBuilder()
    fog = b.volume(1.2, (0.8, 0.85, 0.9), emission=(0.05, 0.04, 0.03))
    b.add_box((0.0, 0.0, 0.2), (0.6, 0.5, 0.9), fog,
              rotation=mod.axis_angle_quat((1, 1, 0), 20.0))
    b.add_sphere((-0.2, 0.05, -0.3), 0.2, b.dielectric(1.5))
    b.add_sphere((0.3, 0.0, -1.6), 0.5,
                 b.metal((0.9, 0.8, 0.6), glossiness=0.8))
    b.add_rect((0.0, -0.6, -1.0), (6.0, 6.0), b.lambert((0.6, 0.6, 0.6)),
               rotation=mod.axis_angle_quat((1, 0, 0), -90.0))
    b.set_gradient_sky()
    return b.build()


INSIDE_CAMERA = CameraSettings(origin=(0.0, 0.0, 0.0),
                               look_at=(0.0, 0.0, -1.0), vertical_fov=60.0,
                               focus_distance=2.0)
SCENES = {"inside": inside_scene, "box_inside": box_inside_scene}


def port_scene(name):
    """(scene, camera settings) of the port."""
    if name in SCENES:
        return SCENES[name](scene_mod), INSIDE_CAMERA
    return (book_scenes.SCENES.get(name) or testbeds.SCENES[name])()


def jax_scene(name):
    if name in SCENES:
        return SCENES[name](jax_scene_mod), INSIDE_CAMERA
    return (jax_scenes.SCENES.get(name) or jax_testbeds.SCENES[name])()


def port_batch(name, size):
    """(scene, the six sphere/camera/sky tables, rect_tables, box_tables,
    vol0) of a size x size batch."""
    scene, cs = port_scene(name)
    cam = camera.make_camera(cs.origin, cs.look_at, cs.up, cs.vertical_fov,
                             1.0, aperture=cs.aperture,
                             focus_distance=cs.focus_distance)
    packed = materials.pack_materials(scene)
    rect, box = megatrace.pack_aux_tables(scene, packed)
    return scene, (
        megatrace.pack_camera_row(cam, size, size), scene.spheres.center,
        scene.spheres.radius, megatrace.pack_sphere_records(scene, packed),
        scene.environment.sky_bottom, scene.environment.sky_top,
    ), rect, box, megatrace.camera_containment_row(scene, packed, cam.origin)


def jax_batch(name, size):
    scene, cs = jax_scene(name)
    cam = jax_camera.make_camera(cs.origin, cs.look_at, cs.up,
                                 cs.vertical_fov, 1.0, aperture=cs.aperture,
                                 focus_distance=cs.focus_distance)
    packed = jax_materials.pack_materials(scene)
    rect, box = pallas_megatrace.pack_aux_tables(scene, packed)
    return scene, (
        pallas_megatrace.pack_camera_row(cam, size, size),
        scene.spheres.center, scene.spheres.radius,
        pallas_megatrace.pack_sphere_records(scene, packed),
        scene.environment.sky_bottom, scene.environment.sky_top,
    ), rect, box, pallas_megatrace.camera_containment_row(scene, packed,
                                                          cam.origin)


@pytest.mark.parametrize("name", ["volume", "probabilistic",
                                  "cornell_volumes", "inside",
                                  "box_inside"])
def test_containment_matches_jax(name):
    """Random points around the scene (the camera-inside scenes: around
    the camera), and the camera's row."""
    scene, cs = port_scene(name)
    js, _ = jax_scene(name)
    r = np.random.default_rng(3)
    centre, half = ((cs.origin, 0.8) if name in SCENES
                    else (cs.look_at, 1.5))
    pts = (r.uniform(-half, half, size=(2000, 3))
           + np.asarray(centre)).astype(np.float32)
    got = intersect.point_inside_volume(scene, torch.from_numpy(pts))
    want = jax_intersect.point_inside_volume(js, jnp.asarray(pts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() >= 0).mean() > 0.01  # some points are inside
    *_, vol0 = port_batch(name, 4)
    *_, jvol0 = jax_batch(name, 4)
    np.testing.assert_array_equal(vol0.numpy(), np.asarray(jvol0))
    assert (vol0[0] >= 0) == (name in SCENES)
    if name == "inside":
        assert float(vol0[0]) == 0.0 and float(vol0[1]) == pytest.approx(0.8)
    if name == "box_inside":
        assert float(vol0[1]) == pytest.approx(1.2)
        assert float(vol0[5]) == pytest.approx(0.05)


def run_both(name, size, seed, spp, depth=8):
    """(port outputs, JAX outputs) as numpy dicts, on the same inputs."""
    n = size * size
    lane_count = np.full(n, spp, np.int32)
    js, jtables, jrect, jbox, jvol0 = jax_batch(name, size)
    sky_on = js.flags.sky == 1
    want = pallas_megatrace.sample_batch(
        jnp.asarray(lane_count), jnp.zeros(n), *jtables, jnp.int32(seed),
        rect_tables=jrect, box_tables=jbox, vol0=jvol0, samples=spp,
        trace_depth=depth, has_dielectrics=js.flags.has_dielectrics,
        sky_on=sky_on, interpret=True, hw_prng=False, want_tape=True,
    )
    ts, ttables, rect, box, vol0 = port_batch(name, size)
    got = megatrace.sample_batch(
        torch.from_numpy(lane_count), torch.zeros(n), *ttables, seed,
        rect_tables=rect, box_tables=box, vol0=vol0, samples=spp,
        trace_depth=depth, has_dielectrics=ts.flags.has_dielectrics,
        sky_on=sky_on, want_tape=True,
    )
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    assert got["tape"].shape == want["tape"].shape == (spp * depth, n)
    return got, want


def assert_lanes_agree(got, want, tape_share):
    same = (got["tape"] == want["tape"]).all(axis=0)
    assert same.mean() >= tape_share, same.mean()
    for k in ("count", "rays"):
        np.testing.assert_array_equal(got[k][same], want[k][same])
    for k in FLOAT_CHANNELS:
        close = np.isclose(got[k], want[k], **TOL)
        close = close.all(axis=-1) if close.ndim == 2 else close
        assert close[same].all(), (k, close[same].mean())
    return same


@pytest.mark.parametrize("name,size,seed,spp,depth", [
    ("volume", 24, 1, 4, 8), ("probabilistic", 24, 2, 3, 8),
    ("cornell_volumes", 24, 3, 3, 8), ("inside", 16, 4, 4, 8),
    ("box_inside", 20, 5, 3, 6),
])
def test_plain_version_matches_jax_kernel(name, size, seed, spp, depth):
    got, want = run_both(name, size, seed, spp, depth)
    assert_lanes_agree(got, want, TAPE_SHARE.get(name, TAPE_SHARE_DEFAULT))
    assert float(got["color"].mean()) > 0.0
    # the walk changed the paths: volume winners (their codes) appear,
    # and some lanes took more iterations than bounces (skips)
    assert (got["tape"] >= 0).mean() > 0.05


def test_walk_and_skips_are_on_the_tape():
    """A fog sphere of density 1e-4 is passed through by every ray that
    enters it: each pass takes an iteration of its own with the sphere's
    code on the tape, and costs a ray; the ray goes on unscattered (the
    centre ray to the sky behind the fog)."""
    b = scene_mod.SceneBuilder()
    thin = b.volume(1e-4, (0.9, 0.9, 0.9))
    b.add_sphere((0.0, -100.5, -1.0), 100.0, b.lambert((0.5, 0.5, 0.5)))
    b.add_sphere((0.0, 0.0, -1.0), 0.5, thin)
    b.set_gradient_sky()
    scene = b.build()
    cs = CameraSettings(origin=(0.0, 0.0, 1.0), look_at=(0.0, 0.0, -1.0),
                        vertical_fov=30.0)
    cam = camera.make_camera(cs.origin, cs.look_at, cs.up, cs.vertical_fov,
                             1.0, focus_distance=cs.focus_distance)
    packed = materials.pack_materials(scene)
    n = 16 * 16
    vol0 = megatrace.camera_containment_row(scene, packed, cam.origin)
    out = megatrace.sample_batch(
        torch.ones(n, dtype=torch.int32), torch.zeros(n),
        megatrace.pack_camera_row(cam, 16, 16), scene.spheres.center,
        scene.spheres.radius, megatrace.pack_sphere_records(scene, packed),
        scene.environment.sky_bottom, scene.environment.sky_top, 3,
        vol0=vol0, samples=1, trace_depth=6, want_tape=True,
        has_dielectrics=False)
    tape = out["tape"]
    # the centre lane enters the fog (code 1) and passes it in one
    # iteration, then meets the sky (-1): two rays, one valid sample
    centre = 8 * 16 + 8
    assert tape[:2, centre].tolist() == [1.0, -1.0]
    assert int(out["rays"][centre]) == 2 and float(out["count"][centre]) == 1
    assert int(out["rays"].sum()) == int((tape > -1.5).sum())


@pytest.mark.parametrize("name", ["volume", "cornell_volumes", "inside"])
@pytest.mark.parametrize("differentiable", [True, False])
def test_trace_matches_jax(name, differentiable):
    w, h, depth, seed = 32, 24, 8, 7
    n = w * h
    js, cs = jax_scene(name)
    cam = jax_camera.make_camera(cs.origin, cs.look_at, cs.up,
                                 cs.vertical_fov, w / h,
                                 aperture=cs.aperture,
                                 focus_distance=cs.focus_distance)
    key = jax.random.PRNGKey(seed)
    rays = jax_camera.generate_rays(
        cam, jax_camera.pixel_coords(w, h, key, True), key)
    active = np.arange(n) % 5 != 2
    want = jax_integrator.trace(js, rays, key, depth,
                                differentiable=differentiable,
                                active=jnp.asarray(active))
    want = {k: np.asarray(getattr(want, k)) for k in WAVE_KEYS}
    scene, _ = port_scene(name)
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


def test_scope():
    for name in ("volume", "probabilistic", "cornell_volumes"):
        scene, _ = port_scene(name)
        assert megatrace.scene_eligible(scene, allow_triangles=True,
                                        allow_rect_box=True,
                                        allow_volumes=True)
        assert megatrace_replay.replay_eligible(scene)
        # the per-ray megatrace has no volume walk, as the JAX package's
        assert not megatrace.scene_eligible(scene, allow_rect_box=True)
        renderer.check_scope(scene)
    assert "volume walk" in megatrace.unsupported_feature(
        port_scene("volume")[0])
    # volumes beside triangles are ported (ROADMAP step 7.2b): the volume
    # builds of the triangle build; the plain version renders them here
    b = scene_mod.SceneBuilder()
    white = b.lambert((0.7, 0.7, 0.7))
    b.add_sphere((0.0, -100.5, 0.0), 100.0, white)
    b.add_sphere((0.0, 0.0, -1.0), 0.5, b.volume(1.0, (0.9, 0.9, 0.9)))
    b.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), white)
    mesh_fog = b.build()
    assert megatrace.scene_eligible(mesh_fog, allow_triangles=True,
                                    allow_rect_box=True, allow_volumes=True)
    renderer.check_scope(mesh_fog)
    packed = materials.pack_materials(mesh_fog)
    cam = camera.make_camera((0.0, 0.0, 1.0), (0.0, 0.0, -1.0), (0, 1, 0),
                             60.0, 1.0)
    out = megatrace.sample_batch(
        torch.ones(4, dtype=torch.int32), torch.zeros(4),
        megatrace.pack_camera_row(cam, 2, 2), mesh_fog.spheres.center,
        mesh_fog.spheres.radius,
        megatrace.pack_sphere_records(mesh_fog, packed),
        torch.zeros(3), torch.zeros(3), 1, samples=1, trace_depth=1,
        vol0=megatrace.camera_containment_row(mesh_fog, packed,
                                              cam.origin),
        tri_tables=megatrace.pack_tri_tables(mesh_fog, packed))
    assert int(out["rays"].sum()) == 4
    assert bool(torch.isfinite(out["color"]).all())


def test_render_batch_takes_the_batch_kernel(monkeypatch):
    """render_batch sends a volume scene to the batch kernel's path (with
    vol0), not to the wavefront."""
    def refuse(*args, **kwargs):
        raise AssertionError("the wavefront arm ran")

    monkeypatch.setattr(renderer, "wavefront_pass", refuse)
    seen = []
    real = megatrace.sample_batch

    def spy(*args, **kwargs):
        seen.append(kwargs.get("vol0"))
        return real(*args, **kwargs)

    monkeypatch.setattr(megatrace, "sample_batch", spy)
    for name in ("volume", "cornell_volumes"):
        scene, cs = port_scene(name)
        cam = camera.make_camera(cs.origin, cs.look_at, cs.up,
                                 cs.vertical_fov, 1.0,
                                 focus_distance=cs.focus_distance)
        img = renderer.render_image(scene, cam, width=12, height=12,
                                    samples_per_pixel=2, trace_depth=6,
                                    seed=1, differentiable=False)
        assert bool(torch.isfinite(img.color).all())
        assert seen[-1] is not None and seen[-1].shape == (8,)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["volume", "probabilistic",
                                  "cornell_volumes", "inside",
                                  "box_inside"])
def test_cuda_volume_builds_match_plain_version(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    scene, tables, rect, box, vol0 = port_batch(name, 64)
    tables = [t.to(dev) for t in tables]
    rect, box = ((None if p is None else tuple(t.to(dev) for t in p))
                 for p in (rect, box))
    n = 64 * 64
    lane_count = torch.full((n,), 4, dtype=torch.int32, device=dev)
    kw = dict(samples=4, trace_depth=8, want_tape=True, rect_tables=rect,
              box_tables=box, vol0=vol0.to(dev),
              sky_on=scene.flags.sky == 1,
              has_dielectrics=scene.flags.has_dielectrics)
    before = (megatrace.LAUNCHES, megatrace.VOL_LAUNCHES)
    got = megatrace.sample_batch(lane_count, torch.zeros(n, device=dev),
                                 *tables, 21, **kw)
    assert (megatrace.LAUNCHES, megatrace.VOL_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    want = megatrace.sample_batch_reference(
        lane_count, torch.zeros(n, device=dev), *tables, 21, **kw)
    got = {k: v.cpu().numpy() for k, v in got.items()}
    want = {k: v.cpu().numpy() for k, v in want.items()}
    assert_lanes_agree(got, want, 0.99)
