"""Rects and boxes in the port against the JAX package: the packer, the
wavefront's tests, the batch kernel's plain version and the wavefront
integrator.

* `megatrace.pack_aux_tables` equals JAX's `pack_aux_tables` (measured:
  every entry identical on the three scenes).
* `geometry.rect_hit_all` / `box_hit_all` and their `_single` forms equal
  JAX's on random rays against random oriented rects and boxes, within a
  few float32 roundings (rtol 1e-5; measured <= 2.2e-6 relative, from
  the normalization of random quaternions and the rotations' products).
* The batch kernel's plain version (`megatrace.sample_batch` on CPU
  tensors, `rect_tables=`, `box_tables=`) against JAX's kernel in
  interpret mode with the hash PRNG and the tape, on `cornell` (6 rects, 2
  boxes, no sphere, no sky), `simple_light` (3 spheres and an emissive
  rect, no sky) and JAX's mixed sphere + rect + box scene
  (tests/test_replay.py:174-199): the tape identical on >= 99.9% of
  lanes, and on those lanes count and rays equal and the float channels
  within atol=rtol=1e-4 (measured: every lane identical, float error 0,
  but simple_light's normals, 9.3e-5 from its r = 1000 ground sphere).
* `integrator.trace` on `cornell`, both arms, against JAX's wavefront:
  valid and ray counts identical and the floats within 1e-3 on >= 99% of
  lanes (measured: every lane).
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
from raytracing_in_one_weekend_tpu.ops import geometry as jax_geometry
from raytracing_in_one_weekend_tpu.ops import pallas_megatrace
from raytracing_in_one_weekend_tpu.render import integrator as jax_integrator
from raytracing_in_one_weekend_tpu.scene import scene as jax_scene_mod
from raytracing_in_one_weekend_tpu_torch.core import camera, materials, rng
from raytracing_in_one_weekend_tpu_torch.core.ray import Rays
from raytracing_in_one_weekend_tpu_torch.models import book_scenes, testbeds
from raytracing_in_one_weekend_tpu_torch.ops import geometry, megatrace
from raytracing_in_one_weekend_tpu_torch.ops import megatrace_replay
from raytracing_in_one_weekend_tpu_torch.render import integrator, renderer
from raytracing_in_one_weekend_tpu_torch.scene import scene as scene_mod
from raytracing_in_one_weekend_tpu_torch.utils.config import CameraSettings

TOL = dict(atol=1e-4, rtol=1e-4)
TAPE_SHARE = 0.999
FLOAT_CHANNELS = ("color", "normal", "albedo", "weight", "fallback_normal",
                  "fallback_albedo")
WAVE_KEYS = ("radiance", "valid", "aov_normal", "aov_albedo", "events",
             "pixel_rays")
MIXED_CAMERA = CameraSettings(origin=(0.0, 0.0, 1.0),
                              look_at=(0.0, 0.0, -1.0), vertical_fov=60.0)


def mixed_scene(mod):
    """JAX's sphere + rect + box testbed (tests/test_replay.py:174-187),
    built with `mod`'s SceneBuilder (either package's scene module)."""
    b = mod.SceneBuilder()
    blue = b.lambert((0.2, 0.3, 0.7))
    white = b.lambert((0.73, 0.73, 0.73))
    gold = b.metal((0.9, 0.8, 0.6), glossiness=0.9)
    b.add_sphere((0.0, 0.0, -1.0), 0.5, blue)
    b.add_rect((0.0, -0.5, -1.0), (4.0, 4.0), white,
               rotation=mod.axis_angle_quat((1, 0, 0), -90.0))  # floor
    b.add_box((1.1, -0.25, -1.2), (0.5, 0.5, 0.5), gold,
              rotation=mod.axis_angle_quat((0, 1, 0), 30.0))
    return b.build()


def glossy_scene(mod):
    """The mixed scene with a glass box (rays inside a box: the winding's
    other branch), a rough metal back wall and a tilted emissive panel:
    every rect and box winner's geometry reaches the image."""
    b = mod.SceneBuilder()
    blue = b.lambert((0.2, 0.3, 0.7))
    white = b.lambert((0.73, 0.73, 0.73))
    gold = b.metal((0.9, 0.8, 0.6), glossiness=0.9)
    steel = b.metal((0.8, 0.8, 0.85), glossiness=0.7)
    glass = b.dielectric(1.5)
    lamp = b.emissive((3.0, 2.5, 2.0))
    b.add_sphere((0.0, 0.0, -1.0), 0.5, blue)
    b.add_rect((0.0, -0.5, -1.0), (4.0, 4.0), white,
               rotation=mod.axis_angle_quat((1, 0, 0), -90.0))
    b.add_rect((0.0, 0.5, -2.2), (3.0, 2.0), steel,
               rotation=mod.axis_angle_quat((1, 0, 0), 10.0))
    b.add_rect((-1.2, 0.6, -1.0), (0.8, 0.8), lamp,
               rotation=mod.axis_angle_quat((0, 1, 0), 70.0))
    b.add_box((1.1, -0.25, -1.2), (0.5, 0.5, 0.5), gold,
              rotation=mod.axis_angle_quat((0, 1, 0), 30.0))
    b.add_box((-0.6, -0.3, -0.6), (0.4, 0.4, 0.4), glass,
              rotation=mod.axis_angle_quat((1, 1, 0), 25.0))
    return b.build()


SCENES = {"mixed": mixed_scene, "glossy": glossy_scene}


def port_scene(name):
    """(scene, camera settings) of the port."""
    if name in SCENES:
        return SCENES[name](scene_mod), MIXED_CAMERA
    return (book_scenes.SCENES.get(name) or testbeds.SCENES[name])()


def jax_scene(name):
    if name in SCENES:
        return SCENES[name](jax_scene_mod), MIXED_CAMERA
    return (jax_scenes.SCENES.get(name) or jax_testbeds.SCENES[name])()


def port_batch(name, size):
    """(scene, the six sphere/camera/sky tables, rect_tables, box_tables)
    of a size x size batch."""
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
    ), rect, box


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
    ), rect, box


@pytest.mark.parametrize("name", ["cornell", "simple_light", "mixed"])
def test_pack_aux_tables_match_jax(name):
    _, _, rect, box = port_batch(name, 4)
    _, _, jrect, jbox = jax_batch(name, 4)
    for got, want in ((rect, jrect), (box, jbox)):
        assert (got is None) == (want is None)
        if got is not None:
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def random_aux(r, count):
    """Random unit-ish quaternions, positions, rect bounds and extents."""
    q = r.normal(size=(count, 4)).astype(np.float32)
    pos = r.normal(size=(count, 3)).astype(np.float32)
    lo = -r.uniform(0.2, 1.0, size=(count, 2)).astype(np.float32)
    hi = r.uniform(0.2, 1.0, size=(count, 2)).astype(np.float32)
    ext = r.uniform(0.2, 1.0, size=(count, 3)).astype(np.float32)
    return q, pos, lo, hi, ext


@pytest.mark.parametrize("seed", [0, 1])
def test_rect_and_box_tests_match_jax(seed):
    r = np.random.default_rng(seed)
    n, k = 400, 7
    q, pos, lo, hi, ext = random_aux(r, k)
    # rays from around the entities aimed near one of them
    o = (r.normal(size=(n, 3)) * 3.0).astype(np.float32)
    aim = pos[r.integers(0, k, n)] + 0.3 * r.normal(size=(n, 3))
    d = (aim - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    j = [jnp.asarray(x) for x in (o, d, q, pos, lo, hi, ext)]
    t = [torch.from_numpy(x) for x in (o, d, q, pos, lo, hi, ext)]
    close = dict(rtol=1e-5, atol=1e-5)  # measured <= 2.2e-6 relative
    for got, want in zip(
            geometry.rect_hit_all(t[0], t[1], t[2], t[3], t[4], t[5]),
            jax_geometry.rect_hit_all(j[0], j[1], j[2], j[3], j[4], j[5])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **close)
    for got, want in zip(
            geometry.box_hit_all(t[0], t[1], t[2], t[3], t[6]),
            jax_geometry.box_hit_all(j[0], j[1], j[2], j[3], j[6])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **close)
    for hits in (jax_geometry.rect_hit_all(*j[:6])[0],
                 jax_geometry.box_hit_all(*j[:4], j[6])[0]):
        assert float(jnp.mean(jnp.min(hits, axis=1) < 1e29)) > 0.2
    # the single forms: one (gathered) entity per ray
    pick = r.integers(0, k, n)
    jp = [jnp.asarray(x[pick]) for x in (q, pos, lo, hi, ext)]
    tp = [torch.from_numpy(x[pick]) for x in (q, pos, lo, hi, ext)]
    np.testing.assert_allclose(
        geometry.rect_hit_single(t[0], t[1], *tp[:4]).numpy(),
        np.asarray(jax_geometry.rect_hit_single(j[0], j[1], *jp[:4])),
        **close)
    for got, want in zip(
            geometry.box_hit_single(t[0], t[1], tp[0], tp[1], tp[4]),
            jax_geometry.box_hit_single(j[0], j[1], jp[0], jp[1], jp[4])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **close)


def run_both(name, size, seed, spp, depth=8):
    """(port outputs, JAX outputs) as numpy dicts, on the same inputs."""
    n = size * size
    lane_count = np.full(n, spp, np.int32)
    js, jtables, jrect, jbox = jax_batch(name, size)
    sky_on = js.flags.sky == 1
    want = pallas_megatrace.sample_batch(
        jnp.asarray(lane_count), jnp.zeros(n), *jtables, jnp.int32(seed),
        rect_tables=jrect, box_tables=jbox, samples=spp, trace_depth=depth,
        has_dielectrics=js.flags.has_dielectrics, sky_on=sky_on,
        interpret=True, hw_prng=False, want_tape=True,
    )
    ts, ttables, rect, box = port_batch(name, size)
    got = megatrace.sample_batch(
        torch.from_numpy(lane_count), torch.zeros(n), *ttables, seed,
        rect_tables=rect, box_tables=box, samples=spp, trace_depth=depth,
        has_dielectrics=ts.flags.has_dielectrics, sky_on=sky_on,
        want_tape=True,
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


@pytest.mark.parametrize("name,size,seed,spp", [
    ("cornell", 32, 1, 4), ("cornell", 16, 2, 2),
    ("simple_light", 24, 3, 4), ("mixed", 24, 4, 3),
])
def test_plain_version_matches_jax_kernel(name, size, seed, spp):
    got, want = run_both(name, size, seed, spp)
    assert_lanes_agree(got, want, TAPE_SHARE)
    s_pad = megatrace.sphere_pad_count(
        port_scene(name)[0].spheres.center.shape[0])
    assert (got["tape"] >= s_pad).any()  # rect or box winners
    assert float(got["color"].mean()) > 0.0


def test_sphere_free_scene_keeps_the_sphere_pad_in_the_codes():
    """cornell has no sphere: the codes of its rects still start at
    SPHERE_PAD and its boxes after the padded rects (JAX's row space)."""
    scene, tables, rect, box = port_batch("cornell", 8)
    assert scene.spheres.center.shape[0] == 0
    rect_base, box_base = megatrace.aux_code_bases(0, rect)
    assert rect_base == megatrace.SPHERE_PAD
    assert box_base == megatrace.SPHERE_PAD + rect[0].shape[0]
    out = megatrace.sample_batch(
        torch.full((64,), 2, dtype=torch.int32), torch.zeros(64), *tables,
        5, rect_tables=rect, box_tables=box, samples=2, trace_depth=4,
        sky_on=False, want_tape=True)
    hits = out["tape"][out["tape"] >= 0]
    assert bool(((hits >= rect_base) & (hits < rect_base + 6)
                 | (hits >= box_base) & (hits < box_base + 2)).all())
    assert bool((hits >= box_base).any())


def test_scope():
    cornell, _ = book_scenes.cornell_box()
    assert megatrace.scene_eligible(cornell, allow_triangles=True,
                                    allow_rect_box=True)
    assert megatrace_replay.replay_eligible(cornell)
    # the per-ray megatrace stays sphere-only, as the JAX package's
    assert not megatrace.scene_eligible(cornell)
    assert "sphere-only" in megatrace.unsupported_feature(cornell)
    renderer.check_scope(cornell)
    light, _ = testbeds.simple_light()
    assert megatrace_replay.replay_eligible(light)
    # rects or boxes beside triangles (ROADMAP step 7.1b): in the batch
    # kernel's scope and the wavefront's; the triangles' tape codes follow
    # the padded rects
    b = scene_mod.SceneBuilder()
    white = b.lambert((0.7, 0.7, 0.7))
    b.add_sphere((0.0, -100.5, 0.0), 100.0, white)
    b.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), white)
    b.add_rect((0, 0, -1), (3.0, 3.0), white)
    mesh_rect = b.build()
    assert megatrace.scene_eligible(mesh_rect, allow_triangles=True,
                                    allow_rect_box=True)
    assert megatrace_replay.replay_eligible(mesh_rect)
    renderer.check_scope(mesh_rect)
    packed = materials.pack_materials(mesh_rect)
    rect, _ = megatrace.pack_aux_tables(mesh_rect, packed)
    assert megatrace.tri_code_base(1, rect) == 128 + rect[0].shape[0]
    cam = camera.make_camera((0.3, 0.3, 3.0), (0.3, 0.3, 0.0), (0, 1, 0),
                             30.0, 1.0)
    out = megatrace.sample_batch(
        torch.ones(16, dtype=torch.int32), torch.zeros(16),
        megatrace.pack_camera_row(cam, 4, 4), mesh_rect.spheres.center,
        mesh_rect.spheres.radius,
        megatrace.pack_sphere_records(mesh_rect, packed),
        torch.zeros(3), torch.zeros(3), 1, samples=1, trace_depth=1,
        rect_tables=rect, want_tape=True, jitter=False,
        tri_tables=megatrace.pack_tri_tables(mesh_rect, packed))
    # the camera sees the triangle and, around it, the rect behind it
    first = set(out["tape"][0].tolist())
    assert {128.0, 128.0 + rect[0].shape[0]} <= first, first
    assert torch.isfinite(out["color"]).all()


@pytest.mark.parametrize("differentiable", [True, False])
def test_trace_matches_jax_on_cornell(differentiable):
    w, h, depth, seed = 48, 32, 8, 7
    n = w * h
    js, cs = jax_scenes.cornell_box()
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
    scene, _ = book_scenes.cornell_box()
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


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell", "simple_light", "glossy"])
def test_cuda_aux_build_matches_plain_version(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    scene, tables, rect, box = port_batch(name, 64)
    tables = [t.to(dev) for t in tables]
    rect, box = ((None if p is None else tuple(t.to(dev) for t in p))
                 for p in (rect, box))
    n = 64 * 64
    lane_count = torch.full((n,), 4, dtype=torch.int32, device=dev)
    kw = dict(samples=4, trace_depth=8, want_tape=True, rect_tables=rect,
              box_tables=box, sky_on=scene.flags.sky == 1,
              has_dielectrics=scene.flags.has_dielectrics)
    before = (megatrace.LAUNCHES, megatrace.AUX_LAUNCHES)
    got = megatrace.sample_batch(lane_count, torch.zeros(n, device=dev),
                                 *tables, 21, **kw)
    assert (megatrace.LAUNCHES, megatrace.AUX_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    want = megatrace.sample_batch_reference(
        lane_count, torch.zeros(n, device=dev), *tables, 21, **kw)
    got = {k: v.cpu().numpy() for k, v in got.items()}
    want = {k: v.cpu().numpy() for k, v in want.items()}
    assert_lanes_agree(got, want, 0.99)
