"""The cubemap sky in the port against the JAX package: the lookup, the
builder, the batch kernel's plain version and the integrators' arms.

* `core.environment._sample_cubemap` (the wavefront's lookup) and
  `megatrace.cube_texels` (the batch kernels' plain version, on
  `pack_cubemap_table`'s rows) pick JAX's `_sample_cubemap` texel on every
  direction: seeded random ones, the face diagonals (the major-axis ties)
  and directions on texel edges, with unequal face width and height.
* The `cubemap` testbed builds JAX's arrays, and `pack_cubemap_table` holds
  JAX's table transposed back (texel (face, y, x) at row face * h + y);
  so do the sphere-only material sweeps (`diffuse_testbed`,
  `metal_roughness`, `refraction`, `dielectric_roughness`, `grid`).
* The batch kernel's plain version against JAX's kernel in interpret mode
  with the hash PRNG and its cube table, on `cubemap` and on a scene with
  a rect beside the cubemap (the cube beside the aux arm): tapes identical
  on >= 0.999 of lanes, the deltas within 1e-5 there (the two normal AOVs
  on >= 0.99 of those lanes and within 1e-3 on all: XLA's CPU rsqrt is not
  correctly rounded, the port's is).
* Both integrators pick one arm on `cubemap`: not the per-ray megatrace
  (JAX's `scene_eligible` refuses a cubemap, its `_kernel` has no cube
  table), the fused sphere selection (`fast`).

The `cuda`-marked case runs each cube build of the batch kernel against
its plain version on the card.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_in_one_weekend_tpu.core import camera as jax_camera
from raytracing_in_one_weekend_tpu.core import environment as jax_env
from raytracing_in_one_weekend_tpu.core import materials as jax_materials
from raytracing_in_one_weekend_tpu.models import testbeds as jax_testbeds
from raytracing_in_one_weekend_tpu.ops import pallas_megatrace
from raytracing_in_one_weekend_tpu.scene import scene as jax_scene_mod
from raytracing_in_one_weekend_tpu_torch.core import camera, environment
from raytracing_in_one_weekend_tpu_torch.core import materials, rng
from raytracing_in_one_weekend_tpu_torch.models import testbeds
from raytracing_in_one_weekend_tpu_torch.ops import megatrace
from raytracing_in_one_weekend_tpu_torch.ops import megatrace_replay
from raytracing_in_one_weekend_tpu_torch.ops import sphere_select
from raytracing_in_one_weekend_tpu_torch.render import integrator, renderer
from raytracing_in_one_weekend_tpu_torch.scene import scene as scene_mod

FLOAT_CHANNELS = ("color", "normal", "albedo", "weight", "fallback_normal",
                  "fallback_albedo")
TAPE_SHARE = 0.999
DELTA_TOL = 1e-5
# the normal AOVs: the port normalises with a correctly rounded rsqrt, XLA's
# CPU rsqrt is not (tests/test_torch_megatrace.py); measured on `cubemap`
# at 24x24: 5 of 576 lanes past 1e-5, the largest 3.7e-5
NORMALS = ("normal", "fallback_normal")
NORMAL_SHARE = 0.99
NORMAL_MAX_ERR = 1e-3


def edge_directions(w: int, h: int) -> np.ndarray:
    """Directions on the major-axis ties (face diagonals, both signs) and on
    texel edges of every face: (uv + 1) * size / 2 exactly an integer."""
    dirs = []
    for sx in (1.0, -1.0):
        for sy in (1.0, -1.0):
            for sz in (1.0, -1.0):
                dirs += [(sx, sy, sz), (sx, sy, 0.3 * sz), (sx, 0.3 * sy, sz),
                         (0.3 * sx, sy, sz), (sx, 0.0, 0.0), (0.0, sy, 0.0),
                         (0.0, 0.0, sz)]
    us = np.arange(w + 1) * (2.0 / w) - 1.0
    vs = np.arange(h + 1) * (2.0 / h) - 1.0
    for axis in range(3):
        for sign in (1.0, -1.0):
            for u in us[::3]:
                for v in vs[::2]:
                    d = np.empty(3)
                    d[axis] = sign
                    d[(axis + 1) % 3] = u
                    d[(axis + 2) % 3] = v
                    dirs.append(tuple(d))
    return np.asarray(dirs, np.float32)


@pytest.mark.parametrize("w,h", [(32, 32), (12, 8)])
def test_lookup_matches_jax(w, h):
    r = np.random.default_rng(w)
    cm = r.random((6, h, w, 3)).astype(np.float32)  # texels tell apart
    v = r.normal(size=(3000, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v = np.concatenate([v, edge_directions(w, h)])
    want = np.asarray(jax_env._sample_cubemap(jnp.asarray(cm),
                                              jnp.asarray(v)))
    got = environment._sample_cubemap(torch.from_numpy(cm),
                                      torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want)
    table = torch.from_numpy(cm).reshape(6 * h, w, 3)
    t = torch.from_numpy(v)
    np.testing.assert_array_equal(
        megatrace.cube_texels(table, (w, h), t[:, 0], t[:, 1],
                              t[:, 2]).numpy(), want)
    # every face took lanes
    face, _, _ = environment.cubemap_index(t[:, 0], t[:, 1], t[:, 2], w, h)
    assert set(face.tolist()) == set(range(6))


def test_cubemap_builder_and_table_match_jax():
    ts, tcs = testbeds.SCENES["cubemap"]()
    js, jcs = jax_testbeds.SCENES["cubemap"]()
    assert dataclasses.asdict(tcs) == dataclasses.asdict(jcs)
    assert ts.flags.sky == js.flags.sky == 2
    for group in ("spheres", "materials", "textures", "environment"):
        jg = getattr(js, group)
        for field in jg._fields:
            want, got = getattr(jg, field), getattr(getattr(ts, group), field)
            if field == "perlin" or want is None:
                assert got is None, (group, field)
                continue
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"{group}.{field}")
    cube, dims = megatrace.pack_cubemap_table(ts)
    jcube, jdims = pallas_megatrace.pack_cubemap_table(js)
    w, h = dims
    assert dims == jdims == (32, 32)
    assert tuple(cube.shape) == (6 * h, w, 3)
    jcube = np.asarray(jcube)
    w_pad = jcube.shape[0] // 3
    for c in range(3):
        np.testing.assert_array_equal(
            cube.numpy()[:, :, c].T, jcube[c * w_pad:c * w_pad + w, :6 * h])
    # a scene without a cubemap has no table
    assert megatrace.pack_cubemap_table(testbeds.SCENES["grid"]()[0]) is None


@pytest.mark.parametrize("name", ["diffuse_testbed", "metal_roughness",
                                  "refraction", "dielectric_roughness",
                                  "grid"])
def test_sphere_testbeds_match_jax(name):
    """The material sweeps (and `material_grid`) build JAX's arrays and
    render on the sphere build (the batch kernel's and the per-ray
    megatrace's scope)."""
    ts, tcs = testbeds.SCENES[name]()
    js, jcs = jax_testbeds.SCENES[name]()
    assert dataclasses.asdict(tcs) == dataclasses.asdict(jcs)
    assert dataclasses.asdict(ts.flags) == dataclasses.asdict(js.flags)
    for group in ("spheres", "materials", "textures", "environment"):
        jg = getattr(js, group)
        for field in jg._fields:
            want, got = getattr(jg, field), getattr(getattr(ts, group), field)
            if field == "perlin" or want is None:
                assert got is None, (group, field)
                continue
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"{group}.{field}")
    assert megatrace.scene_eligible(ts)


def rect_cube_scene(mod):
    """Spheres, a one-sided rect and the cubemap sky, built by the scene
    module `mod` (the port's or the JAX package's)."""
    b = mod.SceneBuilder()
    b.add_sphere((0.0, -100.5, 0.0), 100.0, b.lambert((0.5, 0.5, 0.5)))
    b.add_sphere((0.6, 0.0, 0.0), 0.5, b.metal((0.9, 0.9, 0.9), 0.8))
    b.add_rect((-0.7, 0.3, 0.2), (0.9, 0.7), b.lambert((0.8, 0.3, 0.2)),
               rotation=mod.axis_angle_quat((0.0, 1.0, 0.0), 25.0))
    b.set_cubemap_sky(testbeds.cubemap_faces(16))
    return b.build(), testbeds.SCENES["cubemap"]()[1]


def scene_pair(name):
    if name == "cubemap":
        return testbeds.SCENES[name](), jax_testbeds.SCENES[name]()
    return rect_cube_scene(scene_mod), rect_cube_scene(jax_scene_mod)


def port_batch(scene, cs, size):
    cam = camera.make_camera(cs.origin, cs.look_at, cs.up, cs.vertical_fov,
                             1.0, aperture=cs.aperture,
                             focus_distance=cs.focus_distance,
                             device=scene.spheres.center.device)
    packed = materials.pack_materials(scene)
    rect, box = megatrace.pack_aux_tables(scene, packed)
    cube, dims = megatrace.pack_cubemap_table(scene)
    return (megatrace.pack_camera_row(cam, size, size), scene.spheres.center,
            scene.spheres.radius,
            megatrace.pack_sphere_records(scene, packed),
            scene.environment.sky_bottom, scene.environment.sky_top), dict(
        rect_tables=rect, box_tables=box, cube=cube, cube_dims=dims)


def jax_batch(scene, cs, size):
    cam = jax_camera.make_camera(cs.origin, cs.look_at, cs.up,
                                 cs.vertical_fov, 1.0, aperture=cs.aperture,
                                 focus_distance=cs.focus_distance)
    packed = jax_materials.pack_materials(scene)
    rect, box = pallas_megatrace.pack_aux_tables(scene, packed)
    cube, dims = pallas_megatrace.pack_cubemap_table(scene)
    return (pallas_megatrace.pack_camera_row(cam, size, size),
            scene.spheres.center, scene.spheres.radius,
            pallas_megatrace.pack_sphere_records(scene, packed),
            scene.environment.sky_bottom, scene.environment.sky_top), dict(
        rect_tables=rect, box_tables=box, cube_table=cube, cube_dims=dims)


@pytest.mark.parametrize("name,size,seed", [("cubemap", 24, 1),
                                            ("rect_cube", 16, 2)])
def test_plain_version_matches_jax_kernel(name, size, seed):
    spp, depth = 4, 6
    n = size * size
    lane_count = np.full(n, spp, np.int32)
    (ts, tcs), (js, jcs) = scene_pair(name)
    jtables, jkw = jax_batch(js, jcs, size)
    want = pallas_megatrace.sample_batch(
        jnp.asarray(lane_count), jnp.zeros(n), *jtables, jnp.int32(seed),
        samples=spp, trace_depth=depth,
        has_dielectrics=js.flags.has_dielectrics, sky_on=False,
        interpret=True, hw_prng=False, want_tape=True, **jkw)
    ttables, kw = port_batch(ts, tcs, size)
    got = megatrace.sample_batch(
        torch.from_numpy(lane_count), torch.zeros(n), *ttables, seed,
        samples=spp, trace_depth=depth,
        has_dielectrics=ts.flags.has_dielectrics, sky_on=False,
        want_tape=True, **kw)
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    same = ((got["count"] == want["count"]) & (got["rays"] == want["rays"])
            & np.all(got["tape"] == want["tape"], axis=0))
    assert same.mean() >= TAPE_SHARE, same.mean()
    for k in FLOAT_CHANNELS:
        if k in NORMALS:
            close = np.isclose(got[k], want[k], atol=DELTA_TOL,
                               rtol=DELTA_TOL).all(axis=-1)
            assert close[same].mean() >= NORMAL_SHARE, (k, close[same].mean())
            np.testing.assert_allclose(got[k][same], want[k][same],
                                       atol=NORMAL_MAX_ERR, rtol=0)
            continue
        np.testing.assert_allclose(got[k][same], want[k][same],
                                   atol=DELTA_TOL, rtol=DELTA_TOL,
                                   err_msg=k)
    # the sky took effect: misses, and the sun's texels among them
    assert float((got["tape"] == -1).mean()) > 0.05
    assert float(got["color"].max()) > 2.0


def test_integrators_pick_the_same_arm(monkeypatch):
    """JAX's trace: `mega` needs scene_eligible (refused for a cubemap),
    `fast` a static, untextured sphere-only scene: it takes `fast`; so does
    the port's, launching sphere_select_full and no per-ray megatrace."""
    js, _ = jax_testbeds.SCENES["cubemap"]()
    assert not pallas_megatrace.scene_eligible(js)
    assert (not js.flags.has_motion and not js.flags.has_procedural_textures
            and not js.flags.has_volumes and js.spheres.center.shape[0] > 0
            and js.rects.rot.shape[0] == js.boxes.rot.shape[0] == 0
            and js.triangles.vert0.shape[0] == 0)
    scene, cs = testbeds.SCENES["cubemap"]()
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(megatrace, "megatrace",
                        spy("mega", megatrace.megatrace))
    monkeypatch.setattr(sphere_select, "sphere_select_full",
                        spy("fast", sphere_select.sphere_select_full))
    cam = camera.make_camera(cs.origin, cs.look_at, cs.up, cs.vertical_fov,
                             1.0, focus_distance=cs.focus_distance)
    key = rng.PRNGKey(3)
    rays = camera.generate_rays(cam, camera.pixel_coords(8, 8, key, True),
                                key)
    out = integrator.trace(scene, rays, key, 4, differentiable=False)
    assert "fast" in calls and "mega" not in calls
    assert bool(out.valid.any()) and bool(torch.isfinite(out.radiance).all())


def test_scope():
    scene, _ = testbeds.SCENES["cubemap"]()
    renderer.check_scope(scene)
    assert megatrace.scene_eligible(scene, allow_cubemap=True)
    assert megatrace_replay.replay_eligible(scene)
    # one arm beside the cube is built; two are ROADMAP step 7.6b
    b = scene_mod.SceneBuilder()
    b.add_sphere((0.0, -100.5, 0.0), 100.0, b.lambert((0.5, 0.5, 0.5)))
    b.add_sphere((0.0, 0.0, 0.0), 0.5, b.volume(1.0, (0.9, 0.9, 0.9)),
                 move_offset=(0.0, 0.2, 0.0))
    b.set_cubemap_sky(testbeds.cubemap_faces(4))
    two = b.build()
    renderer.check_scope(two)  # the wavefront takes it
    assert "step 7.6b" in megatrace.unsupported_feature(
        two, True, True, True, True, True, True)
    assert not megatrace_replay.replay_eligible(two)


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["spheres", "rects", "volumes", "motion",
                                 "textures"])
def test_cuda_cube_builds_match_plain_version(arm):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    b = scene_mod.SceneBuilder()
    albedo = (scene_mod.checker((0.9, 0.9, 0.9), (0.1, 0.1, 0.1), 10.0)
              if arm == "textures" else (0.5, 0.5, 0.5))
    b.add_sphere((0.0, -100.5, 0.0), 100.0, b.lambert(albedo))
    b.add_sphere((0.6, 0.0, 0.0), 0.5, b.metal((0.9, 0.9, 0.9), 0.8),
                 move_offset=(0.0, 0.3, 0.0) if arm == "motion" else None)
    if arm == "rects":
        b.add_rect((-0.7, 0.3, 0.2), (0.9, 0.7), b.lambert((0.8, 0.3, 0.2)))
    if arm == "volumes":
        b.add_sphere((-0.7, 0.1, 0.3), 0.4, b.volume(2.0, (0.9, 0.9, 0.9)))
    b.set_cubemap_sky(testbeds.cubemap_faces(16))
    scene = b.build(device=dev)
    cs = testbeds.SCENES["cubemap"]()[1]
    tables, kw = port_batch(scene, cs, 48)
    packed = materials.pack_materials(scene)
    kw.update(move_offsets=scene.spheres.move_offset,
              tex_tables=megatrace.pack_texture_tables(scene),
              vol0=(megatrace.camera_containment_row(
                  scene, packed, tables[0][0:3])
                  if scene.flags.has_volumes else None))
    n = 48 * 48
    lane_count = torch.full((n,), 4, dtype=torch.int32, device=dev)
    statics = dict(samples=4, trace_depth=8, want_tape=True, sky_on=False,
                   has_dielectrics=scene.flags.has_dielectrics)
    before = (megatrace.LAUNCHES, megatrace.CUBE_LAUNCHES)
    got = megatrace.sample_batch(lane_count, torch.zeros(n, device=dev),
                                 *tables, 21, **statics, **kw)
    assert (megatrace.LAUNCHES, megatrace.CUBE_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    want = megatrace.sample_batch_reference(
        lane_count, torch.zeros(n, device=dev), *tables, 21, **statics, **kw)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
