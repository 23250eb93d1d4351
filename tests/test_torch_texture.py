"""Checker, Perlin and image textures in the port against the JAX package:
the builder, the noise, the wavefront's texture sampling, the batch
kernel's plain version and the scope.

* The Perlin tables equal JAX's bit for bit (numpy's default_rng draws
  them on both sides), and so do the four textured scenes' arrays (the
  atlas among them) and `pack_texture_tables` (transposed to a row a
  material).
* `noise.turbulence` and `textures.sample_color` / `sample_scalar` against
  JAX's on random points, normals and uvs over a table of every texture
  type: within 1e-5 (float32 rounding in a different order; measured
  <= 2.4e-7).
* The batch kernel's plain version against JAX's kernel in interpret mode
  with the hash PRNG, on `checkered` and `textured_sphere` (with the
  winner tape: identical on >= 0.999 of lanes, count and rays equal there,
  the floats within atol=rtol=1e-4) and on `perlin` and a 16x16 crop of
  `final_book2` (JAX records no tape over a Perlin texture: lanes are held
  by their count and rays, then the floats).  The port's sphere uv uses a
  correctly rounded atan2 and acos where the JAX kernel uses a polynomial
  atan2 (~1e-6 rad), and its checker and marble sin is correctly rounded
  where XLA's is not: a lane on a texel or checker edge may take the other
  side.  Measured at these sizes: every lane of checkered and
  textured_sphere; 1 of 256 perlin lanes with an albedo 1.7e-4 off (a
  marble sin a few ulps off); 1 of 256 final_book2 lanes with a normal
  2.8e-3 off (the cover's normal gap: XLA's rsqrt, tests/
  test_torch_megatrace.py).  So the float channels are held on 0.99 of
  the agreeing lanes, as the cover's are.
* `integrator.trace` (the general arm, both modes) on `checkered` and
  `textured_sphere` against JAX's wavefront: valid and ray counts
  identical and the floats within 1e-3 on >= 99% of lanes (`perlin` in
  tests/test_torch_texture_slow.py; its texture sampling is held here).
* Scope: textured sphere, rect, box and volume scenes take the batch
  kernel's texture builds, not the per-ray megatrace nor the fast arm;
  `perlin` and `final_book2` are not replay-eligible (no Perlin marble in
  the replay, as in JAX) and train through the wavefront; textures beside
  triangles are refused naming ROADMAP step 7.5b.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_in_one_weekend_tpu.core import camera as jax_camera
from raytracing_in_one_weekend_tpu.core import materials as jax_materials
from raytracing_in_one_weekend_tpu.core import noise as jax_noise
from raytracing_in_one_weekend_tpu.core import textures as jax_textures
from raytracing_in_one_weekend_tpu.models import testbeds as jax_testbeds
from raytracing_in_one_weekend_tpu.ops import pallas_megatrace
from raytracing_in_one_weekend_tpu.render import integrator as jax_integrator
from raytracing_in_one_weekend_tpu_torch.core import camera, materials, noise
from raytracing_in_one_weekend_tpu_torch.core import rng, textures
from raytracing_in_one_weekend_tpu_torch.core.ray import Rays
from raytracing_in_one_weekend_tpu_torch.models import testbeds
from raytracing_in_one_weekend_tpu_torch.ops import megatrace
from raytracing_in_one_weekend_tpu_torch.ops import megatrace_replay
from raytracing_in_one_weekend_tpu_torch.render import integrator, renderer
from raytracing_in_one_weekend_tpu_torch.scene import scene as scene_mod

TEXTURED = ("checkered", "perlin", "textured_sphere", "final_book2")
TOL = dict(atol=1e-4, rtol=1e-4)
FLOAT_CHANNELS = ("color", "normal", "albedo", "weight", "fallback_normal",
                  "fallback_albedo")
WAVE_KEYS = ("radiance", "valid", "aov_normal", "aov_albedo", "events",
             "pixel_rays")
TAPE_SHARE = 0.999
FLOAT_SHARE = 0.99  # of the agreeing lanes (see the docstring)


def port_batch(name, size):
    """(scene, the six sphere/camera/sky tables, the keyword tables)."""
    scene, cs = testbeds.SCENES[name]()
    cam = camera.make_camera(cs.origin, cs.look_at, cs.up, cs.vertical_fov,
                             1.0, aperture=cs.aperture,
                             focus_distance=cs.focus_distance)
    packed = materials.pack_materials(scene)
    rect, box = megatrace.pack_aux_tables(scene, packed)
    return scene, (
        megatrace.pack_camera_row(cam, size, size), scene.spheres.center,
        scene.spheres.radius, megatrace.pack_sphere_records(scene, packed),
        scene.environment.sky_bottom, scene.environment.sky_top,
    ), dict(rect_tables=rect, box_tables=box,
            vol0=(megatrace.camera_containment_row(scene, packed, cam.origin)
                  if scene.flags.has_volumes else None),
            move_offsets=scene.spheres.move_offset,
            tex_tables=megatrace.pack_texture_tables(scene))


def jax_batch(name, size):
    scene, cs = jax_testbeds.SCENES[name]()
    cam = jax_camera.make_camera(cs.origin, cs.look_at, cs.up,
                                 cs.vertical_fov, 1.0, aperture=cs.aperture,
                                 focus_distance=cs.focus_distance)
    packed = jax_materials.pack_materials(scene)
    rect, box = pallas_megatrace.pack_aux_tables(scene, packed)
    tex = pallas_megatrace.pack_texture_tables(scene)
    return scene, (
        pallas_megatrace.pack_camera_row(cam, size, size),
        scene.spheres.center, scene.spheres.radius,
        pallas_megatrace.pack_sphere_records(scene, packed),
        scene.environment.sky_bottom, scene.environment.sky_top,
    ), dict(rect_tables=rect, box_tables=box,
            vol0=(pallas_megatrace.camera_containment_row(scene, packed,
                                                          cam.origin)
                  if scene.flags.has_volumes else None),
            move_offsets=scene.spheres.move_offset,
            tex_tables=tex[:3], img_dims=tex[3])


def test_perlin_tables_match_jax():
    for seed in (1, 7):
        got = noise.make_perlin_tables(seed)
        want = jax_noise.make_perlin_tables(seed)
        for f in dataclasses.fields(got):
            np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                          np.asarray(getattr(want, f.name)))
            assert getattr(got, f.name).numpy().dtype == np.asarray(
                getattr(want, f.name)).dtype


@pytest.mark.parametrize("name", TEXTURED)
def test_scene_arrays_and_texture_tables_match_jax(name):
    ts, tcs = testbeds.SCENES[name]()
    js, jcs = jax_testbeds.SCENES[name]()
    assert dataclasses.asdict(ts.flags) == dataclasses.asdict(js.flags)
    assert dataclasses.asdict(tcs) == dataclasses.asdict(jcs)
    for group in ("spheres", "rects", "boxes", "materials", "textures"):
        jg = getattr(js, group)
        for field in jg._fields:
            want = getattr(jg, field)
            got = getattr(getattr(ts, group), field)
            if field == "perlin":
                assert (got is None) == (want is None)
                continue
            if want is None:
                assert got is None, (group, field)
                continue
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"{group}.{field}")
    got = megatrace.pack_texture_tables(ts)
    want = pallas_megatrace.pack_texture_tables(js)
    m = ts.materials.type.shape[0]
    np.testing.assert_array_equal(got.rec.numpy().T,
                                  np.asarray(want[0])[:, :m])
    assert got.dims == want[3]
    if want[1] is not None:
        np.testing.assert_array_equal(got.perlin.numpy(),
                                      np.asarray(want[1]))
    if want[2] is not None:
        w, h = want[3]
        w_pad = np.asarray(want[2]).shape[0] // 3
        img = np.asarray(want[2])
        rows = got.atlas.shape[0]
        for c in range(3):
            np.testing.assert_array_equal(
                got.atlas.numpy()[:, :, c].T, img[c * w_pad:c * w_pad + w,
                                                  :rows])


def _texture_table(mod):
    """A texture table of every type: constant, checker, Perlin, image,
    constant scalar (with an atlas of two 8x16 images)."""
    r = np.random.default_rng(4)
    atlas = r.random((2, 8, 16, 3)).astype(np.float32)
    return dict(
        type=np.array([0, 1, 2, 3, 4, 5, 4], np.int32),
        main_color=r.random((7, 3)).astype(np.float32),
        secondary_color=r.random((7, 3)).astype(np.float32),
        parameter=np.array([0, 0, 7, 3, 0, 0.4, 0], np.float32),
        scalar_channel=np.array([0, 1, 2, 0, 1, 0, 2], np.int32),
        image_index=np.array([-1, -1, -1, -1, 0, -1, 1], np.int32),
        atlas=atlas)


def test_turbulence_and_sampling_match_jax():
    r = np.random.default_rng(5)
    n = 4000
    pos = (r.normal(size=(n, 3)) * 3.0).astype(np.float32)
    nrm = r.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    uv = r.random((n, 2)).astype(np.float32)
    ids = r.integers(0, 7, n).astype(np.int32)
    tables = noise.make_perlin_tables(3)
    jtables = jax_noise.make_perlin_tables(3)
    got = noise.turbulence(tables, torch.from_numpy(pos)).numpy()
    want = np.asarray(jax_noise.turbulence(jtables, jnp.asarray(pos)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert 0.05 < got.mean() < 0.95
    arrays = _texture_table(None)
    table = textures.TextureTable(
        **{k: torch.from_numpy(v) for k, v in arrays.items()},
        perlin=tables)
    jtable = jax_textures.TextureTable(
        **{k: jnp.asarray(v) for k, v in arrays.items()}, perlin=jtables)
    args = (ids, uv, pos, nrm)
    for fn, jfn in ((textures.sample_color, jax_textures.sample_color),
                    (textures.sample_scalar, jax_textures.sample_scalar)):
        got = fn(table, *(torch.from_numpy(a) for a in args)).numpy()
        want = np.asarray(jfn(jtable, *(jnp.asarray(a) for a in args)))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # every type took lanes, and the checker both colours
    checker = textures.sample_color(table, *(torch.from_numpy(a)
                                             for a in args))[ids == 2]
    assert len(torch.unique(checker, dim=0)) == 2


def run_both(name, size, seed, spp, depth=8):
    """(port outputs, JAX outputs) as numpy dicts, on the same inputs; the
    JAX kernel keeps a tape only without a Perlin texture."""
    n = size * size
    lane_count = np.full(n, spp, np.int32)
    js, jtables, jkw = jax_batch(name, size)
    tape = js.textures.perlin is None
    want = pallas_megatrace.sample_batch(
        jnp.asarray(lane_count), jnp.zeros(n), *jtables, jnp.int32(seed),
        samples=spp, trace_depth=depth,
        has_dielectrics=js.flags.has_dielectrics, sky_on=js.flags.sky == 1,
        interpret=True, hw_prng=False, want_tape=tape, **jkw)
    ts, ttables, kw = port_batch(name, size)
    got = megatrace.sample_batch(
        torch.from_numpy(lane_count), torch.zeros(n), *ttables, seed,
        samples=spp, trace_depth=depth,
        has_dielectrics=ts.flags.has_dielectrics, sky_on=ts.flags.sky == 1,
        want_tape=True, **kw)
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    return got, want


@pytest.mark.parametrize("name,size,seed,spp", [
    ("checkered", 24, 1, 3), ("textured_sphere", 24, 2, 3),
    ("perlin", 16, 3, 2), ("final_book2", 16, 4, 2),
])
def test_plain_version_matches_jax_kernel(name, size, seed, spp):
    got, want = run_both(name, size, seed, spp)
    same = (got["count"] == want["count"]) & (got["rays"] == want["rays"])
    if "tape" in want:
        same &= np.all(got["tape"] == want["tape"], axis=0)
    assert same.mean() >= TAPE_SHARE, same.mean()
    for k in FLOAT_CHANNELS:
        close = np.isclose(got[k], want[k], **TOL)
        close = close.all(axis=-1) if close.ndim == 2 else close
        assert close[same].mean() >= FLOAT_SHARE, (k, close[same].mean())
    # the textures took effect: more than one albedo among the hits
    hit = got["count"] > 0
    assert len(np.unique(got["albedo"][hit].round(3), axis=0)) > 2


# perlin is tests/test_torch_texture_slow.py: JAX's wavefront compiles its
# turbulence for ~30 s a mode
@pytest.mark.parametrize("name,differentiable", [
    ("checkered", True), ("checkered", False), ("textured_sphere", True),
    ("textured_sphere", False),
])
def test_trace_matches_jax(name, differentiable):
    w, h, depth, seed = 24, 16, 6, 7
    n = w * h
    js, cs = jax_testbeds.SCENES[name]()
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
    scene, _ = testbeds.SCENES[name]()
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
    for name in TEXTURED:
        scene, _ = testbeds.SCENES[name]()
        assert megatrace.scene_eligible(
            scene, allow_triangles=True, allow_rect_box=True,
            allow_volumes=True, allow_motion=True, allow_textures=True)
        # the per-ray megatrace reads constant albedos, as JAX's
        assert not megatrace.scene_eligible(scene, allow_rect_box=True,
                                            allow_volumes=True,
                                            allow_motion=True)
        renderer.check_scope(scene)
        # the replay has no Perlin marble, as JAX's
        assert megatrace_replay.replay_eligible(scene) == (
            name in ("checkered", "textured_sphere"))
    # textures beside triangles: ROADMAP step 7.5b
    for tex in (scene_mod.checker((1, 1, 1), (0, 0, 0)),
                scene_mod.perlin((1, 1, 1))):
        b = scene_mod.SceneBuilder()
        white = b.lambert((0.7, 0.7, 0.7))
        b.add_sphere((0.0, -100.5, 0.0), 100.0, b.lambert(tex))
        b.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), white)
        mesh = b.build()
        with pytest.raises(NotImplementedError, match="step 7.5b"):
            renderer.check_scope(mesh)
    packed = materials.pack_materials(mesh)
    with pytest.raises(NotImplementedError, match="step 7.5b"):
        megatrace.sample_batch(
            torch.ones(4, dtype=torch.int32), torch.zeros(4),
            torch.zeros(24), mesh.spheres.center, mesh.spheres.radius,
            megatrace.pack_sphere_records(mesh, packed), torch.zeros(3),
            torch.zeros(3), 1, samples=1, trace_depth=1,
            tex_tables=megatrace.pack_texture_tables(mesh),
            tri_tables=megatrace.pack_tri_tables(mesh, packed))


def test_render_batch_takes_the_texture_build(monkeypatch):
    """render_batch sends the textured scenes to the batch kernel with
    their texture tables, forward; with something requiring grad, perlin
    takes the wavefront and checkered the replay."""
    seen = []
    real = megatrace.sample_batch

    def spy(*args, **kwargs):
        seen.append(kwargs.get("tex_tables"))
        return real(*args, **kwargs)

    monkeypatch.setattr(megatrace, "sample_batch", spy)
    for name in ("checkered", "perlin"):
        scene, cs = testbeds.SCENES[name]()
        cam = camera.make_camera(cs.origin, cs.look_at, cs.up,
                                 cs.vertical_fov, 1.0,
                                 focus_distance=cs.focus_distance)
        img = renderer.render_image(scene, cam, width=8, height=8,
                                    samples_per_pixel=2, trace_depth=4,
                                    seed=1, differentiable=False)
        assert bool(torch.isfinite(img.color).all())
        assert seen[-1] is not None and seen[-1].rec.shape[1] == 16
        seen.clear()
        colors = scene.textures.main_color.clone().requires_grad_()
        textured = dataclasses.replace(scene, textures=dataclasses.replace(
            scene.textures, main_color=colors))
        img = renderer.render_image(textured, cam, width=8, height=8,
                                    samples_per_pixel=2, trace_depth=4,
                                    seed=1)
        img.color.sum().backward()
        assert float(colors.grad.abs().max()) > 0.0
        assert bool(seen) == (name == "checkered")


@pytest.mark.cuda
@pytest.mark.parametrize("name", TEXTURED)
def test_cuda_texture_builds_match_plain_version(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    scene, tables, kw = port_batch(name, 64)
    tables = [t.to(dev) for t in tables]

    def to_dev(v):
        if v is None or isinstance(v, tuple) and not torch.is_tensor(v[0]):
            return v
        if isinstance(v, megatrace.TexTables):
            return megatrace.TexTables(*(to_dev(t) for t in v[:3]), v.dims)
        if isinstance(v, tuple):
            return tuple(t.to(dev) for t in v)
        return v.to(dev)

    kw = {k: to_dev(v) for k, v in kw.items()}
    n = 64 * 64
    lane_count = torch.full((n,), 4, dtype=torch.int32, device=dev)
    before = (megatrace.LAUNCHES, megatrace.TEX_LAUNCHES)
    statics = dict(samples=4, trace_depth=8, want_tape=True,
                   has_dielectrics=scene.flags.has_dielectrics,
                   sky_on=scene.flags.sky == 1)
    got = megatrace.sample_batch(lane_count, torch.zeros(n, device=dev),
                                 *tables, 21, **statics, **kw)
    assert (megatrace.LAUNCHES, megatrace.TEX_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    want = megatrace.sample_batch_reference(
        lane_count, torch.zeros(n, device=dev), *tables, 21, **statics, **kw)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
