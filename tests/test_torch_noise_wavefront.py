"""The sampler flavors on the port's wavefront and in its renderer and
driver, against the JAX package.

* The flavored camera (`pixel_coords(jitter_uv=)`, `generate_rays(lens_uv=)`)
  on the draws of `randomsource.pixel_uniforms`: the jittered coordinates
  bit for bit JAX's, the rays within 1e-6 (the normalization's rounding
  differs from XLA's in the last bit on 0.7% of the components, as with
  white draws).
* `integrator.trace(noise_ctx=...)` at 48x32, depth 4, against JAX's on
  JAX's flavored rays, the same key and active mask, at the bounds of
  tests/test_torch_integrator.py (valid and pixel_rays identical,
  radiance, albedo, events and normals within atol=rtol=1e-3, >= 99% of
  lanes): BLUE (its scalar set flavors every bounce's draws) on
  `three_spheres` and the four-set state (`chip_smoke.four_set_state`:
  every bounce's cosine, the free path and the isotropic direction) on
  `volume`, the port's differentiable and `fast` arms against JAX's
  differentiable arm.
* A flavored differentiable step (`render_image` with BLUE and centres
  requiring grad: the wavefront, as in JAX): the gradients of a weighted
  colour loss to the sphere centres are finite and within 1e-3 of their
  max abs of jax.grad through JAX's render_batch.
* Routes: every registered scene with a flavor takes the route of
  `renderer.noise_route`, the JAX renderer's (the in-kernel tables where
  the tile side divides the width, the pre-drawn rows elsewhere and for
  the Morton-lane classes: more than SPH_CULL_MIN spheres, streamed
  meshes; never the wavefront), and render_batch follows it: the
  kernel's noise arguments (a streamed mesh's pre-drawn columns permuted
  with its Morton lanes, and no sync sampler), or the wavefront with the
  state when something requires grad.
* `ProgressiveRenderer` with NoiseColor.BLUE on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from raytracing_in_one_weekend_tpu.core import camera as jax_camera
from raytracing_in_one_weekend_tpu.core import randomsource as jax_rs
from raytracing_in_one_weekend_tpu.diff import params as jax_params
from raytracing_in_one_weekend_tpu.models import book_scenes as jax_scenes
from raytracing_in_one_weekend_tpu.render import film as jax_film
from raytracing_in_one_weekend_tpu.render import integrator as jax_integrator
from raytracing_in_one_weekend_tpu.render import renderer as jax_renderer
from raytracing_in_one_weekend_tpu.utils.config import NoiseColor as JaxColor
from raytracing_in_one_weekend_tpu_torch.core import camera, randomsource, rng
from raytracing_in_one_weekend_tpu_torch.core.ray import Rays
from raytracing_in_one_weekend_tpu_torch.diff import params
from raytracing_in_one_weekend_tpu_torch.models import book_scenes, testbeds
from raytracing_in_one_weekend_tpu_torch.ops import megatrace
from raytracing_in_one_weekend_tpu_torch.render import (
    driver, integrator, renderer,
)
from raytracing_in_one_weekend_tpu_torch.utils.config import (
    NoiseColor, RenderSettings,
)

TOL = dict(atol=1e-3, rtol=1e-3)
LANE_SHARE = 0.99
GRAD_TOL = 1e-3  # of each gradient's max abs
KEYS = ("radiance", "valid", "aov_normal", "aov_albedo", "events",
        "pixel_rays")
# the registered scenes with Morton lanes in JAX's renderer (more than
# 1024 spheres, more than TRI_MAX triangles): the pre-drawn rows at any
# width
MORTON = {"sphere_field", "mesh_large", "mesh_huge"}


def states(name):
    if name == "four":
        state, arrays = chip_smoke.four_set_state()
        return state, jax_rs.NoiseState(*(jnp.asarray(a) for a in arrays))
    return (randomsource.make_noise_state(NoiseColor.BLUE, seed=7),
            jax_rs.make_noise_state(JaxColor.BLUE, seed=7))


def flavored_rays(name, flavor, w, h, seed, draw):
    """(JAX scene, JAX's flavored rays, the port's own flavored rays),
    after holding the port's jittered coordinates to JAX's."""
    state, jstate = states(flavor)
    js, cs = jax_scenes.SCENES[name]()
    jcam = jax_camera.make_camera(cs.origin, cs.look_at, cs.up,
                                  cs.vertical_fov, w / h,
                                  aperture=cs.aperture,
                                  focus_distance=cs.focus_distance)
    key = jax.random.PRNGKey(seed)
    u4 = jax_rs.pixel_uniforms(jstate, draw, w, h)
    jcoords = jax_camera.pixel_coords(w, h, None, True, jitter_uv=u4[:, :2])
    jrays = jax_camera.generate_rays(jcam, jcoords, key, lens_uv=u4[:, 2:4])
    cam = camera.make_camera(cs.origin, cs.look_at, cs.up, cs.vertical_fov,
                             w / h, aperture=cs.aperture,
                             focus_distance=cs.focus_distance)
    p4 = randomsource.pixel_uniforms(state, draw, w, h)
    coords = camera.pixel_coords(w, h, None, True, jitter_uv=p4[:, :2])
    np.testing.assert_array_equal(coords.numpy(), np.asarray(jcoords))
    rays = camera.generate_rays(cam, coords, rng.PRNGKey(seed),
                                lens_uv=p4[:, 2:4])
    return js, jrays, rays


@pytest.mark.parametrize("name,flavor", [("three_spheres", "blue"),
                                         ("volume", "four")])
@pytest.mark.parametrize("arm", ["differentiable", "fast"])
def test_trace_with_noise_context_matches_jax(name, flavor, arm):
    w, h, depth, seed, draw = 48, 32, 4, 9, 37
    n = w * h
    state, jstate = states(flavor)
    js, jrays, rays = flavored_rays(name, flavor, w, h, seed, draw)
    for got, want in zip((rays.origin, rays.direction),
                         (jrays.origin, jrays.direction)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    rays = Rays(*(torch.tensor(np.asarray(v)) for v in
                  (jrays.origin, jrays.direction, jrays.time)))
    active = np.arange(n) % 5 != 2
    want = jax_integrator.trace(
        js, jrays, jax.random.PRNGKey(seed), depth, differentiable=True,
        active=jnp.asarray(active), noise_ctx=(jstate, draw, w, h))
    want = {k: np.asarray(getattr(want, k)) for k in KEYS}
    scene, _ = book_scenes.SCENES[name]()
    got = integrator_trace(scene, rays, seed, depth, arm, active,
                           (state, draw, w, h))
    same = (got["valid"] == want["valid"]) & (
        got["pixel_rays"] == want["pixel_rays"])
    for k in ("radiance", "aov_albedo", "events", "aov_normal"):
        close = np.isclose(got[k], want[k], **TOL)
        same &= close.all(axis=-1) if close.ndim == 2 else close
    assert same.mean() >= LANE_SHARE, same.mean()
    # the context reached the bounces: white draws take other paths
    white = integrator_trace(scene, rays, seed, depth, arm, active, None)
    assert not np.array_equal(got["radiance"], white["radiance"])


def integrator_trace(scene, rays, seed, depth, arm, active, noise_ctx):
    out = integrator.trace(scene, Rays(rays.origin, rays.direction,
                                       rays.time),
                           rng.PRNGKey(seed), depth,
                           differentiable=arm == "differentiable",
                           active=torch.tensor(active), noise_ctx=noise_ctx)
    return {k: getattr(out, k).numpy() for k in KEYS}


def test_flavored_training_step_matches_jax():
    w, h, spp, depth, seed = 16, 12, 2, 3, 4
    state, jstate = states("blue")
    weights = np.random.default_rng(0).random((w * h, 3)).astype(np.float32)
    js, cs = jax_scenes.SCENES["three_spheres"]()
    jcam = jax_camera.make_camera(cs.origin, cs.look_at, cs.up,
                                  cs.vertical_fov, w / h,
                                  aperture=cs.aperture,
                                  focus_distance=cs.focus_distance)

    def jax_loss(centers):
        acc, _ = jax_renderer.render_batch(
            jax_params.set_sphere_centers(js, centers), jcam,
            jax_film.zero_accumulators(w * h), jax.random.PRNGKey(seed),
            width=w, height=h, samples=spp, trace_depth=depth,
            differentiable=True, noise_color=1, noise_state=jstate)
        return jnp.sum(acc.color * weights)

    want = np.asarray(jax.grad(jax_loss)(js.spheres.center))
    scene, _ = book_scenes.SCENES["three_spheres"]()
    cam = camera.make_camera(cs.origin, cs.look_at, cs.up, cs.vertical_fov,
                             w / h, aperture=cs.aperture,
                             focus_distance=cs.focus_distance)
    centers = scene.spheres.center.detach().clone().requires_grad_()
    s = params.apply_params(scene, {"sphere_centers": centers})
    launches = megatrace.LAUNCHES
    acc = renderer.film.zero_accumulators(w * h)
    renderer.render_batch(s, cam, acc, key=rng.PRNGKey(seed), width=w,
                          height=h, samples=spp, trace_depth=depth,
                          noise_color=1, noise_state=state)
    loss = (acc.color * torch.tensor(weights)).sum()
    got = torch.autograd.grad(loss, centers)[0].numpy()
    assert megatrace.LAUNCHES == launches  # no batch kernel
    scale = np.abs(want).max()
    assert np.isfinite(got).all() and scale > 0
    assert np.abs(got - want).max() <= GRAD_TOL * scale, (
        np.abs(got - want).max() / scale)
    # render_image's training step takes the same route
    img = renderer.render_image(s, cam, key=rng.PRNGKey(seed), width=w,
                                height=h, samples_per_pixel=spp,
                                trace_depth=depth, noise_color=1,
                                noise_state=state)
    assert img.color.requires_grad


def test_noise_route_of_every_registered_scene():
    state, _ = states("blue")
    registry = {**book_scenes.SCENES, **testbeds.SCENES}
    assert MORTON <= set(registry)
    for name, make in registry.items():
        scene, _ = make()
        assert megatrace.scene_eligible(
            scene, allow_triangles=True, allow_rect_box=True,
            allow_volumes=True, allow_motion=True, allow_textures=True,
            allow_cubemap=True), name
        want = "pre_drawn" if name in MORTON else "tables"
        assert renderer.noise_route(scene, state, 512) == want, name
        assert renderer.noise_route(scene, state, 500) == "pre_drawn", name
        assert renderer.noise_route(scene, None, 512) == "white"


class _Stop(Exception):
    pass


@pytest.mark.parametrize("name,width,route", [
    ("three_spheres", 64, "tables"), ("volume", 24, "pre_drawn"),
    ("cornell", 64, "tables"), ("sphere_field", 64, "pre_drawn"),
    ("mesh_large", 64, "pre_drawn"),
])
def test_render_batch_follows_the_route(monkeypatch, name, width, route):
    state, _ = states("blue")
    seen = {}

    def batch(*args, **kwargs):
        seen["batch"] = kwargs
        raise _Stop

    def wave(*args, **kwargs):
        seen["wave"] = kwargs
        raise _Stop

    monkeypatch.setattr(megatrace, "sample_batch", batch)
    monkeypatch.setattr(renderer, "wavefront_pass", wave)
    monkeypatch.setattr(renderer.meshtrace, "sample_batch_sync", wave)
    scene, cs = (book_scenes.SCENES.get(name) or testbeds.SCENES[name])()
    cam = camera.make_camera(cs.origin, cs.look_at, cs.up, cs.vertical_fov,
                             width / 8, aperture=cs.aperture,
                             focus_distance=cs.focus_distance)
    acc = renderer.film.zero_accumulators(width * 8)
    with pytest.raises(_Stop):
        renderer.render_batch(scene, cam, acc, seed=1, width=width,
                              height=8, samples=2, trace_depth=3,
                              noise_color=1, noise_state=state,
                              draw_base=96)
    kw = seen["batch"]
    assert set(seen) == {"batch"}
    if route == "tables":
        assert kw["noise_meta"]["size"] == 64
        assert kw["noise_draw_base"] == renderer.noise_draw_base(96, 2, 3)
        assert "noise_uniforms" not in kw
    else:
        assert kw["noise_uniforms"].shape == (4 * 2, width * 8)
        assert "noise_tbl" not in kw
        # Morton lanes (streamed meshes): the columns follow the lanes
        order = (megatrace.morton_order(width, 8)[0]
                 if kw.get("pixel_index") is not None
                 else torch.arange(width * 8))
        if kw.get("pixel_index") is not None:
            assert torch.equal(kw["pixel_index"], order)
        want = megatrace.pack_noise_uniforms(state, acc.sample_count, width,
                                             8, 2)
        assert torch.equal(kw["noise_uniforms"], want[:, order])
    # something requiring grad: the flavored wavefront
    seen.clear()
    centers = scene.spheres.center.detach().clone().requires_grad_()
    s = params.apply_params(scene, {"sphere_centers": centers})
    with pytest.raises(_Stop):
        renderer.render_batch(s, cam, acc, seed=1, width=width, height=8,
                              samples=2, trace_depth=3, noise_color=1,
                              noise_state=state)
    assert set(seen) == {"wave"}


def test_progressive_renderer_with_blue_noise_on_the_cpu():
    scene, cs = book_scenes.three_spheres()
    settings = RenderSettings(width=64, height=16, samples_per_pixel=4,
                              trace_depth=4, samples_per_batch_range=(2, 2),
                              adaptive_sampling=False,
                              noise_color=NoiseColor.BLUE)
    r = driver.ProgressiveRenderer(scene, cs, settings, seed=3, device="cpu")
    assert r.noise_state is not None
    assert r.noise_state.tiles.shape == (1, 64, 64, 4)
    bases = []
    real = renderer.render_batch

    def spy(*args, **kwargs):
        bases.append(kwargs["draw_base"])
        assert kwargs["noise_state"] is r.noise_state
        return real(*args, **kwargs)

    renderer.render_batch = spy
    try:
        r.run()
    finally:
        renderer.render_batch = real
    assert r.complete and bases == [0, 2]
    img = r.combined()
    assert torch.isfinite(img.color).all()
    assert float(img.color.mean()) > 0.05
    white = driver.ProgressiveRenderer(
        scene, cs, RenderSettings(width=64, height=16, samples_per_pixel=4,
                                  trace_depth=4,
                                  samples_per_batch_range=(2, 2),
                                  adaptive_sampling=False),
        seed=3, device="cpu")
    assert white.noise_state is None
    white.run()
    assert not torch.equal(white.combined().color, img.color)
