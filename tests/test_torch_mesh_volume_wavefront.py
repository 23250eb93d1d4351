"""The port's wavefront on convex volumes beside triangles and on a
volume-material (non-convex) mesh (ROADMAP step 7.2b) against the JAX
package's.

* `integrator.trace` with the same threefry key, rays and active mask,
  differentiable and not (both sides take the general arm: the per-ray
  megatrace is sphere-only), on chip_smoke.mesh_volume_scene's mesh_fog
  (mesh_showcase with a fog sphere around its torus), mesh_fog_inside (the
  rays start in that fog) and torus_volume (a torus of the fog's material
  over a ground sphere: a triangle hit carries no exit, t_exit = BIG, as
  in JAX's intersect.py, so a ray that enters it passes to BIG).
  tests/test_torch_integrator.py's criterion: valid and ray count equal,
  radiance, albedo and events within atol=rtol=1e-3 and the normal within
  1e-3 on >= 99% of lanes.
* The renderer sends the volume-material torus to the wavefront (the
  fused kernels refuse non-convex volumes, as JAX's scene_eligible) and
  renders a finite image; the convex scenes stay on the batch kernel's
  plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from raytracing_in_one_weekend_tpu.core import camera as jax_camera
from raytracing_in_one_weekend_tpu.render import integrator as jax_integrator
from raytracing_in_one_weekend_tpu.scene import scene as jax_scene_mod
from raytracing_in_one_weekend_tpu_torch.core import camera, rng
from raytracing_in_one_weekend_tpu_torch.ops import megatrace
from raytracing_in_one_weekend_tpu_torch.render import film, integrator
from raytracing_in_one_weekend_tpu_torch.render import renderer

from test_torch_integrator import KEYS, LANE_SHARE, TOL, port_rays


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process (tests/test_torch_integrator.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def scene_rays(name, w, h, seed):
    js, cs = chip_smoke.mesh_volume_scene(name, jax_scene_mod)
    cam = jax_camera.make_camera(cs.origin, cs.look_at, cs.up,
                                 cs.vertical_fov, w / h, aperture=cs.aperture,
                                 focus_distance=cs.focus_distance)
    key = jax.random.PRNGKey(seed)
    return js, jax_camera.generate_rays(
        cam, jax_camera.pixel_coords(w, h, key, True), key)


@pytest.mark.parametrize("name,differentiable", [
    ("mesh_fog", True), ("mesh_fog", False), ("mesh_fog_inside", False),
    ("torus_volume", True), ("torus_volume", False),
])
def test_trace_matches_jax(name, differentiable):
    w, h, depth, seed = 32, 24, 6, 9
    n = w * h
    js, rays = scene_rays(name, w, h, seed)
    active = np.arange(n) % 5 != 2
    want = jax_integrator.trace(js, rays, jax.random.PRNGKey(seed), depth,
                                differentiable=differentiable,
                                active=jnp.asarray(active))
    want = {k: np.asarray(getattr(want, k)) for k in KEYS}
    scene, _ = chip_smoke.mesh_volume_scene(name)
    got = integrator.trace(scene, port_rays(rays), rng.PRNGKey(seed), depth,
                           differentiable=differentiable,
                           active=torch.tensor(active))
    got = {k: getattr(got, k).detach().numpy() for k in KEYS}
    ok = (got["valid"] == want["valid"]) & (
        got["pixel_rays"] == want["pixel_rays"])
    for k in ("radiance", "aov_albedo", "events"):
        close = np.isclose(got[k], want[k], **TOL)
        ok &= close.all(axis=-1) if close.ndim == 2 else close
    ok &= np.abs(got["aov_normal"] - want["aov_normal"]).max(-1) <= 1e-3
    assert ok.mean() >= LANE_SHARE, ok.mean()
    assert float(got["radiance"].mean()) > 0.0
    assert got["valid"].any()


def test_renderer_routes_nonconvex_volumes_to_the_wavefront(monkeypatch):
    torus, cs = chip_smoke.mesh_volume_scene("torus_volume")
    assert torus.flags.has_nonconvex_volumes
    assert (megatrace.unsupported_feature(
        torus, True, True, True, True, True, True)
        == megatrace.NONCONVEX_VOLUMES)
    assert megatrace.unported_feature(torus) is None

    def refuse(*args, **kwargs):
        raise AssertionError("the batch kernel ran")

    monkeypatch.setattr(megatrace, "sample_batch", refuse)
    w = 16
    cam = camera.make_camera(cs.origin, cs.look_at, cs.up, cs.vertical_fov,
                             1.0, aperture=cs.aperture,
                             focus_distance=cs.focus_distance)
    acc = film.zero_accumulators(w * w)
    renderer.render_batch(torus, cam, acc, width=w, height=w, samples=2,
                          trace_depth=4, seed=3, differentiable=False)
    img = film.combine(acc, w, w).color
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0
