"""The port's wavefront on a Cornell box with a mesh in it (ROADMAP step
7.1b) against the JAX package's.

* `intersect.nearest_hit` on cornell_mesh camera rays
  (chip_smoke.mesh_aux_scene: 6 rects, 2 boxes, 908 triangles, no
  sphere): JAX on the CPU sweeps rects, boxes and triangles by brute
  force, the port the rects and boxes by brute force and the triangles
  through the triangle selection's plain version, in JAX's order (a later
  kind wins only with a strictly smaller t).  Kind and index identical
  and t within 1e-5 on >= 99% of lanes; on those, normal within 1e-5 and
  the material equal; every kind wins somewhere.
* `integrator.trace` on cornell_mesh with the same threefry key, rays and
  active mask, differentiable and not (both sides take the general arm):
  tests/test_torch_integrator.py's criterion (valid and ray count equal,
  radiance, albedo and events within its TOL, atol=rtol=1e-3, the normal
  within 1e-3, on >= 99% of lanes; the box has no sky, so fewer than half its
  paths end valid and that clause of the criterion does not apply).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from raytracing_in_one_weekend_tpu.core import camera as jax_camera
from raytracing_in_one_weekend_tpu.ops import intersect as jax_intersect
from raytracing_in_one_weekend_tpu.render import integrator as jax_integrator
from raytracing_in_one_weekend_tpu.scene import scene as jax_scene_mod
from raytracing_in_one_weekend_tpu_torch.core import rng
from raytracing_in_one_weekend_tpu_torch.ops import intersect, triangle_select
from raytracing_in_one_weekend_tpu_torch.render import integrator

from test_torch_integrator import KEYS, LANE_SHARE, TOL, port_rays


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process (tests/test_torch_integrator.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cornell_rays(w, h, seed):
    js, cs = chip_smoke.mesh_aux_scene("cornell_mesh", jax_scene_mod)
    cam = jax_camera.make_camera(cs.origin, cs.look_at, cs.up,
                                 cs.vertical_fov, w / h, aperture=cs.aperture,
                                 focus_distance=cs.focus_distance)
    key = jax.random.PRNGKey(seed)
    return js, jax_camera.generate_rays(
        cam, jax_camera.pixel_coords(w, h, key, True), key)


def test_nearest_hit_matches_jax():
    js, rays = cornell_rays(40, 32, 2)
    want = jax_intersect.nearest_hit(js, rays)
    scene, _ = chip_smoke.mesh_aux_scene("cornell_mesh")
    before = triangle_select.LAUNCHES
    got = intersect.nearest_hit(scene, port_rays(rays))
    assert triangle_select.LAUNCHES == before  # CPU: the plain version
    w = {k: np.asarray(getattr(want, k)) for k in want._fields}
    g = {k: getattr(got, k).detach().numpy() for k in w}
    for kind in (1, 2, 3):  # rects, boxes and triangles win
        assert (g["kind"] == kind).any(), kind
    same = ((g["kind"] == w["kind"]) & (g["index"] == w["index"])
            & np.isclose(g["t"], w["t"], rtol=1e-5, atol=1e-5))
    assert same.mean() >= LANE_SHARE, same.mean()
    np.testing.assert_allclose(g["normal"][same], w["normal"][same],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(g["material"][same], w["material"][same])


@pytest.mark.parametrize("differentiable", [True, False])
def test_trace_matches_jax_on_cornell_mesh(differentiable):
    w, h, depth, seed = 40, 32, 6, 7
    n = w * h
    js, rays = cornell_rays(w, h, seed)
    active = np.arange(n) % 5 != 2
    want = jax_integrator.trace(js, rays, jax.random.PRNGKey(seed), depth,
                                differentiable=differentiable,
                                active=jnp.asarray(active))
    want = {k: np.asarray(getattr(want, k)) for k in KEYS}
    scene, _ = chip_smoke.mesh_aux_scene("cornell_mesh")
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
