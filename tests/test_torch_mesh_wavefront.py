"""The port's wavefront on mesh scenes against the JAX package's.

* `intersect.nearest_hit` on mesh_showcase camera rays: JAX on the CPU
  takes its brute force (`geometry.triangle_hit_all`, argmin), the port
  the triangle selection's plain version and the winner's re-evaluation.
  Kind and index identical and t within 1e-5 on >= 99% of lanes; on
  those, normal and uv within 1e-5, the hit point within 1e-4 and the
  material equal.
* `integrator.trace` on mesh_showcase with the same threefry key, rays
  and active mask, differentiable and not (both sides take the general
  arm on a mesh scene): paths identical on >= 99% of lanes, by
  tests/test_torch_integrator.py's criterion.
* The AOV graft on a mesh: a loss linear in the AOV channels through the
  port's render_batch(key=...) and through jax.grad of the JAX render_batch
  on the CPU (tests/test_torch_aov_graft.py): leaves are the sphere
  centres, the soup vertices, the vertex normals and the texture colors,
  each gradient within GRAD_TOL of its max abs.  The vertices go in
  through set_triangle_vertices, whose vert0 is also a term of edge_a and
  edge_b: the case that once counted the shared path twice in the graft.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_in_one_weekend_tpu.core import camera as jax_camera
from raytracing_in_one_weekend_tpu.diff import params as jax_params
from raytracing_in_one_weekend_tpu.models import meshes as jax_meshes
from raytracing_in_one_weekend_tpu.ops import intersect as jax_intersect
from raytracing_in_one_weekend_tpu.render import film as jax_film
from raytracing_in_one_weekend_tpu.render import integrator as jax_integrator
from raytracing_in_one_weekend_tpu.render import renderer as jax_renderer
from raytracing_in_one_weekend_tpu_torch.core import camera, rng
from raytracing_in_one_weekend_tpu_torch.diff import params
from raytracing_in_one_weekend_tpu_torch.models import meshes
from raytracing_in_one_weekend_tpu_torch.ops import intersect, triangle_select
from raytracing_in_one_weekend_tpu_torch.render import film, integrator
from raytracing_in_one_weekend_tpu_torch.render import renderer

from test_torch_integrator import KEYS, compare, port_rays

GRAD_TOL = 1e-4
AOVS = ("normal", "albedo", "weight", "fallback_normal", "fallback_albedo")
LEAVES = ("centers", "vertices", "normals", "main_color")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process (tests/test_torch_integrator.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def showcase_rays(w, h, seed):
    js, cs = jax_meshes.mesh_showcase()
    cam = jax_camera.make_camera(cs.origin, cs.look_at, cs.up,
                                 cs.vertical_fov, w / h, aperture=cs.aperture,
                                 focus_distance=cs.focus_distance)
    key = jax.random.PRNGKey(seed)
    return js, jax_camera.generate_rays(
        cam, jax_camera.pixel_coords(w, h, key, True), key)


def test_nearest_hit_matches_jax():
    js, rays = showcase_rays(40, 32, 2)
    want = jax_intersect.nearest_hit(js, rays)
    scene, _ = meshes.mesh_showcase()
    before = triangle_select.LAUNCHES
    got = intersect.nearest_hit(scene, port_rays(rays))
    assert triangle_select.LAUNCHES == before  # CPU: the plain version
    w = {k: np.asarray(getattr(want, k)) for k in want._fields}
    g = {k: getattr(got, k).detach().numpy() for k in w}
    assert (g["kind"] == 3).mean() > 0.1  # triangles hit
    same = ((g["kind"] == w["kind"]) & (g["index"] == w["index"])
            & np.isclose(g["t"], w["t"], rtol=1e-5, atol=1e-5))
    assert same.mean() >= 0.99, same.mean()
    for k in ("normal", "uv"):
        np.testing.assert_allclose(g[k][same], w[k][same], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    # the point is o + t d: t's 1e-5 at distances up to ~12 (measured
    # <= 2.9e-5 apart)
    np.testing.assert_allclose(g["point"][same], w["point"][same],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(g["material"][same], w["material"][same])


@pytest.mark.parametrize("differentiable", [True, False])
def test_trace_matches_jax_on_a_mesh(differentiable):
    w, h, depth, seed = 40, 32, 6, 7
    n = w * h
    js, rays = showcase_rays(w, h, seed)
    active = np.arange(n) % 5 != 2
    want = jax_integrator.trace(js, rays, jax.random.PRNGKey(seed), depth,
                                differentiable=differentiable,
                                active=jnp.asarray(active))
    want = {k: np.asarray(getattr(want, k)) for k in KEYS}
    scene, _ = meshes.mesh_showcase()
    got = integrator.trace(scene, port_rays(rays), rng.PRNGKey(seed), depth,
                           differentiable=differentiable,
                           active=torch.tensor(active))
    compare("mesh_showcase", {k: getattr(got, k).detach().numpy()
                              for k in KEYS}, want)


def _loss_weights(n, seed=3):
    r = np.random.default_rng(seed)
    return {k: r.normal(size=(n, 3) if k != "weight" else (n,)).astype(
        np.float32) for k in AOVS}


def _small_mesh(mod, meshes_mod):
    """A ground sphere, icosphere(1) with smooth normals and a face-normal
    cube (tests/test_replay.py's _mesh_scene)."""
    b = mod.SceneBuilder()
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, b.lambert((0.5, 0.5, 0.5)))
    v, f, nrm, _ = meshes_mod.icosphere(1)
    b.add_mesh(v, f, b.metal((0.8, 0.7, 0.5), glossiness=0.9), normals=nrm,
               translation=(-1.2, 1.0, 0.0))
    v, f, _, _ = meshes_mod.cube()
    b.add_mesh(v, f, b.lambert((0.8, 0.3, 0.2)), translation=(1.2, 0.5, 0.0),
               face_normals=True)
    b.set_gradient_sky()
    return b.build()


CAM = dict(origin=(0.0, 2.0, 6.0), look_at=(0.0, 0.7, 0.0), up=(0, 1, 0),
           vfov=35.0)


def test_aov_graft_gradients_match_jax_on_a_mesh():
    from raytracing_in_one_weekend_tpu.scene import scene as jax_scene_mod

    from raytracing_in_one_weekend_tpu_torch.scene import scene as scene_mod

    w, spp, depth, seed = 12, 2, 4, 6
    weights = _loss_weights(w * w)
    js = _small_mesh(jax_scene_mod, jax_meshes)
    jcam = jax_camera.make_camera(CAM["origin"], CAM["look_at"], CAM["up"],
                                  CAM["vfov"], 1.0)

    def jax_loss(centers, verts, normals, main_color):
        scene = jax_params.set_texture_colors(
            jax_params.set_triangle_normals(
                jax_params.set_triangle_vertices(
                    jax_params.set_sphere_centers(js, centers), verts),
                normals), main_color)
        acc, _ = jax_renderer.render_batch(
            scene, jcam, jax_film.zero_accumulators(w * w),
            jax.random.PRNGKey(seed), width=w, height=w, samples=spp,
            trace_depth=depth, differentiable=True)
        return sum(jnp.sum(getattr(acc, k) * weights[k]) for k in AOVS)

    jverts = jnp.stack([js.triangles.vert0,
                        js.triangles.vert0 + js.triangles.edge_b,
                        js.triangles.vert0 + js.triangles.edge_a], axis=1)
    want = [np.asarray(g) for g in jax.grad(jax_loss, argnums=(0, 1, 2, 3))(
        js.spheres.center, jverts, js.triangles.normals,
        js.textures.main_color)]

    scene = _small_mesh(scene_mod, meshes)
    cam = camera.make_camera(CAM["origin"], CAM["look_at"], CAM["up"],
                             CAM["vfov"], 1.0)
    leaves = [t.detach().clone().requires_grad_() for t in (
        scene.spheres.center, params.soup_vertices(scene),
        scene.triangles.normals, scene.textures.main_color)]
    s = params.apply_params(scene, dict(zip(
        ("sphere_centers", "triangle_vertices", "triangle_normals",
         "texture_colors"), leaves)))
    acc = film.zero_accumulators(w * w)
    renderer.render_batch(s, cam, acc, key=rng.PRNGKey(seed), width=w,
                          height=w, samples=spp, trace_depth=depth)
    loss = sum((getattr(acc, k) * torch.tensor(weights[k])).sum()
               for k in AOVS)
    runs = renderer.AOV_GRAFT_RUNS
    got = [g.numpy() for g in torch.autograd.grad(loss, leaves)]
    assert renderer.AOV_GRAFT_RUNS == runs + 1
    for leaf, g, r in zip(LEAVES, got, want):
        scale = np.abs(r).max()
        assert np.isfinite(g).all() and scale > 0, leaf
        assert np.abs(g - r).max() <= GRAD_TOL * scale, (
            leaf, np.abs(g - r).max() / scale)


def test_render_batch_on_a_mesh_takes_the_batch_kernel():
    """Forward: the fused arm with the triangle tables (plain version on
    the CPU), statistically equal to the wavefront with the kernel
    refused, as tests/test_torch_integrator.py holds the spheres."""
    from raytracing_in_one_weekend_tpu_torch.ops import megatrace

    scene, cs = meshes.mesh_showcase()
    w = h = 24
    cam = camera.make_camera(cs.origin, cs.look_at, cs.up, cs.vertical_fov,
                             1.0)
    key = rng.PRNGKey(0)
    fused = film.zero_accumulators(w * h)
    with pytest.MonkeyPatch.context() as mp:
        calls = []
        inner = megatrace.sample_batch
        mp.setattr(megatrace, "sample_batch",
                   lambda *a, **k: calls.append(k) or inner(*a, **k))
        renderer.render_batch(scene, cam, fused, key=key, width=w, height=h,
                              samples=4, trace_depth=6, differentiable=False)
    assert len(calls) == 1 and calls[0]["tri_tables"] is not None
    wave = film.zero_accumulators(w * h)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(megatrace, "scene_eligible", lambda *a, **k: False)
        renderer.render_batch(scene, cam, wave, key=key, width=w, height=h,
                              samples=4, trace_depth=6, differentiable=False)
    for k in ("sample_count", "color", "albedo"):
        a, b = getattr(wave, k).mean(), getattr(fused, k).mean()
        assert float(a) == pytest.approx(float(b), rel=0.08), k
    assert dataclasses.is_dataclass(fused)
