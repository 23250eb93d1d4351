"""The AOV-gradient graft of the port's differentiable render_batch.

The fused differentiable arm propagates only the color sum's and valid
count's cotangents through the tape replay; the normal, albedo, weight
and fallback AOVs keep the kernel's values and take their gradients from
the differentiable wavefront on the batch key (the JAX renderer's
renderer.py:314-345 graft).  Here a loss linear in the accumulators' AOV
channels, with fixed numpy weights, goes through the port's
render_batch(key=...) and through jax.grad of the JAX render_batch on the
CPU with the same key.  On the CPU the JAX batch is its wavefront, so both
sides estimate with the same samples: the port's primal AOVs are the
kernel's (hash PRNG), but a linear loss gives both sides the same
cotangent, so the gradients must agree.  Leaves: sphere centres, radii,
the texture colors (the albedos) and the sky.  Each gradient is held
within GRAD_TOL of the leaf's max abs (measured: 3.3e-6 on
three_spheres, 1.1e-5 on single_sphere, both on the centres).

Also: the primal AOVs are the kernel's whether or not something requires
grad, and a photometric loss runs no wavefront (the renderer's
AOV_GRAFT_RUNS counter does not move).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_in_one_weekend_tpu.core import camera as jax_camera
from raytracing_in_one_weekend_tpu.diff import params as jax_params
from raytracing_in_one_weekend_tpu.models import book_scenes as jax_scenes
from raytracing_in_one_weekend_tpu.render import film as jax_film
from raytracing_in_one_weekend_tpu.render import renderer as jax_renderer
from raytracing_in_one_weekend_tpu_torch.core import camera, rng
from raytracing_in_one_weekend_tpu_torch.diff import params
from raytracing_in_one_weekend_tpu_torch.models import book_scenes
from raytracing_in_one_weekend_tpu_torch.ops import sphere_select
from raytracing_in_one_weekend_tpu_torch.render import film, renderer

GRAD_TOL = 1e-4
AOVS = ("normal", "albedo", "weight", "fallback_normal", "fallback_albedo")
LEAVES = ("centers", "radii", "main_color", "sky_bottom", "sky_top")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run puts six test processes on the machine's cores: one
    torch thread each keeps the plain versions' ops from oversubscribing
    them (measured 26x slower for the cover golden with eight threads per
    process)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def loss_weights(n, seed=3):
    r = np.random.default_rng(seed)
    return {k: r.normal(size=(n, 3) if k != "weight" else (n,)).astype(
        np.float32) for k in AOVS}


def port_setup(name, w, h):
    scene, cs = book_scenes.SCENES[name]()
    cam = camera.make_camera(cs.origin, cs.look_at, cs.up, cs.vertical_fov,
                             w / h, aperture=cs.aperture,
                             focus_distance=cs.focus_distance)
    return scene, cam


def port_apply(scene, leaves):
    centers, radii, main_color, sky_b, sky_t = leaves
    scene = params.set_texture_colors(params.set_sphere_radii(
        params.set_sphere_centers(scene, centers), radii), main_color)
    return dataclasses.replace(scene, environment=dataclasses.replace(
        scene.environment, sky_bottom=sky_b, sky_top=sky_t))


def port_leaves(scene):
    return [scene.spheres.center, scene.spheres.radius,
            scene.textures.main_color, scene.environment.sky_bottom,
            scene.environment.sky_top]


def jax_grads(name, w, h, spp, depth, seed, weights):
    js, cs = jax_scenes.SCENES[name]()
    cam = jax_camera.make_camera(cs.origin, cs.look_at, cs.up,
                                 cs.vertical_fov, w / h,
                                 aperture=cs.aperture,
                                 focus_distance=cs.focus_distance)

    def loss(centers, radii, main_color, sky_b, sky_t):
        scene = jax_params.set_texture_colors(jax_params.set_sphere_radii(
            jax_params.set_sphere_centers(js, centers), radii), main_color)
        scene = scene._replace(environment=scene.environment._replace(
            sky_bottom=sky_b, sky_top=sky_t))
        acc, _ = jax_renderer.render_batch(
            scene, cam, jax_film.zero_accumulators(w * h),
            jax.random.PRNGKey(seed), width=w, height=h, samples=spp,
            trace_depth=depth, differentiable=True)
        return sum(jnp.sum(getattr(acc, k) * weights[k]) for k in AOVS)

    leaves = (js.spheres.center, js.spheres.radius, js.textures.main_color,
              js.environment.sky_bottom, js.environment.sky_top)
    return [np.asarray(g) for g in
            jax.grad(loss, argnums=tuple(range(5)))(*leaves)]


def port_grads(name, w, h, spp, depth, seed, weights):
    scene, cam = port_setup(name, w, h)
    leaves = [t.detach().clone().requires_grad_() for t in port_leaves(scene)]
    acc = film.zero_accumulators(w * h)
    renderer.render_batch(port_apply(scene, leaves), cam, acc,
                          key=rng.PRNGKey(seed), width=w, height=h,
                          samples=spp, trace_depth=depth)
    loss = sum((getattr(acc, k) * torch.tensor(weights[k])).sum()
               for k in AOVS)
    runs = renderer.AOV_GRAFT_RUNS
    grads = torch.autograd.grad(loss, leaves)
    assert renderer.AOV_GRAFT_RUNS == runs + 1
    return [g.numpy() for g in grads]


@pytest.mark.parametrize("name,w,spp,depth,seed", [
    ("three_spheres", 12, 3, 5, 4),
    ("single_sphere", 10, 2, 4, 8),
])
def test_aov_gradients_match_jax(name, w, spp, depth, seed):
    weights = loss_weights(w * w)
    want = jax_grads(name, w, w, spp, depth, seed, weights)
    got = port_grads(name, w, w, spp, depth, seed, weights)
    for leaf, g, r in zip(LEAVES, got, want):
        scale = np.abs(r).max()
        assert np.isfinite(g).all() and scale > 0, leaf
        assert np.abs(g - r).max() <= GRAD_TOL * scale, (
            leaf, np.abs(g - r).max() / scale)


def test_primal_aovs_are_the_kernels():
    w = 10
    scene, cam = port_setup("three_spheres", w, w)
    key = rng.PRNGKey(5)
    plain = film.zero_accumulators(w * w)
    renderer.render_batch(scene, cam, plain, key=key, width=w, height=w,
                          samples=2, trace_depth=4, differentiable=False)
    leaves = [t.detach().clone().requires_grad_() for t in port_leaves(scene)]
    grafted = film.zero_accumulators(w * w)
    renderer.render_batch(port_apply(scene, leaves), cam, grafted, key=key,
                          width=w, height=w, samples=2, trace_depth=4)
    for k in ("color", "sample_count") + AOVS:
        assert torch.equal(getattr(grafted, k).detach(), getattr(plain, k)), k
    assert grafted.normal.requires_grad


def test_photometric_loss_runs_no_wavefront():
    w = 10
    scene, cam = port_setup("three_spheres", w, w)
    centers = scene.spheres.center.clone().requires_grad_()
    img = renderer.render_image(params.set_sphere_centers(scene, centers),
                                cam, width=w, height=w, samples_per_pixel=2,
                                trace_depth=4, key=rng.PRNGKey(6))
    runs = renderer.AOV_GRAFT_RUNS
    launches = dict(sphere_select.LAUNCHES)
    torch.mean((img.color - 0.5) ** 2).backward()
    assert renderer.AOV_GRAFT_RUNS == runs
    assert sphere_select.LAUNCHES == launches
    assert float(centers.grad.abs().max()) > 0


def test_key_seeds_the_batch_as_jax_does():
    key = rng.PRNGKey(123)
    want = int(jax.random.randint(jax.random.PRNGKey(123), (), 0,
                                  2**31 - 1))
    w = 6
    scene, cam = port_setup("single_sphere", w, w)
    a = film.zero_accumulators(w * w)
    renderer.render_batch(scene, cam, a, key=key, width=w, height=w,
                          samples=1, trace_depth=3, differentiable=False)
    b = film.zero_accumulators(w * w)
    renderer.render_batch(scene, cam, b, seed=want, width=w, height=w,
                          samples=1, trace_depth=3, differentiable=False)
    assert torch.equal(a.color, b.color)
