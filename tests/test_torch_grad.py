"""Gradients of the port's differentiable fused path.

* `sample_batch_diff` against the JAX package's (the Pallas kernel in
  interpret mode with the hash PRNG, gradient by jax.vjp of the XLA
  replay), same inputs and seed: identical tapes, probe-loss gradients
  within 5e-4 of each leaf's max abs.
* End to end in the port: render_image(differentiable=True) with an L2
  loss equals the sample_batch_diff-level gradient; a loss on an AOV
  gets its gradient from the wavefront graft (tests/test_torch_aov_graft.py
  holds it against JAX); with nothing requiring grad the outputs equal the
  forward path's.
* Finite differences with common random numbers (tests/test_replay.py
  :85-148 protocol, on three_spheres): an interior-masked loss, so that no
  silhouette crosses a pixel of the loss as eps moves the spheres.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_in_one_weekend_tpu.ops import megatrace_replay as jax_replay
from raytracing_in_one_weekend_tpu.ops import pallas_megatrace
from raytracing_in_one_weekend_tpu_torch.core import camera, materials
from raytracing_in_one_weekend_tpu_torch.diff import gradcheck
from raytracing_in_one_weekend_tpu_torch.diff import params as params_mod
from raytracing_in_one_weekend_tpu_torch.models import book_scenes
from raytracing_in_one_weekend_tpu_torch.ops import megatrace
from raytracing_in_one_weekend_tpu_torch.ops import megatrace_replay as mr
from raytracing_in_one_weekend_tpu_torch.render import film, renderer

from test_torch_replay import LEAVES, jax_tables, port_tables

GRAD_TOL = 5e-4


def probe_loss(color, count):
    """sum(color / max(count, 1) * cos(0.37 i)) (tests/test_replay.py
    :1119-1124); the tie at count == 1 splits the derivative as
    jnp.maximum does."""
    if isinstance(color, torch.Tensor):
        img = color / torch.maximum(count, torch.ones_like(count))[:, None]
        i = torch.arange(img.numel(), dtype=torch.float32,
                         device=img.device)
        return (img * torch.cos(i.reshape(img.shape) * 0.37)).sum()
    img = color / jnp.maximum(count, 1.0)[:, None]
    i = jnp.arange(img.size, dtype=jnp.float32)
    return (img * jnp.cos(i.reshape(img.shape) * 0.37)).sum()


def test_sample_batch_diff_matches_jax():
    w, spp, depth, seed = 8, 2, 4, 5
    n = w * w
    scene, tables = port_tables("three_spheres", w)
    jt = jax_tables("three_spheres", w)
    lane_count = np.full(n, spp, np.int32)
    kw = dict(samples=spp, trace_depth=depth,
              has_dielectrics=scene.flags.has_dielectrics, sky_on=True)

    want_tape = pallas_megatrace.sample_batch(
        jnp.asarray(lane_count), jnp.zeros(n), *jt, jnp.int32(seed),
        interpret=True, hw_prng=False, want_tape=True, **kw)["tape"]
    got_tape = megatrace.sample_batch(
        torch.from_numpy(lane_count), torch.zeros(n), *tables, seed,
        want_tape=True, **kw)["tape"]
    np.testing.assert_array_equal(got_tape.numpy(), np.asarray(want_tape))

    def jax_loss(*leaves):
        out = jax_replay.sample_batch_diff(
            jnp.asarray(lane_count), jnp.zeros(n), *leaves, jnp.int32(seed),
            interpret=True, kernel_bwd=False, **kw)
        return probe_loss(out["color"], out["count"])

    want = jax.grad(jax_loss, argnums=tuple(range(6)))(*jt)
    leaves = [t.detach().clone().requires_grad_() for t in tables]
    out = mr.sample_batch_diff(torch.from_numpy(lane_count), torch.zeros(n),
                               *leaves, seed, **kw)
    got = torch.autograd.grad(probe_loss(out["color"], out["count"]), leaves)
    for name, g, r in zip(LEAVES, got, want):
        g, r = g.numpy(), np.asarray(r)
        scale = np.abs(r).max()
        assert scale > 0, name
        assert np.abs(g - r).max() <= GRAD_TOL * scale, (
            name, np.abs(g - r).max() / scale)


def scene_camera(name, w, h):
    scene, cs = book_scenes.SCENES[name]()
    cam = camera.make_camera(cs.origin, cs.look_at, cs.up, cs.vertical_fov,
                             w / h, aperture=cs.aperture,
                             focus_distance=cs.focus_distance)
    return scene, cam


def test_render_image_gradient_equals_sample_batch_diff():
    w, spp, depth, seed = 12, 2, 4, 123
    n = w * w
    scene, cam = scene_camera("three_spheres", w, w)
    target = torch.full((n, 3), 0.5)

    centers = scene.spheres.center.clone().requires_grad_()
    img = renderer.render_image(
        params_mod.set_sphere_centers(scene, centers), cam, width=w,
        height=w, samples_per_pixel=spp, trace_depth=depth, seed=seed,
        differentiable=True)
    torch.mean((img.color - target) ** 2).backward()

    centers2 = scene.spheres.center.clone().requires_grad_()
    records = megatrace.pack_sphere_records(scene,
                                            materials.pack_materials(scene))
    d = mr.sample_batch_diff(
        torch.full((n,), spp, dtype=torch.int32), torch.zeros(n),
        megatrace.pack_camera_row(cam, w, w), centers2, scene.spheres.radius,
        records, scene.environment.sky_bottom, scene.environment.sky_top,
        seed, samples=spp, trace_depth=depth,
        has_dielectrics=scene.flags.has_dielectrics)
    count = d["count"]
    color = torch.where((count == 0)[:, None], 0.0,
                        d["color"] / torch.clamp(count, min=1.0)[:, None])
    torch.mean((color - target) ** 2).backward()
    assert float(centers.grad.abs().max()) > 0
    torch.testing.assert_close(centers.grad, centers2.grad, rtol=1e-6,
                               atol=1e-9)


@pytest.mark.parametrize("aov", ["normal", "albedo"])
def test_aov_loss_is_refused(aov):
    """A loss on an AOV used to be refused (NotImplementedError naming
    ROADMAP step 9); the wavefront graft now gives it a gradient, finite
    and nonzero, and the low-level sample_batch_diff still refuses AOV
    cotangents it cannot propagate."""
    scene, cam = scene_camera("three_spheres", 8, 8)
    centers = scene.spheres.center.clone().requires_grad_()
    img = renderer.render_image(
        params_mod.set_sphere_centers(scene, centers), cam, width=8,
        height=8, samples_per_pixel=1, trace_depth=3, seed=1)
    runs = renderer.AOV_GRAFT_RUNS
    getattr(img, aov).sum().backward()
    assert renderer.AOV_GRAFT_RUNS == runs + 1
    assert bool(torch.isfinite(centers.grad).all())
    assert float(centers.grad.abs().max()) > 0
    records = megatrace.pack_sphere_records(scene,
                                            materials.pack_materials(scene))
    c2 = scene.spheres.center.clone().requires_grad_()
    d = mr.sample_batch_diff(
        torch.full((64,), 1, dtype=torch.int32), torch.zeros(64),
        megatrace.pack_camera_row(cam, 8, 8), c2, scene.spheres.radius,
        records, scene.environment.sky_bottom, scene.environment.sky_top, 1,
        samples=1, trace_depth=3)
    with pytest.raises(NotImplementedError, match="AOV graft"):
        d[aov].sum().backward()


def test_forward_outputs_unchanged_without_grad():
    """The default differentiable=True gives the forward path's outputs,
    accumulators and metrics when no input requires grad."""
    w = 12
    scene, cam = scene_camera("three_spheres", w, w)
    results = []
    for differentiable in (True, False):
        acc = film.zero_accumulators(w * w)
        _, m = renderer.render_batch(
            scene, cam, acc, width=w, height=w, samples=2, trace_depth=4,
            seed=77, differentiable=differentiable)
        results.append((acc, m))
    (acc_d, m_d), (acc_f, m_f) = results
    for k in ("color", "sample_count", "normal", "albedo", "weight",
              "fallback_normal", "fallback_albedo"):
        assert torch.equal(getattr(acc_d, k), getattr(acc_f, k)), k
        assert not getattr(acc_d, k).requires_grad
    assert torch.equal(m_d.pixel_rays, m_f.pixel_rays)
    img = renderer.render_image(scene, cam, width=w, height=w,
                                samples_per_pixel=2, trace_depth=4, seed=3)
    ref = renderer.render_image(scene, cam, width=w, height=w,
                                samples_per_pixel=2, trace_depth=4, seed=3,
                                differentiable=False)
    assert torch.equal(img.color, ref.color)


def _masked_loss(leaf):
    w = 16
    n = w * w
    scene, cam = scene_camera("three_spheres", w, w)
    records = megatrace.pack_sphere_records(scene,
                                            materials.pack_materials(scene))
    mask = torch.zeros((w, w))
    mask[6:10, 6:10] = 1.0  # inside the center sphere's silhouette
    mask = mask.reshape(-1)

    def loss(x):
        centers = x if leaf == "centers" else scene.spheres.center
        radii = x if leaf == "radii" else scene.spheres.radius
        out = mr.sample_batch_diff(
            torch.full((n,), 4, dtype=torch.int32), torch.zeros(n),
            megatrace.pack_camera_row(cam, w, w), centers, radii, records,
            scene.environment.sky_bottom, scene.environment.sky_top, 5,
            samples=4, trace_depth=4,
            has_dielectrics=scene.flags.has_dielectrics, jitter=False)
        img = out["color"] / torch.clamp(out["count"], min=1.0)[:, None]
        return torch.sum(torch.sum(img**2, dim=-1) * mask) / mask.sum()

    x0 = scene.spheres.center if leaf == "centers" else scene.spheres.radius
    return loss, x0.numpy()


@pytest.mark.parametrize("leaf", ["centers", "radii"])
def test_gradients_match_finite_differences(leaf):
    loss, x0 = _masked_loss(leaf)
    report = gradcheck.check_grads(loss, x0, eps=1e-3, rtol=0.15, atol=2e-3)
    assert report["cosine"] > 0.99, report
    assert report["rel_err"] < 0.15, report


@pytest.mark.cuda
def test_cuda_backward_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from raytracing_in_one_weekend_tpu_torch.ops import megatrace_bwd

    dev = torch.device("cuda")
    w, seed = 32, 21
    n = w * w
    scene, tables = port_tables("cover", w)
    tables = [t.to(dev) for t in tables]
    # depth 35 runs paths longer than any at depth 8
    for spp, depth in ((4, 8), (2, 35)):
        lane_count = torch.full((n,), spp, dtype=torch.int32, device=dev)
        kw = dict(samples=spp, trace_depth=depth,
                  has_dielectrics=scene.flags.has_dielectrics, sky_on=True)
        leaves = [t.detach().clone().requires_grad_() for t in tables]
        out = mr.sample_batch_diff(lane_count, torch.zeros(n, device=dev),
                                   *leaves, seed, **kw)
        before = megatrace_bwd.LAUNCHES
        got = torch.autograd.grad(probe_loss(out["color"], out["count"]),
                                  leaves)
        assert megatrace_bwd.LAUNCHES == before + 1
        # the plain version on the card: autograd over the replay of the
        # same tape, whose primal is the kernel's
        tape = megatrace.sample_batch(lane_count, torch.zeros(n, device=dev),
                                      *tables, seed, want_tape=True,
                                      **kw)["tape"]
        plain = [t.detach().clone().requires_grad_() for t in tables]
        csum, cnt = mr.replay(tape, lane_count, *plain, seed, **kw)
        assert torch.equal(csum.detach(), out["color"].detach())
        want = torch.autograd.grad(probe_loss(csum, cnt), plain)
        for name, g, r in zip(LEAVES, got, want):
            scale = float(r.abs().max())
            assert float((g - r).abs().max()) <= GRAD_TOL * scale, (depth,
                                                                    name)
