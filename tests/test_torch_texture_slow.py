"""Slow checks of the Perlin texture on the wavefront against the JAX
package (each case JAX compiles or runs its wavefront with the 7-octave
turbulence for minutes on the CPU, so they sit outside the fast tier;
their fast siblings are in tests/test_torch_texture.py, the turbulence and
texture sampling, and tests/test_torch_texture_grad.py, the sampling's
gradient).

* `integrator.trace` (the general arm, differentiable) on `perlin`
  against JAX's wavefront: valid and ray counts identical and the floats
  within 1e-3 on >= 99% of lanes.
* `perlin` trains through the wavefront (the replay has no marble, as
  JAX's): the differentiable `integrator.trace`'s gradient of a probe loss
  with respect to the texture colours against jax.grad of JAX's (run op by
  op: its jit compile takes many minutes), within 1e-3 of its max abs and
  cosine >= 0.9999.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_in_one_weekend_tpu.core import camera as jax_camera
from raytracing_in_one_weekend_tpu.models import testbeds as jax_testbeds
from raytracing_in_one_weekend_tpu.render import integrator as jax_integrator
from raytracing_in_one_weekend_tpu_torch.core import rng
from raytracing_in_one_weekend_tpu_torch.core.ray import Rays
from raytracing_in_one_weekend_tpu_torch.models import testbeds
from raytracing_in_one_weekend_tpu_torch.render import integrator

pytestmark = pytest.mark.slow

JAX_COSINE = 0.9999


def test_perlin_trace_matches_jax():
    from test_torch_texture import test_trace_matches_jax

    test_trace_matches_jax("perlin", True)


def test_perlin_wavefront_gradient_matches_jax():
    w, h, depth, seed = 12, 8, 3, 5
    n = w * h
    js, cs = jax_testbeds.SCENES["perlin"]()
    cam = jax_camera.make_camera(cs.origin, cs.look_at, cs.up,
                                 cs.vertical_fov, w / h)
    key = jax.random.PRNGKey(seed)
    rays = jax_camera.generate_rays(
        cam, jax_camera.pixel_coords(w, h, key, True), key)
    probe = np.cos(np.arange(n * 3, dtype=np.float32).reshape(n, 3) * 0.37)

    def jax_loss(main):
        scene = js._replace(textures=js.textures._replace(main_color=main))
        out = jax_integrator.trace(scene, rays, key, depth)
        return jnp.sum(out.radiance * probe)

    # op by op: jit-compiling the gradient of JAX's wavefront with the
    # turbulence in its bounce takes many minutes on the CPU
    with jax.disable_jit():
        want = np.asarray(jax.grad(jax_loss)(js.textures.main_color))
    scene, _ = testbeds.SCENES["perlin"]()
    main = scene.textures.main_color.clone().requires_grad_()
    textured = dataclasses.replace(scene, textures=dataclasses.replace(
        scene.textures, main_color=main))
    out = integrator.trace(
        textured, Rays(*(torch.tensor(np.asarray(v)) for v in
                         (rays.origin, rays.direction, rays.time))),
        rng.PRNGKey(seed), depth, differentiable=True)
    (got,) = torch.autograd.grad(
        torch.sum(out.radiance * torch.from_numpy(probe)), (main,))
    got = got.numpy()
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got - want).max() <= 1e-3 * scale, (
        np.abs(got - want).max() / scale)
    cosine = (got * want).sum() / np.sqrt((got ** 2).sum()
                                          * (want ** 2).sum())
    assert cosine >= JAX_COSINE


# 128x128, 4 spp: threads run several paths and warps mix path lengths,
# so a thread past its path's end must add no texel (at 32x32 few warps
# mix them)
