"""The per-ray fused trace's plain version against the JAX kernel.

JAX side: pallas_megatrace.megatrace(..., interpret=True, hw_prng=False),
the Pallas `_kernel` run in interpret mode on the CPU with the hash PRNG.
Port side: ops.megatrace.megatrace on CPU tensors, its plain version.
Both take the same camera rays (made by the JAX camera from a fixed key)
and the same seed, and draw the same random numbers.

Criterion, per lane (tests/test_torch_megatrace.py's): valid and
pixel_rays identical and every float output within atol=rtol=1e-4 on
>= 99% of lanes.  A lane can leave the JAX kernel's path by one float
rounding in the sphere quadratic, which expands |o - c|^2 and cancels most
of its bits, so a share below 1 is rounding, not a fault.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_in_one_weekend_tpu.core import camera as jax_camera
from raytracing_in_one_weekend_tpu.core import materials as jax_materials
from raytracing_in_one_weekend_tpu.models import book_scenes as jax_scenes
from raytracing_in_one_weekend_tpu.ops import pallas_megatrace
from raytracing_in_one_weekend_tpu_torch.core import materials
from raytracing_in_one_weekend_tpu_torch.models import book_scenes
from raytracing_in_one_weekend_tpu_torch.ops import megatrace

TOL = dict(atol=1e-4, rtol=1e-4)
LANE_SHARE = 0.99
FLOATS = ("radiance", "aov_normal", "aov_albedo", "events")


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


def camera_rays(name, w, h, seed):
    """(origin, direction, active) numpy arrays of one jittered camera
    sample per pixel, with every seventh lane masked off."""
    scene, cs = jax_scenes.SCENES[name]()
    cam = jax_camera.make_camera(cs.origin, cs.look_at, cs.up,
                                 cs.vertical_fov, w / h,
                                 aperture=cs.aperture,
                                 focus_distance=cs.focus_distance)
    key = jax.random.PRNGKey(seed)
    coords = jax_camera.pixel_coords(w, h, key, True)
    rays = jax_camera.generate_rays(cam, coords, key)
    active = np.arange(w * h) % 7 != 3
    return (scene, np.asarray(rays.origin), np.asarray(rays.direction),
            active)


def run_both(name, w, h, depth, seed):
    jscene, o, d, active = camera_rays(name, w, h, seed)
    jrec = jax_materials.pack_materials(jscene)[jscene.spheres.material][
        :, :11]
    want = pallas_megatrace.megatrace(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(active),
        jscene.spheres.center, jscene.spheres.radius, jrec,
        jscene.environment.sky_bottom, jscene.environment.sky_top,
        jnp.int32(seed), trace_depth=depth,
        has_dielectrics=jscene.flags.has_dielectrics, sky_on=True,
        interpret=True, hw_prng=False,
    )
    scene, _ = book_scenes.SCENES[name]()
    rec = materials.pack_materials(scene)[scene.spheres.material.long()][
        :, :11]
    got = megatrace.megatrace(
        torch.tensor(o), torch.tensor(d), torch.tensor(active),
        scene.spheres.center, scene.spheres.radius, rec,
        scene.environment.sky_bottom, scene.environment.sky_top, seed,
        trace_depth=depth, has_dielectrics=scene.flags.has_dielectrics,
        sky_on=True,
    )
    return ({k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()}, active)


def lanes_equal(got, want):
    same = (got["valid"] == want["valid"]) & (
        got["pixel_rays"] == want["pixel_rays"])
    for k in FLOATS:
        close = np.isclose(got[k], want[k], **TOL)
        same &= close.all(axis=-1) if close.ndim == 2 else close
    return same


@pytest.mark.parametrize("name,w,h,depth,seed", [
    ("three_spheres", 64, 32, 4, 3),
    ("three_spheres", 64, 32, 8, 4),
    ("cover", 64, 32, 4, 5),
    ("cover", 64, 32, 8, 6),
])
def test_plain_version_matches_jax_kernel(name, w, h, depth, seed):
    got, want, active = run_both(name, w, h, depth, seed)
    share = lanes_equal(got, want).mean()
    assert share >= LANE_SHARE, share
    # masked lanes cast nothing and stay invalid, on both sides
    assert not got["valid"][~active].any()
    assert (got["pixel_rays"][~active] == 0).all()
    assert got["valid"].mean() > 0.5
    assert np.abs(got["pixel_rays"].sum() - want["pixel_rays"].sum()) <= (
        0.01 * want["pixel_rays"].sum())


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    scene, _ = book_scenes.SCENES["cover"]()
    scene = scene.to(dev)
    rec = materials.pack_materials(scene)[scene.spheres.material.long()][
        :, :11]
    g = torch.Generator().manual_seed(0)
    n = 4096
    o = (torch.randn((n, 3), generator=g) * 0.5 + torch.tensor(
        [13.0, 2.0, 3.0])).to(dev)
    d = torch.nn.functional.normalize(
        torch.tensor([-13.0, -2.0, -3.0]) + torch.randn((n, 3), generator=g),
        dim=1).to(dev)
    active = (torch.arange(n) % 5 != 0).to(dev)
    args = (o, d, active, scene.spheres.center, scene.spheres.radius, rec,
            scene.environment.sky_bottom, scene.environment.sky_top, 9)
    before = megatrace.WAVE_LAUNCHES
    got = megatrace.megatrace(*args, trace_depth=8)
    assert megatrace.WAVE_LAUNCHES == before + 1
    want = megatrace.megatrace_reference(*args, trace_depth=8)
    got = {k: v.cpu().numpy() for k, v in got.items()}
    want = {k: v.cpu().numpy() for k, v in want.items()}
    assert lanes_equal(got, want).mean() >= LANE_SHARE
