"""The batch kernel's streamed-triangle arm: the plain version against the
JAX batch kernel, with Morton lanes.

JAX side: pallas_megatrace.sample_batch(..., pixel_index=morton order,
tri_stream_tables=pack_tri_stream_tables, interpret=True, hw_prng=False),
as tests/test_megakernel.py:556-696 runs it.  Port side:
ops.megatrace.sample_batch on CPU tensors with the port's streamed tables
and the same pixel_index, the plain version (`_tri_stream_sweep`: a
lane's super-block test, then its blocks').  Scene: icosphere(4) over a
ground sphere (tests/test_meshtrace.py::_stream_scene; 5120 triangles, 32
blocks, 2 supers) at 16x16, 4 spp, depth 5, seeds 31 and 7.

Criterion: count and rays identical on every lane; every float channel
within atol=rtol=1e-4 on >= 99% of lanes (measured: every lane, largest
error 5.3e-6 in color).  Deltas are in lane order on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_in_one_weekend_tpu.core import camera as jax_camera
from raytracing_in_one_weekend_tpu.core import materials as jax_materials
from raytracing_in_one_weekend_tpu.models import meshes as jax_meshes
from raytracing_in_one_weekend_tpu.ops import pallas_megatrace
from raytracing_in_one_weekend_tpu.scene import scene as jax_scene_mod
from raytracing_in_one_weekend_tpu_torch.core import camera, materials
from raytracing_in_one_weekend_tpu_torch.models import meshes
from raytracing_in_one_weekend_tpu_torch.ops import megatrace
from raytracing_in_one_weekend_tpu_torch.scene import scene as scene_mod

from test_torch_stream_tables import stream_scene

TOL = dict(atol=1e-4, rtol=1e-4)
LANE_SHARE = 0.99
FLOAT_CHANNELS = ("color", "normal", "albedo", "weight", "fallback_normal",
                  "fallback_albedo")
CAMERA = dict(origin=(0.0, 2.5, 7.0), look_at=(0.0, 0.7, 0.0),
              vertical_fov=35.0, focus_distance=7.0)
SIZE, SPP, DEPTH = 16, 4, 5
SEEDS = (31, 7)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process (tests/test_torch_integrator.py):
    the tier-1 run puts six of them on the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_inputs(scene, w, h):
    """(lane_count, count_in, camera row, sphere tables) in Morton lane
    order, the Morton order, and the streamed tables."""
    dev = scene.spheres.center.device
    cam = camera.make_camera(CAMERA["origin"], CAMERA["look_at"], (0, 1, 0),
                             CAMERA["vertical_fov"], w / h, aperture=0.0,
                             focus_distance=CAMERA["focus_distance"],
                             device=dev)
    packed = materials.pack_materials(scene)
    order, _ = (t.to(dev) for t in megatrace.morton_order(w, h))
    n = w * h
    args = (torch.full((n,), SPP, dtype=torch.int32, device=dev)[order],
            torch.zeros(n, device=dev)[order],
            megatrace.pack_camera_row(cam, w, h), scene.spheres.center,
            scene.spheres.radius, megatrace.pack_sphere_records(scene, packed),
            scene.environment.sky_bottom, scene.environment.sky_top)
    return args, order, megatrace.pack_tri_stream_tables(scene, packed)


@pytest.fixture(scope="module")
def runs():
    """JAX interpret-mode outputs for each seed, made once for the module,
    and the port's plain-version outputs on the same inputs."""
    js = stream_scene(jax_scene_mod, jax_meshes)
    jcam = jax_camera.make_camera(
        CAMERA["origin"], CAMERA["look_at"], (0, 1, 0),
        CAMERA["vertical_fov"], 1.0, aperture=0.0,
        focus_distance=CAMERA["focus_distance"])
    jpacked = jax_materials.pack_materials(js)
    jstream = pallas_megatrace.pack_tri_stream_tables(js, jpacked)
    ts = stream_scene(scene_mod, meshes)
    args, order, stream = port_inputs(ts, SIZE, SIZE)
    jorder = jnp.asarray(order.numpy().astype(np.int32))
    n = SIZE * SIZE
    out = {}
    for seed in SEEDS:
        want = pallas_megatrace.sample_batch(
            jnp.full((n,), SPP, jnp.int32)[jorder], jnp.zeros(n),
            pallas_megatrace.pack_camera_row(jcam, SIZE, SIZE),
            js.spheres.center, js.spheres.radius,
            pallas_megatrace.pack_sphere_records(js, jpacked),
            js.environment.sky_bottom, js.environment.sky_top,
            jnp.int32(seed), pixel_index=jorder, tri_stream_tables=jstream,
            samples=SPP, trace_depth=DEPTH, has_dielectrics=False,
            sky_on=True, interpret=True, hw_prng=False)
        megatrace.TRI_PAIRS = 0
        got = megatrace.sample_batch(
            *args, seed, pixel_index=order, tri_stream_tables=stream,
            samples=SPP, trace_depth=DEPTH, has_dielectrics=False)
        out[seed] = ({k: v.numpy() for k, v in got.items()},
                     {k: np.asarray(v) for k, v in want.items()},
                     megatrace.TRI_PAIRS)
    return ts, args, order, stream, out


@pytest.mark.parametrize("seed", SEEDS)
def test_plain_version_matches_jax_kernel(runs, seed):
    *_, out = runs
    got, want, pairs = out[seed]
    np.testing.assert_array_equal(got["count"], want["count"])
    np.testing.assert_array_equal(got["rays"], want["rays"])
    assert got["count"].sum() > 0
    for k in FLOAT_CHANNELS:
        close = np.isclose(got[k], want[k], **TOL)
        close = close.all(axis=-1) if close.ndim == 2 else close
        assert close.mean() >= LANE_SHARE, (k, close.mean())
    # the culls skip most of the mesh: fewer than a tenth of the 5120
    # triangles tested per bounce
    assert 0 < pairs < 0.1 * 5120 * got["rays"].sum()


def test_tape_is_refused_with_streamed_tables(runs):
    _, args, order, stream, _ = runs
    with pytest.raises(ValueError, match="tape"):
        megatrace.sample_batch(*args, 1, pixel_index=order,
                               tri_stream_tables=stream, samples=1,
                               trace_depth=2, want_tape=True)


def test_lane_chunks_do_not_change_streamed_results(runs):
    _, args, order, stream, out = runs
    got = out[SEEDS[0]][0]
    chunked = megatrace.sample_batch_reference(
        *args, SEEDS[0], pixel_index=order, tri_stream_tables=stream,
        samples=SPP, trace_depth=DEPTH, has_dielectrics=False,
        chunk_lanes=100)
    for k, v in chunked.items():
        np.testing.assert_array_equal(v.numpy(), got[k], err_msg=k)


def test_pixel_index_only_moves_pixels(runs):
    """Lane i keys the hash PRNG and renders pixel_index[i]: an identity
    pixel_index gives the default lanes' deltas, bit for bit."""
    _, args, _, stream, _ = runs
    n = SIZE * SIZE
    kw = dict(samples=2, trace_depth=3, has_dielectrics=False,
              tri_stream_tables=stream)
    plain = megatrace.sample_batch(*args, 5, **kw)
    same = megatrace.sample_batch(*args, 5, pixel_index=torch.arange(n),
                                  **kw)
    for k in plain:
        np.testing.assert_array_equal(plain[k].numpy(), same[k].numpy())


@pytest.mark.cuda
def test_cuda_streamed_arm_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    scene = stream_scene(scene_mod, meshes).to(torch.device("cuda"))
    args, order, stream = port_inputs(scene, 64, 64)
    kw = dict(samples=SPP, trace_depth=8, pixel_index=order,
              tri_stream_tables=stream, has_dielectrics=False)
    before = megatrace.LAUNCHES
    got = megatrace.sample_batch(*args, 21, **kw)
    assert megatrace.LAUNCHES == before + 1
    want = megatrace.sample_batch_reference(*args, 21, **kw)
    same = (got["count"] == want["count"]) & (got["rays"] == want["rays"])
    for k in FLOAT_CHANNELS:
        close = torch.isclose(got[k], want[k], **TOL)
        same &= close.reshape(close.shape[0], -1).all(dim=1)
    assert float(same.float().mean()) >= LANE_SHARE
