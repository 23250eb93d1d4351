"""The batch kernel's triangle arm: the plain version against the JAX
batch kernel on mesh scenes.

JAX side: pallas_megatrace.sample_batch(..., tri_tables=pack_tri_tables,
interpret=True, hw_prng=False, want_tape=True).  Port side:
ops.megatrace.sample_batch on CPU tensors with the port's pack_tri_tables,
the plain version.  Scenes: the one-block mesh of tests/test_megakernel.py
:322 (a ground sphere, icosphere(1) and a cube: 92 triangles, one
TRI_BLOCK) and a two-block mesh (icosphere(2) and a cube: 332 triangles,
T_pad 384, two blocks).

Criterion, as tests/test_torch_megatrace.py: the winner tape identical on
>= 99% of lanes; on those lanes count and rays exactly equal and every
float channel, the normal AOVs included, within atol=rtol=1e-4 on >= 99%
of lanes.  Measured: tapes identical on every lane of both cases, the
largest error 7.9e-6 (color) and 9.5e-7 (normal): the triangle normal's
rsqrt shows none of the cover's XLA rsqrt gap (ROADMAP §3) here.
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

TOL = dict(atol=1e-4, rtol=1e-4)
LANE_SHARE = 0.99
FLOAT_CHANNELS = ("color", "normal", "albedo", "weight", "fallback_normal",
                  "fallback_albedo")
CAMERA = dict(origin=(0.0, 2.0, 6.0), look_at=(0.0, 0.7, 0.0),
              vertical_fov=35.0, focus_distance=6.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process (tests/test_torch_integrator.py):
    the tier-1 run puts six of them on the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def mesh_scene(mod, meshes_mod, subdivisions):
    """tests/test_megakernel.py:322's mesh scene, icosphere(subdivisions)."""
    b = mod.SceneBuilder()
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, b.lambert((0.5, 0.5, 0.5)))
    v, f, n, _ = meshes_mod.icosphere(subdivisions)
    b.add_mesh(v, f, b.metal((0.8, 0.7, 0.5), glossiness=0.9),
               normals=n, translation=(-1.2, 1.0, 0.0))
    v, f, _, _ = meshes_mod.cube()
    b.add_mesh(v, f, b.lambert((0.8, 0.3, 0.2)),
               translation=(1.2, 0.5, 0.0), face_normals=True)
    b.set_gradient_sky()
    return b.build()


def port_tables(scene, w, h):
    cam = camera.make_camera(CAMERA["origin"], CAMERA["look_at"], (0, 1, 0),
                             CAMERA["vertical_fov"], w / h, aperture=0.0,
                             focus_distance=CAMERA["focus_distance"],
                             device=scene.spheres.center.device)
    packed = materials.pack_materials(scene)
    return (megatrace.pack_camera_row(cam, w, h), scene.spheres.center,
            scene.spheres.radius, megatrace.pack_sphere_records(scene, packed),
            scene.environment.sky_bottom, scene.environment.sky_top), \
        megatrace.pack_tri_tables(scene, packed)


def jax_tables(scene, w, h):
    cam = jax_camera.make_camera(CAMERA["origin"], CAMERA["look_at"],
                                 (0, 1, 0), CAMERA["vertical_fov"], w / h,
                                 aperture=0.0,
                                 focus_distance=CAMERA["focus_distance"])
    packed = jax_materials.pack_materials(scene)
    return (pallas_megatrace.pack_camera_row(cam, w, h), scene.spheres.center,
            scene.spheres.radius,
            pallas_megatrace.pack_sphere_records(scene, packed),
            scene.environment.sky_bottom, scene.environment.sky_top), \
        pallas_megatrace.pack_tri_tables(scene, packed)


CASES = {
    # name: (icosphere subdivisions, size, spp, depth, seed)
    "one_block": (1, 24, 4, 6, 3),
    "two_blocks": (2, 24, 2, 4, 5),
}


@pytest.fixture(scope="module")
def runs():
    """Each case's JAX interpret-mode outputs, made once for the module,
    and the port's plain-version outputs on the same inputs."""
    out = {}
    for name, (sub, size, spp, depth, seed) in CASES.items():
        n = size * size
        lane_count = np.full(n, spp, np.int32)
        js = mesh_scene(jax_scene_mod, jax_meshes, sub)
        jt, jtri = jax_tables(js, size, size)
        kw = dict(samples=spp, trace_depth=depth, sky_on=True,
                  has_dielectrics=js.flags.has_dielectrics)
        want = pallas_megatrace.sample_batch(
            jnp.asarray(lane_count), jnp.zeros(n), *jt, jnp.int32(seed),
            tri_tables=jtri, interpret=True, hw_prng=False, want_tape=True,
            **kw)
        ts = mesh_scene(scene_mod, meshes, sub)
        tt, ttri = port_tables(ts, size, size)
        got = megatrace.sample_batch(
            torch.from_numpy(lane_count), torch.zeros(n), *tt, seed,
            tri_tables=ttri, want_tape=True, **kw)
        out[name] = (ts, ttri, {k: v.numpy() for k, v in got.items()},
                     {k: np.asarray(v) for k, v in want.items()})
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_jax_kernel(runs, case):
    ts, tri_tables, got, want = runs[case]
    t_pad = tri_tables[0].shape[0]
    assert t_pad == (128 if case == "one_block" else 384)
    same = np.all(got["tape"] == want["tape"], axis=0)
    assert same.mean() >= LANE_SHARE, same.mean()
    # triangle winners are on the tape, in the combined row space
    s_pad = megatrace.sphere_pad_count(ts.spheres.center.shape[0])
    tri_codes = got["tape"][got["tape"] >= s_pad] - s_pad
    assert tri_codes.size > 0 and tri_codes.max() < ts.triangles.vert0.shape[0]
    if case == "two_blocks":
        assert (tri_codes >= megatrace.TRI_BLOCK).any()
        assert (tri_codes < megatrace.TRI_BLOCK).any()
    np.testing.assert_array_equal(got["count"][same], want["count"][same])
    np.testing.assert_array_equal(got["rays"][same], want["rays"][same])
    for k in FLOAT_CHANNELS:
        close = np.isclose(got[k], want[k], **TOL)
        close = close.all(axis=-1) if close.ndim == 2 else close
        assert close[same].mean() >= LANE_SHARE, (k, close[same].mean())


def test_triangle_arm_changes_nothing_in_sphere_only_lanes(runs):
    """The sphere sweep runs first and a triangle wins only with a
    strictly smaller t: with the triangles removed, the lanes whose tape
    never names a triangle trace the same paths."""
    ts, tri_tables, got, _ = runs["one_block"]
    sub, size, spp, depth, seed = CASES["one_block"]
    tt, _ = port_tables(ts, size, size)
    n = size * size
    bare = megatrace.sample_batch(
        torch.full((n,), spp, dtype=torch.int32), torch.zeros(n), *tt, seed,
        samples=spp, trace_depth=depth, want_tape=True,
        has_dielectrics=ts.flags.has_dielectrics)
    s_pad = megatrace.sphere_pad_count(ts.spheres.center.shape[0])
    no_tri = np.all(got["tape"] < s_pad, axis=0)
    assert no_tri.mean() > 0.2
    np.testing.assert_array_equal(bare["tape"].numpy()[:, no_tri],
                                  got["tape"][:, no_tri])
    np.testing.assert_array_equal(bare["color"].numpy()[no_tri],
                                  got["color"][no_tri])


def test_lane_chunks_do_not_change_mesh_results(runs):
    ts, tri_tables, got, _ = runs["two_blocks"]
    sub, size, spp, depth, seed = CASES["two_blocks"]
    tt, _ = port_tables(ts, size, size)
    n = size * size
    chunked = megatrace.sample_batch_reference(
        torch.full((n,), spp, dtype=torch.int32), torch.zeros(n), *tt, seed,
        samples=spp, trace_depth=depth, want_tape=True, tri_tables=tri_tables,
        has_dielectrics=ts.flags.has_dielectrics, chunk_lanes=200)
    for k, v in chunked.items():
        np.testing.assert_array_equal(v.numpy(), got[k], err_msg=k)


def test_cuda_wrapper_refuses_bad_tri_tables():
    """On the card the wrapper checks the tables before any build."""
    ts = mesh_scene(scene_mod, meshes, 1)
    tt, (geo, rec) = port_tables(ts, 4, 4)
    with pytest.raises(ValueError, match="tri_tables"):
        megatrace._sample_batch_cuda(
            torch.ones(16), torch.zeros(16), *tt, 1, 0, samples=1,
            trace_depth=1, t_min=0.0, has_dielectrics=False, sky_on=True,
            jitter=True, want_tape=False, tri_tables=(geo[:100], rec))


@pytest.mark.cuda
def test_cuda_triangle_arm_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    scene, _ = meshes.mesh_showcase()
    scene = scene.to(dev)
    tt, tri = port_tables(scene, 64, 64)
    n = 4096
    args = (torch.full((n,), 4, dtype=torch.int32, device=dev),
            torch.zeros(n, device=dev), *tt, 21)
    kw = dict(samples=4, trace_depth=8, want_tape=True, tri_tables=tri)
    before = megatrace.LAUNCHES
    got = megatrace.sample_batch(*args, **kw)
    assert megatrace.LAUNCHES == before + 1
    want = megatrace.sample_batch_reference(*args, **kw)
    same = torch.all(got["tape"] == want["tape"], dim=0)
    assert float(same.float().mean()) >= LANE_SHARE
