"""Rects and boxes beside triangles (ROADMAP step 7.1b): the batch
kernel's plain version against the JAX batch kernel.

JAX side: pallas_megatrace.sample_batch(..., rect_tables=, box_tables=,
tri_tables= or tri_stream_tables=, interpret=True, hw_prng=False), the
triangle build with want_tape=True.  Port side: ops.megatrace.sample_batch
on CPU tensors, the plain version.  Scenes: chip_smoke.mesh_aux_scene's
cornell_mesh (6 rects, 2 boxes, 908 triangles, no sphere) and the same
with a glass sphere, at 16x16, 2 spp, depth 4; and the Cornell box around
an icosphere(4) (5,120 triangles: the streamed tables) on Morton lanes.

Criterion, tests/test_torch_mesh_megatrace.py's: the winner tape identical
on >= 99% of lanes, the triangles' codes at and past s_pad + R_pad + B_pad
among them; on those lanes count and rays equal and every float channel
within atol=rtol=1e-4 on >= 99% of lanes.  The streamed arm has no tape:
count and rays on every lane, the floats on >= 99% of lanes.  Measured:
tapes identical on every lane of both cases, the largest float error
3.6e-7 (no sphere), 6.0e-7 (glass sphere), 2.4e-7 (streamed).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from raytracing_in_one_weekend_tpu.core import camera as jax_camera
from raytracing_in_one_weekend_tpu.core import materials as jax_materials
from raytracing_in_one_weekend_tpu.models import meshes as jax_meshes
from raytracing_in_one_weekend_tpu.ops import pallas_megatrace
from raytracing_in_one_weekend_tpu.scene import scene as jax_scene_mod
from raytracing_in_one_weekend_tpu_torch.core import camera, materials
from raytracing_in_one_weekend_tpu_torch.models import book_scenes, meshes
from raytracing_in_one_weekend_tpu_torch.ops import megatrace
from raytracing_in_one_weekend_tpu_torch.scene import scene as scene_mod

TOL = dict(atol=1e-4, rtol=1e-4)
LANE_SHARE = 0.99
FLOAT_CHANNELS = ("color", "normal", "albedo", "weight", "fallback_normal",
                  "fallback_albedo")
SIZE, SPP, DEPTH = 16, 2, 4
CASES = {"no_sphere": (False, 11), "glass_sphere": (True, 12)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process (tests/test_torch_integrator.py):
    the tier-1 run puts six of them on the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def stream_scene(mod, meshes_mod):
    """The Cornell box around an icosphere(4) on the tall box: 5,120
    triangles, streamed."""
    b = mod.SceneBuilder()
    book_scenes.add_cornell_box(b, mod.axis_angle_quat)
    v, f, n, _ = meshes_mod.icosphere(4)
    b.add_mesh(v, f, b.metal((0.8, 0.7, 0.5), glossiness=0.9), normals=n,
               translation=(-0.35, 0.15, -0.3), scale=0.25)
    return b.build()


def cameras(w, h):
    cs = book_scenes.cornell_box()[1]
    args = (cs.origin, cs.look_at, (0, 1, 0), cs.vertical_fov, w / h)
    kw = dict(aperture=0.0, focus_distance=cs.focus_distance)
    return camera.make_camera(*args, **kw), jax_camera.make_camera(*args,
                                                                   **kw)


def inputs(scene, jscene, w, h):
    """The port's and JAX's sample_batch tables: (camera row, sphere
    tables), (rect, box, tri) pairs and the streamed tables, each side."""
    cam, jcam = cameras(w, h)
    packed = materials.pack_materials(scene)
    jpacked = jax_materials.pack_materials(jscene)
    port = ((megatrace.pack_camera_row(cam, w, h), scene.spheres.center,
             scene.spheres.radius,
             megatrace.pack_sphere_records(scene, packed),
             scene.environment.sky_bottom, scene.environment.sky_top),
            dict(zip(("rect_tables", "box_tables"),
                     megatrace.pack_aux_tables(scene, packed))))
    jax = ((pallas_megatrace.pack_camera_row(jcam, w, h),
            jscene.spheres.center, jscene.spheres.radius,
            pallas_megatrace.pack_sphere_records(jscene, jpacked),
            jscene.environment.sky_bottom, jscene.environment.sky_top),
           dict(zip(("rect_tables", "box_tables"),
                    pallas_megatrace.pack_aux_tables(jscene, jpacked))))
    if scene.triangles.vert0.shape[0] > megatrace.TRI_MAX:
        port[1]["tri_stream_tables"] = megatrace.pack_tri_stream_tables(
            scene, packed)
        jax[1]["tri_stream_tables"] = pallas_megatrace.pack_tri_stream_tables(
            jscene, jpacked)
    else:
        port[1]["tri_tables"] = megatrace.pack_tri_tables(scene, packed)
        jax[1]["tri_tables"] = pallas_megatrace.pack_tri_tables(jscene,
                                                                jpacked)
    return port, jax


def run_pair(scene, jscene, seed, *, morton=False):
    """(port outputs, JAX outputs) as numpy, in lane order."""
    n = SIZE * SIZE
    (targs, tkw), (jargs, jkw) = inputs(scene, jscene, SIZE, SIZE)
    kw = dict(samples=SPP, trace_depth=DEPTH, sky_on=False,
              has_dielectrics=scene.flags.has_dielectrics)
    lane_count = np.full(n, SPP, np.int32)
    tape = not morton
    if morton:
        order, _ = megatrace.morton_order(SIZE, SIZE)
        tkw["pixel_index"] = order
        jkw["pixel_index"] = jnp.asarray(order.numpy().astype(np.int32))
    want = pallas_megatrace.sample_batch(
        jnp.asarray(lane_count), jnp.zeros(n), *jargs, jnp.int32(seed),
        interpret=True, hw_prng=False, want_tape=tape, **jkw, **kw)
    got = megatrace.sample_batch(
        torch.from_numpy(lane_count), torch.zeros(n), *targs, seed,
        want_tape=tape, **tkw, **kw)
    return ({k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()}, tkw)


@pytest.fixture(scope="module")
def runs():
    """Each case's JAX interpret-mode outputs, made once for the module,
    and the port's plain-version outputs on the same inputs."""
    out = {}
    for name, (sphere, seed) in CASES.items():
        scene, _ = chip_smoke.mesh_aux_scene("cornell_mesh", sphere=sphere)
        jscene, _ = chip_smoke.mesh_aux_scene(
            "cornell_mesh", jax_scene_mod, sphere=sphere)
        out[name] = (scene, *run_pair(scene, jscene, seed))
    scene = stream_scene(scene_mod, meshes)
    out["stream"] = (scene, *run_pair(
        scene, stream_scene(jax_scene_mod, jax_meshes), 13, morton=True))
    return out


def assert_floats(got, want, lanes):
    for k in FLOAT_CHANNELS:
        close = np.isclose(got[k], want[k], **TOL)
        close = close.all(axis=-1) if close.ndim == 2 else close
        assert close[lanes].mean() >= LANE_SHARE, (k, close[lanes].mean())


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_jax_kernel(runs, case):
    scene, got, want, kw = runs[case]
    same = np.all(got["tape"] == want["tape"], axis=0)
    assert same.mean() >= LANE_SHARE, same.mean()
    s = scene.spheres.center.shape[0]
    rect_base, box_base = megatrace.aux_code_bases(s, kw["rect_tables"])
    tri_base = megatrace.tri_code_base(s, kw["rect_tables"],
                                       kw["box_tables"])
    assert tri_base == 128 + 8 + 8
    tape = got["tape"]
    # every kind wins somewhere, in the combined row space
    assert ((tape >= rect_base) & (tape < box_base)).any()
    assert ((tape >= box_base) & (tape < tri_base)).any()
    tri_codes = tape[tape >= tri_base] - tri_base
    assert tri_codes.size > 0
    assert tri_codes.max() < scene.triangles.vert0.shape[0]
    assert ((tape >= 0) & (tape < s)).any() == (s > 0)
    np.testing.assert_array_equal(got["count"][same], want["count"][same])
    np.testing.assert_array_equal(got["rays"][same], want["rays"][same])
    assert got["count"].sum() > 0
    assert_floats(got, want, same)


def test_streamed_plain_version_matches_jax_kernel(runs):
    _, got, want, _ = runs["stream"]
    np.testing.assert_array_equal(got["count"], want["count"])
    np.testing.assert_array_equal(got["rays"], want["rays"])
    assert got["count"].sum() > 0
    assert_floats(got, want, np.ones(SIZE * SIZE, bool))


def test_triangles_win_only_when_strictly_nearer(runs):
    """The rects and boxes sweep before the triangles: with the triangles
    removed, the lanes whose tape never names a triangle trace the same
    paths (the plain version, lane by lane)."""
    scene, got, _, kw = runs["no_sphere"]
    tri_base = megatrace.tri_code_base(0, kw["rect_tables"],
                                       kw["box_tables"])
    n = SIZE * SIZE
    cam, _ = cameras(SIZE, SIZE)
    packed = materials.pack_materials(scene)
    bare = megatrace.sample_batch(
        torch.full((n,), SPP, dtype=torch.int32), torch.zeros(n),
        megatrace.pack_camera_row(cam, SIZE, SIZE), scene.spheres.center,
        scene.spheres.radius, megatrace.pack_sphere_records(scene, packed),
        scene.environment.sky_bottom, scene.environment.sky_top, 11,
        rect_tables=kw["rect_tables"], box_tables=kw["box_tables"],
        samples=SPP, trace_depth=DEPTH, sky_on=False, want_tape=True)
    untouched = ~np.any(got["tape"] >= tri_base, axis=0)
    assert 0 < untouched.sum() < n
    np.testing.assert_array_equal(bare["tape"].numpy()[:, untouched],
                                  got["tape"][:, untouched])
    for k in ("color", "count", "rays"):
        np.testing.assert_array_equal(bare[k].numpy()[untouched],
                                      got[k][untouched])
