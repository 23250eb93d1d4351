"""Convex volumes beside triangles (ROADMAP step 7.2b): the batch
kernel's plain version against the JAX batch kernel, and the plain
streamed and VMEM sweeps against the values their block-by-block forms
gave.

JAX side: pallas_megatrace.sample_batch(..., vol0=, tri_tables= or
tri_stream_tables=, rect_tables=, box_tables=, interpret=True,
hw_prng=False), the triangle build with want_tape=True.  Port side:
ops.megatrace.sample_batch on CPU tensors, the plain version.  Scenes:
chip_smoke.mesh_volume_scene's cornell_mesh_volumes (6 rects, a smoke and
a fog box, 908 triangles, the cube inside the fog, no sphere), mesh_fog
(mesh_showcase with a fog sphere around its torus) and mesh_fog_inside
(the camera in that fog: vol0 nonzero), at 16x16, 2 spp, depth 4; and two
streamed scenes on Morton lanes: the volume Cornell box around an
icosphere(4) in its fog box, and a fog sphere around an icosphere(4)
(5,120 triangles each, the streamed tables).

Criterion, tests/test_torch_volume.py's: the winner tape identical on
>= 0.99 of lanes (the free path's log is correctly rounded in the port and
not in XLA, so a scatter point may move by an ulp; tests/test_torch_volume
holds 0.97 on cornell_volumes, whose smoke box lies on the floor), the
triangles' codes among them; on those lanes count and rays equal and every
float channel within atol=rtol=1e-4 on >= 0.99 of them.  The streamed arm
has no tape: count and rays on >= 0.99 of lanes, the floats on those.  A
segment in a medium that ends at a triangle (chip_smoke.medium_ends) is
taken at least once in every case.  Measured: tapes identical on 0.9961
of cornell_mesh_volumes' lanes and on every lane of the other cases, the
largest float error 6.6e-7; 14 to 626 such segments a case.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from raytracing_in_one_weekend_tpu.core import camera as jax_camera
from raytracing_in_one_weekend_tpu.core import materials as jax_materials
from raytracing_in_one_weekend_tpu.models import meshes as jax_meshes
from raytracing_in_one_weekend_tpu.models import testbeds as jax_testbeds
from raytracing_in_one_weekend_tpu.ops import pallas_megatrace
from raytracing_in_one_weekend_tpu.scene import scene as jax_scene_mod
from raytracing_in_one_weekend_tpu_torch.core import camera, materials
from raytracing_in_one_weekend_tpu_torch.models import meshes, testbeds
from raytracing_in_one_weekend_tpu_torch.ops import megatrace
from raytracing_in_one_weekend_tpu_torch.scene import scene as scene_mod

TOL = dict(atol=1e-4, rtol=1e-4)
LANE_SHARE = 0.99
FLOAT_CHANNELS = ("color", "normal", "albedo", "weight", "fallback_normal",
                  "fallback_albedo")
SIZE, SPP, DEPTH = 16, 2, 4
CASES = {"cornell_mesh_volumes": 21, "mesh_fog": 22, "mesh_fog_inside": 23}
STREAM_CASES = {"stream_cornell": 24, "stream_fog": 25}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process (tests/test_torch_integrator.py):
    the tier-1 run puts six of them on the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def stream_scene(name, mod, meshes_mod):
    """An icosphere(4) (5,120 triangles: the streamed tables) inside the
    volume Cornell box's fog box (stream_cornell), or inside a fog sphere
    over a ground sphere (stream_fog)."""
    b = mod.SceneBuilder()
    v, f, n, _ = meshes_mod.icosphere(4)
    if name == "stream_cornell":
        cam = testbeds.add_cornell_volumes(b, mod.axis_angle_quat)
        b.add_mesh(v, f, b.metal((0.8, 0.7, 0.5), glossiness=0.9),
                   normals=n, translation=(0.4, -0.75, 0.25), scale=0.15)
        return b.build(), cam
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, b.lambert((0.5, 0.5, 0.5)))
    b.add_mesh(v, f, b.lambert((0.8, 0.3, 0.2)), normals=n,
               translation=(0.0, 0.6, 0.0), scale=0.5)
    b.add_sphere((0.0, 0.6, 0.0), 1.0, b.volume(1.5, (0.9, 0.9, 0.9)))
    b.set_gradient_sky()
    return b.build(), meshes._mesh_camera(0.6)


def cameras(cs, w, h):
    args = (cs.origin, cs.look_at, cs.up, cs.vertical_fov, w / h)
    kw = dict(aperture=cs.aperture, focus_distance=cs.focus_distance)
    return camera.make_camera(*args, **kw), jax_camera.make_camera(*args,
                                                                   **kw)


def inputs(scene, jscene, cs, w, h):
    """The port's and JAX's sample_batch tables: (camera row, sphere
    tables), (rect, box, tri or streamed tables, vol0), each side."""
    cam, jcam = cameras(cs, w, h)
    packed = materials.pack_materials(scene)
    jpacked = jax_materials.pack_materials(jscene)
    port = ((megatrace.pack_camera_row(cam, w, h), scene.spheres.center,
             scene.spheres.radius,
             megatrace.pack_sphere_records(scene, packed),
             scene.environment.sky_bottom, scene.environment.sky_top),
            dict(zip(("rect_tables", "box_tables"),
                     megatrace.pack_aux_tables(scene, packed)),
                 vol0=megatrace.camera_containment_row(scene, packed,
                                                       cam.origin)))
    jax = ((pallas_megatrace.pack_camera_row(jcam, w, h),
            jscene.spheres.center, jscene.spheres.radius,
            pallas_megatrace.pack_sphere_records(jscene, jpacked),
            jscene.environment.sky_bottom, jscene.environment.sky_top),
           dict(zip(("rect_tables", "box_tables"),
                    pallas_megatrace.pack_aux_tables(jscene, jpacked)),
                vol0=pallas_megatrace.camera_containment_row(
                    jscene, jpacked, jcam.origin)))
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


def run_pair(scene, jscene, cs, seed, *, morton=False):
    """(port outputs, JAX outputs) as numpy, in lane order, the port's
    tables, and the plain run's segments in a medium that end at a
    triangle."""
    n = SIZE * SIZE
    (targs, tkw), (jargs, jkw) = inputs(scene, jscene, cs, SIZE, SIZE)
    kw = dict(samples=SPP, trace_depth=DEPTH, sky_on=scene.flags.sky == 1,
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
    base = megatrace.tri_code_base(scene.spheres.center.shape[0],
                                   tkw["rect_tables"], tkw["box_tables"])
    with chip_smoke.medium_ends(base) as ends:
        got = megatrace.sample_batch(
            torch.from_numpy(lane_count), torch.zeros(n), *targs, seed,
            want_tape=tape, **tkw, **kw)
    return ({k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()}, tkw,
            ends["forward"])


@pytest.fixture(scope="module")
def runs():
    """Each case's JAX interpret-mode outputs, made once for the module,
    and the port's plain-version outputs on the same inputs."""
    out = {}
    for name, seed in CASES.items():
        scene, cs = chip_smoke.mesh_volume_scene(name)
        jscene, _ = chip_smoke.mesh_volume_scene(name, jax_scene_mod)
        out[name] = (scene, *run_pair(scene, jscene, cs, seed))
    for name, seed in STREAM_CASES.items():
        scene, cs = stream_scene(name, scene_mod, meshes)
        jscene, _ = stream_scene(name, jax_scene_mod, jax_meshes)
        out[name] = (scene, *run_pair(scene, jscene, cs, seed, morton=True))
    return out


def assert_floats(got, want, lanes):
    for k in FLOAT_CHANNELS:
        close = np.isclose(got[k], want[k], **TOL)
        close = close.all(axis=-1) if close.ndim == 2 else close
        assert close[lanes].mean() >= LANE_SHARE, (k, close[lanes].mean())


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_jax_kernel(runs, case):
    scene, got, want, kw, ends = runs[case]
    same = np.all(got["tape"] == want["tape"], axis=0)
    assert same.mean() >= LANE_SHARE, same.mean()
    s = scene.spheres.center.shape[0]
    tri_base = megatrace.tri_code_base(s, kw["rect_tables"],
                                       kw["box_tables"])
    tri_codes = got["tape"][got["tape"] >= tri_base] - tri_base
    assert tri_codes.size > 0
    assert tri_codes.max() < scene.triangles.vert0.shape[0]
    # the lanes of a medium: some segment in one ends at a triangle
    assert ends > 0
    assert (float(kw["vol0"][0]) >= 0.0) == (case == "mesh_fog_inside")
    np.testing.assert_array_equal(got["count"][same], want["count"][same])
    np.testing.assert_array_equal(got["rays"][same], want["rays"][same])
    assert got["count"].sum() > 0
    assert_floats(got, want, same)


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_streamed_plain_version_matches_jax_kernel(runs, case):
    _, got, want, _, ends = runs[case]
    same = (got["count"] == want["count"]) & (got["rays"] == want["rays"])
    assert same.mean() >= LANE_SHARE, same.mean()
    assert ends > 0
    assert got["count"].sum() > 0
    assert_floats(got, want, same)


# ---- the plain sweeps: the streamed one (its one-pass form), the VMEM one ---

# recorded from the block-by-block form it replaced, on this case:
# (TRI_PAIRS, SLAB_TESTS, sha256 of its (t, row, u, v) outputs' bytes)
STREAM_SWEEP_PIN = (2668416, 100400, "0d7c9930bf5ae2a577507486cb069608"
                    "50624ff9896a5753bc53fc82f36b80fa")


def test_stream_sweep_keeps_winners_counts_and_bits():
    b = scene_mod.SceneBuilder()
    v, f, n, _ = meshes.icosphere(4)
    b.add_mesh(v, f, b.lambert((0.5, 0.5, 0.5)), normals=n)
    v, f, n, _ = meshes.torus()
    b.add_mesh(v, f, b.lambert((0.2, 0.4, 0.8)), normals=n,
               translation=(1.5, 0.0, 0.0), scale=0.8)
    v, f, n, _ = meshes.icosphere(4)
    b.add_mesh(v, f, b.metal((0.8, 0.7, 0.5), glossiness=0.9), normals=n,
               translation=(-1.2, 0.6, 0.3), scale=0.7)
    scene = b.build()
    stream = megatrace.pack_tri_stream_tables(
        scene, materials.pack_materials(scene))
    assert stream.sup.shape[0] == 4  # four supers: the bound crosses them
    rng = np.random.default_rng(20)
    m = 3000
    o = rng.normal(size=(m, 3)).astype(np.float32) * 3.0
    d = rng.normal(size=(m, 3)).astype(np.float32) * 0.8 - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    best = np.where(rng.random(m) < 0.3, rng.random(m) * 4.0,
                    1e30).astype(np.float32)
    pairs, slabs = megatrace.TRI_PAIRS, megatrace.SLAB_TESTS
    hit = megatrace._tri_stream_sweep(
        tuple(torch.from_numpy(o[:, k].copy()) for k in range(3)),
        tuple(torch.from_numpy(d[:, k].copy()) for k in range(3)),
        torch.from_numpy(best), stream, 1e-3)
    digest = hashlib.sha256()
    for x in hit:
        digest.update(x.numpy().tobytes())
    assert (megatrace.TRI_PAIRS - pairs, megatrace.SLAB_TESTS - slabs,
            digest.hexdigest()) == STREAM_SWEEP_PIN
    # the earlier row on a tie: every winner is the index-order dense
    # sweep's over the same rows
    t, row, _, _ = hit
    rows = stream.geo
    ea, eb, v0 = (tuple(rows[:, k:k + 1] for k in range(c, c + 3))
                  for c in (0, 3, 6))
    o_t = tuple(torch.from_numpy(o[:, k].copy()) for k in range(3))
    d_t = tuple(torch.from_numpy(d[:, k].copy()) for k in range(3))
    dense_t, _, _ = megatrace.moller_trumbore(o_t, d_t, ea, eb, v0, 1e-3)
    dense_min, dense_row = torch.min(dense_t, dim=0)
    won = t < torch.from_numpy(best)
    assert int(won.sum()) > 100
    np.testing.assert_array_equal(t[won].numpy(), dense_min[won].numpy())
    np.testing.assert_array_equal(row[won].numpy(), dense_row[won].numpy())


# the block-by-block VMEM sweep's values on this case: (TRI_PAIRS,
# SLAB_TESTS, sha256 of its (t, row, u, v) outputs' bytes, sha256 of its
# per-block masks of the lanes that swept each block)
VMEM_SWEEP_PIN = (1403648, 27000, "3b93914220bbe4f83033b351bdf2f5a9"
                  "5d3861115ddf041ece10aea931014177",
                  "bbbedbead7c44345585d36a544a5aafc"
                  "2d2010f463dbccedbce61c19fe5db5f6")


def test_vmem_sweep_keeps_winners_counts_and_bits():
    b = scene_mod.SceneBuilder()
    v, f, n, _ = meshes.icosphere(3)
    b.add_mesh(v, f, b.lambert((0.5, 0.5, 0.5)), normals=n)
    v, f, n, _ = meshes.icosphere(2)
    b.add_mesh(v, f, b.lambert((0.2, 0.4, 0.8)), normals=n,
               translation=(1.5, 0.0, 0.0), scale=0.8)
    v, f, _, _ = meshes.cube()
    b.add_mesh(v, f, b.lambert((0.8, 0.3, 0.2)),
               translation=(-1.2, 0.6, 0.3), scale=0.7, face_normals=True)
    scene = b.build()
    geo, _ = megatrace.pack_tri_tables(scene, materials.pack_materials(scene))
    # nine blocks, the last one partial: its pad rows are not counted
    assert geo.shape[0] == 1664 and geo.shape[0] % megatrace.TRI_BLOCK
    rng = np.random.default_rng(21)
    m = 3000
    o = rng.normal(size=(m, 3)).astype(np.float32) * 3.0
    d = rng.normal(size=(m, 3)).astype(np.float32) * 0.8 - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    best = np.where(rng.random(m) < 0.3, rng.random(m) * 4.0,
                    1e30).astype(np.float32)
    pairs, slabs = megatrace.TRI_PAIRS, megatrace.SLAB_TESTS
    tested = []
    hit = megatrace._tri_sweep(
        tuple(torch.from_numpy(o[:, k].copy()) for k in range(3)),
        tuple(torch.from_numpy(d[:, k].copy()) for k in range(3)),
        torch.from_numpy(best), geo, 1e-3, tested)
    digest = hashlib.sha256()
    for x in hit:
        digest.update(x.numpy().tobytes())
    masks = hashlib.sha256(torch.stack(tested).numpy().tobytes())
    assert (megatrace.TRI_PAIRS - pairs, megatrace.SLAB_TESTS - slabs,
            digest.hexdigest(), masks.hexdigest()) == VMEM_SWEEP_PIN
    assert int((hit[0] < torch.from_numpy(best)).sum()) > 1000


# cornell_with_volumes' scene leaves (sha256, in port_leaves' order) as the
# builder gave them before add_cornell_volumes took its body
CORNELL_VOLUMES_PIN = ("fa02aa4a90e90f1fcee0d94d6101d357"
                       "e51087bf5c0cd8995327b375e361c534")


def test_cornell_with_volumes_keeps_its_tables():
    scene, _ = testbeds.cornell_with_volumes()
    digest = hashlib.sha256()
    for group in ("spheres", "rects", "boxes", "triangles", "materials",
                  "textures", "environment"):
        g = getattr(scene, group)
        for field in g.__dataclass_fields__:
            value = getattr(g, field)
            if value is not None:
                digest.update(f"{group}.{field}".encode())
                digest.update(value.numpy().tobytes())
    assert digest.hexdigest() == CORNELL_VOLUMES_PIN
    # and the JAX package's builder, through the shared helper
    jb = jax_scene_mod.SceneBuilder()
    testbeds.add_cornell_volumes(jb, jax_scene_mod.axis_angle_quat)
    want, _ = jax_testbeds.cornell_with_volumes()
    got = jb.build()
    for group in ("rects", "boxes", "materials"):
        for field in getattr(want, group)._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(getattr(got, group), field)),
                np.asarray(getattr(getattr(want, group), field)),
                err_msg=f"{group}.{field}")
