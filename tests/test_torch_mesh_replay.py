"""The tape replay's triangle arm and its gradient against the JAX
package's, on mesh scenes.

One tape feeds both sides: the port's plain forward with want_tape=True
(equal to the JAX kernel's on mesh scenes,
tests/test_torch_mesh_megatrace.py).  JAX side: megatrace_replay.replay
with tri_tables under jax.vjp; port side: ops/megatrace_replay.replay under
torch.autograd; the same leaves (the six sphere-scene tables plus the
triangle geometry and records), the same probe-loss cotangents
(tests/test_torch_replay.py).  Scenes: tests/test_replay.py's
`_mesh_scene` (icosphere(1) with smooth normals and a face-normal cube)
and `_smooth_triangle_scene` (one triangle with distinct vertex normals,
whose interior vertex gradients are the smooth signal).

Criterion: the port's replay equals its kernel's outputs bit for bit;
the two replays' primals agree within 1e-4 on >= 99% of lanes; with the
cotangent restricted to the agreeing lanes, every leaf's gradient within
GRAD_TOL = 5e-4 of its max abs and a cosine >= 0.9999 (measured: every
lane agrees, errors <= 2.7e-5, cosines 1.000000), and the triangle vertex
and normal leaves nonzero.

The trainer (diff/inverse.optimize) then fits the soup vertices of a
small mesh: finite losses and moved vertices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_in_one_weekend_tpu.core import materials as jax_materials
from raytracing_in_one_weekend_tpu.models import meshes as jax_meshes
from raytracing_in_one_weekend_tpu.ops import megatrace_replay as jax_replay
from raytracing_in_one_weekend_tpu.ops import pallas_megatrace
from raytracing_in_one_weekend_tpu.scene import scene as jax_scene_mod
from raytracing_in_one_weekend_tpu_torch.core import camera, materials
from raytracing_in_one_weekend_tpu_torch.diff import inverse, params
from raytracing_in_one_weekend_tpu_torch.models import meshes
from raytracing_in_one_weekend_tpu_torch.ops import megatrace
from raytracing_in_one_weekend_tpu_torch.ops import megatrace_bwd as mb
from raytracing_in_one_weekend_tpu_torch.ops import megatrace_replay as mr
from raytracing_in_one_weekend_tpu_torch.render import renderer
from raytracing_in_one_weekend_tpu_torch.scene import scene as scene_mod

from test_torch_replay import probe_cotangents

LEAVES = ("camera_row", "centers", "radii", "records", "sky_bottom",
          "sky_top", "tri_geo", "tri_rec")
GRAD_TOL = 5e-4
COSINE = 0.9999


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process (tests/test_torch_integrator.py):
    the tier-1 run puts six of them on the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def mesh_scene(mod, meshes_mod):
    b = mod.SceneBuilder()
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, b.lambert((0.5, 0.5, 0.5)))
    v, f, n, _ = meshes_mod.icosphere(1)
    b.add_mesh(v, f, b.metal((0.8, 0.7, 0.5), glossiness=0.9),
               normals=n, translation=(-1.2, 1.0, 0.0))
    v, f, _, _ = meshes_mod.cube()
    b.add_mesh(v, f, b.lambert((0.8, 0.3, 0.2)),
               translation=(1.2, 0.5, 0.0), face_normals=True)
    b.set_gradient_sky()
    return b.build()


def smooth_triangle_scene(mod, meshes_mod=None):
    b = mod.SceneBuilder()
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, b.lambert((0.1, 0.7, 0.1)))
    v = np.asarray([[-1.5, 0.3, 0.0], [1.5, 0.5, 0.0], [0.0, 2.2, -1.0]],
                   np.float32)
    f = np.asarray([[0, 1, 2]], np.int32)
    n = np.asarray([[0.6, 0.6, 0.52], [-0.6, 0.6, 0.52], [0.0, 0.2, 0.98]],
                   np.float32)
    n = n / np.linalg.norm(n, axis=1, keepdims=True)
    b.add_mesh(v, f, b.lambert((0.8, 0.4, 0.2)), normals=n)
    b.set_gradient_sky()
    return b.build()


SCENES = {"mesh": mesh_scene, "smooth_triangle": smooth_triangle_scene}
CAMERA = dict(origin=(0.0, 2.0, 6.0), look_at=(0.0, 0.9, 0.0), vfov=35.0)


def tables(scene, size, jax_side):
    if jax_side:
        from raytracing_in_one_weekend_tpu.core import camera as jcam
        cam = jcam.make_camera(CAMERA["origin"], CAMERA["look_at"],
                               (0, 1, 0), CAMERA["vfov"], 1.0)
        packed = jax_materials.pack_materials(scene)
        pm = pallas_megatrace
    else:
        cam = camera.make_camera(CAMERA["origin"], CAMERA["look_at"],
                                 (0, 1, 0), CAMERA["vfov"], 1.0)
        packed = materials.pack_materials(scene)
        pm = megatrace
    return ((pm.pack_camera_row(cam, size, size), scene.spheres.center,
             scene.spheres.radius, pm.pack_sphere_records(scene, packed),
             scene.environment.sky_bottom, scene.environment.sky_top),
            pm.pack_tri_tables(scene, packed))


def both_replays(name, size, spp, depth, seed):
    ts = SCENES[name](scene_mod, meshes)
    js = SCENES[name](jax_scene_mod, jax_meshes)
    tt, ttri = tables(ts, size, False)
    jt, jtri = tables(js, size, True)
    for a, b in zip((*jt, *jtri), (*tt, *ttri)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    n = size * size
    lane_count = np.full(n, spp, np.int32)
    kw = dict(samples=spp, trace_depth=depth,
              has_dielectrics=ts.flags.has_dielectrics, sky_on=True)
    out = megatrace.sample_batch(torch.from_numpy(lane_count),
                                 torch.zeros(n), *tt, seed, want_tape=True,
                                 tri_tables=ttri, **kw)
    tape = jnp.asarray(out["tape"].numpy())

    def jax_fn(*leaves):
        return jax_replay.replay(tape, jnp.asarray(lane_count), *leaves[:6],
                                 jnp.int32(seed), tri_tables=leaves[6:],
                                 **kw)

    (jcsum, jcnt), vjp = jax.vjp(jax_fn, *jt, *jtri)
    leaves = [t.detach().clone().requires_grad_() for t in (*tt, *ttri)]
    csum, cnt = mr.replay(out["tape"], torch.from_numpy(lane_count),
                          *leaves[:6], seed, tri_tables=tuple(leaves[6:]),
                          **kw)
    assert torch.equal(csum.detach(), out["color"])
    assert torch.equal(cnt.detach(), out["count"])
    agree = (np.isclose(csum.detach().numpy(), np.asarray(jcsum), atol=1e-4,
                        rtol=1e-4).all(1)
             & (cnt.detach().numpy() == np.asarray(jcnt)))
    return csum, cnt, leaves, vjp, agree, out, ts, kw, lane_count, tt, ttri


@pytest.mark.parametrize("name,size,spp,depth,seed", [
    ("mesh", 12, 2, 4, 3),
    ("smooth_triangle", 12, 2, 4, 5),
])
def test_replay_and_gradient_match_jax(name, size, spp, depth, seed):
    csum, cnt, leaves, vjp, agree, out, ts, *_ = both_replays(
        name, size, spp, depth, seed)
    s_pad = megatrace.sphere_pad_count(ts.spheres.center.shape[0])
    assert bool((out["tape"] >= s_pad).any())  # triangle winners replayed
    assert agree.mean() >= 0.99, agree.mean()
    cot_color, cot_count = probe_cotangents(out["color"].numpy(),
                                            out["count"].numpy())
    cot_color = (cot_color * agree[:, None]).astype(np.float32)
    cot_count = (cot_count * agree).astype(np.float32)
    ported = torch.autograd.grad(
        (csum, cnt), leaves,
        (torch.from_numpy(cot_color), torch.from_numpy(cot_count)))
    ref = vjp((jnp.asarray(cot_color), jnp.asarray(cot_count)))
    t = ts.triangles.vert0.shape[0]
    for leaf, p, r in zip(LEAVES, ported, ref):
        p, r = p.numpy(), np.asarray(r)
        scale = np.abs(r).max()
        if scale == 0.0:
            assert np.abs(p).max() == 0.0, leaf
            continue
        assert np.abs(p - r).max() <= GRAD_TOL * scale, (
            leaf, np.abs(p - r).max() / scale)
        cosine = (p * r).sum() / np.sqrt((p * p).sum() * (r * r).sum())
        assert cosine >= COSINE, (leaf, cosine)
    geo_g = ported[6][:t, :9].abs().max()
    normal_g = ported[7][12:21, :t].abs().max()
    assert float(geo_g) > 0 and float(normal_g) > 0


def test_replay_grad_reference_takes_the_triangle_leaves():
    csum, cnt, leaves, vjp, agree, out, ts, kw, lane_count, tt, ttri = \
        both_replays("smooth_triangle", 8, 2, 3, 9)
    n = lane_count.shape[0]
    cot_color, cot_count = probe_cotangents(out["color"].numpy(),
                                            out["count"].numpy())
    got = mb.replay_grad(out["tape"], torch.from_numpy(lane_count), *tt, 9,
                         torch.from_numpy(cot_color),
                         torch.from_numpy(cot_count), tri_tables=ttri, **kw)
    want = torch.autograd.grad(
        (csum, cnt), leaves,
        (torch.from_numpy(cot_color), torch.from_numpy(cot_count)))
    assert len(got) == len(LEAVES) and n == 64
    for leaf, g, w in zip(LEAVES, got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6, msg=leaf)


def test_render_image_gradient_reaches_the_soup():
    """render_image(differentiable=True) on a mesh scene: the soup's
    vertices take the tape replay's gradient through pack_tri_tables."""
    scene = smooth_triangle_scene(scene_mod)
    cam = camera.make_camera(CAMERA["origin"], CAMERA["look_at"], (0, 1, 0),
                             CAMERA["vfov"], 1.0)
    verts = params.soup_vertices(scene).clone().requires_grad_()
    img = renderer.render_image(params.set_triangle_vertices(scene, verts),
                                cam, width=12, height=12,
                                samples_per_pixel=2, trace_depth=3, seed=4)
    runs = renderer.AOV_GRAFT_RUNS
    torch.mean((img.color - 0.3) ** 2).backward()
    assert renderer.AOV_GRAFT_RUNS == runs  # photometric: no graft
    assert bool(torch.isfinite(verts.grad).all())
    assert float(verts.grad.abs().max()) > 0


def test_optimize_fits_soup_vertices():
    scene = smooth_triangle_scene(scene_mod)
    cam = camera.make_camera(CAMERA["origin"], CAMERA["look_at"], (0, 1, 0),
                             CAMERA["vfov"], 1.0)
    config = inverse.InverseRenderConfig(width=12, height=12,
                                         samples_per_pixel=2, trace_depth=3,
                                         learning_rate=2e-2, steps=3)
    true_verts = params.soup_vertices(scene)
    target = renderer.render_image(scene, cam, width=12, height=12,
                                   samples_per_pixel=8, trace_depth=3,
                                   seed=1, differentiable=False).color
    init = true_verts + torch.tensor([0.0, 0.15, 0.0])
    fitted, losses = inverse.optimize(scene, cam, target,
                                      {"triangle_vertices": init}, config,
                                      seed=2)
    assert len(losses) == 3 and np.isfinite(losses).all()
    moved = (fitted["triangle_vertices"] - init).abs().max()
    assert 0 < float(moved) < 0.2


@pytest.mark.cuda
def test_cuda_backward_triangle_arm_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    scene, _ = meshes.mesh_showcase()
    scene = scene.to(dev)
    cam = camera.make_camera(CAMERA["origin"], CAMERA["look_at"], (0, 1, 0),
                             CAMERA["vfov"], 1.0, device=dev)
    packed = materials.pack_materials(scene)
    tt = (megatrace.pack_camera_row(cam, 64, 64), scene.spheres.center,
          scene.spheres.radius, megatrace.pack_sphere_records(scene, packed),
          scene.environment.sky_bottom, scene.environment.sky_top)
    tri = megatrace.pack_tri_tables(scene, packed)
    n = 64 * 64
    lane_count = torch.full((n,), 4, dtype=torch.int32, device=dev)
    kw = dict(samples=4, trace_depth=8, has_dielectrics=False, sky_on=True,
              tri_tables=tri)
    out = megatrace.sample_batch(lane_count, torch.zeros(n, device=dev),
                                 *tt, 3, want_tape=True, **kw)
    cots = (torch.cos(torch.arange(n * 3, device=dev).reshape(n, 3) * 0.37),
            torch.zeros(n, device=dev))
    before = mb.LAUNCHES
    got = mb.replay_grad(out["tape"], lane_count, *tt, 3, *cots, **kw)
    assert mb.LAUNCHES == before + 1
    want = mb.replay_grad_reference(out["tape"], lane_count, *tt, 3, *cots,
                                    **kw)
    for leaf, g, w in zip(LEAVES, got, want):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 5e-4 * scale, leaf
