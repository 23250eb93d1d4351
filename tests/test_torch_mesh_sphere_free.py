"""Meshes without spheres (ROADMAP step 7.1b): the sync sampler and the
batch kernel's streamed arm with an empty sphere table, and the
renderer's routes for phase 30's scenes.

* `meshtrace.sample_batch_sync`, plain, against JAX's
  `pallas_meshtrace.sample_batch_sync(interpret=True)` on an icosphere(4)
  alone (5,120 triangles, no sphere, gradient sky) at 8x8, 1 spp, depth
  3: count and rays identical on every pixel, every float channel within
  atol=rtol=1e-4 on >= 99% of pixels (tests/test_torch_meshtrace.py's
  bounds).
* `megatrace.sample_batch` with the streamed tables, plain, against JAX's
  `pallas_megatrace.sample_batch(interpret=True)` on the same soup, Morton
  lanes, the same bounds.
* The renderer's route for chip_smoke.mesh_aux_scene's three scenes against
  the JAX renderer's conditions (its render_batch :347-420,
  megatrace_replay.replay_eligible): the triangle build's table forward,
  the tape replay with rect, box and triangle tables in training and the
  noise tables under a flavor (cornell_mesh); the streamed kernel with the
  rect and box tables on Morton lanes and the pre-drawn rows under a
  flavor (cornell_mesh_large); the sync sampler (mesh_huge_bare), never
  under a flavor.  The kernels are stubbed: the test reads which is
  called, with which tables.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from raytracing_in_one_weekend_tpu.core import camera as jax_camera
from raytracing_in_one_weekend_tpu.core import materials as jax_materials
from raytracing_in_one_weekend_tpu.models import meshes as jax_meshes
from raytracing_in_one_weekend_tpu.ops import megatrace_replay as jax_replay
from raytracing_in_one_weekend_tpu.ops import pallas_megatrace
from raytracing_in_one_weekend_tpu.ops import pallas_meshtrace
from raytracing_in_one_weekend_tpu.scene import scene as jax_scene_mod
from raytracing_in_one_weekend_tpu_torch.core import (
    camera, materials, randomsource, rng,
)
from raytracing_in_one_weekend_tpu_torch.models import meshes
from raytracing_in_one_weekend_tpu_torch.ops import (
    megatrace, megatrace_replay, meshtrace,
)
from raytracing_in_one_weekend_tpu_torch.render import film, renderer
from raytracing_in_one_weekend_tpu_torch.scene import scene as scene_mod
from raytracing_in_one_weekend_tpu_torch.utils.config import NoiseColor

TOL = dict(atol=1e-4, rtol=1e-4)
SHARE = 0.99
FLOAT_CHANNELS = ("color", "normal", "albedo", "weight", "fallback_normal",
                  "fallback_albedo")
CAMERA = dict(origin=(0.0, 0.5, 4.0), look_at=(0.0, 0.0, 0.0),
              vertical_fov=35.0, focus_distance=4.0)
W = H = 8
SPP, DEPTH = 1, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process (tests/test_torch_integrator.py):
    the tier-1 run puts six of them on the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def bare_soup(mod, meshes_mod):
    """An icosphere(4) alone: 5,120 triangles (streamed), no sphere."""
    b = mod.SceneBuilder()
    v, f, n, _ = meshes_mod.icosphere(4)
    b.add_mesh(v, f, b.metal((0.8, 0.7, 0.5), glossiness=0.6), normals=n)
    b.set_gradient_sky()
    return b.build()


def soup_inputs(jax_side: bool):
    mod, mm, cam_mod, pack, ops = (
        (jax_scene_mod, jax_meshes, jax_camera, jax_materials,
         pallas_megatrace) if jax_side
        else (scene_mod, meshes, camera, materials, megatrace))
    scene = bare_soup(mod, mm)
    cam = cam_mod.make_camera(CAMERA["origin"], CAMERA["look_at"], (0, 1, 0),
                              CAMERA["vertical_fov"], W / H, aperture=0.0,
                              focus_distance=CAMERA["focus_distance"])
    pk = pack.pack_materials(scene)
    return scene, cam, (scene.spheres.center, scene.spheres.radius,
                        ops.pack_sphere_records(scene, pk),
                        scene.environment.sky_bottom,
                        scene.environment.sky_top), \
        ops.pack_tri_stream_tables(scene, pk)


@pytest.fixture(scope="module")
def runs():
    """JAX's interpret-mode sync sampler and streamed batch kernel on the
    bare soup, made once for the module, and the port's plain versions."""
    n = W * H
    jscene, jcam, jtables, jstream = soup_inputs(True)
    scene, cam, tables, stream = soup_inputs(False)
    assert scene.spheres.center.shape[0] == 0
    kw = dict(samples=SPP, trace_depth=DEPTH, has_dielectrics=False,
              sky_on=True)
    sync = (meshtrace.sample_batch_sync(
        torch.full((n,), SPP, dtype=torch.int32), torch.zeros(n), cam,
        rng.PRNGKey(3), *tables, stream, width=W, height=H, **kw),
        pallas_meshtrace.sample_batch_sync(
            jnp.full((n,), SPP, jnp.int32), jnp.zeros(n), jcam,
            jax.random.PRNGKey(3), *jtables, jstream, width=W, height=H,
            interpret=True, **kw))
    order, _ = megatrace.morton_order(W, H)
    jorder = jnp.asarray(order.numpy().astype(np.int32))
    streamed = (megatrace.sample_batch(
        torch.full((n,), SPP, dtype=torch.int32), torch.zeros(n),
        megatrace.pack_camera_row(cam, W, H), *tables, 9,
        pixel_index=order, tri_stream_tables=stream, **kw),
        pallas_megatrace.sample_batch(
            jnp.full((n,), SPP, jnp.int32), jnp.zeros(n),
            pallas_megatrace.pack_camera_row(jcam, W, H), *jtables,
            jnp.int32(9), pixel_index=jorder, tri_stream_tables=jstream,
            interpret=True, hw_prng=False, **kw))
    return {name: ({k: v.numpy() for k, v in got.items()},
                   {k: np.asarray(v) for k, v in want.items()})
            for name, (got, want) in (("sync", sync), ("stream", streamed))}


@pytest.mark.parametrize("route", ["sync", "stream"])
def test_sphere_free_soup_matches_jax(runs, route):
    got, want = runs[route]
    assert got["count"].sum() > 0
    # the soup is hit: some lanes bounce more than once
    assert (got["rays"] > SPP).any()
    np.testing.assert_array_equal(got["count"], want["count"])
    np.testing.assert_array_equal(got["rays"], want["rays"])
    for k in FLOAT_CHANNELS:
        close = np.isclose(got[k], want[k], **TOL)
        close = close.all(axis=-1) if close.ndim == 2 else close
        assert close.mean() >= SHARE, (k, close.mean())


def test_plain_bounce_sync_reads_no_sphere_record():
    """bounce_sync's plain version on an empty sphere table: one bounce of
    a few live lanes, finite, the lanes that miss the soup on the sky."""
    scene, cam, tables, stream = soup_inputs(False)
    sph, rec, sky = meshtrace.scene_tables(*tables)
    assert sph.shape == (0, 4) and rec.shape == (0, megatrace.KERNEL_REC)
    state = torch.zeros((meshtrace.ST_ROWS, 4))
    state[0:3] = torch.tensor([0.0, 0.5, 4.0])[:, None]
    state[3:6] = torch.tensor([[0.0, -0.12, -1.0], [0.0, -0.12, -1.0],
                               [0.0, 1.0, 0.0], [0.6, 0.0, -0.8]]).T
    state[6:9] = 1.0
    state[12] = 1.0
    state[meshtrace.LANE_ROW] = torch.arange(4.0)
    out = meshtrace.bounce_sync(state.clone(), 5, 0, 0, (sph, rec, sky),
                                stream)
    assert torch.isfinite(out).all()
    assert out[12, 0] == 1.0 and out[12, 2] == 0.0  # a hit, a miss
    assert out[meshtrace.RAYS_ROW].tolist() == [1.0] * 4


def test_sphere_free_mesh_is_in_scope():
    """A mesh without spheres: no ported path refused it before step
    7.1b; the batch kernel, the replay (at most TRI_MAX triangles) and the
    wavefront take it now."""
    scene = bare_soup(scene_mod, meshes)
    renderer.check_scope(scene)
    assert megatrace.unported_feature(scene) is None
    assert megatrace.scene_eligible(scene, allow_triangles=True,
                                    allow_rect_box=True)
    # the per-ray megatrace stays sphere-only, as JAX's
    assert not megatrace.scene_eligible(scene, allow_triangles=True)
    small, _ = chip_smoke.mesh_aux_scene("cornell_mesh")
    assert megatrace_replay.replay_eligible(small)
    assert not megatrace_replay.replay_eligible(scene)  # streamed


class _Called(Exception):
    pass


def route_of(scene, monkeypatch, *, grad=False, flavor=False):
    """(the entry point render_batch calls for `scene` at 64x64 on the CPU,
    its keyword arguments): the kernels stubbed, the first call raises."""
    seen = {}

    def stub(name):
        def call(*args, **kwargs):
            seen.update(name=name, kwargs=kwargs)
            raise _Called
        return call

    for module, name in ((megatrace, "sample_batch"),
                         (megatrace_replay, "sample_batch_diff"),
                         (meshtrace, "sample_batch_sync"),
                         (renderer, "wavefront_pass")):
        monkeypatch.setattr(module, name, stub(name))
    w = 64  # the blue tile's side divides it: the tables route
    scene = scene.to("cpu")
    if grad:
        scene.rects.pos.requires_grad_(True)
    cam = camera.make_camera((0, 0, 3.2), (0, 0, 0), (0, 1, 0), 40.0, 1.0)
    state = (randomsource.make_noise_state(NoiseColor.BLUE, seed=7)
             if flavor else None)
    with pytest.raises(_Called):
        renderer.render_batch(
            scene, cam, film.zero_accumulators(w * w), seed=1, width=w,
            height=w, samples=2, trace_depth=3, differentiable=grad,
            noise_color=int(NoiseColor.BLUE) if flavor else 0,
            noise_state=state)
    return seen["name"], seen["kwargs"]


def jax_route(jscene) -> str:
    """The JAX renderer's forward route (render_batch :347-420) on a TPU:
    the batch kernel's VMEM triangle arm, its streamed arm, or the sync
    sampler."""
    assert pallas_megatrace.scene_eligible(
        jscene, allow_rect_box=True, allow_volumes=True, allow_motion=True,
        allow_triangles=True, allow_textures=True, allow_cubemap=True)
    tris = jscene.triangles.vert0.shape[0]
    if tris <= pallas_megatrace.TRI_MAX:
        return "tri"
    if (tris > pallas_meshtrace.SYNC_TRI_MIN
            and jscene.rects.rot.shape[0] == 0
            and jscene.boxes.rot.shape[0] == 0):
        return "sync"
    return "stream"


@pytest.mark.parametrize("name", chip_smoke.MESH_AUX_SCENES)
def test_renderer_routes_as_jax(name, monkeypatch):
    scene, _ = chip_smoke.mesh_aux_scene(name)
    jscene, _ = chip_smoke.mesh_aux_scene(name, jax_scene_mod)
    want = jax_route(jscene)
    called, kw = route_of(scene, monkeypatch)
    aux = scene.rects.rot.shape[0] > 0
    if want == "sync":
        assert called == "sample_batch_sync"
    else:
        assert called == "sample_batch"
        assert (kw.get("tri_tables") is not None) == (want == "tri")
        assert (kw.get("tri_stream_tables") is not None) == (want == "stream")
        assert (kw.get("rect_tables") is not None) == aux
        assert (kw.get("box_tables") is not None) == aux
        assert (kw.get("pixel_index") is not None) == (want == "stream")
    # training: the tape replay where JAX's replay takes the scene (the
    # rect, box and triangle tables), else the differentiable wavefront
    assert (megatrace_replay.replay_eligible(scene)
            == bool(jax_replay.replay_eligible(jscene)))
    called, kw = route_of(scene, monkeypatch, grad=True)
    if megatrace_replay.replay_eligible(scene):
        assert called == "sample_batch_diff"
        for k in ("tri_tables", "rect_tables", "box_tables"):
            assert kw[k] is not None, k
    else:
        assert called == "wavefront_pass"
    # a flavor: the noise tables with lanes in pixel order, the pre-drawn
    # rows on Morton lanes; never the sync sampler (JAX :390)
    called, kw = route_of(scene, monkeypatch, flavor=True)
    assert called == "sample_batch"
    if want == "tri":
        assert kw.get("noise_tbl") is not None
    else:
        assert kw.get("noise_uniforms") is not None
        assert kw.get("pixel_index") is not None
