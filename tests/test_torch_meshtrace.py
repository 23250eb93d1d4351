"""The bounce-synchronous streamed-mesh sampler (ops/meshtrace.py) against
the JAX package's ops/pallas_meshtrace.py.

* `pair_compact` and `restore`, plain versions, against JAX's
  `_pair_compact` and `_restore` (interpret mode) on seeded random states
  of 2-6 tiles with exactly half the lanes alive and +-0.0 in the
  directions, and across a full alternating compaction schedule.  JAX
  permutes by one-hot products, which turn -0.0 into +0.0 (x * 1 + 0 *
  y); the port moves the bits.  So the outputs are bit-identical once the
  port's -0.0 are read as +0.0, and bit-identical as they are on states
  without -0.0; and the port alone is an exact permutation (restore gives
  its input back bit for bit).
* `sample_batch_sync`, plain, against JAX's `sample_batch_sync(interpret=
  True)` on tests/test_meshtrace.py::_stream_scene at 64x16, 4 spp, depth
  5 (4 tiles, 5120 triangles): per pixel, count and rays identical on
  every pixel, every float channel within atol=rtol=1e-4 on >= 99% of
  pixels (measured: every pixel, largest error 5.5e-6 in color); and
  compact=True against compact=False, bit for bit.
* The renderer: `_stream_scene` takes the batch kernel's streamed arm with
  Morton lanes, or the sync sampler with SYNC_TRI_MIN set to TRI_MAX, and
  `render_batch` matches the JAX renderer's on both routes (16x16, 2 spp,
  depth 3, the same key; count and rays identical, floats within 1e-4 on
  >= 99% of pixels); with something requiring grad it takes the
  differentiable wavefront (8x8), whose gradients are finite.
The cuda-marked tests hold each kernel to its plain version and skip
without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_in_one_weekend_tpu.core import camera as jax_camera
from raytracing_in_one_weekend_tpu.core import materials as jax_materials
from raytracing_in_one_weekend_tpu.models import meshes as jax_meshes
from raytracing_in_one_weekend_tpu.ops import pallas_megatrace
from raytracing_in_one_weekend_tpu.ops import pallas_meshtrace
from raytracing_in_one_weekend_tpu.ops import pallas_sphere
from raytracing_in_one_weekend_tpu.render import film as jax_film
from raytracing_in_one_weekend_tpu.render import renderer as jax_renderer
from raytracing_in_one_weekend_tpu.scene import scene as jax_scene_mod
from raytracing_in_one_weekend_tpu_torch.core import camera, materials, rng
from raytracing_in_one_weekend_tpu_torch.diff import params
from raytracing_in_one_weekend_tpu_torch.models import meshes
from raytracing_in_one_weekend_tpu_torch.ops import megatrace, meshtrace
from raytracing_in_one_weekend_tpu_torch.render import film, renderer
from raytracing_in_one_weekend_tpu_torch.scene import scene as scene_mod

from test_torch_stream_tables import stream_scene

TOL = dict(atol=1e-4, rtol=1e-4)
PIXEL_SHARE = 0.99
FLOAT_CHANNELS = ("color", "normal", "albedo", "weight", "fallback_normal",
                  "fallback_albedo")
CAMERA = dict(origin=(0.0, 2.5, 7.0), look_at=(0.0, 0.7, 0.0),
              vertical_fov=35.0, focus_distance=7.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process (tests/test_torch_integrator.py):
    the tier-1 run puts six of them on the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.uint32)


def plus_zero(x: np.ndarray) -> np.ndarray:
    """x with every -0.0 read as +0.0 (what JAX's one-hot products give)."""
    return np.where(x == 0.0, np.float32(0.0), x)


def random_state(tiles: int, seed: int, signed_zeros: bool = True):
    """A (24, tiles * 1024) state: normal rows, lane ids 0..n-1, exactly
    half the lanes alive, a fifth of the direction components +0.0 and
    (with `signed_zeros`) a fifth -0.0."""
    g = np.random.default_rng(seed)
    n = tiles * meshtrace.RAY_TILE
    state = g.standard_normal((meshtrace.ST_ROWS, n)).astype(np.float32)
    d = state[3:6]
    d[g.random(d.shape) < 0.2] = 0.0
    if signed_zeros:
        d[g.random(d.shape) < 0.2] = -0.0
    alive = np.zeros(n, np.float32)
    alive[g.permutation(n)[:n // 2]] = 1.0
    state[12] = alive
    state[meshtrace.LANE_ROW] = np.arange(n, dtype=np.float32)
    return state


@pytest.mark.parametrize("tiles", [2, 3, 4, 5, 6])
def test_pair_compact_and_restore_match_jax(tiles):
    state = random_state(tiles, 40 + tiles)
    want = np.asarray(pallas_meshtrace._pair_compact(jnp.asarray(state),
                                                     interpret=True))
    got = meshtrace.pair_compact(torch.from_numpy(state)).numpy()
    pairs = tiles // 2 * meshtrace.PAIR  # a last odd tile stays as it is
    np.testing.assert_array_equal(bits(plus_zero(got[:, :pairs])),
                                  bits(want[:, :pairs]))
    np.testing.assert_array_equal(bits(got[:, pairs:]), bits(state[:, pairs:]))
    np.testing.assert_array_equal(bits(want[:, pairs:]),
                                  bits(state[:, pairs:]))
    assert np.signbit(got[3:6]).sum() == np.signbit(state[3:6]).sum()
    # live lanes first in each pair (octant classes), then the dead
    alive = got[12, :pairs].reshape(-1, meshtrace.PAIR)
    assert (np.diff(alive, axis=1) <= 0).all()
    assert not np.array_equal(got[meshtrace.LANE_ROW],
                              state[meshtrace.LANE_ROW])
    # the port restores its own input bit for bit; JAX's restore of JAX's
    # compaction equals it where JAX kept the sign of zero
    back = meshtrace.restore(torch.from_numpy(got)).numpy()
    np.testing.assert_array_equal(bits(back), bits(state))
    want_back = np.asarray(pallas_meshtrace._restore(jnp.asarray(want),
                                                     interpret=True))
    np.testing.assert_array_equal(bits(plus_zero(back)), bits(want_back))
    # without -0.0 in the state, no reading is needed
    plain = random_state(tiles, 50 + tiles, signed_zeros=False)
    want = np.asarray(pallas_meshtrace._pair_compact(jnp.asarray(plain),
                                                     interpret=True))
    got = meshtrace.pair_compact(torch.from_numpy(plain)).numpy()
    np.testing.assert_array_equal(bits(got), bits(want))


def test_pair_compact_is_identity_below_a_pair():
    state = torch.from_numpy(random_state(1, 3))
    np.testing.assert_array_equal(bits(meshtrace.pair_compact(state)),
                                  bits(state))


def jax_compact_pass(state, b):
    """pallas_meshtrace.sample_batch_sync's compaction after bounce b
    (:540-563), which the JAX module keeps inline."""
    n_pad, t = state.shape[1], pallas_megatrace.RAY_TILE
    if b % 2 == 0 or n_pad < 3 * t:
        return pallas_meshtrace._pair_compact(state, True)
    inner = (n_pad // t - 1) // 2 * 2 * t
    return jnp.concatenate(
        [state[:, :t], pallas_meshtrace._pair_compact(state[:, t:t + inner],
                                                      True),
         state[:, t + inner:]], axis=1)


@pytest.mark.parametrize("tiles", [5, 8])
def test_alternating_schedule_matches_jax(tiles):
    """Eight compaction passes with lanes dying and turning between them
    (the same changes, by lane id, on both sides), then the restore."""
    g = np.random.default_rng(tiles)
    state = random_state(tiles, 60 + tiles, signed_zeros=False)
    n = state.shape[1]
    mine, theirs = torch.from_numpy(state.copy()), jnp.asarray(state)
    die = g.random((8, n)) < 0.25
    turn = g.standard_normal((8, 3, n)).astype(np.float32)
    for b in range(8):
        ids = mine[meshtrace.LANE_ROW].long().numpy()
        np.testing.assert_array_equal(bits(mine), bits(theirs))
        mine[12] *= torch.from_numpy(~die[b][ids]).float()
        mine[3:6] = torch.from_numpy(turn[b][:, ids])
        theirs = jnp.asarray(mine.numpy())
        mine = meshtrace._compact_pass(mine, b)
        theirs = jax_compact_pass(theirs, b)
    np.testing.assert_array_equal(bits(mine), bits(theirs))
    back = meshtrace.restore(mine).numpy()
    np.testing.assert_array_equal(
        bits(back), bits(pallas_meshtrace._restore(theirs, True)))
    np.testing.assert_array_equal(back[meshtrace.LANE_ROW], np.arange(n))


def sync_inputs(mod, meshes_mod, cam_mod, w, h, jax_side: bool):
    scene = stream_scene(mod, meshes_mod)
    kw = dict(aperture=0.0, focus_distance=CAMERA["focus_distance"])
    cam = cam_mod.make_camera(CAMERA["origin"], CAMERA["look_at"],
                              (0, 1, 0), CAMERA["vertical_fov"], w / h, **kw)
    pk = (jax_materials if jax_side else materials).pack_materials(scene)
    ops = pallas_megatrace if jax_side else megatrace
    return scene, cam, (scene.spheres.center, scene.spheres.radius,
                        ops.pack_sphere_records(scene, pk),
                        scene.environment.sky_bottom,
                        scene.environment.sky_top,
                        ops.pack_tri_stream_tables(scene, pk))


SYNC = dict(w=64, h=16, spp=4, depth=5)


def port_sync(**kw):
    w, h = SYNC["w"], SYNC["h"]
    _, cam, tables = sync_inputs(scene_mod, meshes, camera, w, h, False)
    out = meshtrace.sample_batch_sync(
        torch.full((w * h,), SYNC["spp"], dtype=torch.int32),
        torch.zeros(w * h), cam, rng.PRNGKey(1), *tables, width=w,
        height=h, samples=SYNC["spp"], trace_depth=SYNC["depth"],
        has_dielectrics=False, **kw)
    return {k: v.numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def sync_runs():
    w, h = SYNC["w"], SYNC["h"]
    _, cam, tables = sync_inputs(jax_scene_mod, jax_meshes, jax_camera, w, h,
                                 True)
    want = pallas_meshtrace.sample_batch_sync(
        jnp.full((w * h,), SYNC["spp"], jnp.int32), jnp.zeros(w * h), cam,
        jax.random.PRNGKey(1), *tables, width=w, height=h,
        samples=SYNC["spp"], trace_depth=SYNC["depth"],
        has_dielectrics=False, sky_on=True, interpret=True)
    return port_sync(), {k: np.asarray(v) for k, v in want.items()}


def assert_pixels_agree(got: dict, want: dict):
    np.testing.assert_array_equal(got["count"], want["count"])
    np.testing.assert_array_equal(got["rays"], want["rays"])
    for k in FLOAT_CHANNELS:
        close = np.isclose(got[k], want[k], **TOL)
        close = close.all(axis=-1) if close.ndim == 2 else close
        assert close.mean() >= PIXEL_SHARE, (k, close.mean())


def test_sample_batch_sync_matches_jax(sync_runs):
    got, want = sync_runs
    assert got["count"].sum() > 0 and (got["count"] <= SYNC["spp"]).all()
    assert_pixels_agree(got, want)


def test_compaction_changes_no_bit(sync_runs):
    got, _ = sync_runs
    flat = port_sync(compact=False)
    for k in got:
        np.testing.assert_array_equal(bits(flat[k]), bits(got[k]), k)


def render_inputs(w, h):
    scene = stream_scene(scene_mod, meshes)
    cam = camera.make_camera(CAMERA["origin"], CAMERA["look_at"], (0, 1, 0),
                             CAMERA["vertical_fov"], w / h, aperture=0.0,
                             focus_distance=CAMERA["focus_distance"])
    return scene, cam


@pytest.mark.parametrize("route", ["morton_batch", "sync"])
def test_renderer_routes_streamed_mesh_like_jax(monkeypatch, route):
    w = h = 16
    spp, depth = 2, 3
    calls = []
    for mod, name in ((megatrace, "sample_batch"),
                      (meshtrace, "sample_batch_sync")):
        inner = getattr(mod, name)

        def spy(*a, _inner=inner, _name=name, **kw):
            calls.append((_name, kw))
            return _inner(*a, **kw)

        monkeypatch.setattr(mod, name, spy)
    if route == "sync":
        monkeypatch.setattr(meshtrace, "SYNC_TRI_MIN", megatrace.TRI_MAX)
        monkeypatch.setattr(pallas_meshtrace, "SYNC_TRI_MIN",
                            pallas_megatrace.TRI_MAX)
    scene, cam = render_inputs(w, h)
    acc, metrics = renderer.render_batch(
        scene, cam, film.zero_accumulators(w * h), key=rng.PRNGKey(3),
        width=w, height=h, samples=spp, trace_depth=depth)
    assert [c[0] for c in calls] == (["sample_batch_sync"] if route == "sync"
                                     else ["sample_batch"])
    if route == "morton_batch":
        kw = calls[0][1]
        order, _ = megatrace.morton_order(w, h)
        assert torch.equal(kw["pixel_index"], order)
        assert kw["tri_stream_tables"] is not None
        assert kw.get("tri_tables") is None

    js = stream_scene(jax_scene_mod, jax_meshes)
    jcam = jax_camera.make_camera(
        CAMERA["origin"], CAMERA["look_at"], (0, 1, 0),
        CAMERA["vertical_fov"], w / h, aperture=0.0,
        focus_distance=CAMERA["focus_distance"])
    monkeypatch.setattr(pallas_sphere, "use_pallas", lambda: True)
    monkeypatch.setattr(pallas_megatrace, "FORCE_INTERPRET", True)
    monkeypatch.setattr(pallas_meshtrace, "FORCE_INTERPRET", True)
    jacc, jmetrics = jax_renderer.render_batch(
        js, jcam, jax_film.zero_accumulators(w * h), jax.random.PRNGKey(3),
        width=w, height=h, samples=spp, trace_depth=depth,
        differentiable=False)
    got = dict(color=acc.color, count=acc.sample_count, normal=acc.normal,
               albedo=acc.albedo, weight=acc.weight,
               fallback_normal=acc.fallback_normal,
               fallback_albedo=acc.fallback_albedo, rays=metrics.pixel_rays)
    want = dict(color=jacc.color, count=jacc.sample_count, normal=jacc.normal,
                albedo=jacc.albedo, weight=jacc.weight,
                fallback_normal=jacc.fallback_normal,
                fallback_albedo=jacc.fallback_albedo,
                rays=jmetrics.pixel_rays)
    assert_pixels_agree({k: v.detach().numpy() for k, v in got.items()},
                        {k: np.asarray(v) for k, v in want.items()})


def test_differentiable_streamed_mesh_takes_the_wavefront(monkeypatch):
    w = h = 8
    called = []
    for mod, name in ((megatrace, "sample_batch"),
                      (meshtrace, "sample_batch_sync")):
        monkeypatch.setattr(mod, name,
                            lambda *a, _n=name, **k: called.append(_n))
    scene, cam = render_inputs(w, h)
    centers = scene.spheres.center.clone().requires_grad_()
    img = renderer.render_image(
        params.apply_params(scene, {"sphere_centers": centers}), cam,
        width=w, height=h, samples_per_pixel=1, trace_depth=3,
        key=rng.PRNGKey(2))
    torch.mean(img.color).backward()
    assert not called
    assert bool(torch.isfinite(centers.grad).all())
    assert bool(torch.isfinite(img.color).all())


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_permutes_match_plain_versions():
    dev = _cuda()
    for tiles in (2, 3, 4):
        state = torch.from_numpy(random_state(tiles, tiles)).to(dev)
        got = meshtrace.pair_compact(state)
        want = meshtrace.pair_compact_reference(state)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        back = meshtrace.restore(got)
        assert torch.equal(back.view(torch.int32), state.view(torch.int32))


@pytest.mark.cuda
def test_cuda_sync_sampler_matches_plain_version(monkeypatch):
    dev = _cuda()
    w = h = 32
    scene = stream_scene(scene_mod, meshes).to(dev)
    cam = camera.make_camera(CAMERA["origin"], CAMERA["look_at"], (0, 1, 0),
                             CAMERA["vertical_fov"], 1.0, aperture=0.0,
                             focus_distance=CAMERA["focus_distance"],
                             device=dev)
    pk = materials.pack_materials(scene)
    args = (torch.full((w * h,), 4, dtype=torch.int32, device=dev),
            torch.zeros(w * h, device=dev), cam, rng.PRNGKey(1),
            scene.spheres.center, scene.spheres.radius,
            megatrace.pack_sphere_records(scene, pk),
            scene.environment.sky_bottom, scene.environment.sky_top,
            megatrace.pack_tri_stream_tables(scene, pk))
    kw = dict(width=w, height=h, samples=4, trace_depth=6,
              has_dielectrics=False)
    before = meshtrace.SYNC_LAUNCHES
    got = meshtrace.sample_batch_sync(*args, **kw)
    assert meshtrace.SYNC_LAUNCHES == before + 6
    for name in ("bounce_sync", "pair_compact", "restore"):
        monkeypatch.setattr(meshtrace, name,
                            getattr(meshtrace, f"{name}_reference"))
    want = meshtrace.sample_batch_sync(*args, **kw)
    same = (got["count"] == want["count"]) & (got["rays"] == want["rays"])
    assert float(same.float().mean()) >= PIXEL_SHARE
