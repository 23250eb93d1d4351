"""The blocked sphere sweep (more than SPH_CULL_MIN spheres) against the
dense one and against the JAX package's blocked sweep.

Setup, the JAX package's own (tests/test_megakernel.py::
TestSphereBlockCull): SPH_CULL_MIN monkeypatched to 4 on both sides, so
that cover_scene(grid=3) (40 spheres) takes the blocked sweep, at 16x16,
3 spp, depth 4; the port's SPH_BLOCK is patched to 8 as well, so that its
sweep culls five blocks (JAX keeps its 256).  One JAX run of each kind is
shared per module.

* pack_sphere_blocks equals JAX's, static and moving, at JAX's block size
  and at 8.
* The port's blocked plain sweep equals its dense plain sweep bit for bit
  (every output row and the tape), static and moving, and culls (its
  SPH_PAIRS below the dense sweep's pairs).
* The port's plain blocked sample_batch against JAX's
  sample_batch(interpret=True, hw_prng=False) with the cull on, and the
  port's tape against JAX's want_tape=True run (JAX's tape run keeps its
  dense sweep), by the bounds of tests/test_torch_megatrace.py: the tape
  identical on >= 99% of lanes, count and rays equal there, floats within
  1e-4 on >= 99% of them (the normal channels on >= 95%, within 1e-2:
  XLA's CPU rsqrt on the cover's small spheres, ROADMAP §3).
* A sphere-only scene of 1,100 spheres takes the per-ray megatrace (the
  `mega` arm) in both packages' integrator.trace: the port's scope once
  refused it (the fault this slice repairs).  At the patched threshold the
  port's plain per-ray megatrace equals JAX's in interpret mode.
* sphere_field is the cover generator at grid 32 in both packages, whose
  builds past SPH_CULL_MIN (grid 16) are equal, and every mix that is
  ROADMAP step 7.7b raises naming it.
* On the card (marked `cuda`): the blocked builds, static and moving,
  and #9's build for big scenes against their plain versions.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_in_one_weekend_tpu.core import camera as jax_camera
from raytracing_in_one_weekend_tpu.core import materials as jax_materials
from raytracing_in_one_weekend_tpu.models import book_scenes as jax_scenes
from raytracing_in_one_weekend_tpu.models import testbeds as jax_testbeds
from raytracing_in_one_weekend_tpu.ops import pallas_megatrace
from raytracing_in_one_weekend_tpu.ops import pallas_sphere
from raytracing_in_one_weekend_tpu.render import integrator as jax_integrator
from raytracing_in_one_weekend_tpu.scene import scene as jax_scene_mod
from raytracing_in_one_weekend_tpu_torch.core import camera, materials, rng
from raytracing_in_one_weekend_tpu_torch.core.ray import Rays
from raytracing_in_one_weekend_tpu_torch.models import book_scenes, testbeds
from raytracing_in_one_weekend_tpu_torch.ops import megatrace
from raytracing_in_one_weekend_tpu_torch.ops import megatrace_bwd
from raytracing_in_one_weekend_tpu_torch.render import integrator
from raytracing_in_one_weekend_tpu_torch.scene import scene as scene_mod

W = 16
SPP, DEPTH, SEED = 3, 4, 99
CULL_MIN, PORT_BLOCK = 4, 8
TOL = dict(atol=1e-4, rtol=1e-4)
FLOAT_CHANNELS = ("color", "normal", "albedo", "weight", "fallback_normal",
                  "fallback_albedo")
LANE_SHARE = 0.99
COVER_NORMAL_SHARE = 0.95  # tests/test_torch_megatrace.py's bounds
COVER_NORMAL_MAX_ERR = 1e-2


def port_args(motion=False, size=W):
    scene, cs = book_scenes.cover_scene(grid=3, motion_blur=motion)
    cam = camera.make_camera(cs.origin, cs.look_at, cs.up, cs.vertical_fov,
                             1.0, aperture=cs.aperture,
                             focus_distance=cs.focus_distance)
    records = megatrace.pack_sphere_records(
        scene, materials.pack_materials(scene))
    n = size * size
    args = (torch.full((n,), SPP, dtype=torch.int32), torch.zeros(n),
            megatrace.pack_camera_row(cam, size, size), scene.spheres.center,
            scene.spheres.radius, records, scene.environment.sky_bottom,
            scene.environment.sky_top, SEED)
    kw = dict(samples=SPP, trace_depth=DEPTH,
              has_dielectrics=scene.flags.has_dielectrics, sky_on=True,
              move_offsets=scene.spheres.move_offset if motion else None)
    return scene, args, kw


def jax_args():
    scene, cs = jax_scenes.cover_scene(grid=3)
    cam = jax_camera.make_camera(cs.origin, cs.look_at, cs.up,
                                 cs.vertical_fov, 1.0, aperture=cs.aperture,
                                 focus_distance=cs.focus_distance)
    records = pallas_megatrace.pack_sphere_records(
        scene, jax_materials.pack_materials(scene))
    n = W * W
    args = (jnp.full((n,), SPP, jnp.int32), jnp.zeros((n,)),
            pallas_megatrace.pack_camera_row(cam, W, W),
            scene.spheres.center, scene.spheres.radius, records,
            scene.environment.sky_bottom, scene.environment.sky_top,
            jnp.int32(SEED))
    kw = dict(samples=SPP, trace_depth=DEPTH,
              has_dielectrics=bool(scene.flags.has_dielectrics),
              sky_on=True, hw_prng=False, interpret=True)
    return args, kw


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's sample_batch with its cull on (no tape) and its tape run (the
    dense sweep), at the patched threshold; numpy dicts."""
    args, kw = jax_args()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas_megatrace, "SPH_CULL_MIN", CULL_MIN)
        pallas_megatrace.sample_batch.clear_cache()
        try:
            culled = pallas_megatrace.sample_batch(*args, **kw)
            taped = pallas_megatrace.sample_batch(*args, want_tape=True,
                                                  **kw)
        finally:
            pallas_megatrace.sample_batch.clear_cache()
    return ({k: np.asarray(v) for k, v in culled.items()},
            {k: np.asarray(v) for k, v in taped.items()})


@pytest.fixture(scope="module")
def port_runs():
    """The port's plain sample_batch with the tape: dense, then blocked at
    the patched threshold and block size; with the pairs each swept."""
    _, args, kw = port_args()
    dense = megatrace.sample_batch(*args, want_tape=True, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(megatrace, "SPH_CULL_MIN", CULL_MIN)
        mp.setattr(megatrace, "SPH_BLOCK", PORT_BLOCK)
        before = megatrace.SPH_PAIRS
        blocked = megatrace.sample_batch(*args, want_tape=True, **kw)
        pairs = megatrace.SPH_PAIRS - before
    return dense, blocked, pairs


@pytest.mark.parametrize("motion", [False, True])
@pytest.mark.parametrize("block", [pallas_megatrace.SPH_BLOCK, PORT_BLOCK])
def test_pack_sphere_blocks_matches_jax(monkeypatch, motion, block):
    scene, _ = book_scenes.cover_scene(grid=3, motion_blur=motion)
    jscene, _ = jax_scenes.cover_scene(grid=3, motion_blur=motion)
    monkeypatch.setattr(pallas_megatrace, "SPH_BLOCK", block)
    want = pallas_megatrace.pack_sphere_blocks(
        jscene.spheres.center, jscene.spheres.radius,
        jscene.spheres.move_offset if motion else None)
    got = megatrace.pack_sphere_blocks(
        scene.spheres.center, scene.spheres.radius,
        scene.spheres.move_offset if motion else None, block=block)
    assert got.shape == (megatrace.sphere_pad_count(40) // block
                         if block <= 128 else 1, 8)
    np.testing.assert_array_equal(got.reshape(1, -1).numpy(),
                                  np.asarray(want))


def test_blocked_plain_sweep_equals_dense_bitwise(port_runs):
    dense, blocked, pairs = port_runs
    assert dense.keys() == blocked.keys()
    for k in dense:
        assert torch.equal(dense[k], blocked[k]), k
    # the cull fires: fewer (lane, sphere) pairs than every bounce x 40
    assert 0 < pairs < int(dense["rays"].sum()) * 40


def test_blocked_plain_sweep_equals_dense_bitwise_moving(monkeypatch):
    _, args, kw = port_args(motion=True, size=8)
    dense = megatrace.sample_batch(*args, want_tape=True, **kw)
    monkeypatch.setattr(megatrace, "SPH_CULL_MIN", CULL_MIN)
    monkeypatch.setattr(megatrace, "SPH_BLOCK", PORT_BLOCK)
    blocked = megatrace.sample_batch(*args, want_tape=True, **kw)
    for k in dense:
        assert torch.equal(dense[k], blocked[k]), k


def check_against_jax(got, want, tape):
    if tape:
        same = np.all(got["tape"] == want["tape"], axis=0)
        assert same.mean() >= LANE_SHARE, same.mean()
    else:
        same = np.ones(got["count"].shape, bool)
    same &= (got["count"] == want["count"]) & (got["rays"] == want["rays"])
    assert same.mean() >= LANE_SHARE, same.mean()
    for k in FLOAT_CHANNELS:
        close = np.isclose(got[k], want[k], **TOL)
        close = close.all(axis=-1) if close.ndim == 2 else close
        if k.endswith("normal"):
            assert close[same].mean() >= COVER_NORMAL_SHARE, k
            assert np.abs(got[k] - want[k])[same].max() < COVER_NORMAL_MAX_ERR
        else:
            assert close[same].mean() >= LANE_SHARE, (k, close[same].mean())


def test_blocked_plain_version_matches_jax_blocked_kernel(port_runs,
                                                          jax_runs):
    _, blocked, _ = port_runs
    got = {k: v.numpy() for k, v in blocked.items() if k != "tape"}
    check_against_jax(got, jax_runs[0], tape=False)


def test_blocked_tape_matches_jax_tape(port_runs, jax_runs):
    _, blocked, _ = port_runs
    got = {k: v.numpy() for k, v in blocked.items()}
    assert got["tape"].shape == jax_runs[1]["tape"].shape
    check_against_jax(got, jax_runs[1], tape=True)


def field_scene(builder_mod, count):
    """A sphere-only scene of `count` small Lambert spheres on a ground
    sphere, the same in both packages."""
    b = builder_mod.SceneBuilder()
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, b.lambert((0.5, 0.5, 0.5)))
    side = int(np.ceil(np.sqrt(count - 1)))
    for k in range(count - 1):
        x, z = k % side, k // side
        b.add_sphere((x * 0.5 - 8.0, 0.2, z * 0.5 - 8.0), 0.2,
                     b.lambert((0.2 + 0.6 * (k % 7) / 7, 0.5, 0.3)))
    return b.build()


class _Taken(Exception):
    pass


def test_big_sphere_scene_takes_mega_in_both_integrators(monkeypatch):
    def taken(*args, **kwargs):
        raise _Taken

    scene = field_scene(scene_mod, 1100)
    assert scene.spheres.center.shape[0] == 1100 > megatrace.SPH_CULL_MIN
    monkeypatch.setattr(megatrace, "megatrace", taken)
    rays = Rays(torch.zeros(4, 3), torch.tensor([[0.0, 0.0, -1.0]] * 4),
                torch.zeros(4))
    with pytest.raises(_Taken):
        integrator.trace(scene, rays, rng.PRNGKey(0), trace_depth=2,
                         differentiable=False)

    jscene = field_scene(jax_scene_mod, 1100)
    monkeypatch.setattr(pallas_sphere, "use_pallas", lambda: True)
    monkeypatch.setattr(pallas_megatrace, "megatrace", taken)
    from raytracing_in_one_weekend_tpu.core.ray import Rays as JaxRays
    import jax
    jrays = JaxRays(jnp.zeros((4, 3)), jnp.asarray([[0.0, 0.0, -1.0]] * 4),
                    jnp.zeros((4,)))
    with pytest.raises(_Taken):
        jax_integrator.trace(jscene, jrays, jax.random.PRNGKey(0),
                             trace_depth=2, differentiable=False)


def test_plain_megatrace_past_former_cap_matches_jax(monkeypatch):
    monkeypatch.setattr(megatrace, "SPH_CULL_MIN", CULL_MIN)
    monkeypatch.setattr(pallas_megatrace, "SPH_CULL_MIN", CULL_MIN)
    scene, _ = book_scenes.cover_scene(grid=3)
    jscene, _ = jax_scenes.cover_scene(grid=3)
    assert megatrace.scene_eligible(scene)  # past the patched threshold
    n = 128
    r = np.random.default_rng(5)
    o = np.tile(np.float32([13.0, 2.0, 3.0]), (n, 1))
    o += r.uniform(-0.2, 0.2, (n, 3)).astype(np.float32)
    d = (np.float32([-13.0, -1.5, -3.0])
         + r.uniform(-2.0, 2.0, (n, 3))).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    active = np.arange(n) % 9 != 0
    rec = materials.pack_materials(scene)[scene.spheres.material.long()]
    jrec = jax_materials.pack_materials(jscene)[jscene.spheres.material]
    kw = dict(trace_depth=DEPTH, has_dielectrics=True, sky_on=True)
    got = megatrace.megatrace(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(active),
        scene.spheres.center, scene.spheres.radius, rec[:, :11],
        scene.environment.sky_bottom, scene.environment.sky_top, 17, **kw)
    want = pallas_megatrace.megatrace(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(active),
        jscene.spheres.center, jscene.spheres.radius, jrec[:, :11],
        jscene.environment.sky_bottom, jscene.environment.sky_top,
        jnp.int32(17), interpret=True, hw_prng=False, **kw)
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    same = (got["valid"] == want["valid"]) & (got["pixel_rays"]
                                              == want["pixel_rays"])
    assert same.mean() >= LANE_SHARE
    for k in ("radiance", "aov_albedo", "events"):
        close = np.isclose(got[k], want[k], **TOL)
        close = close.all(axis=-1) if close.ndim == 2 else close
        assert close[same].mean() >= LANE_SHARE, k


def test_sphere_field_builds_equal_jax(monkeypatch):
    # Both registry entries call the cover generator at grid 32 ...
    calls = []
    with monkeypatch.context() as m:
        for pkg, mod in (("port", book_scenes), ("jax", jax_scenes)):
            m.setattr(mod, "cover_scene",
                      lambda *a, pkg=pkg, **k: calls.append((pkg, a, k)))
        testbeds.sphere_field()
        jax_testbeds.sphere_field()
    assert calls == [("port", (), {"grid": 32}), ("jax", (), {"grid": 32})]
    scene, _ = testbeds.sphere_field()
    assert scene.spheres.center.shape[0] == 4099
    assert scene.spheres.move_offset is None
    assert megatrace.scene_eligible(scene, allow_triangles=True,
                                    allow_rect_box=True, allow_volumes=True,
                                    allow_motion=True, allow_textures=True)
    assert megatrace.scene_eligible(scene)  # the per-ray megatrace too
    # ... whose builds are equal past SPH_CULL_MIN, Morton order included
    # (grid 16, 1,025 spheres: JAX's builder takes ~10 s at grid 32).
    scene, cs = book_scenes.cover_scene(grid=16)
    jscene, jcs = jax_scenes.cover_scene(grid=16)
    assert scene.spheres.center.shape[0] == 1025
    assert dataclasses.asdict(cs) == dataclasses.asdict(jcs)
    for k in ("center", "radius", "material"):
        np.testing.assert_array_equal(getattr(scene.spheres, k).numpy(),
                                      np.asarray(getattr(jscene.spheres, k)))
    assert not jscene.flags.has_motion
    np.testing.assert_array_equal(
        materials.pack_materials(scene).numpy(),
        np.asarray(jax_materials.pack_materials(jscene)))


def test_mixes_past_the_threshold_raise_naming_step_7_7b(monkeypatch):
    monkeypatch.setattr(megatrace, "SPH_CULL_MIN", CULL_MIN)
    scene, args, kw = port_args(size=4)
    b = scene_mod.SceneBuilder()
    for k in range(6):
        b.add_sphere((float(k), 0.0, 0.0), 0.3, b.lambert((0.5, 0.5, 0.5)))
    b.add_rect((0.0, 2.0, 0.0), (1.0, 1.0), b.lambert((0.9, 0.9, 0.9)))
    mixed = b.build()
    reason = megatrace.unsupported_feature(
        mixed, allow_triangles=True, allow_rect_box=True, allow_volumes=True,
        allow_motion=True, allow_textures=True)
    assert "7.7b" in reason
    rect_tables = (torch.zeros((8, 16)), torch.zeros((24, 8)))
    vol0 = torch.tensor([-1.0, 0, 0, 0, 0, 0, 0, 0])
    for extra in (dict(rect_tables=rect_tables), dict(vol0=vol0),
                  dict(tri_tables=(torch.zeros((128, 16)),
                                   torch.zeros((32, 128))))):
        with pytest.raises(NotImplementedError, match=r"7\.7b"):
            megatrace.sample_batch(*args, **kw, **extra)
    for flags in ((True, False, False), (False, True, False),
                  (False, False, True)):
        with pytest.raises(NotImplementedError, match=r"7\.7b"):
            megatrace_bwd.build_kind(*flags, big=True)
    for flags in (dict(has_motion=True), dict(has_tex=True)):
        with pytest.raises(NotImplementedError, match=r"7\.7b"):
            megatrace_bwd.build_kind(False, False, False, big=True, **flags)
    assert megatrace_bwd.build_kind(False, False, False, big=True) \
        == megatrace_bwd.BIG


def cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("motion", [False, True])
def test_cuda_blocked_build_matches_plain_version(monkeypatch, motion):
    dev = cuda_or_skip()
    monkeypatch.setattr(megatrace, "SPH_CULL_MIN", CULL_MIN)
    monkeypatch.setattr(megatrace, "SPH_BLOCK", PORT_BLOCK)
    _, args, kw = port_args(motion=motion, size=32)
    args = tuple(a.to(dev) if torch.is_tensor(a) else a for a in args)
    if motion:
        kw["move_offsets"] = kw["move_offsets"].to(dev)
    before = megatrace.BLOCKED_LAUNCHES
    got = megatrace.sample_batch(*args, want_tape=True, **kw)
    torch.cuda.synchronize()
    assert megatrace.BLOCKED_LAUNCHES == before + 1
    want = megatrace.sample_batch_reference(*args, want_tape=True, **kw)
    same = (torch.all(got["tape"] == want["tape"], dim=0)
            & (got["count"] == want["count"]) & (got["rays"] == want["rays"]))
    for k in FLOAT_CHANNELS:
        close = torch.isclose(got[k], want[k], **TOL)
        same &= close.reshape(close.shape[0], -1).all(dim=1)
    assert float(same.float().mean()) >= LANE_SHARE


@pytest.mark.cuda
def test_cuda_megatrace_past_the_threshold_matches_plain_version(
        monkeypatch):
    dev = cuda_or_skip()
    monkeypatch.setattr(megatrace, "SPH_CULL_MIN", CULL_MIN)
    scene, _ = book_scenes.cover_scene(grid=3)
    scene = scene.to(dev)
    n = 4096
    gen = torch.Generator().manual_seed(5)
    o = (torch.tensor([13.0, 2.0, 3.0])
         + 0.4 * torch.rand((n, 3), generator=gen) - 0.2).to(dev)
    d = (torch.tensor([-13.0, -1.5, -3.0])
         + 4.0 * torch.rand((n, 3), generator=gen) - 2.0)
    d = (d / d.norm(dim=1, keepdim=True)).to(dev)
    active = (torch.arange(n) % 9 != 0).to(dev)
    rec = materials.pack_materials(scene)[scene.spheres.material.long()]
    args = (o, d, active, scene.spheres.center, scene.spheres.radius,
            rec[:, :11], scene.environment.sky_bottom,
            scene.environment.sky_top, 17)
    kw = dict(trace_depth=DEPTH, has_dielectrics=True, sky_on=True)
    before = megatrace.WAVE_BIG_LAUNCHES
    got = megatrace.megatrace(*args, **kw)
    torch.cuda.synchronize()
    assert megatrace.WAVE_BIG_LAUNCHES == before + 1
    want = megatrace.megatrace_reference(*args, **kw)
    same = ((got["valid"] == want["valid"])
            & (got["pixel_rays"] == want["pixel_rays"]))
    for k in ("radiance", "aov_normal", "aov_albedo", "events"):
        close = torch.isclose(got[k], want[k], **TOL)
        same &= close.reshape(close.shape[0], -1).all(dim=1)
    assert float(same.float().mean()) >= LANE_SHARE
