"""The batch kernel's plain version against the JAX batch kernel.

JAX side: pallas_megatrace.sample_batch(..., interpret=True,
hw_prng=False, want_tape=True), the Pallas kernel run in interpret mode
on the CPU with the hash PRNG.  Port side: ops.megatrace.sample_batch on
CPU tensors, which is the plain PyTorch version.  Both draw the same
random numbers (tests/test_torch_rng.py), so they trace the same paths.

Criterion, per lane: the winner tape (the sphere hit at every iteration)
is identical on >= 99% of lanes; on those lanes `count` and `rays` are
exactly equal and the float channels agree within atol=rtol=1e-4; every
channel's mean agrees within 1%.

One measured exception, traced to XLA's CPU rsqrt: the normal AOVs on
the book cover.  The normal is read off the sphere quadratic, which
expands |o - c|^2 = |o|^2 - 2 o.c + |c|^2 - r^2 and cancels ~12 bits for
the cover's r = 0.2 spheres seen from 13 units away, so one ulp of ray
direction moves the hit normal by ~1e-4.  The port normalises with a
correctly rounded rsqrt; XLA's CPU rsqrt is not correctly rounded.  At
32x32, 4 spp, depth 8, seeds 1-3, the share of tape-identical cover lanes
whose normal agrees within 1e-4 measured 0.959-0.964 (fallback normal
0.978-0.988), with a largest error of 2.9e-3 (1.6e-3).  With the port's
rsqrt replaced by XLA's and nothing else changed, the shares rise to
0.993-1.000 and 0.999-1.000 (`test_cover_normal_gap_is_xla_rsqrt`);
replacing sqrt, sin or cos changes no bit.  So the cover's two normal
channels are held to a share of 0.95 and, on every tape-identical lane,
to an error below 1e-2: rounding stays below that, while a fault in AOV
capture gives errors of order one.  Every other channel and scene meets
0.99 (three_spheres and single_sphere: 1.0).
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
from raytracing_in_one_weekend_tpu_torch.core import camera, materials
from raytracing_in_one_weekend_tpu_torch.core import randomsource
from raytracing_in_one_weekend_tpu_torch.models import book_scenes
from raytracing_in_one_weekend_tpu_torch.ops import megatrace, megatrace_replay
from raytracing_in_one_weekend_tpu_torch.render import renderer
from raytracing_in_one_weekend_tpu_torch.utils.config import NoiseColor

TOL = dict(atol=1e-4, rtol=1e-4)
FLOAT_CHANNELS = ("color", "normal", "albedo", "weight", "fallback_normal",
                  "fallback_albedo")
LANE_SHARE = 0.99
COVER_NORMAL_SHARE = 0.95  # see the module docstring
COVER_NORMAL_MAX_ERR = 1e-2  # on tape-identical lanes; measured <= 2.9e-3


def port_inputs(name, w, h):
    scene, cs = book_scenes.SCENES[name]()
    cam = camera.make_camera(cs.origin, cs.look_at, cs.up, cs.vertical_fov,
                             w / h, aperture=cs.aperture,
                             focus_distance=cs.focus_distance)
    records = megatrace.pack_sphere_records(
        scene, materials.pack_materials(scene)
    )
    return scene, (
        megatrace.pack_camera_row(cam, w, h), scene.spheres.center,
        scene.spheres.radius, records, scene.environment.sky_bottom,
        scene.environment.sky_top,
    )


def jax_inputs(name, w, h):
    scene, cs = jax_scenes.SCENES[name]()
    cam = jax_camera.make_camera(cs.origin, cs.look_at, cs.up,
                                 cs.vertical_fov, w / h,
                                 aperture=cs.aperture,
                                 focus_distance=cs.focus_distance)
    records = pallas_megatrace.pack_sphere_records(
        scene, jax_materials.pack_materials(scene)
    )
    return scene, (
        pallas_megatrace.pack_camera_row(cam, w, h), scene.spheres.center,
        scene.spheres.radius, records, scene.environment.sky_bottom,
        scene.environment.sky_top,
    )


def run_both(name, size, seed, spp=4, depth=8):
    """(port outputs, JAX outputs) as numpy dicts, on the same inputs."""
    n = size * size
    lane_count = np.full(n, spp, np.int32)
    js, jtables = jax_inputs(name, size, size)
    want = pallas_megatrace.sample_batch(
        jnp.asarray(lane_count), jnp.zeros(n), *jtables, jnp.int32(seed),
        samples=spp, trace_depth=depth,
        has_dielectrics=js.flags.has_dielectrics, sky_on=True,
        interpret=True, hw_prng=False, want_tape=True,
    )
    ts, ttables = port_inputs(name, size, size)
    got = megatrace.sample_batch(
        torch.from_numpy(lane_count), torch.zeros(n), *ttables, seed,
        samples=spp, trace_depth=depth,
        has_dielectrics=ts.flags.has_dielectrics, sky_on=True,
        want_tape=True,
    )
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    assert got["tape"].shape == want["tape"].shape == (spp * depth, n)
    return got, want


def close_lanes(got, want, k):
    close = np.isclose(got[k], want[k], **TOL)
    return close.all(axis=-1) if close.ndim == 2 else close


@pytest.mark.parametrize("name,size,seed", [
    ("cover", 32, 1), ("cover", 32, 2), ("cover", 32, 3),
    ("three_spheres", 16, 1), ("single_sphere", 16, 1),
])
def test_plain_version_matches_jax_kernel(name, size, seed):
    got, want = run_both(name, size, seed)
    same = np.all(got["tape"] == want["tape"], axis=0)
    assert same.mean() >= LANE_SHARE, same.mean()
    np.testing.assert_array_equal(got["count"][same], want["count"][same])
    np.testing.assert_array_equal(got["rays"][same], want["rays"][same])
    for k in FLOAT_CHANNELS:
        close = close_lanes(got, want, k)
        if name == "cover" and k.endswith("normal"):
            assert close[same].mean() >= COVER_NORMAL_SHARE, \
                (k, close[same].mean())
            err = np.abs(got[k] - want[k])[same].max()
            assert err < COVER_NORMAL_MAX_ERR, (k, err)
        else:
            assert close[same].mean() >= LANE_SHARE, (k, close[same].mean())
    for k in FLOAT_CHANNELS + ("count", "rays"):
        m_got, m_want = got[k].mean(), want[k].mean()
        assert abs(m_got - m_want) <= 0.01 * abs(m_want) + 1e-6, k


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_cover_normal_gap_is_xla_rsqrt(monkeypatch, seed):
    """With XLA's CPU rsqrt in the port, the cover's normal channels meet
    the 0.99 bound as well: the gap the test above allows is that rsqrt's
    rounding and nothing else."""
    xla_rsqrt = jax.jit(jax.lax.rsqrt)
    monkeypatch.setattr(
        megatrace, "_rsqrt",
        lambda x: torch.from_numpy(np.array(xla_rsqrt(x.float().numpy()))),
    )
    got, want = run_both("cover", 32, seed)
    same = np.all(got["tape"] == want["tape"], axis=0)
    assert same.mean() >= LANE_SHARE, same.mean()
    for k in FLOAT_CHANNELS:
        share = close_lanes(got, want, k)[same].mean()
        assert share >= LANE_SHARE, (k, share)


def test_adaptive_lane_counts_respected():
    w = h = 16
    _, tables = port_inputs("single_sphere", w, h)
    lane_count = torch.arange(w * h, dtype=torch.int32) % 4  # 0..3 samples
    out = megatrace.sample_batch(
        lane_count, torch.zeros(w * h), *tables, 3, samples=4,
        trace_depth=6, has_dielectrics=False, sky_on=True,
    )
    count = out["count"].numpy()
    assert np.all(count <= lane_count.numpy())
    zero_lanes = lane_count.numpy() == 0
    assert np.all(count[zero_lanes] == 0)
    assert np.all(out["rays"].numpy()[zero_lanes] == 0)


def test_fallback_aovs_captured_once_pixel_has_none():
    w = h = 8
    _, tables = port_inputs("single_sphere", w, h)
    kw = dict(samples=2, trace_depth=4, has_dielectrics=False, sky_on=True)
    lane_count = torch.full((w * h,), 2, dtype=torch.int32)
    out = megatrace.sample_batch(lane_count, torch.zeros(w * h), *tables, 5,
                                 **kw)
    assert out["fallback_normal"].abs().max() > 0.5  # something captured
    # with count_in > 0 everywhere, fallback rows stay zero
    out2 = megatrace.sample_batch(lane_count, torch.ones(w * h), *tables, 5,
                                  **kw)
    assert out2["fallback_normal"].abs().max() == 0.0


def test_cpu_tensors_take_the_plain_version():
    _, tables = port_inputs("single_sphere", 8, 8)
    args = (torch.full((64,), 2, dtype=torch.int32), torch.zeros(64),
            *tables, 9)
    kw = dict(samples=2, trace_depth=4, has_dielectrics=False, sky_on=True,
              want_tape=True)
    before = megatrace.LAUNCHES
    got = megatrace.sample_batch(*args, **kw)
    want = megatrace.sample_batch_reference(*args, **kw)
    assert megatrace.LAUNCHES == before  # no kernel on the CPU
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_lane_chunks_do_not_change_results():
    _, tables = port_inputs("three_spheres", 16, 16)
    args = (torch.full((256,), 3, dtype=torch.int32), torch.zeros(256),
            *tables, 4)
    kw = dict(samples=3, trace_depth=5, want_tape=True)
    whole = megatrace.sample_batch_reference(*args, **kw)
    chunked = megatrace.sample_batch_reference(*args, chunk_lanes=100, **kw)
    for k in whole:
        torch.testing.assert_close(chunked[k], whole[k], rtol=0, atol=0)


def test_lane_base_keys_the_random_streams_like_jax():
    w = h = 8
    lane_base = 2**20
    kw = dict(samples=2, trace_depth=4, has_dielectrics=False, sky_on=True,
              want_tape=True)
    _, jtables = jax_inputs("single_sphere", w, h)
    want = pallas_megatrace.sample_batch(
        jnp.full((w * h,), 2, jnp.int32), jnp.zeros(w * h), *jtables,
        jnp.int32(6), lane_base=lane_base, interpret=True, hw_prng=False,
        **kw,
    )
    _, tables = port_inputs("single_sphere", w, h)
    lane_count = torch.full((w * h,), 2, dtype=torch.int32)
    got = megatrace.sample_batch(lane_count, torch.zeros(w * h), *tables, 6,
                                 lane_base, **kw)
    np.testing.assert_array_equal(got["tape"].numpy(),
                                  np.asarray(want["tape"]))
    base0 = megatrace.sample_batch(lane_count, torch.zeros(w * h), *tables,
                                   6, **kw)
    assert not torch.equal(base0["tape"], got["tape"])


def _mesh_with_a_rect():
    """A triangle and a rect: rects and boxes in mesh scenes are ported
    (ROADMAP step 7.1b)."""
    from raytracing_in_one_weekend_tpu_torch.scene.scene import SceneBuilder

    b = SceneBuilder()
    white = b.lambert((0.7, 0.7, 0.7))
    b.add_sphere((0.0, -100.5, 0.0), 100.0, white)
    b.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), white)
    b.add_rect((0, 0, -1), (1.0, 1.0), white)
    return b.build()


def _mesh_with_a_fog_sphere():
    """A triangle beside a volume sphere: convex volumes in mesh scenes are
    ported (ROADMAP step 7.2b)."""
    from raytracing_in_one_weekend_tpu_torch.scene.scene import SceneBuilder

    b = SceneBuilder()
    white = b.lambert((0.7, 0.7, 0.7))
    b.add_sphere((0.0, -100.5, 0.0), 100.0, white)
    b.add_sphere((0.0, 0.0, -1.0), 0.5, b.volume(1.0, (0.9, 0.9, 0.9)))
    b.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), white)
    return b.build()


def _mesh_with_a_moving_sphere():
    """A triangle beside a moving sphere: motion in mesh scenes is ROADMAP
    step 7.3b."""
    from raytracing_in_one_weekend_tpu_torch.scene.scene import SceneBuilder

    b = SceneBuilder()
    white = b.lambert((0.7, 0.7, 0.7))
    b.add_sphere((0.0, -100.5, 0.0), 100.0, white)
    b.add_sphere((0.0, 0.0, -1.0), 0.5, white, move_offset=(0.0, 0.3, 0.0))
    b.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), white)
    return b.build()


def test_scope_refusals_name_the_roadmap():
    refused = [_mesh_with_a_moving_sphere()]
    for scene in refused:
        assert not megatrace.scene_eligible(scene, allow_triangles=True,
                                            allow_rect_box=True,
                                            allow_volumes=True,
                                            allow_motion=True)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            renderer.check_scope(scene)
    # rects and boxes beside triangles are ported (step 7.1b): the batch
    # kernel's aux builds of the triangle build and the streamed kernel
    mesh_rect = _mesh_with_a_rect()
    assert megatrace.scene_eligible(mesh_rect, allow_triangles=True,
                                    allow_rect_box=True, allow_volumes=True,
                                    allow_motion=True)
    assert megatrace.unported_feature(mesh_rect) is None
    renderer.check_scope(mesh_rect)
    # convex volumes beside triangles are ported (step 7.2b): the volume
    # builds of the triangle build and the streamed kernel, MESH_VOL and
    # MESH_AUX_VOL in the backward
    mesh_fog = _mesh_with_a_fog_sphere()
    assert megatrace.scene_eligible(mesh_fog, allow_triangles=True,
                                    allow_rect_box=True, allow_volumes=True,
                                    allow_motion=True)
    assert megatrace.unported_feature(mesh_fog) is None
    assert megatrace_replay.replay_eligible(mesh_fog)
    assert megatrace_replay.kernel_backward_built(mesh_fog)
    renderer.check_scope(mesh_fog)
    with pytest.raises(NotImplementedError, match="step 7.3b"):
        renderer.check_scope(_mesh_with_a_moving_sphere())
    # cubemap skies are ported (step 7.6): the builder takes them and the
    # batch kernel's cube builds render them; the per-ray megatrace reads
    # the gradient sky, as JAX's
    from raytracing_in_one_weekend_tpu_torch.scene.scene import SceneBuilder

    b = SceneBuilder()
    b.add_sphere((0.0, 0.0, -1.0), 0.5, b.lambert((0.5, 0.5, 0.5)))
    b.set_cubemap_sky(np.zeros((6, 4, 4, 3), np.float32))
    cube = b.build()
    assert not megatrace.scene_eligible(cube)
    assert megatrace.scene_eligible(cube, allow_triangles=True,
                                    allow_rect_box=True, allow_volumes=True,
                                    allow_motion=True, allow_textures=True,
                                    allow_cubemap=True)
    renderer.check_scope(cube)
    # unit-shutter motion is ported (step 7.3): the batch kernel's motion
    # builds and the replay take cover_motion; the per-ray megatrace is
    # static
    motion, _ = book_scenes.SCENES["cover_motion"]()
    assert megatrace.scene_eligible(motion, allow_triangles=True,
                                    allow_rect_box=True, allow_volumes=True,
                                    allow_motion=True)
    assert megatrace_replay.replay_eligible(motion)
    assert not megatrace.scene_eligible(motion)
    renderer.check_scope(motion)
    # convex volumes are ported (step 7.2): the batch kernel's volume
    # builds and the replay take them; the per-ray megatrace has no walk
    volume, _ = book_scenes.volume_test()
    assert megatrace.scene_eligible(volume, allow_triangles=True,
                                    allow_rect_box=True, allow_volumes=True)
    assert megatrace_replay.replay_eligible(volume)
    assert not megatrace.scene_eligible(volume)
    renderer.check_scope(volume)
    # rects and boxes are ported (step 7.1): the batch kernel's aux build
    # and the replay take cornell; the per-ray megatrace stays sphere-only
    cornell, _ = book_scenes.cornell_box()
    assert megatrace.scene_eligible(cornell, allow_triangles=True,
                                    allow_rect_box=True)
    assert megatrace_replay.replay_eligible(cornell)
    assert not megatrace.scene_eligible(cornell)
    renderer.check_scope(cornell)
    scene, _ = book_scenes.cover_scene()
    assert megatrace.scene_eligible(scene)
    # the differentiable path is ported: same scope as the forward one
    assert megatrace_replay.replay_eligible(scene)
    renderer.check_scope(scene)
    # sampler flavors are in scope (steps 11 and 11b): every build of the
    # batch kernel has a noise build, so a flavored forward batch of
    # either scene takes the batch kernel
    state = randomsource.make_noise_state(NoiseColor.BLUE, seed=7)
    assert renderer.noise_route(scene, state, 512) == "tables"
    assert renderer.noise_route(cornell, state, 512) == "tables"


def test_other_devices_are_refused():
    _, tables = port_inputs("single_sphere", 4, 4)
    meta = [t.to("meta") for t in tables]
    with pytest.raises(ValueError, match="unsupported device"):
        megatrace.sample_batch(
            torch.ones(16, device="meta"), torch.zeros(16, device="meta"),
            *meta, 1, samples=1, trace_depth=1,
        )


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    _, tables = port_inputs("cover", 64, 64)
    tables = [t.to(dev) for t in tables]
    lane_count = torch.full((4096,), 4, dtype=torch.int32, device=dev)
    kw = dict(samples=4, trace_depth=8, want_tape=True)
    before = megatrace.LAUNCHES
    got = megatrace.sample_batch(lane_count, torch.zeros(4096, device=dev),
                                 *tables, 21, **kw)
    assert megatrace.LAUNCHES == before + 1
    want = megatrace.sample_batch_reference(
        lane_count, torch.zeros(4096, device=dev), *tables, 21, **kw
    )
    same = torch.all(got["tape"] == want["tape"], dim=0)
    assert float(same.float().mean()) >= LANE_SHARE
    for k in FLOAT_CHANNELS:
        close = torch.isclose(got[k], want[k], **TOL)
        close = close.reshape(close.shape[0], -1).all(dim=1)
        assert float(close[same].float().mean()) >= LANE_SHARE, k
