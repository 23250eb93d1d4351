"""Gradients of sphere scenes past SPH_CULL_MIN: the tape of the blocked
sweep, the port's replay through sample_batch_diff against jax.vjp of the
JAX package's replay, and the renderer's routes.

Setup as tests/test_torch_sphere_blocks.py: SPH_CULL_MIN patched to 4 on
both sides (both builders then Morton-sort the spheres) and the port's
SPH_BLOCK to 8, cover_scene(grid=3) (40 spheres), 16x16, 3 spp, depth 4.  The port's forward takes its blocked plain sweep; JAX's tape run
keeps its dense sweep, and the two tapes are the same (the culled blocks
hold no hit).  The gradient (probe loss sum(color / max(count, 1) *
cos(0.37 i)) through sample_batch_diff, whose backward on CPU tensors is
autograd over the plain replay) is held to jax.vjp of JAX's replay on the
same tape by the cover's bounds of tests/test_torch_replay.py: the primal
agrees on >= 99% of lanes, and with the cotangent on those lanes each leaf
is within 2e-2 of its max abs and at a cosine >= 0.9999 (the JAX replay
does not mirror the kernel's fused multiply-adds, and the cover's small
spheres cancel ~12 bits).

The renderer sends a static scene past the threshold to the batch kernel
forward and to the tape and #2 when differentiable, a moving one to the
wavefront when differentiable (not replay-eligible until ROADMAP step
7.7b), with no Morton lanes on either.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_in_one_weekend_tpu.ops import megatrace_replay as jax_replay
from raytracing_in_one_weekend_tpu.ops import pallas_megatrace
from raytracing_in_one_weekend_tpu_torch.core import camera
from raytracing_in_one_weekend_tpu_torch.diff import params
from raytracing_in_one_weekend_tpu_torch.models import book_scenes
from raytracing_in_one_weekend_tpu_torch.ops import megatrace
from raytracing_in_one_weekend_tpu_torch.ops import megatrace_bwd as mb
from raytracing_in_one_weekend_tpu_torch.ops import megatrace_replay as mr
from raytracing_in_one_weekend_tpu_torch.render import renderer
from test_torch_replay import probe_cotangents
from test_torch_sphere_blocks import CULL_MIN, PORT_BLOCK, jax_args, port_args

LEAVES = ("camera_row", "centers", "radii", "records", "sky_bottom",
          "sky_top")
COVER_GRAD_TOL = 2e-2  # tests/test_torch_replay.py's cover bounds
COVER_COSINE = 0.9999
TOL = 5e-4  # the kernel against the plain replay's autograd


@pytest.fixture
def blocked(monkeypatch):
    """The patched threshold on both sides (both builders then Morton-sort
    the spheres, as past the real one) and the port's block size."""
    monkeypatch.setattr(megatrace, "SPH_CULL_MIN", CULL_MIN)
    monkeypatch.setattr(megatrace, "SPH_BLOCK", PORT_BLOCK)
    monkeypatch.setattr(pallas_megatrace, "SPH_CULL_MIN", CULL_MIN)


def test_gradient_through_sample_batch_diff_matches_jax(blocked):
    scene, args, kw = port_args()
    kw.pop("move_offsets")
    lane_count, count_in, tables, seed = args[0], args[1], args[2:8], args[8]
    tape = megatrace.sample_batch(*args, want_tape=True, **kw)["tape"]
    leaves = [t.detach().clone().requires_grad_() for t in tables]
    out = mr.sample_batch_diff(lane_count, count_in, *leaves, seed, **kw)

    jt = jax_args()[0][2:8]
    for a, b in zip(jt, tables):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())

    def jax_fn(*lv):
        return jax_replay.replay(jnp.asarray(tape.numpy()),
                                 jnp.asarray(lane_count.numpy()), *lv,
                                 jnp.int32(seed), **kw)

    (jcsum, jcnt), vjp = jax.vjp(jax_fn, *jt)
    color = out["color"].detach().numpy()
    count = out["count"].detach().numpy()
    agree = (np.isclose(color, np.asarray(jcsum), atol=1e-4,
                        rtol=1e-4).all(1) & (count == np.asarray(jcnt)))
    assert agree.mean() >= 0.99, agree.mean()
    cot_color, cot_count = probe_cotangents(color, count)
    cot_color = (cot_color * agree[:, None]).astype(np.float32)
    cot_count = (cot_count * agree).astype(np.float32)
    ported = torch.autograd.grad(
        (out["color"], out["count"]), leaves,
        (torch.from_numpy(cot_color), torch.from_numpy(cot_count)))
    ref = vjp((jnp.asarray(cot_color), jnp.asarray(cot_count)))
    for name, p, r in zip(LEAVES, ported, ref):
        p, r = p.numpy(), np.asarray(r)
        scale = np.abs(r).max()
        assert scale > 0, name
        assert np.abs(p - r).max() <= COVER_GRAD_TOL * scale, (
            name, np.abs(p - r).max() / scale)
        cosine = (p * r).sum() / np.sqrt((p * p).sum() * (r * r).sum())
        assert cosine >= COVER_COSINE, (name, cosine)


def renderer_routes(monkeypatch, scene, differentiable):
    """(batch kernel calls, differentiable batch calls, wavefront calls) of
    one 8x8 render_batch."""
    seen = {"batch": 0, "diff": 0, "wave": 0}

    def counting(module, name, key):
        inner = getattr(module, name)

        def call(*a, **k):
            seen[key] += 1
            if key != "wave":
                assert k.get("pixel_index") is None  # no Morton lanes
            return inner(*a, **k)
        monkeypatch.setattr(module, name, call)

    counting(megatrace, "sample_batch", "batch")
    counting(mr, "sample_batch_diff", "diff")
    counting(renderer, "wavefront_pass", "wave")
    _, cs = book_scenes.cover_scene(grid=3)
    cam = camera.make_camera(cs.origin, cs.look_at, cs.up, cs.vertical_fov,
                             1.0, aperture=cs.aperture,
                             focus_distance=cs.focus_distance)
    if differentiable:
        scene = params.set_sphere_centers(
            scene, scene.spheres.center.clone().requires_grad_())
    img = renderer.render_image(scene, cam, width=8, height=8,
                                samples_per_pixel=1, trace_depth=2, seed=1,
                                differentiable=differentiable)
    if differentiable:
        img.color.sum().backward()
    return seen


@pytest.mark.parametrize("differentiable", [False, True])
def test_renderer_routes_past_the_threshold(monkeypatch, blocked,
                                            differentiable):
    scene, _ = book_scenes.cover_scene(grid=3)
    seen = renderer_routes(monkeypatch, scene, differentiable)
    assert seen["wave"] == 0
    assert seen["diff" if differentiable else "batch"] == 1


def test_moving_scene_past_the_threshold_trains_through_the_wavefront(
        monkeypatch, blocked):
    scene, _ = book_scenes.cover_scene(grid=3, motion_blur=True)
    assert not mr.replay_eligible(scene)
    assert megatrace.scene_eligible(scene, allow_triangles=True,
                                    allow_rect_box=True, allow_volumes=True,
                                    allow_motion=True, allow_textures=True)
    seen = renderer_routes(monkeypatch, scene, True)
    assert seen["wave"] == 1 and seen["diff"] == 0


@pytest.mark.cuda
def test_cuda_backward_past_the_threshold_matches_plain_version(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    monkeypatch.setattr(megatrace, "SPH_CULL_MIN", CULL_MIN)
    monkeypatch.setattr(megatrace, "SPH_BLOCK", PORT_BLOCK)
    dev = torch.device("cuda")
    _, args, kw = port_args(size=32)
    kw.pop("move_offsets")
    args = tuple(a.to(dev) if torch.is_tensor(a) else a for a in args)
    out = megatrace.sample_batch(*args, want_tape=True, **kw)
    n = args[0].shape[0]
    rng = np.random.default_rng(2)
    cots = tuple(torch.from_numpy(rng.standard_normal(shape)
                                  .astype(np.float32)).to(dev)
                 for shape in ((n, 3), (n,)))
    before = mb.BIG_LAUNCHES
    got = mb.replay_grad(out["tape"], args[0], *args[2:9], *cots, **kw)
    assert mb.BIG_LAUNCHES == before + 1
    want = mb.replay_grad_reference(out["tape"], args[0], *args[2:9], *cots,
                                    **kw)
    for g, r in zip(got, want):
        assert float((g - r).abs().max()) <= TOL * float(r.abs().max())
