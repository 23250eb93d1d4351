"""The port's tape replay and its gradient against the JAX package's.

One tape feeds both sides: the port's plain forward with want_tape=True
(equal to the JAX kernel's tape, tests/test_torch_megatrace.py), so no
Pallas interpret compile is needed.  JAX side: megatrace_replay.replay
under jax.vjp; port side: ops/megatrace_replay.replay under
torch.autograd; the same leaves, the same probe-loss cotangents
(loss = sum(color / max(count, 1) * cos(0.37 i)), tests/test_replay.py
:1119-1124).

three_spheres (16x16, 3 spp, depth 5, and the 8x8, 1 spp, depth 12
config of tests/test_replay.py:1308): per-lane primal within 1e-4 on
>= 99% of lanes, every leaf's gradient within 5e-4 of the leaf's max abs
(measured <= 4.2e-6 at depth 5).

The cover (16x16, 2 spp, depth 4) is bounded differently, for a measured
reason.  The JAX replay is plain jnp: it does not mirror the kernel's
fused multiply-adds, while the port's replay does and equals the kernel
bit for bit.  The sphere quadratic cancels ~12 bits on the cover's small
far spheres, so the JAX replay leaves the tape's path on a few lanes
(seeds 1-6: 0-2 of 256 lanes, primal off by up to 5e-4), and each such
lane's gradient differs wholesale (per-leaf error up to 0.34 with those
lanes in).  With the cotangent restricted to the lanes whose primals
agree, the per-leaf error measured 3.4e-5 to 9.6e-3 (seeds 1-6) and the
cosine between the two gradients >= 0.99999: float32 rounding amplified
by the same cancellation.  So the cover is held to a primal share of
0.99 and, on the agreeing lanes, to a per-leaf error below 2e-2 and a
cosine above 0.9999; a wrong derivative gives errors of order one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_in_one_weekend_tpu.core import camera as jax_camera
from raytracing_in_one_weekend_tpu.core import materials as jax_materials
from raytracing_in_one_weekend_tpu.models import book_scenes as jax_scenes
from raytracing_in_one_weekend_tpu.ops import megatrace_replay as jax_replay
from raytracing_in_one_weekend_tpu.ops import pallas_megatrace
from raytracing_in_one_weekend_tpu_torch.core import camera, materials
from raytracing_in_one_weekend_tpu_torch.models import book_scenes
from raytracing_in_one_weekend_tpu_torch.ops import megatrace
from raytracing_in_one_weekend_tpu_torch.ops import megatrace_replay as mr

LEAVES = ("camera_row", "centers", "radii", "records", "sky_bottom",
          "sky_top")
GRAD_TOL = 5e-4
COVER_GRAD_TOL = 2e-2  # see the module docstring; measured <= 9.6e-3
COVER_COSINE = 0.9999  # measured >= 0.99999


def port_tables(name, size):
    scene, cs = book_scenes.SCENES[name]()
    cam = camera.make_camera(cs.origin, cs.look_at, cs.up, cs.vertical_fov,
                             1.0, aperture=cs.aperture,
                             focus_distance=cs.focus_distance)
    records = megatrace.pack_sphere_records(
        scene, materials.pack_materials(scene)
    )
    return scene, (megatrace.pack_camera_row(cam, size, size),
                   scene.spheres.center, scene.spheres.radius, records,
                   scene.environment.sky_bottom, scene.environment.sky_top)


def jax_tables(name, size):
    scene, cs = jax_scenes.SCENES[name]()
    cam = jax_camera.make_camera(cs.origin, cs.look_at, cs.up,
                                 cs.vertical_fov, 1.0, aperture=cs.aperture,
                                 focus_distance=cs.focus_distance)
    records = pallas_megatrace.pack_sphere_records(
        scene, jax_materials.pack_materials(scene)
    )
    return (pallas_megatrace.pack_camera_row(cam, size, size),
            scene.spheres.center, scene.spheres.radius, records,
            scene.environment.sky_bottom, scene.environment.sky_top)


def probe_cotangents(color, count):
    """Cotangents of (color_sum, count) for the probe loss."""
    n = color.shape[0]
    probe = np.cos(np.arange(n * 3, dtype=np.float32).reshape(n, 3)
                   * np.float32(0.37))
    safe = np.maximum(count, 1.0)
    cot_color = (probe / safe[:, None]).astype(np.float32)
    cot_count = np.where(count >= 1.0, -(color * probe).sum(1) / safe**2,
                         0.0).astype(np.float32)
    return cot_color, cot_count


def both_replays(name, size, spp, depth, seed):
    """Primals, gradients and cotangent lane mask of both replays."""
    scene, tables = port_tables(name, size)
    n = size * size
    lane_count = np.full(n, spp, np.int32)
    kw = dict(samples=spp, trace_depth=depth,
              has_dielectrics=scene.flags.has_dielectrics, sky_on=True)
    out = megatrace.sample_batch(torch.from_numpy(lane_count),
                                 torch.zeros(n), *tables, seed,
                                 want_tape=True, **kw)
    jt = jax_tables(name, size)
    for a, b in zip(jt, tables):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    tape = jnp.asarray(out["tape"].numpy())

    def jax_fn(*leaves):
        return jax_replay.replay(tape, jnp.asarray(lane_count), *leaves,
                                 jnp.int32(seed), **kw)

    (jcsum, jcnt), vjp = jax.vjp(jax_fn, *jt)
    leaves = [t.detach().clone().requires_grad_() for t in tables]
    csum, cnt = mr.replay(out["tape"], torch.from_numpy(lane_count),
                          *leaves, seed, **kw)
    # the port's replay is the kernel's output, bit for bit
    assert torch.equal(csum.detach(), out["color"])
    assert torch.equal(cnt.detach(), out["count"])
    jcsum, jcnt = np.asarray(jcsum), np.asarray(jcnt)
    agree = (np.isclose(csum.detach().numpy(), jcsum, atol=1e-4,
                        rtol=1e-4).all(1)
             & (cnt.detach().numpy() == jcnt))
    return csum, cnt, leaves, vjp, agree, out


def grads(csum, cnt, leaves, vjp, cot_color, cot_count):
    ported = torch.autograd.grad(
        (csum, cnt), leaves,
        (torch.from_numpy(cot_color), torch.from_numpy(cot_count)),
        retain_graph=True,
    )
    ref = vjp((jnp.asarray(cot_color), jnp.asarray(cot_count)))
    return [(name, p.numpy(), np.asarray(r))
            for name, p, r in zip(LEAVES, ported, ref)]


def test_entity_rows_match_jax():
    _, tables = port_tables("cover", 8)
    jt = jax_tables("cover", 8)
    got = mr.build_entity_rows(*tables[1:4]).numpy()
    want, layout = jax_replay.build_entity_rows(*jt[1:4])
    assert layout["cols"] == mr.ENTITY_COLS
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("size,spp,depth", [
    (16, 3, 5),
    (8, 1, 12),  # the depth-12 config of tests/test_replay.py:1308
])
def test_three_spheres_replay_and_gradient_match_jax(size, spp, depth):
    csum, cnt, leaves, vjp, agree, out = both_replays(
        "three_spheres", size, spp, depth, 7)
    assert agree.mean() >= 0.99
    cot_color, cot_count = probe_cotangents(out["color"].numpy(),
                                            out["count"].numpy())
    for name, p, r in grads(csum, cnt, leaves, vjp, cot_color, cot_count):
        scale = np.abs(r).max()
        assert scale > 0, name
        assert np.abs(p - r).max() <= GRAD_TOL * scale, (
            name, np.abs(p - r).max() / scale)


@pytest.mark.parametrize("seed", [3, 4])
def test_cover_replay_and_gradient_match_jax(seed):
    csum, cnt, leaves, vjp, agree, out = both_replays("cover", 16, 2, 4,
                                                      seed)
    assert agree.mean() >= 0.99
    cot_color, cot_count = probe_cotangents(out["color"].numpy(),
                                            out["count"].numpy())
    cot_color = (cot_color * agree[:, None]).astype(np.float32)
    cot_count = (cot_count * agree).astype(np.float32)
    for name, p, r in grads(csum, cnt, leaves, vjp, cot_color, cot_count):
        scale = np.abs(r).max()
        assert np.abs(p - r).max() <= COVER_GRAD_TOL * scale, (
            name, np.abs(p - r).max() / scale)
        cosine = (p * r).sum() / np.sqrt((p * p).sum() * (r * r).sum())
        assert cosine >= COVER_COSINE, (name, cosine)


def test_replay_skips_idle_blocks_and_matches_without_grad():
    """Blocks of an all-idle tape are identity steps; grad mode off gives
    the same primal as the checkpointed replay."""
    scene, tables = port_tables("single_sphere", 8)
    n = 64
    lane_count = torch.full((n,), 2, dtype=torch.int32)
    lane_count[::3] = 0  # idle lanes
    kw = dict(samples=3, trace_depth=4, has_dielectrics=False, sky_on=True)
    out = megatrace.sample_batch(lane_count, torch.zeros(n), *tables, 9,
                                 want_tape=True, **kw)
    assert bool((out["tape"][-4:] == -2.0).all())  # the last block idles
    with torch.no_grad():
        csum, cnt = mr.replay(out["tape"], lane_count, *tables, 9, **kw)
    assert torch.equal(csum, out["color"])
    assert torch.equal(cnt, out["count"])
