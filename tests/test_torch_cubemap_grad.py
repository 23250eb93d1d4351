"""Gradients to the cubemap sky: the port's tape replay against the JAX
package's, the backward kernel's cube build (its lane code built for the
host) against torch.autograd of the plain replay, and the wavefront's
gradient against JAX's.

* The replay's primal equals the port's plain forward bit for bit, and its
  gradients (the six sphere/camera/sky leaves, the albedos among the
  records, and the cube texel plane) agree with jax.vjp of JAX's XLA
  `megatrace_replay.replay` (`cube_table=`) on the same tape and
  probe-loss cotangents on `cubemap`: cosine >= 0.9999 and each leaf
  within 2e-2 of its max abs (tests/test_torch_replay.py's bounds).  The
  texel index is a decision on both sides.
* The lane code's cube build (csrc/megatrace_replay_lane.cuh, kCube): each
  iteration's forward equal to `replay_iteration`, its hand VJP within
  5e-4 of each cotangent's max abs of autograd's, and `host_backward` (the
  kernels' schedule, a miss's texel cotangent summed into the plane)
  within 5e-4 of each leaf's max of `replay_grad_reference`, the cube
  plane among them, at depths 5 and 35.
* `kernel_backward_built`: the backward kernel's cube build beside spheres
  alone, up to CUBE_TEXELS_MAX texels (the cap stubbed to the testbed's
  6 x 32 x 32); beside another arm (ROADMAP step 7.6b) or past the cap
  none.
* The wavefront (`integrator.trace`, differentiable) to the faces against
  jax.vjp of JAX's: within 1e-3 of the max abs, the sun's texels among
  those that moved.

The `cuda`-marked case holds the backward kernel's cube build to the plain
replay's autograd on the card.
"""

import ctypes
import dataclasses
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_in_one_weekend_tpu.core import camera as jax_camera
from raytracing_in_one_weekend_tpu.models import testbeds as jax_testbeds
from raytracing_in_one_weekend_tpu.ops import megatrace_replay as jax_replay
from raytracing_in_one_weekend_tpu.render import integrator as jax_integrator
from raytracing_in_one_weekend_tpu_torch.core import rng
from raytracing_in_one_weekend_tpu_torch.core.ray import Rays
from raytracing_in_one_weekend_tpu_torch.models import book_scenes, testbeds
from raytracing_in_one_weekend_tpu_torch.ops import megatrace
from raytracing_in_one_weekend_tpu_torch.ops import megatrace_bwd as mb
from raytracing_in_one_weekend_tpu_torch.ops import megatrace_replay as mr
from raytracing_in_one_weekend_tpu_torch.ops.cuda_build import CSRC_DIR
from raytracing_in_one_weekend_tpu_torch.render import integrator
from test_torch_cubemap import jax_batch, port_batch
from test_torch_volume_grad import probe_cotangents

LEAVES = ("camera_row", "centers", "radii", "records", "sky_bottom",
          "sky_top", "cube")
JAX_GRAD_TOL = 2e-2
JAX_COSINE = 0.9999
TOL = 5e-4  # the kernel against the plain replay's autograd

_HARNESS = r"""
#include "megatrace_replay_lane.cuh"
using namespace rtiw;

// The cube build (kCube) of the lane code, one lane at a time.
constexpr int kCols = Layout<false, false, false, false, true>::grad;
constexpr int kRow = Layout<false, false, false, false, true>::row;

static LaneEnvCube env(const float* consts, const float* ent, int i,
                       const float* lc, int seed, int td, int diel,
                       const float* cube, int w, int h) {
  LaneEnvCube E;
  static_cast<LaneEnv&>(E) =
      make_lane_env(consts, ent, i, lc[i], seed, 0, td, 0.0f, diel, 0, 1);
  E.cube = cube;
  E.cube_w = w;
  E.cube_h = h;
  return E;
}

extern "C" {
void step_forward_all(float* state, const float* codes, const float* lc,
                      const float* consts, const float* ent, int n, int it,
                      int seed, int td, int diel, const float* cube, int w,
                      int h) {
  for (int i = 0; i < n; ++i) {
    const LaneEnvCube E = env(consts, ent, i, lc, seed, td, diel, cube, w, h);
    float st[kStateVars];
    for (int k = 0; k < kStateVars; ++k) st[k] = state[(size_t)k * n + i];
    step_forward<false, false, false, false, false, true>(st, codes[i], it,
                                                          E);
    for (int k = 0; k < kStateVars; ++k) state[(size_t)k * n + i] = st[k];
  }
}
// cot_texel: (4, n) the miss's texel (-1: none) and its three cotangents
void step_vjp_all(const float* state, const float* codes,
                  const float* cot_out, const float* lc, const float* consts,
                  const float* ent, float* cot_in, float* cot_ent,
                  float* cot_scal, float* cot_texel, int n, int it, int seed,
                  int td, int diel, const float* cube, int w, int h) {
  for (int i = 0; i < n; ++i) {
    const LaneEnvCube E = env(consts, ent, i, lc, seed, td, diel, cube, w, h);
    float st[kStateVars], g[kStateVars], ge[kRow], gs[kScal];
    for (int k = 0; k < kStateVars; ++k) {
      st[k] = state[(size_t)k * n + i];
      g[k] = cot_out[(size_t)k * n + i];
    }
    for (int k = 0; k < kScal; ++k) gs[k] = 0.0f;
    step_vjp<false, false, false, false, false, true>(st, g, codes[i], it, E,
                                                      ge, gs);
    for (int k = 0; k < kStateVars; ++k) cot_in[(size_t)k * n + i] = g[k];
    for (int k = 0; k < kCols; ++k) cot_ent[(size_t)k * n + i] = ge[k];
    for (int k = 0; k < kScal; ++k) cot_scal[(size_t)k * n + i] = gs[k];
    for (int k = 0; k < 4; ++k) cot_texel[(size_t)k * n + i] = ge[kCols + k];
  }
}
void backward_all(const float* tape, const float* lc, const float* consts,
                  const float* ent, const float* cot, float* dent,
                  float* dscal, float* dcube, int n, int seed, int samples,
                  int td, int diel, const float* cube, int w, int h) {
  host_backward<false, false, false, false, false, true>(
      tape, lc, consts, ent, cot, n, samples, td, seed, 0, 0.0f, diel, 0, 1,
      dscal, CubeEntityAdd{dent, dcube}, nullptr, 0, 0, cube, w, h);
}
}
"""


@pytest.fixture(scope="module")
def cube_lib(tmp_path_factory):
    out = tmp_path_factory.mktemp("cube_lane")
    src = Path(out) / "harness.cpp"
    src.write_text(_HARNESS)
    lib = Path(out) / "libcubelane.so"
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler is needed to build the lane code"
    # -ffp-contract=off: no fused multiply-add beyond the written fmaf, as
    # nvcc's -fmad=false
    subprocess.run([cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-fPIC",
                    "-shared", "-I", str(CSRC_DIR), "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def _p(t):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def setup(size, spp, depth, seed):
    """The cubemap batch's inputs, its tape and the replay's keyword
    arguments."""
    scene, cs = testbeds.SCENES["cubemap"]()
    tables, kw = port_batch(scene, cs, size)
    n = size * size
    lane_count = torch.full((n,), spp, dtype=torch.int32)
    kw = dict(samples=spp, trace_depth=depth,
              has_dielectrics=scene.flags.has_dielectrics, sky_on=False,
              cube=kw["cube"], cube_dims=kw["cube_dims"])
    out = megatrace.sample_batch(lane_count, torch.zeros(n), *tables, seed,
                                 want_tape=True, **kw)
    return tables, lane_count, kw, out


def test_replay_and_gradient_match_jax():
    size, spp, depth, seed = 12, 2, 4, 3
    tables, lane_count, kw, out = setup(size, spp, depth, seed)
    cube, dims = kw.pop("cube"), kw.pop("cube_dims")
    leaves = [t.detach().clone().requires_grad_() for t in (*tables, cube)]
    csum, cnt = mr.replay(out["tape"], lane_count, *leaves[:6], seed,
                          cube=leaves[6], cube_dims=dims, **kw)
    # the replay is the kernel's plain version, bit for bit
    assert torch.equal(csum.detach(), out["color"])
    assert torch.equal(cnt.detach(), out["count"])

    js, jcs = jax_testbeds.SCENES["cubemap"]()
    jtables, jkw = jax_batch(js, jcs, size)
    tape = jnp.asarray(out["tape"].numpy())

    def jax_fn(*lv):
        return jax_replay.replay(
            tape, jnp.asarray(lane_count.numpy()), *lv[:6], jnp.int32(seed),
            cube_table=lv[6], cube_dims=jkw["cube_dims"], **kw)

    (jcsum, jcnt), vjp = jax.vjp(jax_fn, *jtables, jkw["cube_table"])
    agree = (np.isclose(csum.detach().numpy(), np.asarray(jcsum),
                        atol=1e-4, rtol=1e-4).all(1)
             & (cnt.detach().numpy() == np.asarray(jcnt)))
    assert agree.mean() >= 0.99, agree.mean()
    cot_color, cot_count = probe_cotangents(out["color"].numpy(),
                                            out["count"].numpy())
    cot_color = (cot_color * agree[:, None]).astype(np.float32)
    cot_count = (cot_count * agree).astype(np.float32)
    ported = torch.autograd.grad(
        (csum, cnt), leaves,
        (torch.from_numpy(cot_color), torch.from_numpy(cot_count)),
        allow_unused=True)
    ref = [np.asarray(r) for r in
           vjp((jnp.asarray(cot_color), jnp.asarray(cot_count)))]
    w, h = dims  # JAX's planes (3 W_pad, FH_pad) back to (6 h, w, 3)
    w_pad = ref[6].shape[0] // 3
    ref[6] = np.stack([ref[6][c * w_pad:c * w_pad + w, :6 * h].T
                       for c in range(3)], axis=-1)
    moved = []
    for leaf, p, r in zip(LEAVES, ported, ref):
        p = np.zeros_like(r) if p is None else p.numpy()
        scale = np.abs(r).max()
        if scale == 0.0:
            assert np.abs(p).max() == 0.0, leaf
            continue
        moved.append(leaf)
        assert np.abs(p - r).max() <= JAX_GRAD_TOL * scale, (
            leaf, np.abs(p - r).max() / scale)
        cosine = (p * r).sum() / np.sqrt((p * p).sum() * (r * r).sum())
        assert cosine >= JAX_COSINE, (leaf, cosine)
    assert {"cube", "records"} <= set(moved), moved
    # the albedos' columns moved (records 1-3 of the lambert spheres)
    assert float(ported[3][:, 1:4].abs().max()) > 0.0


def cube_env(size, spp, depth, seed):
    """setup() plus the lane code's entity rows, constants and faces."""
    tables, lane_count, kw, out = setup(size, spp, depth, seed)
    s = tables[1].shape[0]
    ent = mr.build_entity_rows(*tables[1:4]).detach()[:s].contiguous()
    consts = mb._consts(tables[0], tables[4], tables[5])
    return tables, lane_count, kw, out, ent, consts, kw["cube"].contiguous()


def test_step_and_its_adjoint_match_autograd(cube_lib):
    seed, depth = 7, 6
    tables, lane_count, kw, out, ent, consts, cube = cube_env(16, 2, depth,
                                                              seed)
    w, h = kw["cube_dims"]
    n = lane_count.shape[0]
    lcf = lane_count.float().contiguous()
    env = mr.make_env(lane_count, tables[0], tables[4], tables[5], seed)
    state = mr.initial_state(n, "cpu")
    keys = mr.STATE_KEYS
    rng_ = np.random.default_rng(0)
    worst, texels = {}, 0
    for it in range(2 * depth):
        codes = out["tape"][it].contiguous()
        s_in = torch.stack([state[k] for k in keys]).contiguous()
        s_host = s_in.clone()
        cube_lib.step_forward_all(_p(s_host), _p(codes), _p(lcf), _p(consts),
                                  _p(ent), n, it, seed, depth, 0, _p(cube),
                                  w, h)
        wt = ent[torch.clamp(codes, min=0).long()].T
        state = mr.replay_iteration(state, wt, codes, it, env, jitter=True,
                                    has_dielectrics=False, sky_on=False,
                                    trace_depth=depth, cube=(cube, (w, h)))
        s_out = torch.stack([state[k] for k in keys])
        same = torch.ones(len(keys), dtype=torch.bool)
        same[keys.index("lp")] = False  # a log sum: logf against torch's log
        assert torch.equal(s_host[same], s_out[same]), it

        cot_out = torch.from_numpy(
            rng_.standard_normal((len(keys), n)).astype(np.float32))
        cot_out[12:16] = 0.0  # decisions and counters carry no cotangent
        got = (torch.empty(len(keys), n), torch.empty(len(mr.GRAD_COLS), n),
               torch.empty(mb.N_SCAL, n), torch.empty(4, n))
        cube_lib.step_vjp_all(_p(s_in), _p(codes), _p(cot_out), _p(lcf),
                              _p(consts), _p(ent), *(_p(t) for t in got), n,
                              it, seed, depth, 0, _p(cube), w, h)
        # the texel's cotangent against autograd of the step to the faces
        leaf = cube.clone().requires_grad_()
        with torch.enable_grad():
            st = {k: s_in[j] for j, k in enumerate(keys)}
            o = mr.replay_iteration(st, wt, codes, it, env, jitter=True,
                                    has_dielectrics=False, sky_on=False,
                                    trace_depth=depth, cube=(leaf, (w, h)))
            g_cube, = torch.autograd.grad(
                [o[k] for k in keys if o[k].requires_grad], leaf,
                [cot_out[j] for j, k in enumerate(keys)
                 if o[k].requires_grad], allow_unused=True)
        plane = torch.zeros(6 * h * w, 3)
        hit = got[3][0] >= 0
        texels += int(hit.sum())
        plane.index_add_(0, got[3][0][hit].long(), got[3][1:4, hit].T)
        if g_cube is not None:
            np.testing.assert_allclose(plane.reshape(g_cube.shape).numpy(),
                                       g_cube.numpy(), atol=1e-6, rtol=1e-5)
        else:
            assert not bool(hit.any())
        want = mb.replay_step_vjp_reference(
            s_in, codes, it, cot_out, lane_count, *tables, seed,
            trace_depth=depth, has_dielectrics=False, sky_on=False,
            cube=cube, cube_dims=(w, h))
        for name, k, rows in mb.STEP_COTANGENTS:
            g, r = got[k][rows], want[k][rows]
            scale = float(r.abs().max())
            if scale == 0.0:
                assert float(g.abs().max()) == 0.0, (it, name)
                continue
            worst[name] = max(worst.get(name, 0.0),
                              float((g - r).abs().max()) / scale)
    assert max(worst.values()) <= TOL, worst
    assert texels > 0


@pytest.mark.parametrize("size,spp,depth", [(12, 3, 5), (8, 2, 35)])
def test_lane_backward_matches_replay_grad_reference(cube_lib, size, spp,
                                                     depth):
    seed = 11
    tables, lane_count, kw, out, ent, consts, cube = cube_env(size, spp,
                                                              depth, seed)
    n = lane_count.shape[0]
    rng_ = np.random.default_rng(1)
    cot_color = torch.from_numpy(rng_.standard_normal((n, 3))
                                 .astype(np.float32))
    cot_count = torch.from_numpy(rng_.standard_normal(n).astype(np.float32))
    want = mb.replay_grad_reference(out["tape"], lane_count, *tables, seed,
                                    cot_color, cot_count, **kw)
    s = tables[1].shape[0]
    cot = torch.cat([cot_color.T, cot_count[None]]).contiguous()
    dent = torch.zeros(s, len(mr.GRAD_COLS))
    dscal = torch.zeros(mb.N_SCAL)
    dcube = torch.zeros_like(cube)
    lcf = lane_count.float().contiguous()  # bound while the call runs
    cube_lib.backward_all(_p(out["tape"]), _p(lcf), _p(consts), _p(ent),
                          _p(cot), _p(dent), _p(dscal), _p(dcube), n, seed,
                          spp, depth, 0, _p(cube), *kw["cube_dims"])
    with torch.enable_grad():
        leaves = tuple(t.detach().requires_grad_() for t in tables[1:4])
        rows = mr.build_entity_rows(*leaves)
    dtable = torch.zeros_like(rows)
    dtable[:s, list(mr.GRAD_COLS)] = dent
    grads = torch.autograd.grad(rows, leaves, dtable)
    got = (dscal[:24], *grads, dscal[24:27], dscal[27:30], dcube)
    assert len(got) == len(want)
    for leaf, g, r in zip(LEAVES, got, want):
        scale = float(r.abs().max())
        if leaf.startswith("sky"):  # unused under a cubemap
            assert scale == 0.0 and float(g.abs().max()) == 0.0
            continue
        assert scale > 0, leaf
        err = float((g - r).abs().max())
        assert err <= TOL * scale, (leaf, err / scale)


def with_cube_sky(scene, faces):
    env = scene.environment
    return dataclasses.replace(
        scene, environment=dataclasses.replace(
            env, sky_type=torch.full_like(env.sky_type, 2), cubemap=faces),
        flags=dataclasses.replace(scene.flags, sky=2))


@pytest.mark.parametrize("name,cube,built", [
    ("cubemap", False, True), ("simple_light", False, True),
    ("simple_light", True, False), ("volume", True, False),
    ("cover_motion", True, False), ("checkered", True, False)])
def test_kernel_backward_built(name, cube, built):
    # a cubemap trains through the backward kernel beside spheres alone;
    # beside another arm (ROADMAP step 7.6b) the renderer takes the
    # wavefront on the card
    scene, _ = {**book_scenes.SCENES, **testbeds.SCENES}[name]()
    if cube:
        scene = with_cube_sky(
            scene, testbeds.SCENES["cubemap"]()[0].environment.cubemap)
    assert mr.replay_eligible(scene)
    assert mr.kernel_backward_built(scene) is built


@pytest.mark.parametrize("over", [0, 1])
def test_kernel_backward_built_caps_the_texels(monkeypatch, over):
    # a cubemap of more texels than the backward kernel's cube build
    # indexes trains on the wavefront (the renderer asks before any kernel
    # runs); at the cap it takes the kernel
    from raytracing_in_one_weekend_tpu_torch.ops import megatrace_bwd

    scene, _ = testbeds.SCENES["cubemap"]()
    texels = scene.environment.cubemap[..., 0].numel()
    monkeypatch.setattr(megatrace_bwd, "CUBE_TEXELS_MAX", texels - over)
    assert mr.kernel_backward_built(scene) is (over == 0)


def test_wavefront_gradient_matches_jax():
    w = h = 8
    depth, seed = 3, 5
    js, cs = jax_testbeds.SCENES["cubemap"]()
    cam = jax_camera.make_camera(cs.origin, cs.look_at, cs.up,
                                 cs.vertical_fov, w / h,
                                 focus_distance=cs.focus_distance)
    key = jax.random.PRNGKey(seed)
    rays = jax_camera.generate_rays(
        cam, jax_camera.pixel_coords(w, h, key, True), key)
    probe = np.cos(np.arange(w * h * 3, dtype=np.float32)
                   .reshape(w * h, 3) * 0.37)

    def jax_fn(cm):
        scene = js._replace(environment=js.environment._replace(cubemap=cm))
        return jax_integrator.trace(scene, rays, key, depth,
                                    differentiable=True).radiance

    want, vjp = jax.vjp(jax_fn, js.environment.cubemap)
    want_grad = np.asarray(vjp(jnp.asarray(probe))[0])
    scene, _ = testbeds.SCENES["cubemap"]()
    faces = scene.environment.cubemap.clone().requires_grad_()
    leafy = dataclasses.replace(scene, environment=dataclasses.replace(
        scene.environment, cubemap=faces))
    got = integrator.trace(
        leafy, Rays(*(torch.tensor(np.asarray(v)) for v in
                      (rays.origin, rays.direction, rays.time))),
        rng.PRNGKey(seed), depth, differentiable=True).radiance
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)
    grad, = torch.autograd.grad(got, faces, torch.from_numpy(probe))
    scale = np.abs(want_grad).max()
    assert scale > 0
    assert np.abs(grad.numpy() - want_grad).max() <= 1e-3 * scale
    # the sun's texels (+X face, radiance ~20) took some of it
    assert float(grad[0].abs().max()) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("size,spp,depth", [(32, 2, 8), (32, 2, 35),
                                            (128, 4, 8)])
def test_cuda_backward_matches_plain_version(size, spp, depth):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    tables, lane_count, kw, _ = setup(size, spp, depth, 9)
    tables = [t.to(dev) for t in tables]
    kw["cube"] = kw["cube"].to(dev)
    lane_count = lane_count.to(dev)
    n = lane_count.shape[0]
    out = megatrace.sample_batch(lane_count, torch.zeros(n, device=dev),
                                 *tables, 9, want_tape=True, **kw)
    rng_ = np.random.default_rng(2)
    cots = (torch.from_numpy(rng_.standard_normal((n, 3)).astype(np.float32))
            .to(dev),
            torch.from_numpy(rng_.standard_normal(n).astype(np.float32))
            .to(dev))
    before = (mb.LAUNCHES, mb.CUBE_LAUNCHES)
    got = mb.replay_grad(out["tape"], lane_count, *tables, 9, *cots, **kw)
    assert (mb.LAUNCHES, mb.CUBE_LAUNCHES) == (before[0] + 1, before[1] + 1)
    want = mb.replay_grad_reference(out["tape"], lane_count, *tables, 9,
                                    *cots, **kw)
    assert len(got) == len(want)
    for leaf, g, r in zip(LEAVES, got, want):
        scale = float(r.abs().max())
        assert float((g - r).abs().max()) <= TOL * scale, leaf
