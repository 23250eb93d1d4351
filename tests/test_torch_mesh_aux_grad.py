"""Gradients through rects and boxes beside triangles (ROADMAP step 7.1b):
the port's sample_batch_diff against the JAX package's, and the backward
kernel's build with both (MESH_AUX; its lane code built for the host)
against torch.autograd of the plain replay.

* On cornell_mesh (chip_smoke.mesh_aux_scene: 6 rects, 2 boxes, 908
  triangles, no sphere) at 16x16, 2 spp, depth 4: the port's
  `megatrace_replay.sample_batch_diff` on the CPU (the plain forward, then
  autograd over the plain replay) against jax.vjp of JAX's
  `sample_batch_diff(interpret=True)`, with respect to pack_aux_tables'
  and pack_tri_tables' six tables, under a probe loss on the color
  (JAX propagates the color's cotangent only).  The primal colors agree
  within 1e-4 on >= 99% of lanes and the probe weights only those lanes;
  each leaf within 2e-2 of its max abs with cosine >= 0.9999
  (tests/test_torch_replay.py's bounds), and each kind (rect, box,
  triangle) has a nonzero leaf: the material rows (a Lambert scene's flat
  walls move no geometry).
* The lane code's build with kTris and kAux (csrc/megatrace_replay_lane.cuh):
  each iteration's forward equal to `replay_iteration` on every state
  entry but `lp`, its hand VJP within 5e-4 of each cotangent's max abs of
  autograd's (megatrace_bwd.TRI_STEP_COTANGENTS), and `host_backward`
  (the kernels' whole schedule, MeshEntityAdd over every row past the
  padded spheres) within 5e-4 of each leaf's max of replay_grad_reference
  at depths 8 and 35.
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

import chip_smoke
from raytracing_in_one_weekend_tpu.ops import megatrace_replay as jax_replay
from raytracing_in_one_weekend_tpu.scene import scene as jax_scene_mod
from raytracing_in_one_weekend_tpu_torch.ops import megatrace
from raytracing_in_one_weekend_tpu_torch.ops import megatrace_bwd as mb
from raytracing_in_one_weekend_tpu_torch.ops import megatrace_replay as mr
from raytracing_in_one_weekend_tpu_torch.ops.cuda_build import CSRC_DIR
from test_torch_aux_grad import probe_cotangents
from test_torch_mesh_aux import inputs

JAX_GRAD_TOL = 2e-2  # the cover's bound, tests/test_torch_replay.py
JAX_COSINE = 0.9999
TOL = 5e-4  # the lane code against the plain replay's autograd
TABLES = ("tri_geo", "tri_rec", "rect_geo", "rect_rec", "box_geo",
          "box_rec")

_HARNESS = r"""
#include "megatrace_replay_lane.cuh"
using namespace rtiw;

// The build with kTris and kAux of the lane code, one lane at a time.
extern "C" {
void step_forward_all(float* state, const float* codes, const float* lc,
                      const float* consts, const float* ent, int n, int it,
                      int seed, int td, int diel, int sky) {
  for (int i = 0; i < n; ++i) {
    LaneEnv E = make_lane_env(consts, ent, i, lc[i], seed, 0, td, 0.0f,
                              diel, sky, 1);
    float st[kStateVars];
    for (int k = 0; k < kStateVars; ++k) st[k] = state[(size_t)k * n + i];
    step_forward<true, true>(st, codes[i], it, E);
    for (int k = 0; k < kStateVars; ++k) state[(size_t)k * n + i] = st[k];
  }
}
void step_vjp_all(const float* state, const float* codes,
                  const float* cot_out, const float* lc, const float* consts,
                  const float* ent, float* cot_in, float* cot_ent,
                  float* cot_scal, int n, int it, int seed, int td, int diel,
                  int sky) {
  for (int i = 0; i < n; ++i) {
    LaneEnv E = make_lane_env(consts, ent, i, lc[i], seed, 0, td, 0.0f,
                              diel, sky, 1);
    float st[kStateVars], g[kStateVars], ge[kTriGradCols], gs[kScal];
    for (int k = 0; k < kStateVars; ++k) {
      st[k] = state[(size_t)k * n + i];
      g[k] = cot_out[(size_t)k * n + i];
    }
    for (int k = 0; k < kScal; ++k) gs[k] = 0.0f;
    step_vjp<true, true>(st, g, codes[i], it, E, ge, gs);
    for (int k = 0; k < kStateVars; ++k) cot_in[(size_t)k * n + i] = g[k];
    for (int k = 0; k < kTriGradCols; ++k)
      cot_ent[(size_t)k * n + i] = ge[k];
    for (int k = 0; k < kScal; ++k) cot_scal[(size_t)k * n + i] = gs[k];
  }
}
void backward_all(const float* tape, const float* lc, const float* consts,
                  const float* ent, const float* cot, float* dent,
                  float* dscal, float* drows, int row_base, int n, int seed,
                  int samples, int td, int diel, int sky) {
  host_backward<true, true>(tape, lc, consts, ent, cot, n, samples, td,
                            seed, 0, 0.0f, diel, sky, 1, dscal,
                            MeshEntityAdd{dent, drows, row_base});
}
}
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process (tests/test_torch_integrator.py):
    the tier-1 run puts six of them on the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def lane_lib(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_aux_lane")
    src = Path(out) / "harness.cpp"
    src.write_text(_HARNESS)
    lib = Path(out) / "libmeshauxlane.so"
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler is needed to build the lane code"
    # -ffp-contract=off: no fused multiply-add beyond the written fmaf, as
    # nvcc's -fmad=false
    subprocess.run([cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-fPIC",
                    "-shared", "-I", str(CSRC_DIR), "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


def scenes(size):
    port, _ = chip_smoke.mesh_aux_scene("cornell_mesh")
    jscene, _ = chip_smoke.mesh_aux_scene("cornell_mesh", jax_scene_mod)
    return port, inputs(port, jscene, size, size)


def test_gradients_match_jax_sample_batch_diff():
    size, spp, depth, seed = 16, 2, 4, 3
    scene, ((targs, tkw), (jargs, jkw)) = scenes(size)
    n = size * size
    kw = dict(samples=spp, trace_depth=depth, sky_on=False,
              has_dielectrics=scene.flags.has_dielectrics)
    flat = [t for k in ("tri_tables", "rect_tables", "box_tables")
            for t in tkw[k]]
    leaves = [t.detach().clone().requires_grad_() for t in flat]
    pairs = dict(tri_tables=tuple(leaves[0:2]),
                 rect_tables=tuple(leaves[2:4]),
                 box_tables=tuple(leaves[4:6]))
    lane_count = np.full(n, spp, np.int32)
    got = mr.sample_batch_diff(torch.from_numpy(lane_count), torch.zeros(n),
                               *targs, seed, **pairs, **kw)

    def jax_fn(tg, tr, rg, rr, bg, br):
        out = jax_replay.sample_batch_diff(
            jnp.asarray(lane_count), jnp.zeros(n), *jargs, jnp.int32(seed),
            rect_tables=(rg, rr), box_tables=(bg, br), tri_tables=(tg, tr),
            interpret=True, **kw)
        return out["color"]

    jflat = [t for k in ("tri_tables", "rect_tables", "box_tables")
             for t in jkw[k]]
    jcolor, vjp = jax.vjp(jax_fn, *jflat)
    color = got["color"].detach().numpy()
    agree = np.isclose(color, np.asarray(jcolor), atol=1e-4,
                       rtol=1e-4).all(1)
    assert agree.mean() >= 0.99, agree.mean()
    assert got["count"].sum() > 0
    probe, _ = probe_cotangents(color, got["count"].detach().numpy())
    probe = (probe * agree[:, None]).astype(np.float32)
    ported = torch.autograd.grad(got["color"], leaves,
                                 torch.from_numpy(probe), allow_unused=True)
    ref = vjp(jnp.asarray(probe))
    nonzero = []
    for leaf, p, r in zip(TABLES, ported, ref):
        r = np.asarray(r)
        p = np.zeros_like(r) if p is None else p.numpy()
        scale = np.abs(r).max()
        if scale == 0.0:
            assert np.abs(p).max() == 0.0, leaf
            continue
        nonzero.append(leaf)
        assert np.abs(p - r).max() <= JAX_GRAD_TOL * scale, (
            leaf, np.abs(p - r).max() / scale)
        cosine = (p * r).sum() / np.sqrt((p * p).sum() * (r * r).sum())
        assert cosine >= JAX_COSINE, (leaf, cosine)
    # every kind moves: its material rows at least
    assert {"tri_rec", "rect_rec", "box_rec"} <= set(nonzero), nonzero


def lane_env(size, spp, depth, seed):
    """The batch's tables, its tape (the plain forward), the replay's
    keyword arguments, the lane code's entity table and constants."""
    scene, ((tables, tkw), _) = scenes(size)
    n = size * size
    lane_count = torch.full((n,), spp, dtype=torch.int32)
    kw = dict(samples=spp, trace_depth=depth,
              has_dielectrics=scene.flags.has_dielectrics, sky_on=False,
              tri_tables=tkw["tri_tables"], rect_tables=tkw["rect_tables"],
              box_tables=tkw["box_tables"])
    out = megatrace.sample_batch(lane_count, torch.zeros(n), *tables, seed,
                                 want_tape=True, **kw)
    ent = mr.build_entity_rows(*tables[1:4], kw["tri_tables"],
                               kw["rect_tables"], kw["box_tables"]
                               ).detach().contiguous()
    assert ent.shape[1] == mr.TRI_ENTITY_COLS
    consts = torch.cat([tables[0], tables[4], tables[5], torch.zeros(2)])
    return tables, lane_count, kw, out, ent, consts


def test_step_and_its_adjoint_match_autograd(lane_lib):
    seed, depth = 7, 6
    tables, lane_count, kw, out, ent, consts = lane_env(16, 2, depth, seed)
    tri_base = megatrace.tri_code_base(0, kw["rect_tables"],
                                       kw["box_tables"])
    assert float((out["tape"] >= tri_base).float().mean()) > 0.05
    assert bool(((out["tape"] >= 128) & (out["tape"] < tri_base)).any())
    n = lane_count.shape[0]
    lcf = lane_count.float().contiguous()
    env = mr.make_env(lane_count, tables[0], tables[4], tables[5], seed)
    state = mr.initial_state(n, "cpu")
    rng = np.random.default_rng(0)
    diel, sky = int(kw["has_dielectrics"]), int(kw["sky_on"])
    worst = {}
    for it in range(2 * depth):
        codes = out["tape"][it].contiguous()
        s_in = torch.stack([state[k] for k in mr.STATE_KEYS]).contiguous()
        s_host = s_in.clone()
        lane_lib.step_forward_all(_p(s_host), _p(codes), _p(lcf),
                                  _p(consts), _p(ent), n, it, seed, depth,
                                  diel, sky)
        wt = ent[torch.clamp(codes, min=0).long()].T
        state = mr.replay_iteration(state, wt, codes, it, env, jitter=True,
                                    has_dielectrics=bool(diel),
                                    sky_on=bool(sky), trace_depth=depth,
                                    has_tris=True, has_aux=True)
        s_out = torch.stack([state[k] for k in mr.STATE_KEYS])
        assert torch.equal(s_host[:-1], s_out[:-1]), it

        cot_out = torch.from_numpy(
            rng.standard_normal((len(mr.STATE_KEYS), n)).astype(np.float32))
        cot_out[12:16] = 0.0  # decisions and counters carry no cotangent
        got = (torch.empty(len(mr.STATE_KEYS), n),
               torch.empty(len(mr.TRI_GRAD_COLS), n),
               torch.empty(mb.N_SCAL, n))
        lane_lib.step_vjp_all(_p(s_in), _p(codes), _p(cot_out), _p(lcf),
                              _p(consts), _p(ent), *(_p(t) for t in got), n,
                              it, seed, depth, diel, sky)
        want = mb.replay_step_vjp_reference(
            s_in, codes, it, cot_out, lane_count, *tables, seed,
            trace_depth=depth, has_dielectrics=bool(diel),
            sky_on=bool(sky), tri_tables=kw["tri_tables"],
            rect_tables=kw["rect_tables"], box_tables=kw["box_tables"])
        for leaf, k, rows in mb.TRI_STEP_COTANGENTS:
            g, r = got[k][rows], want[k][rows]
            scale = float(r.abs().max())
            if scale == 0.0:
                assert float(g.abs().max()) == 0.0, (it, leaf)
                continue
            err = float((g - r).abs().max()) / scale
            worst[leaf] = max(worst.get(leaf, 0.0), err)
    assert max(worst.values()) <= TOL, worst
    # the triangles' geometry moves, and the rects' and boxes' frames
    assert {"centers", "radii", "edge_b", "vertex_normals"} <= set(worst)


@pytest.mark.parametrize("size,spp,depth", [(16, 2, 8), (8, 2, 35)])
def test_lane_backward_matches_replay_grad_reference(lane_lib, size, spp,
                                                     depth):
    seed = 11
    tables, lane_count, kw, out, ent, consts = lane_env(size, spp, depth,
                                                        seed)
    n = lane_count.shape[0]
    rng = np.random.default_rng(1)
    cot_color = torch.from_numpy(rng.standard_normal((n, 3))
                                 .astype(np.float32))
    cot_count = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    want = mb.replay_grad_reference(out["tape"], lane_count, *tables, seed,
                                    cot_color, cot_count, **kw)
    s_pad = megatrace.sphere_pad_count(0)
    flat = [t for k in ("tri_tables", "rect_tables", "box_tables")
            for t in kw[k]]
    cot = torch.cat([cot_color.T, cot_count[None]]).contiguous()
    dent = torch.zeros(0, len(mr.GRAD_COLS))
    drows = torch.zeros(ent.shape[0] - s_pad, len(mr.TRI_GRAD_COLS))
    dscal = torch.zeros(mb.N_SCAL)
    lcf = lane_count.float().contiguous()  # bound while the call runs
    lane_lib.backward_all(_p(out["tape"]), _p(lcf), _p(consts), _p(ent),
                          _p(cot), _p(dent), _p(dscal), _p(drows), s_pad, n,
                          seed, spp, depth, int(kw["has_dielectrics"]),
                          int(kw["sky_on"]))
    with torch.enable_grad():
        leaves = tuple(t.detach().requires_grad_()
                       for t in (*tables[1:4], *flat))
        rows = mr.build_entity_rows(*leaves[:3], tuple(leaves[3:5]),
                                    tuple(leaves[5:7]), tuple(leaves[7:9]))
    dtable = torch.zeros_like(rows)
    dtable[s_pad:, list(mr.TRI_GRAD_COLS)] = drows
    grads = torch.autograd.grad(rows, leaves, dtable, allow_unused=True)
    got = (dscal[:24], *grads[:3], dscal[24:27], dscal[27:30], *grads[3:])
    assert len(got) == len(want)
    moved = 0
    for g, r in zip(got, want):
        g = torch.zeros_like(r) if g is None else g
        scale = float(r.abs().max()) if r.numel() else 0.0
        if scale == 0.0:
            assert float(g.abs().max()) == 0.0 if g.numel() else True
            continue
        moved += 1
        assert float((g - r).abs().max()) <= TOL * scale, (
            float((g - r).abs().max()) / scale)
    assert moved >= 6  # the camera, the six tables' moving ones
