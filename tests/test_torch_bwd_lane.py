"""The backward kernel's per-lane code, built for the host, against
torch.autograd of the plain replay.

csrc/megatrace_replay_lane.cuh holds the arithmetic of the CUDA backward
kernel (csrc/megatrace_bwd.cu): the replay step, its adjoint derived by
hand, and one lane's whole two-phase backward.  It is host-and-device
code, so the host C++ compiler builds the same source into a small
library here (the CUDA build needs the card).  Checks:

* the step's forward equals the plain `replay_iteration` bit for bit on
  every state entry but `lp` (a log sum: logf against torch's log);
* the hand VJP of each iteration against autograd, per lane, each
  cotangent tensor (megatrace_bwd.STEP_COTANGENTS) within 5e-4 of its max
  abs (measured <= 2.9e-5: float32 rounding in the cover's cancellations
  sets the level);
* the whole backward (the scan, the grouping, each path's forward and
  reverse sweep, the cotangent sums) against `replay_grad_reference`, each
  leaf within 5e-4, at depths 5 and 8 and at 35 and 64, whose paths run
  longer than any at depth 8.

The mesh instantiation (triangle winners: Möller–Trumbore and the normal
lerp, 38-column entity rows, 28-column cotangent rows summed apart from
the spheres') is held the same way on `mesh_showcase` and on one smooth
triangle (tests/test_torch_mesh_replay.py), with the triangle leaves
(edge_a, edge_b, vert0, vertex normals; the geometry and record tables)
added to the checks.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from raytracing_in_one_weekend_tpu_torch.core import camera, materials
from raytracing_in_one_weekend_tpu_torch.models import book_scenes, meshes
from raytracing_in_one_weekend_tpu_torch.ops import megatrace
from raytracing_in_one_weekend_tpu_torch.ops import megatrace_bwd as mb
from raytracing_in_one_weekend_tpu_torch.ops import megatrace_replay as mr
from raytracing_in_one_weekend_tpu_torch.ops.cuda_build import CSRC_DIR

TOL = 5e-4

_HARNESS = r"""
#include "megatrace_replay_lane.cuh"
using namespace rtiw;

// tris != 0 takes the mesh instantiation: a 38-column entity table, the
// 28-column cotangent rows and triangle rows (codes >= tri_base) summed
// into dent_tri.
template <bool kTris>
void step_forward_t(float* state, const float* codes, const float* lc,
                    const float* consts, const float* ent, int n, int it,
                    int seed, int td, int diel) {
  for (int i = 0; i < n; ++i) {
    LaneEnv E = make_lane_env(consts, ent, i, lc[i], seed, 0, td, 0.0f,
                              diel, 1, 1);
    float st[kStateVars];
    for (int k = 0; k < kStateVars; ++k) st[k] = state[(size_t)k * n + i];
    step_forward<kTris>(st, codes[i], it, E);
    for (int k = 0; k < kStateVars; ++k) state[(size_t)k * n + i] = st[k];
  }
}

template <bool kTris>
void step_vjp_t(const float* state, const float* codes, const float* cot_out,
                const float* lc, const float* consts, const float* ent,
                float* cot_in, float* cot_ent, float* cot_scal, int n, int it,
                int seed, int td, int diel) {
  constexpr int cols = Layout<kTris>::grad;
  for (int i = 0; i < n; ++i) {
    LaneEnv E = make_lane_env(consts, ent, i, lc[i], seed, 0, td, 0.0f,
                              diel, 1, 1);
    float st[kStateVars], g[kStateVars], ge[cols], gs[kScal];
    for (int k = 0; k < kStateVars; ++k) {
      st[k] = state[(size_t)k * n + i];
      g[k] = cot_out[(size_t)k * n + i];
    }
    for (int k = 0; k < kScal; ++k) gs[k] = 0.0f;
    step_vjp<kTris>(st, g, codes[i], it, E, ge, gs);
    for (int k = 0; k < kStateVars; ++k) cot_in[(size_t)k * n + i] = g[k];
    for (int k = 0; k < cols; ++k) cot_ent[(size_t)k * n + i] = ge[k];
    for (int k = 0; k < kScal; ++k) cot_scal[(size_t)k * n + i] = gs[k];
  }
}

extern "C" {
void step_forward_all(float* state, const float* codes, const float* lc,
                      const float* consts, const float* ent, int n, int it,
                      int seed, int td, int diel, int tris) {
  (tris ? step_forward_t<true> : step_forward_t<false>)(
      state, codes, lc, consts, ent, n, it, seed, td, diel);
}
void step_vjp_all(const float* state, const float* codes,
                  const float* cot_out, const float* lc, const float* consts,
                  const float* ent, float* cot_in, float* cot_ent,
                  float* cot_scal, int n, int it, int seed, int td,
                  int diel, int tris) {
  (tris ? step_vjp_t<true> : step_vjp_t<false>)(
      state, codes, cot_out, lc, consts, ent, cot_in, cot_ent, cot_scal, n,
      it, seed, td, diel);
}
void backward_all(const float* tape, const float* lc, const float* consts,
                  const float* ent, const float* cot, float* dent,
                  float* dscal, int n, int seed, int samples, int td,
                  int diel, float* dent_tri, int tri_base) {
  if (dent_tri == nullptr)
    host_backward(tape, lc, consts, ent, cot, n, samples, td, seed, 0, 0.0f,
                  diel, 1, 1, dscal, EntityAdd{dent});
  else
    host_backward<true>(tape, lc, consts, ent, cot, n, samples, td, seed, 0,
                        0.0f, diel, 1, 1, dscal,
                        MeshEntityAdd{dent, dent_tri, tri_base});
}
}
"""


@pytest.fixture(scope="module")
def lane_lib(tmp_path_factory):
    out = tmp_path_factory.mktemp("lane")
    src = Path(out) / "harness.cpp"
    src.write_text(_HARNESS)
    lib = Path(out) / "liblane.so"
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


def _smooth_triangle():
    from test_torch_mesh_replay import CAMERA, smooth_triangle_scene

    from raytracing_in_one_weekend_tpu_torch.scene import scene as scene_mod
    from raytracing_in_one_weekend_tpu_torch.utils.config import \
        CameraSettings

    return smooth_triangle_scene(scene_mod), CameraSettings(
        origin=CAMERA["origin"], look_at=CAMERA["look_at"],
        vertical_fov=CAMERA["vfov"], focus_distance=6.0)


MESH_SCENES = {"mesh_showcase": meshes.mesh_showcase,
               "smooth_triangle": _smooth_triangle}


def setup(name, size, spp, depth, seed):
    """The batch inputs, the tape and the lane code's tables; mesh scenes
    add `tri_tables` to kw and pass the whole padded entity table."""
    scene, cs = (MESH_SCENES.get(name) or book_scenes.SCENES[name])()
    cam = camera.make_camera(cs.origin, cs.look_at, cs.up, cs.vertical_fov,
                             1.0, aperture=cs.aperture,
                             focus_distance=cs.focus_distance)
    packed = materials.pack_materials(scene)
    records = megatrace.pack_sphere_records(scene, packed)
    tables = (megatrace.pack_camera_row(cam, size, size),
              scene.spheres.center, scene.spheres.radius, records,
              scene.environment.sky_bottom, scene.environment.sky_top)
    n = size * size
    lane_count = torch.full((n,), spp, dtype=torch.int32)
    kw = dict(samples=spp, trace_depth=depth,
              has_dielectrics=scene.flags.has_dielectrics, sky_on=True)
    tri = megatrace.pack_tri_tables(scene, packed)
    if tri is not None:
        kw["tri_tables"] = tri
    out = megatrace.sample_batch(lane_count, torch.zeros(n), *tables, seed,
                                 want_tape=True, **kw)
    ent = mr.build_entity_rows(*tables[1:4], tri).detach().contiguous()
    consts = torch.cat([tables[0], tables[4], tables[5], torch.zeros(2)])
    return tables, lane_count, kw, out, ent, consts


@pytest.mark.parametrize("name", ["cover", "mesh_showcase"])
def test_step_and_its_adjoint_match_autograd(lane_lib, name):
    seed, depth = 7, 8
    tables, lane_count, kw, out, ent, consts = setup(name, 24, 2, depth,
                                                     seed)
    tri = kw.get("tri_tables")
    tris = int(tri is not None)
    cols = mr.TRI_GRAD_COLS if tri is not None else mr.GRAD_COLS
    cotangents = mb.TRI_STEP_COTANGENTS if tri is not None \
        else mb.STEP_COTANGENTS
    if tri is not None:  # triangle winners on the tape
        s_pad = megatrace.sphere_pad_count(tables[1].shape[0])
        assert float((out["tape"] >= s_pad).float().mean()) > 0.05
    n = lane_count.shape[0]
    lcf = lane_count.float().contiguous()
    env = mr.make_env(lane_count, tables[0], tables[4], tables[5], seed)
    state = mr.initial_state(n, "cpu")
    rng = np.random.default_rng(0)
    diel = int(kw["has_dielectrics"])
    worst = {}
    for it in range(2 * depth):
        codes = out["tape"][it].contiguous()
        s_in = torch.stack([state[k] for k in mr.STATE_KEYS]).contiguous()
        s_host = s_in.clone()
        lane_lib.step_forward_all(_p(s_host), _p(codes), _p(lcf),
                                  _p(consts), _p(ent), n, it, seed, depth,
                                  diel, tris)
        wt = ent[torch.clamp(codes, min=0).long()].T
        state = mr.replay_iteration(state, wt, codes, it, env, jitter=True,
                                    has_dielectrics=bool(diel), sky_on=True,
                                    trace_depth=depth, has_tris=bool(tris))
        s_out = torch.stack([state[k] for k in mr.STATE_KEYS])
        assert torch.equal(s_host[:-1], s_out[:-1]), it

        cot_out = torch.from_numpy(
            rng.standard_normal((len(mr.STATE_KEYS), n)).astype(np.float32))
        cot_out[12:16] = 0.0  # decisions and counters carry no cotangent
        got = (torch.empty(len(mr.STATE_KEYS), n),
               torch.empty(len(cols), n), torch.empty(mb.N_SCAL, n))
        lane_lib.step_vjp_all(_p(s_in), _p(codes), _p(cot_out), _p(lcf),
                              _p(consts), _p(ent), *(_p(t) for t in got), n,
                              it, seed, depth, diel, tris)
        want = mb.replay_step_vjp_reference(
            s_in, codes, it, cot_out, lane_count, *tables, seed,
            trace_depth=depth, has_dielectrics=bool(diel), tri_tables=tri)
        for name, k, rows in cotangents:
            g, r = got[k][rows], want[k][rows]
            scale = float(r.abs().max())
            if scale == 0.0:
                assert float(g.abs().max()) == 0.0, (it, name)
                continue
            err = float((g - r).abs().max()) / scale
            worst[name] = max(worst.get(name, 0.0), err)
    assert max(worst.values()) <= TOL, worst


# depths 35 (the reference's default) and 64 (the kernel's MAX_DEPTH) run
# paths longer than any at depth 8
@pytest.mark.parametrize("name,size,spp,depth", [
    ("three_spheres", 16, 3, 5), ("cover", 24, 4, 8), ("cover", 12, 2, 35),
    ("three_spheres", 8, 2, 64), ("mesh_showcase", 16, 2, 8),
    ("smooth_triangle", 12, 2, 35),
])
def test_lane_backward_matches_replay_grad_reference(lane_lib, name, size,
                                                     spp, depth):
    seed = 11
    tables, lane_count, kw, out, ent, consts = setup(name, size, spp, depth,
                                                     seed)
    n = lane_count.shape[0]
    rng = np.random.default_rng(1)
    cot_color = torch.from_numpy(rng.standard_normal((n, 3))
                                 .astype(np.float32))
    cot_count = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    want = mb.replay_grad_reference(out["tape"], lane_count, *tables, seed,
                                    cot_color, cot_count, **kw)

    s = tables[1].shape[0]
    s_pad = megatrace.sphere_pad_count(s)
    tri = tuple(kw.get("tri_tables", ()))
    cot = torch.cat([cot_color.T, cot_count[None]]).contiguous()
    dent = torch.zeros(s, len(mr.GRAD_COLS))
    dent_tri = (torch.zeros(tri[0].shape[0], len(mr.TRI_GRAD_COLS))
                if tri else None)
    dscal = torch.zeros(mb.N_SCAL)
    lcf = lane_count.float().contiguous()  # bound while the call runs
    lane_lib.backward_all(_p(out["tape"]), _p(lcf), _p(consts), _p(ent),
                          _p(cot), _p(dent), _p(dscal), n, seed,
                          spp, depth, int(kw["has_dielectrics"]),
                          None if dent_tri is None else _p(dent_tri), s_pad)
    with torch.enable_grad():
        leaves = tuple(t.detach().requires_grad_()
                       for t in (*tables[1:4], *tri))
        rows = mr.build_entity_rows(*leaves[:3], leaves[3:] or None)
    dtable = torch.zeros_like(rows)
    dtable[:s, list(mr.GRAD_COLS)] = dent
    if tri:
        dtable[s_pad:, list(mr.TRI_GRAD_COLS)] = dent_tri
    grads = torch.autograd.grad(rows, leaves, dtable)
    got = (dscal[:24], *grads[:3], dscal[24:27], dscal[27:30], *grads[3:])
    for leaf, g, r in zip(("camera_row", "centers", "radii", "records",
                           "sky_bottom", "sky_top", "tri_geo", "tri_rec"),
                          got, want):
        scale = float(r.abs().max())
        assert scale > 0, leaf
        assert float((g - r).abs().max()) <= TOL * scale, (
            leaf, float((g - r).abs().max()) / scale)
