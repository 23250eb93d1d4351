"""Gradients through convex volumes beside triangles (ROADMAP step 7.2b):
the port's sample_batch_diff against the JAX package's, and the backward
kernel's MESH_VOL and MESH_AUX_VOL builds (their lane code built for the
host) against torch.autograd of the plain replay.

* On chip_smoke.mesh_volume_scene's cornell_mesh_volumes (rects, a smoke
  and a fog box, 908 triangles, no sphere: MESH_AUX_VOL) and
  mesh_fog_inside (mesh_showcase in a fog sphere, the camera inside it:
  MESH_VOL, vol0 nonzero) at 16x16, 2 spp, depth 5 (a depth 8 does not
  divide keeps JAX's replay VJP compiling in seconds,
  tests/test_torch_aux_grad.py): the port's
  `megatrace_replay.sample_batch_diff` on the CPU (the plain forward, then
  autograd over the plain replay) against jax.vjp of JAX's
  `sample_batch_diff(interpret=True)` with respect to the sphere records
  (a fog sphere's density among them), pack_tri_tables' and
  pack_aux_tables' tables and vol0, under a probe loss on the color (JAX
  propagates the color's cotangent only).  The primal colors agree within
  1e-4 on >= 99% of lanes and the probe weights only those; each leaf
  within 2e-2 of its max abs with cosine >= 0.9999 (tests/
  test_torch_replay.py's bounds), a leaf zero but for rounding (below
  1e-5 of the largest leaf's max on both sides, as
  tests/test_torch_volume_grad.py holds) excepted; the triangle tables,
  the volume's density (box or sphere records) and, with the camera in
  the fog, vol0 move.
* The lane code's builds with kTris and kVol (csrc/
  megatrace_replay_lane.cuh; kAux beside rects and boxes): each
  iteration's forward equal to `replay_iteration` on every state entry but
  `lp`, its hand VJP within 5e-4 of each cotangent's max abs of
  autograd's (megatrace_bwd.TRI_STEP_COTANGENTS with the medium and vol0
  rows), and `host_backward` (the kernels' whole schedule, MeshEntityAdd
  over every row past the padded spheres) within 5e-4 of each leaf's max
  of replay_grad_reference at depths 8 and 35, each leaf's max floored at
  1e-4 of the largest leaf's (tests/test_torch_volume_grad.py).
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
from test_torch_mesh_volume import inputs
from test_torch_volume_grad import assert_leaves_close, probe_cotangents

JAX_GRAD_TOL = 2e-2  # the cover's bound, tests/test_torch_replay.py
JAX_COSINE = 0.9999
NOISE = 1e-5  # of the largest leaf's max: a leaf below it is zero
TOL = 5e-4  # the lane code against the plain replay's autograd
AUX_SCENE, SPHERE_SCENE = "cornell_mesh_volumes", "mesh_fog_inside"

_HARNESS = r"""
#include "megatrace_replay_lane.cuh"
using namespace rtiw;

// The builds with kTris and kVol of the lane code, one lane at a time:
// beside spheres (aux == 0, MESH_VOL) or beside rects and boxes (aux != 0,
// MESH_AUX_VOL).
template <bool kAux>
void forward_t(float* state, const float* codes, const float* lc,
               const float* consts, const float* ent, int n, int it,
               int seed, int td, int diel, int sky) {
  for (int i = 0; i < n; ++i) {
    LaneEnv E = make_lane_env(consts, ent, i, lc[i], seed, 0, td, 0.0f,
                              diel, sky, 1);
    float st[kVolStateVars];
    for (int k = 0; k < kVolStateVars; ++k)
      st[k] = state[(size_t)k * n + i];
    step_forward<true, kAux, true>(st, codes[i], it, E);
    for (int k = 0; k < kVolStateVars; ++k)
      state[(size_t)k * n + i] = st[k];
  }
}

template <bool kAux>
void vjp_t(const float* state, const float* codes, const float* cot_out,
           const float* lc, const float* consts, const float* ent,
           float* cot_in, float* cot_ent, float* cot_scal, int n, int it,
           int seed, int td, int diel, int sky) {
  for (int i = 0; i < n; ++i) {
    LaneEnv E = make_lane_env(consts, ent, i, lc[i], seed, 0, td, 0.0f,
                              diel, sky, 1);
    float st[kVolStateVars], g[kVolStateVars], ge[kTriGradCols],
        gs[kScalVol];
    for (int k = 0; k < kVolStateVars; ++k) {
      st[k] = state[(size_t)k * n + i];
      g[k] = cot_out[(size_t)k * n + i];
    }
    for (int k = 0; k < kScalVol; ++k) gs[k] = 0.0f;
    step_vjp<true, kAux, true>(st, g, codes[i], it, E, ge, gs);
    for (int k = 0; k < kVolStateVars; ++k) cot_in[(size_t)k * n + i] = g[k];
    for (int k = 0; k < kTriGradCols; ++k)
      cot_ent[(size_t)k * n + i] = ge[k];
    for (int k = 0; k < kScalVol; ++k) cot_scal[(size_t)k * n + i] = gs[k];
  }
}

extern "C" {
void step_forward_all(float* state, const float* codes, const float* lc,
                      const float* consts, const float* ent, int n, int it,
                      int seed, int td, int diel, int sky, int aux) {
  (aux ? forward_t<true> : forward_t<false>)(state, codes, lc, consts, ent,
                                             n, it, seed, td, diel, sky);
}
void step_vjp_all(const float* state, const float* codes,
                  const float* cot_out, const float* lc, const float* consts,
                  const float* ent, float* cot_in, float* cot_ent,
                  float* cot_scal, int n, int it, int seed, int td, int diel,
                  int sky, int aux) {
  (aux ? vjp_t<true> : vjp_t<false>)(state, codes, cot_out, lc, consts, ent,
                                     cot_in, cot_ent, cot_scal, n, it, seed,
                                     td, diel, sky);
}
void backward_all(const float* tape, const float* lc, const float* consts,
                  const float* ent, const float* cot, float* dent,
                  float* dscal, float* drows, int row_base, int n, int seed,
                  int samples, int td, int diel, int sky, int aux) {
  if (aux)
    host_backward<true, true, true>(tape, lc, consts, ent, cot, n, samples,
                                    td, seed, 0, 0.0f, diel, sky, 1, dscal,
                                    MeshEntityAdd{dent, drows, row_base});
  else
    host_backward<true, false, true>(tape, lc, consts, ent, cot, n, samples,
                                     td, seed, 0, 0.0f, diel, sky, 1, dscal,
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
    out = tmp_path_factory.mktemp("mesh_vol_lane")
    src = Path(out) / "harness.cpp"
    src.write_text(_HARNESS)
    lib = Path(out) / "libmeshvollane.so"
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


def scenes(name, size):
    port, cs = chip_smoke.mesh_volume_scene(name)
    jscene, _ = chip_smoke.mesh_volume_scene(name, jax_scene_mod)
    return port, inputs(port, jscene, cs, size, size)


def _tables(kw):
    """The differentiable tables of a case, in order, with their names."""
    names, flat = [], []
    for key, short in (("tri_tables", "tri"), ("rect_tables", "rect"),
                       ("box_tables", "box")):
        if kw.get(key) is not None:
            names += [f"{short}_geo", f"{short}_rec"]
            flat += list(kw[key])
    return names, flat


@pytest.mark.parametrize("name,seed", [(AUX_SCENE, 3), (SPHERE_SCENE, 4)])
def test_gradients_match_jax_sample_batch_diff(name, seed):
    size, spp, depth = 16, 2, 5
    scene, ((targs, tkw), (jargs, jkw)) = scenes(name, size)
    n = size * size
    kw = dict(samples=spp, trace_depth=depth, sky_on=scene.flags.sky == 1,
              has_dielectrics=scene.flags.has_dielectrics)
    names, flat = _tables(tkw)
    names = ["records", *names, "vol0"]
    leaves = [t.detach().clone().requires_grad_()
              for t in (targs[3], *flat, tkw["vol0"])]
    rest = iter(leaves[1:-1])
    pairs = {k: (None if tkw.get(k) is None else (next(rest), next(rest)))
             for k in ("tri_tables", "rect_tables", "box_tables")}
    lane_count = np.full(n, spp, np.int32)
    got = mr.sample_batch_diff(torch.from_numpy(lane_count), torch.zeros(n),
                               *targs[:3], leaves[0], *targs[4:], seed,
                               vol0=leaves[-1], **pairs, **kw)
    _, jflat = _tables(jkw)
    jleaves = [jargs[3], *jflat, jkw["vol0"]]

    def jax_fn(rec, *lv):
        rest = iter(lv[:-1])
        jp = {k: (None if jkw.get(k) is None else (next(rest), next(rest)))
              for k in ("tri_tables", "rect_tables", "box_tables")}
        out = jax_replay.sample_batch_diff(
            jnp.asarray(lane_count), jnp.zeros(n), *jargs[:3], rec,
            *jargs[4:], jnp.int32(seed), vol0=lv[-1], interpret=True,
            **jp, **kw)
        return out["color"]

    jcolor, vjp = jax.vjp(jax_fn, *jleaves)
    color = got["color"].detach().numpy()
    agree = np.isclose(color, np.asarray(jcolor), atol=1e-4,
                       rtol=1e-4).all(1)
    assert agree.mean() >= 0.99, agree.mean()
    assert got["count"].sum() > 0
    probe, _ = probe_cotangents(color, got["count"].detach().numpy())
    probe = (probe * agree[:, None]).astype(np.float32)
    ported = torch.autograd.grad(got["color"], leaves,
                                 torch.from_numpy(probe), allow_unused=True)
    ref = [np.asarray(r) for r in vjp(jnp.asarray(probe))]
    largest = max(np.abs(r).max(initial=0.0) for r in ref)
    nonzero = []
    for leaf, p, r in zip(names, ported, ref):
        p = np.zeros_like(r) if p is None else p.numpy()
        scale = np.abs(r).max() if r.size else 0.0
        if scale <= NOISE * largest:
            assert np.abs(p).max(initial=0.0) <= NOISE * largest, leaf
            continue
        nonzero.append(leaf)
        assert np.abs(p - r).max() <= JAX_GRAD_TOL * scale, (
            leaf, np.abs(p - r).max() / scale)
        cosine = (p * r).sum() / np.sqrt((p * p).sum() * (r * r).sum())
        assert cosine >= JAX_COSINE, (leaf, cosine)
    assert {"tri_geo", "tri_rec"} <= set(nonzero), nonzero
    if name == AUX_SCENE:
        # the fog and smoke boxes' density rides box_rec (row 9)
        assert {"rect_rec", "box_rec"} <= set(nonzero), nonzero
    else:
        assert {"records", "vol0"} <= set(nonzero), nonzero


def lane_env(name, size, spp, depth, seed):
    """The batch's tables, its tape (the plain forward), the replay's
    keyword arguments, the lane code's entity table and constants."""
    scene, ((tables, tkw), _) = scenes(name, size)
    n = size * size
    lane_count = torch.full((n,), spp, dtype=torch.int32)
    kw = dict(samples=spp, trace_depth=depth,
              has_dielectrics=scene.flags.has_dielectrics,
              sky_on=scene.flags.sky == 1, tri_tables=tkw["tri_tables"],
              rect_tables=tkw["rect_tables"], box_tables=tkw["box_tables"],
              vol0=tkw["vol0"])
    out = megatrace.sample_batch(lane_count, torch.zeros(n), *tables, seed,
                                 want_tape=True, **kw)
    ent = mr.build_entity_rows(*tables[1:4], kw["tri_tables"],
                               kw["rect_tables"], kw["box_tables"]
                               ).detach().contiguous()
    assert ent.shape[1] == mr.TRI_ENTITY_COLS
    consts = mb._consts(tables[0], tables[4], tables[5], kw["vol0"])
    return tables, lane_count, kw, out, ent, consts


@pytest.mark.parametrize("name", [AUX_SCENE, SPHERE_SCENE])
def test_step_and_its_adjoint_match_autograd(lane_lib, name):
    seed, depth = 7, 6
    tables, lane_count, kw, out, ent, consts = lane_env(name, 16, 2, depth,
                                                        seed)
    aux = int(kw["rect_tables"] is not None or kw["box_tables"] is not None)
    s = tables[1].shape[0]
    tri_base = megatrace.tri_code_base(s, kw["rect_tables"],
                                       kw["box_tables"])
    assert float((out["tape"] >= tri_base).float().mean()) > 0.02
    n = lane_count.shape[0]
    lcf = lane_count.float().contiguous()
    env = mr.make_env(lane_count, tables[0], tables[4], tables[5], seed,
                      vol0=kw["vol0"])
    state = mr.initial_state(n, "cpu", has_volumes=True)
    keys = mr.VOL_STATE_KEYS
    rng = np.random.default_rng(0)
    diel, sky = int(kw["has_dielectrics"]), int(kw["sky_on"])
    worst = {}
    with chip_smoke.medium_ends(tri_base) as ends:
        for it in range(2 * depth):
            codes = out["tape"][it].contiguous()
            s_in = torch.stack([state[k] for k in keys]).contiguous()
            s_host = s_in.clone()
            lane_lib.step_forward_all(_p(s_host), _p(codes), _p(lcf),
                                      _p(consts), _p(ent), n, it, seed,
                                      depth, diel, sky, aux)
            wt = ent[torch.clamp(codes, min=0).long()].T
            state = mr.replay_iteration(
                state, wt, codes, it, env, jitter=True,
                has_dielectrics=bool(diel), sky_on=bool(sky),
                trace_depth=depth, has_tris=True, has_aux=bool(aux),
                has_volumes=True)
            s_out = torch.stack([state[k] for k in keys])
            same = torch.ones(len(keys), dtype=torch.bool)
            same[keys.index("lp")] = False  # a log sum: logf against torch
            assert torch.equal(s_host[same], s_out[same]), it

            cot_out = torch.from_numpy(
                rng.standard_normal((len(keys), n)).astype(np.float32))
            cot_out[12:16] = 0.0  # decisions and counters: no cotangent
            cot_out[keys.index("in_id")] = 0.0
            got = (torch.empty(len(keys), n),
                   torch.empty(len(mr.TRI_GRAD_COLS), n),
                   torch.empty(mb.N_SCAL_VOL, n))
            lane_lib.step_vjp_all(_p(s_in), _p(codes), _p(cot_out), _p(lcf),
                                  _p(consts), _p(ent),
                                  *(_p(t) for t in got), n, it, seed, depth,
                                  diel, sky, aux)
            want = mb.replay_step_vjp_reference(
                s_in, codes, it, cot_out, lane_count, *tables, seed,
                trace_depth=depth, has_dielectrics=bool(diel),
                sky_on=bool(sky), tri_tables=kw["tri_tables"],
                rect_tables=kw["rect_tables"], box_tables=kw["box_tables"],
                vol0=kw["vol0"])
            for leaf, k, rows in (mb.TRI_STEP_COTANGENTS
                                  + mb.VOL_COTANGENTS):
                g, r = got[k][rows], want[k][rows]
                scale = float(r.abs().max())
                if scale == 0.0:
                    assert float(g.abs().max()) == 0.0, (it, leaf)
                    continue
                err = float((g - r).abs().max()) / scale
                worst[leaf] = max(worst.get(leaf, 0.0), err)
    assert max(worst.values()) <= TOL, worst
    # segments in a medium ended at triangles, whose geometry moves
    assert ends["replay"] > 0
    assert {"medium", "edge_b", "vert0", "vertex_normals"} <= set(worst)
    if name == SPHERE_SCENE:
        assert "vol0" in worst


@pytest.mark.parametrize("name,size,spp,depth", [
    (AUX_SCENE, 16, 2, 8), (SPHERE_SCENE, 16, 2, 8), (AUX_SCENE, 8, 2, 35),
])
def test_lane_backward_matches_replay_grad_reference(lane_lib, name, size,
                                                     spp, depth):
    seed = 11
    tables, lane_count, kw, out, ent, consts = lane_env(name, size, spp,
                                                        depth, seed)
    aux = int(kw["rect_tables"] is not None or kw["box_tables"] is not None)
    n = lane_count.shape[0]
    rng = np.random.default_rng(1)
    cot_color = torch.from_numpy(rng.standard_normal((n, 3))
                                 .astype(np.float32))
    cot_count = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    want = mb.replay_grad_reference(out["tape"], lane_count, *tables, seed,
                                    cot_color, cot_count, **kw)
    s = tables[1].shape[0]
    s_pad = megatrace.sphere_pad_count(s)
    pairs = [kw[k] for k in ("tri_tables", "rect_tables", "box_tables")]
    flat = [t for pair in pairs if pair is not None for t in pair]
    cot = torch.cat([cot_color.T, cot_count[None]]).contiguous()
    dent = torch.zeros(s, len(mr.GRAD_COLS))
    drows = torch.zeros(ent.shape[0] - s_pad, len(mr.TRI_GRAD_COLS))
    dscal = torch.zeros(mb.N_SCAL_VOL)
    lcf = lane_count.float().contiguous()  # bound while the call runs
    lane_lib.backward_all(_p(out["tape"]), _p(lcf), _p(consts), _p(ent),
                          _p(cot), _p(dent), _p(dscal), _p(drows), s_pad, n,
                          seed, spp, depth, int(kw["has_dielectrics"]),
                          int(kw["sky_on"]), aux)
    with torch.enable_grad():
        leaves = tuple(t.detach().requires_grad_()
                       for t in (*tables[1:4], *flat))
        rest = iter(leaves[3:])
        rows = mr.build_entity_rows(
            *leaves[:3], *(None if p is None else (next(rest), next(rest))
                           for p in pairs))
    dtable = torch.zeros_like(rows)
    dtable[:s, list(mr.GRAD_COLS)] = dent
    dtable[s_pad:, list(mr.TRI_GRAD_COLS)] = drows
    grads = torch.autograd.grad(rows, leaves, dtable, allow_unused=True)
    got = (dscal[:24], *grads[:3], dscal[24:27], dscal[27:30], *grads[3:],
           dscal[30:])
    assert assert_leaves_close(got, want) >= 4


@pytest.mark.parametrize("name", [AUX_SCENE, "mesh_fog"])
def test_render_image_trains_through_the_plain_versions(monkeypatch, name):
    """render_image(differentiable=True) takes the scene through the batch
    kernel's plain version and the plain replay (the CPU's versions of #1
    and #2), never the wavefront; its gradients to the soup's vertices are
    finite, those to the albedos nonzero, and in the sky-lit mesh_fog
    those to its density too (in the dark box, density 8, they are ~1e-9
    at this size)."""
    from raytracing_in_one_weekend_tpu_torch.diff import params as params_mod
    from raytracing_in_one_weekend_tpu_torch.render import renderer

    def refuse(*args, **kwargs):
        raise AssertionError("the wavefront arm ran")

    monkeypatch.setattr(renderer, "wavefront_pass", refuse)
    seen = []
    inner = mr.sample_batch_diff

    def spy(*args, **kwargs):
        seen.append(kwargs.get("vol0") is not None
                    and kwargs.get("tri_tables") is not None)
        return inner(*args, **kwargs)

    monkeypatch.setattr(mr, "sample_batch_diff", spy)
    scene, cs = chip_smoke.mesh_volume_scene(name)
    w = 12
    camera, _ = chip_smoke.batch_inputs(scene, cs, w, w, "cpu")
    names = ("triangle_vertices", "texture_colors", "material_parameters")
    params = {k: v.detach().clone().requires_grad_() for k, v in
              params_mod.extract_params(scene, names).items()}
    out = renderer.render_image(params_mod.apply_params(scene, params),
                                camera, width=w, height=w,
                                samples_per_pixel=2, trace_depth=4, seed=5,
                                differentiable=True)
    (out.color ** 2).mean().backward()
    assert seen == [True]
    for k, v in params.items():
        assert bool(torch.isfinite(v.grad).all()), k
    assert float(params["texture_colors"].grad.abs().max()) > 0.0
    if name == "mesh_fog":  # a sky-lit fog: its density moves the image
        assert float(params["material_parameters"].grad.abs().max()) > 0.0
