"""The backward kernel's path-by-path schedule, built for the host, against
the plain replay.

The backward (csrc/megatrace_bwd.cu) rests on the adjoint being local to a
path: a regen overwrites the path state, so no cotangent crosses from one
path to the one before it, and the color and count cotangents stay the
lane's own.  csrc/megatrace_replay_lane.cuh holds its host-and-device
pieces: `scan_lane` (the tape scan), `path_backward` (one path forward
from its regen state, then step_vjp in reverse) and `host_backward`, the
kernels' schedule on the host (count, grouping by length longest first,
scatter, each path's backward, the sums).  The host C++ compiler builds
them here, as tests/test_torch_bwd_lane.py does.  Checks:

* the scan's paths (the host build and the plain `scan_paths_reference`)
  equal those the regen and termination flags of the plain
  `replay_iteration` mark: cover and mesh_showcase, depths 5, 8 and 35,
  uniform lane counts, uneven ones with zeros, counts above the samples
  (paths cut by the tape's end) and a shortened tape;
* the locality itself, by torch.autograd over the plain replay: at every
  regen, the incoming o, d, th, rad and lp get no cotangent, and cs and
  cnt get the lane's;
* the host schedule against `replay_grad_reference`, each leaf within
  5e-4 of its max abs, at depths 5, 8, 35 and 64, sphere and mesh scenes,
  adaptive lane counts (zeros, uneven, above the samples);
* on a card (cuda marker): the scan and path kernels against the plain
  versions on the cover at 128x128.
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
LEAF_NAMES = ("camera_row", "centers", "radii", "records", "sky_bottom",
              "sky_top", "tri_geo", "tri_rec")

_HARNESS = r"""
#include "megatrace_replay_lane.cuh"
using namespace rtiw;

extern "C" {
// Every path of every lane, in scan order: (lane, it0, length) triples.
long scan_all(const float* tape, const float* lc, int n, int iters, int td,
              int* out) {
  long k = 0;
  for (int i = 0; i < n; ++i)
    scan_lane(tape, n, i, iters, lc[i], td, [&](int it0, int len) {
      out[3 * k] = i;
      out[3 * k + 1] = it0;
      out[3 * k + 2] = len;
      ++k;
    });
  return k;
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
def path_lib(tmp_path_factory):
    out = tmp_path_factory.mktemp("paths")
    src = Path(out) / "harness.cpp"
    src.write_text(_HARNESS)
    lib = Path(out) / "libpaths.so"
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler is needed to build the path code"
    # -ffp-contract=off: no fused multiply-add beyond the written fmaf, as
    # nvcc's -fmad=false
    subprocess.run([cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-fPIC",
                    "-shared", "-I", str(CSRC_DIR), "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib))
    lib.scan_all.restype = ctypes.c_long
    return lib


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


SCENES = {"mesh_showcase": meshes.mesh_showcase,
          "smooth_triangle": _smooth_triangle}


def lane_counts(kind: str, n: int, spp: int, depth: int, device="cpu"):
    """Uniform `spp`; "uneven": 0..spp with a run of zeros; "over": spp up
    to spp * trace_depth (lanes that start more paths than the samples
    and run to the tape's end, which cuts their last), from a seeded numpy
    generator."""
    g = np.random.default_rng(n + spp)
    if kind == "uniform":
        c = np.full(n, spp)
    elif kind == "uneven":
        c = g.integers(0, spp + 1, n)
        c[: max(1, n // 10)] = 0
    else:
        c = g.integers(spp, spp * depth + 1, n)
    return torch.from_numpy(c.astype(np.int32)).to(device)


def setup(name, size, spp, depth, seed, kind="uniform", device="cpu"):
    """The batch inputs, lane counts, options and forward outputs (with the
    tape) of a small batch; mesh scenes add `tri_tables` to kw."""
    scene, cs = (SCENES.get(name) or book_scenes.SCENES[name])()
    scene = scene.to(device)
    cam = camera.make_camera(cs.origin, cs.look_at, cs.up, cs.vertical_fov,
                             1.0, aperture=cs.aperture,
                             focus_distance=cs.focus_distance, device=device)
    packed = materials.pack_materials(scene)
    records = megatrace.pack_sphere_records(scene, packed)
    tables = (megatrace.pack_camera_row(cam, size, size),
              scene.spheres.center, scene.spheres.radius, records,
              scene.environment.sky_bottom, scene.environment.sky_top)
    n = size * size
    lc = lane_counts(kind, n, spp, depth, device)
    kw = dict(samples=spp, trace_depth=depth,
              has_dielectrics=scene.flags.has_dielectrics, sky_on=True)
    tri = megatrace.pack_tri_tables(scene, packed)
    if tri is not None:
        kw["tri_tables"] = tri
    out = megatrace.sample_batch(lc, torch.zeros(n, device=device), *tables,
                                 seed, want_tape=True, **kw)
    return tables, lc, kw, out


def replay_paths(tape, lc, tables, seed, kw):
    """(P, 3) paths (lane, it0, length) from the flags of the plain
    replay_iteration: a regen starts one, a lane that was active and is
    not after the step ends it, a lane active after the last row has one
    cut by the tape's end."""
    iters, n = tape.shape
    tri = kw.get("tri_tables")
    ent = mr.build_entity_rows(*tables[1:4], tri).detach()
    env = mr.make_env(lc, tables[0], tables[4], tables[5], seed)
    state = mr.initial_state(n, tape.device)
    it0 = torch.zeros(n, dtype=torch.int64)
    lanes = torch.arange(n)
    found = []
    with torch.no_grad():
        for it in range(iters):
            regen = (state["active"] < 0.5) & (state["started"] < env[
                "per_pixel"])
            was_active = regen | (state["active"] > 0.5)
            it0 = torch.where(regen, it, it0)
            state = mr.replay_iteration(
                state, ent[torch.clamp(tape[it], min=0).long()].T, tape[it],
                it, env, jitter=True, has_dielectrics=kw["has_dielectrics"],
                sky_on=True, trace_depth=kw["trace_depth"],
                has_tris=tri is not None)
            end = was_active & (state["active"] < 0.5)
            found.append(torch.stack([lanes[end], it0[end],
                                      it - it0[end] + 1], 1))
    cut = state["active"] > 0.5
    found.append(torch.stack([lanes[cut], it0[cut], iters - it0[cut]], 1))
    return mb.canonical_paths(torch.cat(found))


def host_scan(lib, tape, lc, depth):
    iters, n = tape.shape
    out = torch.empty((iters * n, 3), dtype=torch.int32)
    lcf = lc.float().contiguous()
    tape = tape.contiguous()
    k = lib.scan_all(_p(tape), _p(lcf), n, iters, depth, _p(out))
    return mb.canonical_paths(out[:k].to(torch.int64))


@pytest.mark.parametrize("name,size,spp,depth,kind", [
    ("cover", 12, 3, 5, "uniform"), ("cover", 12, 4, 8, "uneven"),
    ("cover", 8, 2, 35, "over"), ("mesh_showcase", 10, 3, 5, "over"),
    ("mesh_showcase", 12, 3, 8, "uneven"),
    ("mesh_showcase", 8, 2, 35, "uniform"),
])
def test_scan_matches_replay_flags(path_lib, name, size, spp, depth, kind):
    tables, lc, kw, out = setup(name, size, spp, depth, 9, kind)
    tape = out["tape"]
    want = replay_paths(tape, lc, tables, 9, kw)
    assert int(want[:, 2].sum()) == int(out["rays"].sum())  # live iterations
    if kind == "over":
        assert bool((want[:, 1] + want[:, 2] == tape.shape[0]).any())
    if kind == "uneven":
        assert not bool(torch.isin(torch.nonzero(lc == 0)[:, 0],
                                   want[:, 0]).any())
    assert torch.equal(host_scan(path_lib, tape, lc, depth), want)
    assert torch.equal(mb.scan_paths_reference(tape, lc, depth), want)
    assert torch.equal(mb.scan_paths(tape, lc, samples=spp,
                                     trace_depth=depth), want)
    # a shortened tape: the replay over its rows cuts paths the same way
    short = tape[:-3].contiguous()
    want = replay_paths(short, lc, tables, 9, kw)
    assert torch.equal(host_scan(path_lib, short, lc, depth), want)
    assert torch.equal(mb.scan_paths_reference(short, lc, depth), want)


@pytest.mark.parametrize("name", ["cover", "mesh_showcase"])
def test_adjoint_is_local_to_a_path(name):
    """At every regen the incoming path state (o, d, th, rad, lp) gets no
    cotangent and cs and cnt get the lane's, by autograd over the plain
    replay_iteration."""
    size, spp, depth, seed = 10, 3, 5, 4
    tables, lc, kw, out = setup(name, size, spp, depth, seed, "uneven")
    tape = out["tape"]
    n = lc.shape[0]
    tri = kw.get("tri_tables")
    ent = mr.build_entity_rows(*tables[1:4], tri).detach()
    env = mr.make_env(lc, tables[0], tables[4], tables[5], seed)
    g = np.random.default_rng(2)
    cot_c = torch.from_numpy(g.standard_normal((3, n)).astype(np.float32))
    cot_n = torch.from_numpy(g.standard_normal(n).astype(np.float32))
    path_keys = ("ox", "oy", "oz", "dx", "dy", "dz", "thx", "thy", "thz",
                 "radx", "rady", "radz", "lp")
    with torch.enable_grad():
        state = {k: v.clone().requires_grad_(k in path_keys
                                             or k in ("csx", "csy", "csz",
                                                      "cnt"))
                 for k, v in mr.initial_state(n, "cpu").items()}
        inputs, regens = [], []
        for it in range(tape.shape[0]):
            # a copy the iteration alone reads: its .grad is the cotangent
            # of the iteration's input (the previous output also feeds
            # that iteration's own cs and cnt)
            state = {k: v.clone() if v.requires_grad else v
                     for k, v in state.items()}
            for v in state.values():
                if v.requires_grad:
                    v.retain_grad()
            inputs.append(state)
            regens.append((state["active"] < 0.5)
                          & (state["started"] < env["per_pixel"]))
            state = mr.replay_iteration(
                state, ent[torch.clamp(tape[it], min=0).long()].T, tape[it],
                it, env, jitter=True, has_dielectrics=kw["has_dielectrics"],
                sky_on=True, trace_depth=depth, has_tris=tri is not None)
        loss = ((torch.stack([state["csx"], state["csy"], state["csz"]])
                 * cot_c).sum() + (state["cnt"] * cot_n).sum())
        loss.backward()
    checked = 0
    for st, regen in zip(inputs, regens):
        if not bool(regen.any()):
            continue
        for k in path_keys:
            grad = st[k].grad
            assert grad is None or float(grad[regen].abs().max()) == 0.0, k
        for c, k in enumerate(("csx", "csy", "csz")):
            assert torch.equal(st[k].grad[regen], cot_c[c][regen]), k
        assert torch.equal(st["cnt"].grad[regen], cot_n[regen])
        checked += int(regen.sum())
    assert checked == int(lc.sum())  # every path's regen


def host_grads(lib, tape, lc, tables, seed, cot_color, cot_count, kw):
    """host_backward's leaves, the entity-row sums taken back through
    build_entity_rows as the wrapper does."""
    n = lc.shape[0]
    s = tables[1].shape[0]
    s_pad = megatrace.sphere_pad_count(s)
    tri = tuple(kw.get("tri_tables", ()))
    ent = mr.build_entity_rows(*tables[1:4], tri or None).detach() \
        .contiguous()
    consts = torch.cat([tables[0], tables[4], tables[5], torch.zeros(2)])
    cot = torch.cat([cot_color.T, cot_count[None]]).contiguous()
    dent = torch.zeros(s, len(mr.GRAD_COLS))
    dent_tri = (torch.zeros(tri[0].shape[0], len(mr.TRI_GRAD_COLS))
                if tri else None)
    dscal = torch.zeros(mb.N_SCAL)
    lcf = lc.float().contiguous()
    tape = tape.contiguous()
    lib.backward_all(_p(tape), _p(lcf), _p(consts), _p(ent), _p(cot),
                     _p(dent), _p(dscal), n, seed, kw["samples"],
                     kw["trace_depth"], int(kw["has_dielectrics"]),
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
    return (dscal[:24], *grads[:3], dscal[24:27], dscal[27:30], *grads[3:])


@pytest.mark.parametrize("name,size,spp,depth,kind", [
    ("cover", 12, 3, 5, "uneven"), ("cover", 10, 2, 8, "over"),
    ("three_spheres", 8, 2, 35, "uneven"), ("three_spheres", 6, 2, 64,
                                            "over"),
    ("mesh_showcase", 12, 2, 8, "uneven"),
    ("smooth_triangle", 8, 2, 35, "over"),
])
def test_host_schedule_matches_replay_grad_reference(path_lib, name, size,
                                                      spp, depth, kind):
    seed = 13
    tables, lc, kw, out = setup(name, size, spp, depth, seed, kind)
    n = lc.shape[0]
    g = np.random.default_rng(5)
    cot_color = torch.from_numpy(g.standard_normal((n, 3))
                                 .astype(np.float32))
    cot_count = torch.from_numpy(g.standard_normal(n).astype(np.float32))
    want = mb.replay_grad_reference(out["tape"], lc, *tables, seed,
                                    cot_color, cot_count, **kw)
    got = host_grads(path_lib, out["tape"], lc, tables, seed, cot_color,
                     cot_count, kw)
    assert len(got) == len(want)
    for leaf, gg, r in zip(LEAF_NAMES, got, want):
        scale = float(r.abs().max())
        assert scale > 0, leaf
        assert float((gg - r).abs().max()) <= TOL * scale, (
            leaf, float((gg - r).abs().max()) / scale)


@pytest.mark.cuda
def test_cuda_scan_and_path_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    seed = 11
    tables, lc, kw, out = setup("cover", 128, 8, 8, seed, "uneven", dev)
    n = lc.shape[0]
    g = np.random.default_rng(5)
    cot_color = torch.from_numpy(g.standard_normal((n, 3))
                                 .astype(np.float32)).to(dev)
    cot_count = torch.from_numpy(g.standard_normal(n)
                                 .astype(np.float32)).to(dev)
    launches, scans = mb.LAUNCHES, mb.SCAN_LAUNCHES
    got_paths = mb.scan_paths(out["tape"], lc, samples=8, trace_depth=8)
    assert torch.equal(mb.canonical_paths(got_paths),
                       mb.scan_paths_reference(out["tape"], lc, 8))
    lengths = got_paths[:, 2]
    assert bool((lengths[1:] <= lengths[:-1]).all())  # longest first
    got = mb.replay_grad(out["tape"], lc, *tables, seed, cot_color,
                         cot_count, **kw)
    torch.cuda.synchronize()
    assert mb.LAUNCHES == launches + 1 and mb.SCAN_LAUNCHES == scans + 4
    want = mb.replay_grad_reference(out["tape"], lc, *tables, seed,
                                    cot_color, cot_count, **kw)
    for leaf, gg, r in zip(LEAF_NAMES, got, want):
        scale = float(r.abs().max())
        assert scale > 0, leaf
        assert float((gg - r).abs().max()) <= TOL * scale, leaf
