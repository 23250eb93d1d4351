"""Gradients through convex volumes: the port's tape replay against the
JAX package's, and the backward kernel's volume builds (their lane code
built for the host) against torch.autograd of the plain replay.

* The replay's primal equals the port's plain forward bit for bit, and
  its gradients (the six sphere/camera/sky leaves, pack_aux_tables' four
  tables where the scene has rects or boxes, and the camera's medium row
  vol0) agree with jax.vjp of JAX's `megatrace_replay.replay` on the same
  tape and probe-loss cotangents (tests/test_replay.py:786, :1173;
  tests/test_grad.py:163): cosine >= 0.9999 and each leaf within 2e-2 of
  its max abs, the cover's bound (measured: cosine >= 0.9999999, errors
  <= 2.4e-5 of the max).  A volume's density moves through the score
  terms only, in both packages.  A leaf whose gradient is zero but for
  float rounding is held below 1e-5 of the largest leaf's max on both
  sides instead: moving the point where a ray passes a volume's boundary
  along the ray leaves the ray where it was, so a skip passes its
  boundary's geometry a derivative that the next hit cancels (the fog
  box's geometry in `box_inside`, ~1e-6 of the largest leaf).
* The lane code's volume builds (csrc/megatrace_replay_lane.cuh, kVol,
  beside spheres and beside rects and boxes): each iteration's forward
  equal to `replay_iteration` on every state entry but `lp`, its hand VJP
  within 5e-4 of each cotangent's max abs of autograd's
  (megatrace_bwd.STEP_COTANGENTS with the medium and vol0 rows), and
  `host_backward` (the kernels' whole schedule) within 5e-4 of each
  leaf's max of `replay_grad_reference`, vol0 and the density among
  them, at depths 8 to 64.  Each leaf's max is floored at 1e-4 of the
  largest leaf's: a leaf whose terms cancel (a skip's derivative to its
  boundary's geometry, above) keeps the float error of its terms, ~1e-3
  of its own max in `box_inside` at 32x32 (7e-5 absolute, 2.4e-8 of the
  largest leaf), on the host and on the card alike.
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
from test_torch_volume import jax_batch, port_batch

LEAVES = ("camera_row", "centers", "radii", "records", "sky_bottom",
          "sky_top")
JAX_GRAD_TOL = 2e-2  # the cover's bound, tests/test_torch_replay.py
JAX_COSINE = 0.9999
NOISE = 1e-5  # of the largest leaf's max: a leaf below it is zero
TOL = 5e-4  # the kernel against the plain replay's autograd
FLOOR = 1e-4  # of the largest leaf's max: the least scale of a leaf's TOL


def assert_leaves_close(got, want) -> int:
    """Each leaf of `got` within TOL of its max abs in `want`, that max
    floored at FLOOR of the largest leaf's (see the docstring); returns
    the number of leaves with a gradient."""
    assert len(got) == len(want)
    largest = max(float(r.abs().max()) for r in want if r.numel())
    moved = 0
    for g, r in zip(got, want):
        if r.numel() == 0:
            continue
        g = torch.zeros_like(r) if g is None else g
        scale = float(r.abs().max())
        if scale == 0.0:
            assert float(g.abs().max()) == 0.0
            continue
        moved += 1
        err = float((g - r).abs().max())
        assert err <= TOL * max(scale, FLOOR * largest), (err, scale, largest)
    return moved

_HARNESS = r"""
#include "megatrace_replay_lane.cuh"
using namespace rtiw;

// The volume builds (kVol) of the lane code, one lane at a time: beside
// spheres (aux == 0) or beside rects and boxes (aux != 0).
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
    step_forward<false, kAux, true>(st, codes[i], it, E);
    for (int k = 0; k < kVolStateVars; ++k)
      state[(size_t)k * n + i] = st[k];
  }
}

template <bool kAux>
void vjp_t(const float* state, const float* codes, const float* cot_out,
           const float* lc, const float* consts, const float* ent,
           float* cot_in, float* cot_ent, float* cot_scal, int n, int it,
           int seed, int td, int diel, int sky) {
  constexpr int cols = Layout<false, kAux>::grad;
  for (int i = 0; i < n; ++i) {
    LaneEnv E = make_lane_env(consts, ent, i, lc[i], seed, 0, td, 0.0f,
                              diel, sky, 1);
    float st[kVolStateVars], g[kVolStateVars], ge[cols], gs[kScalVol];
    for (int k = 0; k < kVolStateVars; ++k) {
      st[k] = state[(size_t)k * n + i];
      g[k] = cot_out[(size_t)k * n + i];
    }
    for (int k = 0; k < kScalVol; ++k) gs[k] = 0.0f;
    step_vjp<false, kAux, true>(st, g, codes[i], it, E, ge, gs);
    for (int k = 0; k < kVolStateVars; ++k) cot_in[(size_t)k * n + i] = g[k];
    for (int k = 0; k < cols; ++k) cot_ent[(size_t)k * n + i] = ge[k];
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
                  float* dscal, float* daux, int aux_base, int n, int seed,
                  int samples, int td, int diel, int sky) {
  if (daux == nullptr)
    host_backward<false, false, true>(tape, lc, consts, ent, cot, n,
                                      samples, td, seed, 0, 0.0f, diel, sky,
                                      1, dscal, EntityAdd{dent});
  else
    host_backward<false, true, true>(tape, lc, consts, ent, cot, n, samples,
                                     td, seed, 0, 0.0f, diel, sky, 1, dscal,
                                     AuxEntityAdd{dent, daux, aux_base});
}
}
"""


@pytest.fixture(scope="module")
def vol_lib(tmp_path_factory):
    out = tmp_path_factory.mktemp("vol_lane")
    src = Path(out) / "harness.cpp"
    src.write_text(_HARNESS)
    lib = Path(out) / "libvollane.so"
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


def probe_cotangents(color, count):
    """Cotangents of (color_sum, count) for the probe loss
    sum(color / max(count, 1) * cos(0.37 i))."""
    n = color.shape[0]
    probe = np.cos(np.arange(n * 3, dtype=np.float32).reshape(n, 3)
                   * np.float32(0.37))
    safe = np.maximum(count, 1.0)
    cot_color = (probe / safe[:, None]).astype(np.float32)
    cot_count = np.where(count >= 1.0, -(color * probe).sum(1) / safe**2,
                         0.0).astype(np.float32)
    return cot_color, cot_count


def setup(name, size, spp, depth, seed):
    """The batch inputs, its tape, and keyword arguments of the replay."""
    scene, tables, rect, box, vol0 = port_batch(name, size)
    n = size * size
    lane_count = torch.full((n,), spp, dtype=torch.int32)
    kw = dict(samples=spp, trace_depth=depth,
              has_dielectrics=scene.flags.has_dielectrics,
              sky_on=scene.flags.sky == 1, rect_tables=rect, box_tables=box,
              vol0=vol0)
    out = megatrace.sample_batch(lane_count, torch.zeros(n), *tables, seed,
                                 want_tape=True, **kw)
    return tables, lane_count, kw, out


# Depths that 8 does not divide keep JAX's replay VJP compiling in
# seconds (its _CKPT_SPAN, tests/test_torch_aux_grad.py); depths 8 to 64
# are held to autograd of the port's replay below, which this test holds
# to JAX's.
@pytest.mark.parametrize("name,size,spp,depth,seed", [
    ("volume", 16, 2, 6, 3), ("inside", 12, 3, 5, 5),
    ("cornell_volumes", 12, 2, 6, 3), ("box_inside", 12, 2, 5, 4),
])
def test_replay_and_gradient_match_jax(name, size, spp, depth, seed):
    tables, lane_count, kw, out = setup(name, size, spp, depth, seed)
    rect, box, vol0 = (kw.pop(k) for k in ("rect_tables", "box_tables",
                                           "vol0"))
    aux = [t for pair in (rect, box) if pair is not None for t in pair]
    leaves = [t.detach().clone().requires_grad_()
              for t in (*tables, *aux, vol0)]
    it = iter(leaves[6:-1])
    lrect = None if rect is None else (next(it), next(it))
    lbox = None if box is None else (next(it), next(it))
    csum, cnt = mr.replay(out["tape"], lane_count, *leaves[:6], seed,
                          rect_tables=lrect, box_tables=lbox,
                          vol0=leaves[-1], **kw)
    # the replay is the kernel's plain version, bit for bit
    assert torch.equal(csum.detach(), out["color"])
    assert torch.equal(cnt.detach(), out["count"])

    _, jtables, jrect, jbox, jvol0 = jax_batch(name, size)
    jaux = [t for pair in (jrect, jbox) if pair is not None for t in pair]
    tape = jnp.asarray(out["tape"].numpy())

    def jax_fn(*lv):
        rest = iter(lv[6:-1])
        r = None if jrect is None else (next(rest), next(rest))
        b = None if jbox is None else (next(rest), next(rest))
        return jax_replay.replay(tape, jnp.asarray(lane_count.numpy()),
                                 *lv[:6], jnp.int32(seed), r, b,
                                 vol0=lv[-1], **kw)

    (jcsum, jcnt), vjp = jax.vjp(jax_fn, *jtables, *jaux, jvol0)
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
    names = (*LEAVES, *(["rect_geo", "rect_rec"] if rect else []),
             *(["box_geo", "box_rec"] if box else []), "vol0")
    nonzero = []
    ref = [np.asarray(r) for r in ref]
    largest = max(np.abs(r).max(initial=0.0) for r in ref)
    for leaf, p, r in zip(names, ported, ref):
        p = np.zeros_like(r) if p is None else p.numpy()
        scale = np.abs(r).max() if r.size else 0.0
        if scale <= NOISE * largest:
            # a gradient that is zero but for rounding (see the docstring)
            assert np.abs(p).max(initial=0.0) <= NOISE * largest, leaf
            continue
        nonzero.append(leaf)
        assert np.abs(p - r).max() <= JAX_GRAD_TOL * scale, (
            leaf, np.abs(p - r).max() / scale)
        cosine = (p * r).sum() / np.sqrt((p * p).sum() * (r * r).sum())
        assert cosine >= JAX_COSINE, (leaf, cosine)
    # a camera inside a medium: its row's density and albedo move
    assert ("vol0" in nonzero) == (name in ("inside", "box_inside"))


def vol_env(name, size, spp, depth, seed):
    """setup() plus the lane code's entity table and constants."""
    tables, lane_count, kw, out = setup(name, size, spp, depth, seed)
    ent = mr.build_entity_rows(*tables[1:4], None, kw["rect_tables"],
                               kw["box_tables"]).detach().contiguous()
    if kw["rect_tables"] is None and kw["box_tables"] is None:
        ent = ent[:tables[1].shape[0]].contiguous()
    consts = mb._consts(tables[0], tables[4], tables[5], kw["vol0"])
    return tables, lane_count, kw, out, ent, consts


@pytest.mark.parametrize("name", ["volume", "inside", "cornell_volumes",
                                  "box_inside"])
def test_step_and_its_adjoint_match_autograd(vol_lib, name):
    seed, depth = 7, 8
    tables, lane_count, kw, out, ent, consts = vol_env(name, 20, 2, depth,
                                                       seed)
    aux = int(kw["rect_tables"] is not None or kw["box_tables"] is not None)
    cols = mr.AUX_GRAD_COLS if aux else mr.GRAD_COLS
    cotangents = ((mb.AUX_STEP_COTANGENTS if aux else mb.STEP_COTANGENTS)
                  + mb.VOL_COTANGENTS)
    n = lane_count.shape[0]
    lcf = lane_count.float().contiguous()
    env = mr.make_env(lane_count, tables[0], tables[4], tables[5], seed,
                      vol0=kw["vol0"])
    state = mr.initial_state(n, "cpu", has_volumes=True)
    keys = mr.VOL_STATE_KEYS
    rng = np.random.default_rng(0)
    diel, sky = int(kw["has_dielectrics"]), int(kw["sky_on"])
    worst = {}
    for it in range(2 * depth):
        codes = out["tape"][it].contiguous()
        s_in = torch.stack([state[k] for k in keys]).contiguous()
        s_host = s_in.clone()
        vol_lib.step_forward_all(_p(s_host), _p(codes), _p(lcf),
                                 _p(consts), _p(ent), n, it, seed, depth,
                                 diel, sky, aux)
        wt = ent[torch.clamp(codes, min=0).long()].T
        state = mr.replay_iteration(
            state, wt, codes, it, env, jitter=True,
            has_dielectrics=bool(diel), sky_on=bool(sky), trace_depth=depth,
            has_aux=bool(aux), has_volumes=True)
        s_out = torch.stack([state[k] for k in keys])
        lp = keys.index("lp")  # a log sum: logf against torch's log
        same = torch.ones(len(keys), dtype=torch.bool)
        same[lp] = False
        assert torch.equal(s_host[same], s_out[same]), it

        cot_out = torch.from_numpy(
            rng.standard_normal((len(keys), n)).astype(np.float32))
        cot_out[12:16] = 0.0  # decisions and counters carry no cotangent
        cot_out[keys.index("in_id")] = 0.0
        got = (torch.empty(len(keys), n), torch.empty(len(cols), n),
               torch.empty(mb.N_SCAL_VOL, n))
        vol_lib.step_vjp_all(_p(s_in), _p(codes), _p(cot_out), _p(lcf),
                             _p(consts), _p(ent), *(_p(t) for t in got), n,
                             it, seed, depth, diel, sky, aux)
        want = mb.replay_step_vjp_reference(
            s_in, codes, it, cot_out, lane_count, *tables, seed,
            trace_depth=depth, has_dielectrics=bool(diel),
            sky_on=bool(sky), rect_tables=kw["rect_tables"],
            box_tables=kw["box_tables"], vol0=kw["vol0"])
        for leaf, k, rows in cotangents:
            g, r = got[k][rows], want[k][rows]
            scale = float(r.abs().max())
            if scale == 0.0:
                assert float(g.abs().max()) == 0.0, (it, leaf)
                continue
            err = float((g - r).abs().max()) / scale
            worst[leaf] = max(worst.get(leaf, 0.0), err)
    assert max(worst.values()) <= TOL, worst
    assert "medium" in worst and "records" in worst
    if name in ("inside", "box_inside"):
        assert "vol0" in worst


# depths 35 (the reference's default) and 64 (the kernel's MAX_DEPTH) run
# paths longer than any at depth 8
@pytest.mark.parametrize("name,size,spp,depth", [
    ("volume", 16, 2, 8), ("inside", 12, 2, 8), ("cornell_volumes", 12, 2, 8),
    ("box_inside", 32, 2, 8), ("box_inside", 12, 2, 35),
    ("probabilistic", 8, 2, 64), ("cornell_volumes", 8, 2, 64),
])
def test_lane_backward_matches_replay_grad_reference(vol_lib, name, size,
                                                     spp, depth):
    seed = 11
    tables, lane_count, kw, out, ent, consts = vol_env(name, size, spp,
                                                       depth, seed)
    n = lane_count.shape[0]
    rng = np.random.default_rng(1)
    cot_color = torch.from_numpy(rng.standard_normal((n, 3))
                                 .astype(np.float32))
    cot_count = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    want = mb.replay_grad_reference(out["tape"], lane_count, *tables, seed,
                                    cot_color, cot_count, **kw)
    s = tables[1].shape[0]
    s_pad = megatrace.sphere_pad_count(s)
    rect, box = kw["rect_tables"], kw["box_tables"]
    flat = [t for pair in (rect, box) if pair is not None for t in pair]
    cot = torch.cat([cot_color.T, cot_count[None]]).contiguous()
    dent = torch.zeros(s, len(mr.GRAD_COLS))
    daux = (torch.zeros(ent.shape[0] - s_pad, len(mr.AUX_GRAD_COLS))
            if flat else None)
    dscal = torch.zeros(mb.N_SCAL_VOL)
    lcf = lane_count.float().contiguous()  # bound while the call runs
    vol_lib.backward_all(_p(out["tape"]), _p(lcf), _p(consts), _p(ent),
                         _p(cot), _p(dent), _p(dscal), _p(daux), s_pad, n,
                         seed, spp, depth, int(kw["has_dielectrics"]),
                         int(kw["sky_on"]))
    with torch.enable_grad():
        leaves = tuple(t.detach().requires_grad_()
                       for t in (*tables[1:4], *flat))
        rest = iter(leaves[3:])
        rows = mr.build_entity_rows(
            *leaves[:3], None,
            None if rect is None else (next(rest), next(rest)),
            None if box is None else (next(rest), next(rest)))
    dtable = torch.zeros_like(rows)
    dtable[:s, list(mr.GRAD_COLS)] = dent
    if daux is not None:
        dtable[s_pad:, list(mr.AUX_GRAD_COLS)] = daux
    grads = torch.autograd.grad(rows, leaves, dtable, allow_unused=True)
    got = (dscal[:24], *grads[:3], dscal[24:27], dscal[27:30], *grads[3:],
           dscal[30:])
    assert assert_leaves_close(got, want) >= 2


def test_density_gradient_is_the_score_term():
    """The replay's density gradient on the volume scene comes from the lp
    terms alone: with the score surrogate cut (lp detached) it is zero,
    as the JAX replay's detached free path makes it."""
    tables, lane_count, kw, out = setup("volume", 12, 2, 6, 2)
    records = tables[3].detach().clone().requires_grad_()
    vol0 = kw.pop("vol0")
    csum, cnt = mr.replay(out["tape"], lane_count, tables[0], tables[1],
                          tables[2], records, tables[4], tables[5], 2,
                          vol0=vol0, **kw)
    (g,) = torch.autograd.grad(csum.sum() + cnt.sum(), (records,))
    fog = 1  # volume_test's fog sphere
    assert float(g[fog, 9].abs()) > 0.0  # its density (record column 9)


def test_density_fit_runs_through_the_trainer():
    """diff/inverse.optimize on cornell_volumes' material parameters (the
    two densities): the density reaches the replay through the packed
    records and aux tables, and moves."""
    from raytracing_in_one_weekend_tpu_torch.core import camera as cam_mod
    from raytracing_in_one_weekend_tpu_torch.diff import inverse
    from raytracing_in_one_weekend_tpu_torch.models import testbeds
    from raytracing_in_one_weekend_tpu_torch.render import renderer

    scene, cs = testbeds.cornell_with_volumes()
    cam = cam_mod.make_camera(cs.origin, cs.look_at, cs.up, cs.vertical_fov,
                              1.0, focus_distance=cs.focus_distance)
    cfg = inverse.InverseRenderConfig(width=10, height=10,
                                      samples_per_pixel=4, trace_depth=6,
                                      learning_rate=0.5, steps=3)
    target = renderer.render_image(scene, cam, width=10, height=10,
                                   samples_per_pixel=16, trace_depth=6,
                                   seed=3, differentiable=False).color
    start = scene.materials.parameter.clone()
    start[4:6] = 4.0  # the smoke's and the fog's densities
    fit, losses = inverse.optimize(scene, cam, target,
                                   {"material_parameters": start}, cfg,
                                   seed=0)
    assert len(losses) == 3 and np.isfinite(losses).all()
    moved = (fit["material_parameters"] - start).abs()
    assert float(moved[4:6].max()) > 0.0
    assert float(moved[:4].max()) == 0.0  # the surfaces' have no gradient


@pytest.mark.cuda
@pytest.mark.parametrize("name,depth", [("cornell_volumes", 8),
                                        ("inside", 35), ("box_inside", 8)])
def test_cuda_backward_matches_plain_version(name, depth):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    tables, lane_count, kw, _ = setup(name, 32, 2, depth, 9)
    tables = [t.to(dev) for t in tables]
    for k in ("rect_tables", "box_tables"):
        if kw[k] is not None:
            kw[k] = tuple(t.to(dev) for t in kw[k])
    kw["vol0"] = kw["vol0"].to(dev)
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
    assert assert_leaves_close(got, want) >= 2
