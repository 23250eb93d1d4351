"""Gradients through rects and boxes: the port's tape replay against the
JAX package's, and the backward kernel's aux build (its lane code built
for the host) against torch.autograd of the plain replay.

* The replay's primal equals the port's plain forward bit for bit, and
  its gradients (the six sphere/camera/sky leaves and pack_aux_tables'
  rect_geo, rect_rec, box_geo and box_rec) agree with jax.vjp of JAX's
  `megatrace_replay.replay` on the same tape and probe-loss cotangents
  (tests/test_torch_replay.py): cosine >= 0.9999 and each leaf within 2e-2
  of its max abs, the cover's bound (measured: cosine 1.000000, errors <=
  2.9e-6 of the max).  On `cornell` every surface is a flat Lambert or
  emitter, so its geometry's gradients are exactly zero (on both sides)
  and only the material rows carry any; the mixed scene (a metal box, a
  gradient sky) gives every rect and box leaf a gradient, and so does the
  glossy one below (a rough metal wall and a glass box added).
* The lane code's aux build (csrc/megatrace_replay_lane.cuh, kAux): each
  iteration's forward equal to `replay_iteration` on every state entry but
  `lp`, its hand VJP within 5e-4 of each cotangent's max abs of autograd's
  (megatrace_bwd.AUX_STEP_COTANGENTS), and `host_backward` (the kernels'
  whole schedule) within 5e-4 of each leaf's max of
  `replay_grad_reference` at depths 8 to 64.
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
from test_torch_aux import jax_batch, port_batch

LEAVES = ("camera_row", "centers", "radii", "records", "sky_bottom",
          "sky_top")
JAX_GRAD_TOL = 2e-2  # the cover's bound, tests/test_torch_replay.py
JAX_COSINE = 0.9999
TOL = 5e-4  # the kernel against the plain replay's autograd

_HARNESS = r"""
#include "megatrace_replay_lane.cuh"
using namespace rtiw;

// The aux build (kAux) of the lane code, one lane at a time.
extern "C" {
void step_forward_all(float* state, const float* codes, const float* lc,
                      const float* consts, const float* ent, int n, int it,
                      int seed, int td, int diel, int sky) {
  for (int i = 0; i < n; ++i) {
    LaneEnv E = make_lane_env(consts, ent, i, lc[i], seed, 0, td, 0.0f,
                              diel, sky, 1);
    float st[kStateVars];
    for (int k = 0; k < kStateVars; ++k) st[k] = state[(size_t)k * n + i];
    step_forward<false, true>(st, codes[i], it, E);
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
    float st[kStateVars], g[kStateVars], ge[kAuxGradCols], gs[kScal];
    for (int k = 0; k < kStateVars; ++k) {
      st[k] = state[(size_t)k * n + i];
      g[k] = cot_out[(size_t)k * n + i];
    }
    for (int k = 0; k < kScal; ++k) gs[k] = 0.0f;
    step_vjp<false, true>(st, g, codes[i], it, E, ge, gs);
    for (int k = 0; k < kStateVars; ++k) cot_in[(size_t)k * n + i] = g[k];
    for (int k = 0; k < kAuxGradCols; ++k)
      cot_ent[(size_t)k * n + i] = ge[k];
    for (int k = 0; k < kScal; ++k) cot_scal[(size_t)k * n + i] = gs[k];
  }
}
void backward_all(const float* tape, const float* lc, const float* consts,
                  const float* ent, const float* cot, float* dent,
                  float* dscal, float* daux, int aux_base, int n, int seed,
                  int samples, int td, int diel, int sky) {
  host_backward<false, true>(tape, lc, consts, ent, cot, n, samples, td,
                             seed, 0, 0.0f, diel, sky, 1, dscal,
                             AuxEntityAdd{dent, daux, aux_base});
}
}
"""


@pytest.fixture(scope="module")
def aux_lib(tmp_path_factory):
    out = tmp_path_factory.mktemp("aux_lane")
    src = Path(out) / "harness.cpp"
    src.write_text(_HARNESS)
    lib = Path(out) / "libauxlane.so"
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
    scene, tables, rect, box = port_batch(name, size)
    n = size * size
    lane_count = torch.full((n,), spp, dtype=torch.int32)
    kw = dict(samples=spp, trace_depth=depth,
              has_dielectrics=scene.flags.has_dielectrics,
              sky_on=scene.flags.sky == 1, rect_tables=rect, box_tables=box)
    out = megatrace.sample_batch(lane_count, torch.zeros(n), *tables, seed,
                                 want_tape=True, **kw)
    return tables, lane_count, kw, out


# Depths that 8 does not divide: JAX's replay then checkpoints each
# iteration alone (its _CKPT_SPAN), while a span of 8 fused iterations,
# or the glossy scene's dielectric box, makes its VJP compile for minutes
# and take gigabytes on the CPU.  The glossy scene and depths 8 to 64 are
# held to autograd of the port's replay below, which this test holds to
# JAX's.
@pytest.mark.parametrize("name,size,spp,depth,seed", [
    ("mixed", 16, 2, 6, 3), ("mixed", 12, 3, 5, 5),
    ("cornell", 16, 2, 6, 3), ("simple_light", 16, 2, 6, 3),
])
def test_replay_and_gradient_match_jax(name, size, spp, depth, seed):
    tables, lane_count, kw, out = setup(name, size, spp, depth, seed)
    rect, box = kw.pop("rect_tables"), kw.pop("box_tables")
    aux = [t for pair in (rect, box) if pair is not None for t in pair]
    leaves = [t.detach().clone().requires_grad_() for t in (*tables, *aux)]
    it = iter(leaves[6:])
    lrect = None if rect is None else (next(it), next(it))
    lbox = None if box is None else (next(it), next(it))
    csum, cnt = mr.replay(out["tape"], lane_count, *leaves[:6], seed,
                          rect_tables=lrect, box_tables=lbox, **kw)
    # the replay is the kernel's plain version, bit for bit
    assert torch.equal(csum.detach(), out["color"])
    assert torch.equal(cnt.detach(), out["count"])

    _, jtables, jrect, jbox = jax_batch(name, size)
    jaux = [t for pair in (jrect, jbox) if pair is not None for t in pair]
    tape = jnp.asarray(out["tape"].numpy())

    def jax_fn(*lv):
        rest = iter(lv[6:])
        r = None if jrect is None else (next(rest), next(rest))
        b = None if jbox is None else (next(rest), next(rest))
        return jax_replay.replay(tape, jnp.asarray(lane_count.numpy()),
                                 *lv[:6], jnp.int32(seed), r, b, **kw)

    (jcsum, jcnt), vjp = jax.vjp(jax_fn, *jtables, *jaux)
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
             *(["box_geo", "box_rec"] if box else []))
    nonzero = []
    for leaf, p, r in zip(names, ported, ref):
        r = np.asarray(r)
        p = np.zeros_like(r) if p is None else p.numpy()
        scale = np.abs(r).max() if r.size else 0.0
        if scale == 0.0:
            assert np.abs(p).max(initial=0.0) == 0.0, leaf
            continue
        nonzero.append(leaf)
        assert np.abs(p - r).max() <= JAX_GRAD_TOL * scale, (
            leaf, np.abs(p - r).max() / scale)
        cosine = (p * r).sum() / np.sqrt((p * p).sum() * (r * r).sum())
        assert cosine >= JAX_COSINE, (leaf, cosine)
    if name == "mixed":  # every rect and box leaf moves
        assert {"rect_geo", "rect_rec", "box_geo", "box_rec"} <= set(nonzero)


def aux_env(name, size, spp, depth, seed):
    """setup() plus the lane code's entity table and constants."""
    tables, lane_count, kw, out = setup(name, size, spp, depth, seed)
    ent = mr.build_entity_rows(*tables[1:4], None, kw["rect_tables"],
                               kw["box_tables"]).detach().contiguous()
    consts = torch.cat([tables[0], tables[4], tables[5], torch.zeros(2)])
    return tables, lane_count, kw, out, ent, consts


@pytest.mark.parametrize("name", ["glossy", "cornell"])
def test_step_and_its_adjoint_match_autograd(aux_lib, name):
    seed, depth = 7, 8
    tables, lane_count, kw, out, ent, consts = aux_env(name, 24, 2, depth,
                                                       seed)
    s_pad = megatrace.sphere_pad_count(tables[1].shape[0])
    assert float((out["tape"] >= s_pad).float().mean()) > 0.05
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
        aux_lib.step_forward_all(_p(s_host), _p(codes), _p(lcf),
                                 _p(consts), _p(ent), n, it, seed, depth,
                                 diel, sky)
        wt = ent[torch.clamp(codes, min=0).long()].T
        state = mr.replay_iteration(state, wt, codes, it, env, jitter=True,
                                    has_dielectrics=bool(diel),
                                    sky_on=bool(sky), trace_depth=depth,
                                    has_aux=True)
        s_out = torch.stack([state[k] for k in mr.STATE_KEYS])
        assert torch.equal(s_host[:-1], s_out[:-1]), it

        cot_out = torch.from_numpy(
            rng.standard_normal((len(mr.STATE_KEYS), n)).astype(np.float32))
        cot_out[12:16] = 0.0  # decisions and counters carry no cotangent
        got = (torch.empty(len(mr.STATE_KEYS), n),
               torch.empty(len(mr.AUX_GRAD_COLS), n),
               torch.empty(mb.N_SCAL, n))
        aux_lib.step_vjp_all(_p(s_in), _p(codes), _p(cot_out), _p(lcf),
                             _p(consts), _p(ent), *(_p(t) for t in got), n,
                             it, seed, depth, diel, sky)
        want = mb.replay_step_vjp_reference(
            s_in, codes, it, cot_out, lane_count, *tables, seed,
            trace_depth=depth, has_dielectrics=bool(diel),
            sky_on=bool(sky), rect_tables=kw["rect_tables"],
            box_tables=kw["box_tables"])
        for leaf, k, rows in mb.AUX_STEP_COTANGENTS:
            g, r = got[k][rows], want[k][rows]
            scale = float(r.abs().max())
            if scale == 0.0:
                assert float(g.abs().max()) == 0.0, (it, leaf)
                continue
            err = float((g - r).abs().max()) / scale
            worst[leaf] = max(worst.get(leaf, 0.0), err)
    assert max(worst.values()) <= TOL, worst
    if name == "glossy":  # the rect and box rows' geometry moves
        assert {"centers", "radii", "positions", "extents"} <= set(worst)


# depths 35 (the reference's default) and 64 (the kernel's MAX_DEPTH) run
# paths longer than any at depth 8
@pytest.mark.parametrize("name,size,spp,depth", [
    ("glossy", 16, 2, 8), ("cornell", 16, 2, 8), ("mixed", 12, 2, 35),
    ("glossy", 8, 2, 64), ("simple_light", 12, 2, 8),
])
def test_lane_backward_matches_replay_grad_reference(aux_lib, name, size,
                                                     spp, depth):
    seed = 11
    tables, lane_count, kw, out, ent, consts = aux_env(name, size, spp,
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
    daux = torch.zeros(ent.shape[0] - s_pad, len(mr.AUX_GRAD_COLS))
    dscal = torch.zeros(mb.N_SCAL)
    lcf = lane_count.float().contiguous()  # bound while the call runs
    aux_lib.backward_all(_p(out["tape"]), _p(lcf), _p(consts), _p(ent),
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
    dtable[s_pad:, list(mr.AUX_GRAD_COLS)] = daux
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
    assert moved >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("name,depth", [("cornell", 8), ("glossy", 35)])
def test_cuda_backward_matches_plain_version(name, depth):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    tables, lane_count, kw, _ = setup(name, 32, 2, depth, 9)
    tables = [t.to(dev) for t in tables]
    for k in ("rect_tables", "box_tables"):
        if kw[k] is not None:
            kw[k] = tuple(t.to(dev) for t in kw[k])
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
    for g, r in zip(got, want):
        if r.numel() == 0:
            continue
        assert float((g - r).abs().max()) <= TOL * float(r.abs().max())


def test_cornell_fit_runs_through_the_trainer():
    """diff/inverse.optimize on cornell's albedos and box positions: the
    rect and box parameters reach the replay through pack_aux_tables;
    the albedos, which reach the image without silhouettes, move toward
    the target."""
    from raytracing_in_one_weekend_tpu_torch.core import camera as cam_mod
    from raytracing_in_one_weekend_tpu_torch.diff import inverse
    from raytracing_in_one_weekend_tpu_torch.models import book_scenes
    from raytracing_in_one_weekend_tpu_torch.render import renderer

    scene, cs = book_scenes.cornell_box()
    cam = cam_mod.make_camera(cs.origin, cs.look_at, cs.up, cs.vertical_fov,
                              1.0, focus_distance=cs.focus_distance)
    cfg = inverse.InverseRenderConfig(width=12, height=12,
                                      samples_per_pixel=4, trace_depth=4,
                                      learning_rate=5e-2, steps=3)
    target = renderer.render_image(scene, cam, width=12, height=12,
                                   samples_per_pixel=16, trace_depth=4,
                                   seed=3, differentiable=False).color
    true = scene.textures.main_color
    start = true.clone()
    start[:3] = 0.5  # the red, green and white walls' albedos
    seen = []
    fit, losses = inverse.optimize(
        scene, cam, target,
        {"texture_colors": start, "box_positions": scene.boxes.pos},
        cfg, seed=0,
        callback=lambda i, p, loss: seen.append(
            float(p["texture_colors"].detach()[:3].sub(start[:3]).abs()
                  .max())))
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert seen[-1] > 0.0  # the albedos moved
    assert torch.isfinite(fit["box_positions"]).all()
