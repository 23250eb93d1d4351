"""Gradients through checker, image and Perlin textures: the port's tape
replay against the JAX package's, the backward kernel's texture build (its
lane code built for the host) against torch.autograd of the plain replay,
and a Perlin scene's wavefront gradient against JAX's.

* The replay's primal equals the port's plain forward bit for bit, and its
  gradients (the six sphere/camera/sky leaves, the texture records' main
  and secondary colours and the atlas's texels) agree with jax.vjp of
  JAX's `megatrace_replay.replay` (`tex_tables=`) on the same tape and
  probe-loss cotangents, on `checkered` and `textured_sphere`: cosine >=
  0.9999 and each leaf within 2e-2 of its max abs (tests/
  test_torch_replay.py's bound).  The texel index is a decision on both
  sides (no gradient through the uv).
* The lane code's texture build (csrc/megatrace_replay_lane.cuh, kTex):
  each iteration's forward equal to `replay_iteration`, its hand VJP
  within 5e-4 of each cotangent's max abs of autograd's (STEP_COTANGENTS
  and the texture colours), and `host_backward` (the kernels' schedule,
  the texel plane summed per texel) within 5e-4 of each leaf's max of
  `replay_grad_reference`, the atlas among them, at depths 5 to 64.
* `perlin` trains through the wavefront (the replay has no marble, as
  JAX's): `textures.sample_color`'s gradient to the texture colours and
  the hit points against jax.vjp of JAX's, within 1e-3 of its max abs; the
  whole wavefront's gradient against JAX's is
  tests/test_torch_texture_slow.py (JAX's runs op by op there: its jit
  compile takes many minutes).
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
from raytracing_in_one_weekend_tpu_torch.models import testbeds
from raytracing_in_one_weekend_tpu_torch.ops import megatrace
from raytracing_in_one_weekend_tpu_torch.ops import megatrace_bwd as mb
from raytracing_in_one_weekend_tpu_torch.ops import megatrace_replay as mr
from raytracing_in_one_weekend_tpu_torch.ops.cuda_build import CSRC_DIR
from raytracing_in_one_weekend_tpu_torch.render import integrator
from test_torch_texture import jax_batch, port_batch
from test_torch_volume_grad import probe_cotangents

LEAVES = ("camera_row", "centers", "radii", "records", "sky_bottom",
          "sky_top", "tex_rec", "atlas")
JAX_GRAD_TOL = 2e-2
JAX_COSINE = 0.9999
TOL = 5e-4  # the kernel against the plain replay's autograd

_HARNESS = r"""
#include "megatrace_replay_lane.cuh"
using namespace rtiw;

// The texture build (kTex) of the lane code, one lane at a time.
constexpr int kCols = Layout<false, false, false, true>::grad;
constexpr int kRow = Layout<false, false, false, true>::row;

static LaneEnvTex env(const float* consts, const float* ent, int i,
                      const float* lc, int seed, int td, int diel,
                      const float* atlas, int w, int h) {
  LaneEnvTex E;
  static_cast<LaneEnv&>(E) =
      make_lane_env(consts, ent, i, lc[i], seed, 0, td, 0.0f, diel, 1, 1);
  E.atlas = atlas;
  E.img_w = w;
  E.img_h = h;
  return E;
}

extern "C" {
void step_forward_all(float* state, const float* codes, const float* lc,
                      const float* consts, const float* ent, int n, int it,
                      int seed, int td, int diel, const float* atlas, int w,
                      int h) {
  for (int i = 0; i < n; ++i) {
    const LaneEnvTex E = env(consts, ent, i, lc, seed, td, diel, atlas, w, h);
    float st[kStateVars];
    for (int k = 0; k < kStateVars; ++k) st[k] = state[(size_t)k * n + i];
    step_forward<false, false, false, false, true>(st, codes[i], it, E);
    for (int k = 0; k < kStateVars; ++k) state[(size_t)k * n + i] = st[k];
  }
}
void step_vjp_all(const float* state, const float* codes,
                  const float* cot_out, const float* lc, const float* consts,
                  const float* ent, float* cot_in, float* cot_ent,
                  float* cot_scal, int n, int it, int seed, int td, int diel,
                  const float* atlas, int w, int h) {
  for (int i = 0; i < n; ++i) {
    const LaneEnvTex E = env(consts, ent, i, lc, seed, td, diel, atlas, w, h);
    float st[kStateVars], g[kStateVars], ge[kRow], gs[kScal];
    for (int k = 0; k < kStateVars; ++k) {
      st[k] = state[(size_t)k * n + i];
      g[k] = cot_out[(size_t)k * n + i];
    }
    for (int k = 0; k < kScal; ++k) gs[k] = 0.0f;
    step_vjp<false, false, false, false, true>(st, g, codes[i], it, E, ge,
                                               gs);
    for (int k = 0; k < kStateVars; ++k) cot_in[(size_t)k * n + i] = g[k];
    for (int k = 0; k < kCols; ++k) cot_ent[(size_t)k * n + i] = ge[k];
    for (int k = 0; k < kScal; ++k) cot_scal[(size_t)k * n + i] = gs[k];
  }
}
void backward_all(const float* tape, const float* lc, const float* consts,
                  const float* ent, const float* cot, float* dent,
                  float* dscal, float* datlas, int n, int seed, int samples,
                  int td, int diel, const float* atlas, int w, int h) {
  host_backward<false, false, false, false, true>(
      tape, lc, consts, ent, cot, n, samples, td, seed, 0, 0.0f, diel, 1, 1,
      dscal, TexEntityAdd{dent, datlas}, atlas, w, h);
}
}
"""


@pytest.fixture(scope="module")
def tex_lib(tmp_path_factory):
    out = tmp_path_factory.mktemp("tex_lane")
    src = Path(out) / "harness.cpp"
    src.write_text(_HARNESS)
    lib = Path(out) / "libtexlane.so"
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
    texture build takes textured spheres alone)."""
    scene, tables, kw = port_batch(name, size)
    assert kw["rect_tables"] is None and kw["vol0"] is None
    n = size * size
    lane_count = torch.full((n,), spp, dtype=torch.int32)
    kw = dict(samples=spp, trace_depth=depth,
              has_dielectrics=scene.flags.has_dielectrics, sky_on=True,
              tex_tables=kw["tex_tables"])
    out = megatrace.sample_batch(lane_count, torch.zeros(n), *tables, seed,
                                 want_tape=True, **kw)
    return tables, lane_count, kw, out


@pytest.mark.parametrize("name,size,spp,depth,seed", [
    ("checkered", 16, 2, 5, 3), ("textured_sphere", 16, 2, 5, 4),
])
def test_replay_and_gradient_match_jax(name, size, spp, depth, seed):
    tables, lane_count, kw, out = setup(name, size, spp, depth, seed)
    tex = kw.pop("tex_tables")
    atlas = tex.atlas
    leaves = [t.detach().clone().requires_grad_() for t in (
        *tables, tex.rec, *(() if atlas is None else (atlas,)))]
    ltex = megatrace.TexTables(leaves[6], None,
                               None if atlas is None else leaves[7], tex.dims)
    csum, cnt = mr.replay(out["tape"], lane_count, *leaves[:6], seed,
                          tex_tables=ltex, **kw)
    # the replay is the kernel's plain version, bit for bit
    assert torch.equal(csum.detach(), out["color"])
    assert torch.equal(cnt.detach(), out["count"])

    _, jtables, jkw = jax_batch(name, size)
    texrec, _, img = jkw["tex_tables"]
    tape = jnp.asarray(out["tape"].numpy())

    def jax_fn(*lv):
        return jax_replay.replay(
            tape, jnp.asarray(lane_count.numpy()), *lv[:6], jnp.int32(seed),
            tex_tables=(lv[6], None, lv[7] if img is not None else None),
            img_dims=jkw["img_dims"], **kw)

    jleaves = (*jtables, texrec, *(() if img is None else (img,)))
    (jcsum, jcnt), vjp = jax.vjp(jax_fn, *jleaves)
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
    m = tex.rec.shape[0]
    ref[6] = ref[6][:, :m].T  # JAX's records, a column a material
    if atlas is not None:  # JAX's planes (3 W_pad, AH_pad)
        w, _ = tex.dims
        w_pad = ref[7].shape[0] // 3
        rows = atlas.shape[0]
        ref[7] = np.stack([ref[7][c * w_pad:c * w_pad + w, :rows].T
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
    assert "tex_rec" in moved
    assert ("atlas" in moved) == (atlas is not None)


def tex_env(name, size, spp, depth, seed):
    """setup() plus the lane code's entity rows (the real spheres', 39
    columns), constants and atlas."""
    tables, lane_count, kw, out = setup(name, size, spp, depth, seed)
    tex = kw["tex_tables"]
    s = tables[1].shape[0]
    ent = mr.build_entity_rows(*tables[1:4], tex_rec=tex.rec).detach()[
        :s].contiguous()
    consts = mb._consts(tables[0], tables[4], tables[5])
    atlas = None if tex.atlas is None else tex.atlas.contiguous()
    return tables, lane_count, kw, out, ent, consts, atlas


@pytest.mark.parametrize("name", ["checkered", "textured_sphere"])
def test_step_and_its_adjoint_match_autograd(tex_lib, name):
    seed, depth = 7, 8
    tables, lane_count, kw, out, ent, consts, atlas = tex_env(name, 16, 2,
                                                              depth, seed)
    w, h = kw["tex_tables"].dims
    cols = mr.grad_cols(False, False, False, True)
    cotangents = mb.STEP_COTANGENTS + mb.TEX_COTANGENTS
    n = lane_count.shape[0]
    lcf = lane_count.float().contiguous()
    env = mr.make_env(lane_count, tables[0], tables[4], tables[5], seed)
    state = mr.initial_state(n, "cpu")
    keys = mr.STATE_KEYS
    rng_ = np.random.default_rng(0)
    diel = int(kw["has_dielectrics"])
    worst = {}
    for it in range(2 * depth):
        codes = out["tape"][it].contiguous()
        s_in = torch.stack([state[k] for k in keys]).contiguous()
        s_host = s_in.clone()
        tex_lib.step_forward_all(_p(s_host), _p(codes), _p(lcf), _p(consts),
                                 _p(ent), n, it, seed, depth, diel, _p(atlas),
                                 w, h)
        wt = ent[torch.clamp(codes, min=0).long()].T
        state = mr.replay_iteration(state, wt, codes, it, env, jitter=True,
                                    has_dielectrics=bool(diel), sky_on=True,
                                    trace_depth=depth, tex=(atlas, (w, h)))
        s_out = torch.stack([state[k] for k in keys])
        lp = keys.index("lp")  # a log sum: logf against torch's log
        same = torch.ones(len(keys), dtype=torch.bool)
        same[lp] = False
        assert torch.equal(s_host[same], s_out[same]), it

        cot_out = torch.from_numpy(
            rng_.standard_normal((len(keys), n)).astype(np.float32))
        cot_out[12:16] = 0.0  # decisions and counters carry no cotangent
        got = (torch.empty(len(keys), n), torch.empty(len(cols), n),
               torch.empty(mb.N_SCAL, n))
        tex_lib.step_vjp_all(_p(s_in), _p(codes), _p(cot_out), _p(lcf),
                             _p(consts), _p(ent), *(_p(t) for t in got), n,
                             it, seed, depth, diel, _p(atlas), w, h)
        want = mb.replay_step_vjp_reference(
            s_in, codes, it, cot_out, lane_count, *tables, seed,
            trace_depth=depth, has_dielectrics=bool(diel),
            tex_tables=kw["tex_tables"])
        for leaf, k, rows in cotangents:
            g, r = got[k][rows], want[k][rows]
            scale = float(r.abs().max())
            if scale == 0.0:
                assert float(g.abs().max()) == 0.0, (it, leaf)
                continue
            err = float((g - r).abs().max()) / scale
            worst[leaf] = max(worst.get(leaf, 0.0), err)
    assert max(worst.values()) <= TOL, worst
    assert "texture_colors" in worst


# depths 35 (the reference's default) and 64 (the kernel's MAX_DEPTH) run
# paths longer than any at depth 8
@pytest.mark.parametrize("name,size,spp,depth", [
    ("checkered", 12, 3, 5), ("textured_sphere", 16, 4, 8),
    ("checkered", 8, 2, 35), ("textured_sphere", 8, 2, 64),
])
def test_lane_backward_matches_replay_grad_reference(tex_lib, name, size,
                                                     spp, depth):
    seed = 11
    tables, lane_count, kw, out, ent, consts, atlas = tex_env(
        name, size, spp, depth, seed)
    tex = kw["tex_tables"]
    n = lane_count.shape[0]
    rng_ = np.random.default_rng(1)
    cot_color = torch.from_numpy(rng_.standard_normal((n, 3))
                                 .astype(np.float32))
    cot_count = torch.from_numpy(rng_.standard_normal(n).astype(np.float32))
    want = mb.replay_grad_reference(out["tape"], lane_count, *tables, seed,
                                    cot_color, cot_count, **kw)
    s = tables[1].shape[0]
    cols = mr.grad_cols(False, False, False, True)
    cot = torch.cat([cot_color.T, cot_count[None]]).contiguous()
    dent = torch.zeros(s, len(cols))
    dscal = torch.zeros(mb.N_SCAL)
    datlas = None if atlas is None else torch.zeros_like(atlas)
    lcf = lane_count.float().contiguous()  # bound while the call runs
    tex_lib.backward_all(_p(out["tape"]), _p(lcf), _p(consts), _p(ent),
                         _p(cot), _p(dent), _p(dscal), _p(datlas), n, seed,
                         spp, depth, int(kw["has_dielectrics"]), _p(atlas),
                         *tex.dims)
    with torch.enable_grad():
        leaves = tuple(t.detach().requires_grad_()
                       for t in (*tables[1:4], tex.rec))
        rows = mr.build_entity_rows(*leaves[:3], tex_rec=leaves[3])
    dtable = torch.zeros_like(rows)
    dtable[:s, list(cols)] = dent
    grads = torch.autograd.grad(rows, leaves, dtable)
    got = (dscal[:24], *grads[:3], dscal[24:27], dscal[27:30], grads[3],
           *(() if datlas is None else (datlas,)))
    assert len(got) == len(want)
    for leaf, g, r in zip(LEAVES, got, want):
        scale = float(r.abs().max())
        assert scale > 0, leaf
        err = float((g - r).abs().max())
        assert err <= TOL * scale, (leaf, err / scale)


def test_perlin_texture_gradient_matches_jax():
    """The wavefront's Perlin marble and checker colours (`textures.
    sample_color`) and their gradient to the texture colours and the hit
    points against jax.vjp of JAX's, on random points over a table of
    every texture type (the whole wavefront's gradient on `perlin` is
    tests/test_torch_texture_slow.py)."""
    from raytracing_in_one_weekend_tpu.core import noise as jax_noise
    from raytracing_in_one_weekend_tpu.core import textures as jax_textures
    from raytracing_in_one_weekend_tpu_torch.core import noise, textures
    from test_torch_texture import _texture_table

    r = np.random.default_rng(6)
    n = 2000
    pos = (r.normal(size=(n, 3)) * 3.0).astype(np.float32)
    nrm = r.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    uv = r.random((n, 2)).astype(np.float32)
    ids = r.integers(0, 7, n).astype(np.int32)
    probe = np.cos(np.arange(n * 3, dtype=np.float32).reshape(n, 3) * 0.37)
    arrays = _texture_table(None)
    jtables = jax_noise.make_perlin_tables(2)

    def jax_fn(main, p):
        table = jax_textures.TextureTable(
            **{k: jnp.asarray(v) for k, v in arrays.items()
               if k != "main_color"}, main_color=main, perlin=jtables)
        return jax_textures.sample_color(table, jnp.asarray(ids),
                                         jnp.asarray(uv), p,
                                         jnp.asarray(nrm))

    want, vjp = jax.vjp(jax_fn, jnp.asarray(arrays["main_color"]),
                        jnp.asarray(pos))
    want_grads = vjp(jnp.asarray(probe))
    main = torch.from_numpy(arrays["main_color"]).requires_grad_()
    p = torch.from_numpy(pos).requires_grad_()
    table = textures.TextureTable(
        **{k: torch.from_numpy(v) for k, v in arrays.items()
           if k != "main_color"}, main_color=main,
        perlin=noise.make_perlin_tables(2))
    got = textures.sample_color(table, torch.from_numpy(ids),
                                torch.from_numpy(uv), p,
                                torch.from_numpy(nrm))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    grads = torch.autograd.grad(got, (main, p), torch.from_numpy(probe))
    for g, w in zip(grads, want_grads):
        w = np.asarray(w)
        scale = np.abs(w).max()
        assert scale > 0
        assert np.abs(g.numpy() - w).max() <= 1e-3 * scale
    # the marble's gradient to the hit point is the turbulence's
    assert float(grads[1][ids == 3].abs().max()) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("name,size,spp,depth", [
    ("checkered", 32, 2, 8), ("textured_sphere", 32, 2, 35),
    ("textured_sphere", 128, 4, 8)])
def test_cuda_backward_matches_plain_version(name, size, spp, depth):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    tables, lane_count, kw, _ = setup(name, size, spp, depth, 9)
    tables = [t.to(dev) for t in tables]
    tex = kw["tex_tables"]
    kw["tex_tables"] = megatrace.TexTables(
        *(None if t is None else t.to(dev) for t in tex[:3]), tex.dims)
    lane_count = lane_count.to(dev)
    n = lane_count.shape[0]
    out = megatrace.sample_batch(lane_count, torch.zeros(n, device=dev),
                                 *tables, 9, want_tape=True, **kw)
    rng_ = np.random.default_rng(2)
    cots = (torch.from_numpy(rng_.standard_normal((n, 3)).astype(np.float32))
            .to(dev),
            torch.from_numpy(rng_.standard_normal(n).astype(np.float32))
            .to(dev))
    before = mb.LAUNCHES
    got = mb.replay_grad(out["tape"], lane_count, *tables, 9, *cots, **kw)
    assert mb.LAUNCHES == before + 1
    want = mb.replay_grad_reference(out["tape"], lane_count, *tables, 9,
                                    *cots, **kw)
    assert len(got) == len(want)
    for leaf, g, r in zip(LEAVES, got, want):
        scale = float(r.abs().max())
        assert scale > 0, leaf
        assert float((g - r).abs().max()) <= TOL * scale, leaf
