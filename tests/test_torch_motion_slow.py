"""Slow check of where the backward kernel's motion build and the plain
replay's autograd part: the lane code's motion build (csrc/
megatrace_replay_lane.cuh, kMotion, built for the host: the kernel's
per-lane arithmetic) against `replay_grad_reference` on cover_motion,
32x32, 4 spp, depth 8, seed 7, with the probe loss's cotangents, where the
two differ by up to ~4e-5 of a leaf's max (the move offsets'; the chip's
128x128 check reads the same order).  Its fast siblings are
tests/test_torch_motion_grad.py's, which hold the two within 5e-4.

* The order of the sums is not the cause: summing the lanes' centre and
  move cotangents in float64 instead of float32 moves the lane code's by
  under 2e-6 of their max.
* The gap sits in a grazing hit: bisecting the lanes by their cotangents
  finds the one lane that carries the move leaf's largest gap.  Its
  gradient there is of the leaf's own size (it goes as 1/sqrt(disc)), the
  two float32 versions of it agree within 1e-4, and both are more than
  10% from a float64 replay along the same tape (the port's plain replay
  with its float helpers in float64): float32 does not fix that lane's
  gradient to better than the gap.

Run with -s to print the numbers.  The file also holds the second seed
of test_torch_motion_grad.py's comparison with JAX's replay (seed 5; the
fast tier keeps seed 4).
"""

import ctypes
import shutil
import subprocess

import pytest
import torch

from raytracing_in_one_weekend_tpu_torch.ops import megatrace as mk
from raytracing_in_one_weekend_tpu_torch.ops import megatrace_bwd as mb
from raytracing_in_one_weekend_tpu_torch.ops import megatrace_replay as mr
from raytracing_in_one_weekend_tpu_torch.ops.cuda_build import CSRC_DIR
from test_torch_motion_grad import _HARNESS, _p, motion_env
from test_torch_volume_grad import probe_cotangents

pytestmark = pytest.mark.slow

# the lane code's backward with the entity cotangents summed in float64
_F64_SUMS = r"""
struct DoubleMotionAdd {
  double* base;
  void operator()(int w, const float* ge) const {
    if (w >= 0)
      for (int k = 0; k < kMotionGradCols; ++k)
        base[w * kMotionGradCols + k] += (double)ge[k];
  }
};
extern "C" void backward_all_f64(
    const float* tape, const float* lc, const float* consts,
    const float* ent, const float* cot, double* dent, float* dscal, int n,
    int seed, int samples, int td, int diel) {
  host_backward<false, false, false, true>(
      tape, lc, consts, ent, cot, n, samples, td, seed, 0, 0.0f, diel, 1, 1,
      dscal, DoubleMotionAdd{dent});
}
"""


def _float64_helpers(monkeypatch):
    """The plain version's float32 helpers replaced by float64 ones (no
    float32 rounding anywhere along the replay)."""
    def d(x):
        return x.double() if isinstance(x, torch.Tensor) else float(x)

    def dot3(ax, ay, az, bx, by, bz):
        return d(az) * d(bz) + (d(ax) * d(bx) + d(ay) * d(by))

    def normalize3(x, y, z, eps=1e-12):
        inv = 1.0 / torch.sqrt(torch.clamp(dot3(x, y, z, x, y, z), min=eps))
        return x * inv, y * inv, z * inv

    helpers = dict(
        _fma=lambda a, b, c: d(a) * d(b) + d(c),
        _sqrt=lambda x: torch.sqrt(d(x)),
        _rsqrt=lambda x: 1.0 / torch.sqrt(d(x)),
        _log=lambda x: torch.log(d(x)), _sin=lambda x: torch.sin(d(x)),
        _cos=lambda x: torch.cos(d(x)), _dot3=dot3, _normalize3=normalize3)
    for mod in (mk, mr):
        for name, fn in helpers.items():
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, fn)


def _replay64(tables, move, lane_count, tape, seed, kw, cots):
    """Gradients of the float64 replay along `tape` (leaves: the six
    tables and the move offsets, promoted to float64)."""
    leaves = [t.detach().double().requires_grad_() for t in (*tables, move)]
    cam, cen, rad, rec, sky_b, sky_t, mv = leaves
    s = cen.shape[0]
    zeros = torch.zeros(s, 1, dtype=torch.float64)
    ent = torch.cat([cen, rad[:, None], zeros.expand(s, 6), rec[:, :11],
                     zeros, rec[:, 11:12], mv], 1)
    env = mr.make_env(lane_count, tables[0], tables[4], tables[5], seed)
    for j, k in enumerate(("co", "ll", "hh", "vv", "rr", "uu")):
        env[k] = cam[3 * j:3 * j + 3]
    env.update(lens_radius=cam[18], width=cam[19], height=cam[20],
               sky_b=sky_b, sky_t=sky_t)
    n = lane_count.shape[0]
    state = {k: v.double() for k, v in
             mr.initial_state(n, "cpu", has_motion=True).items()}
    for it in range(tape.shape[0]):
        codes = tape[it]
        wt = ent[torch.clamp(codes, min=0).long()].T
        state = mr.replay_iteration(
            state, wt, codes, it, env, jitter=True,
            has_dielectrics=kw["has_dielectrics"], sky_on=True,
            trace_depth=kw["trace_depth"], has_motion=True)
    csum = torch.stack([state["csx"], state["csy"], state["csz"]], -1)
    return torch.autograd.grad((csum, state["cnt"]), leaves,
                               tuple(c.double() for c in cots),
                               allow_unused=True)


def test_replay_and_gradient_match_jax_second_seed():
    from test_torch_motion_grad import test_replay_and_gradient_match_jax

    test_replay_and_gradient_match_jax(16, 2, 4, 5)


def test_motion_gradient_gap_is_a_grazing_lane(tmp_path, monkeypatch):
    size, spp, depth, seed = 32, 4, 8, 7
    src = tmp_path / "harness.cpp"
    src.write_text(_HARNESS + _F64_SUMS)
    lib_path = tmp_path / "libmotionf64.so"
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler is needed to build the lane code"
    subprocess.run([cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-fPIC",
                    "-shared", "-I", str(CSRC_DIR), "-o", str(lib_path),
                    str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))

    tables, lane_count, kw, out, ent, consts = motion_env(size, spp, depth,
                                                          seed)
    n, s = lane_count.shape[0], tables[1].shape[0]
    cot_color, cot_count = (torch.from_numpy(c) for c in probe_cotangents(
        out["color"].numpy(), out["count"].numpy()))
    lcf = lane_count.float().contiguous()
    cols = len(mr.grad_cols(False, False, True))
    move_cols = slice(len(mr.GRAD_COLS), cols)

    def lane_code(mask, f64):
        """The lane code's (s, 16) entity cotangents with the lanes outside
        `mask` given no cotangent, summed in float64 or float32."""
        m = mask.float()
        cot = torch.cat([(cot_color * m[:, None]).T,
                         (cot_count * m)[None]]).contiguous()
        dent = torch.zeros(s, cols,
                           dtype=torch.float64 if f64 else torch.float32)
        dscal = torch.zeros(mb.N_SCAL)
        fn = lib.backward_all_f64 if f64 else lib.backward_all
        fn(_p(out["tape"]), _p(lcf), _p(consts), _p(ent), _p(cot), _p(dent),
           _p(dscal), n, seed, spp, depth, int(kw["has_dielectrics"]))
        return dent.double()

    def plain(mask):
        m = mask.float()
        return mb.replay_grad_reference(
            out["tape"], lane_count, *tables, seed, cot_color * m[:, None],
            cot_count * m, **kw)

    every = torch.ones(n, dtype=torch.bool)
    want = plain(every)
    d32, d64 = lane_code(every, False), lane_code(every, True)
    gaps = {}
    for leaf, sl, w in (("centers", slice(0, 3), want[1]),
                        ("move_offsets", move_cols, want[6])):
        scale = float(w.abs().max())
        order = float((d32[:, sl] - d64[:, sl]).abs().max()) / scale
        gaps[leaf] = float((d32[:, sl] - w.double()).abs().max()) / scale
        print(f"{leaf}: lane code against plain {gaps[leaf]:.3e} of the "
              f"leaf's max; float32 against float64 sums {order:.3e}")
        assert order < 2e-6, (leaf, order)
    assert gaps["move_offsets"] > 1e-5  # the gap this test explains

    # bisect the lanes for the one behind the move leaf's largest gap
    diff = (d64[:, move_cols] - want[6].double()).abs()
    row, col = divmod(int(diff.argmax()), 3)
    lanes = torch.arange(n)
    while lanes.numel() > 1:
        halves = (lanes[:lanes.numel() // 2], lanes[lanes.numel() // 2:])
        part_gaps = []
        for half in halves:
            mask = torch.zeros(n, dtype=torch.bool)
            mask[half] = True
            got = lane_code(mask, True)[row, move_cols][col]
            part_gaps.append(abs(float(got) - float(plain(mask)[6][row, col])))
        lanes = halves[part_gaps.index(max(part_gaps))]
    lane = int(lanes[0])
    mask = torch.zeros(n, dtype=torch.bool)
    mask[lane] = True
    g_lane = lane_code(mask, True)[row, move_cols]
    p_lane = plain(mask)[6][row].double()
    _float64_helpers(monkeypatch)
    m = mask.float()
    g64 = _replay64(tables, kw["move_offsets"], lane_count, out["tape"],
                    seed, dict(kw, trace_depth=depth),
                    (cot_color * m[:, None], cot_count * m))[6][row]
    norm64 = float(g64.norm())
    apart = float((g_lane - p_lane).norm()) / float(p_lane.norm())
    off32 = float((p_lane - g64).norm()) / norm64
    off_code = float((g_lane - g64).norm()) / norm64
    share = float(p_lane.abs().max()) / float(want[6].abs().max())
    print(f"lane {lane} (sphere {row}, tape {out['tape'][:, lane].tolist()}"
          f"): move gradient {share:.3f} of the leaf's max; lane code and "
          f"plain {apart:.3e} apart; float64 replay {off32:.3f} from plain, "
          f"{off_code:.3f} from the lane code")
    assert share > 0.1
    assert apart < 1e-4
    assert off32 > 0.1 and off_code > 0.1
