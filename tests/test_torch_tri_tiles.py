"""The batch kernel's triangle build (csrc/megatrace_batch.cu,
megatrace_tri_kernel): the tests of the lanes that sweep a triangle block
are dealt to the warp's 32 threads, rows to threads, the winner a (t, row)
key lowered by atomicMin.

* The plain model of the warp's triangle loop
  (`megatrace.tri_loop_slots`, read over a plain batch by
  `chip_smoke.recorded_tri_loops`): its tests are the plain sweep's
  (TRI_PAIRS); the lane-use share of one thread a lane walking the blocks
  (the build before) lies in (0, 1] and is 1 where every lane of a warp
  needs the same blocks, and the dealt loop's is 1 for blocks of whole
  steps (32 TRI_DEALT_ROWS rows); on a mesh_showcase 32x32 batch 8x4
  tiles give the loop before no lower share than lane order.
* Ties: the plain version on tables where the most hit triangle is copied
  into an earlier row of its block (another thread's row of the dealt
  loop) and into a later block keeps the earliest row on every lane (a
  triangle wins only with a strictly smaller t), and the duplicate in the
  later block never wins.
* cuda-marked: the build against its plain version with uneven lane
  counts (some 0), count_in > 0 and a width that is not a multiple of 8,
  and on the tie tables: tape, count and rays identical on every lane and
  the float channels equal (chip_smoke phase 14 reads max abs err 0).
"""

import pytest
import torch

import chip_smoke
from raytracing_in_one_weekend_tpu_torch.core import camera, materials
from raytracing_in_one_weekend_tpu_torch.models import meshes
from raytracing_in_one_weekend_tpu_torch.ops import megatrace

FLOAT_CHANNELS = ("color", "normal", "albedo", "weight", "fallback_normal",
                  "fallback_albedo")


def showcase_inputs(w, h, dev):
    scene, cs = meshes.mesh_showcase()
    scene = scene.to(dev)
    cam = camera.make_camera(cs.origin, cs.look_at, cs.up, cs.vertical_fov,
                             w / h, aperture=cs.aperture,
                             focus_distance=cs.focus_distance, device=dev)
    packed = materials.pack_materials(scene)
    tables = (megatrace.pack_camera_row(cam, w, h), scene.spheres.center,
              scene.spheres.radius,
              megatrace.pack_sphere_records(scene, packed),
              scene.environment.sky_bottom, scene.environment.sky_top)
    kw = dict(has_dielectrics=scene.flags.has_dielectrics, sky_on=True)
    return scene, tables, megatrace.pack_tri_tables(scene, packed), kw


def loop_totals(w, spp, dev=torch.device("cpu")):
    """tri_loop_slots summed over a plain mesh_showcase batch, in lane
    order and in tiles, and the plain sweep's own pair count."""
    _, tables, tri, kw = showcase_inputs(w, w, dev)
    n = w * w
    orders = dict(lanes=torch.arange(n),
                  tiles=megatrace.tile_lane_order(n, w))
    megatrace.TRI_PAIRS = 0
    with chip_smoke.recorded_tri_loops(tri[0].shape[0], orders) as tot:
        megatrace.sample_batch_reference(
            torch.full((n,), spp, dtype=torch.int32), torch.zeros(n),
            *tables, 7, samples=spp, trace_depth=8, tri_tables=tri,
            chunk_lanes=n, **kw)
    return tot, megatrace.TRI_PAIRS


@pytest.fixture(scope="module")
def showcase_loops():
    return loop_totals(32, 2)


def test_loop_model_counts_the_plain_sweeps_tests(showcase_loops):
    tot, pairs = showcase_loops
    assert pairs > 0
    for name in ("lanes", "tiles"):
        assert tot[name]["tests"] == pairs


def test_loop_shares_lie_in_the_unit_interval(showcase_loops):
    tot, _ = showcase_loops
    for name in ("lanes", "tiles"):
        for slots in ("lane_slots", "dealt_slots"):
            share = tot[name]["tests"] / tot[name][slots]
            assert 0.0 < share <= 1.0, (name, slots, share)
    # mesh_showcase's swept blocks are whole 192-row blocks: whole steps
    # of the dealt loop, no idle thread
    assert tot["tiles"]["tests"] == tot["tiles"]["dealt_slots"]


def test_tiles_give_no_lower_share_than_lane_order(showcase_loops):
    tot, _ = showcase_loops
    share = {k: v["tests"] / v["lane_slots"] for k, v in tot.items()}
    assert share["tiles"] >= share["lanes"], share


@pytest.mark.parametrize("t_rows", [1024, 332, 4096])
def test_loop_share_is_one_where_a_warps_lanes_need_the_same_blocks(t_rows):
    blocks = -(-t_rows // megatrace.TRI_BLOCK)
    n = 32 * 7
    g = torch.Generator().manual_seed(t_rows)
    # each warp (32 lanes in lane order) needs its own random set of blocks
    per_warp = torch.rand((blocks, n // 32), generator=g) < 0.4
    per_warp[0, 0] = True
    tested = per_warp.repeat_interleave(32, dim=1)
    got = megatrace.tri_loop_slots(tested, t_rows, torch.arange(n))
    assert got["tests"] == got["lane_slots"]
    # dealt: each pair runs ceil(rows / step) steps of 32 threads, each
    # thread TRI_DEALT_ROWS rows a step
    step = 32 * megatrace.TRI_DEALT_ROWS
    rows = [min(megatrace.TRI_BLOCK, t_rows - b * megatrace.TRI_BLOCK)
            for b in range(blocks)]
    want = sum(int(tested[b].sum()) * -(-rows[b] // step) * step
               for b in range(blocks))
    assert got["dealt_slots"] == want
    assert got["tests"] / got["dealt_slots"] <= 1.0
    # a thread order that mixes the warps' lanes runs more slots
    mixed = torch.randperm(n, generator=g)
    assert megatrace.tri_loop_slots(tested, t_rows, mixed)["lane_slots"] \
        >= got["lane_slots"]


def test_partial_warps_and_idle_lanes():
    # 45 lanes: a partial second warp of idle threads; lane 40 alone
    # sweeps block 1 (64 rows of a 256-row table)
    tested = torch.zeros((2, 45), dtype=torch.bool)
    tested[0, :3] = True
    tested[1, 40] = True
    got = megatrace.tri_loop_slots(tested, 256, torch.arange(45))
    assert got["tests"] == 3 * 192 + 64
    assert got["lane_slots"] == 32 * 192 + 32 * 64
    # block 1's 64 rows take one step of the dealt loop
    assert got["dealt_slots"] == 3 * 192 + 32 * megatrace.TRI_DEALT_ROWS


def tie_tables(tri, tape, s_pad):
    """pack_tri_tables' pair with the most hit triangle of `tape` copied
    into the row before it (another thread's row of the dealt loop; the
    row after when it is its block's first) and into the same place of
    the next block (the previous one when it is the last block with
    triangles), the block AABBs recomputed as pack_tri_tables does.
    Returns the tables, the original row and its two copies."""
    geo, rec = (t.clone() for t in tri)
    codes = tape[tape >= s_pad].to(torch.int64) - s_pad
    row = int(torch.bincount(codes).argmax())
    blk = megatrace.TRI_BLOCK
    near = row - 1 if row % blk else row + 1
    far = near + blk
    if (geo[far - far % blk, 9] >= 1e29).item():  # a pad-only block
        far = near - blk
    assert 0 <= far < geo.shape[0]
    for dup in (near, far):
        geo[dup, :9] = geo[row, :9]
        rec[:, dup] = rec[:, row]
    v0, ea, eb = geo[:, 6:9], geo[:, 0:3], geo[:, 3:6]
    for st in range(0, geo.shape[0], blk):
        live = (ea[st:st + blk] != 0).any(1) | (eb[st:st + blk] != 0).any(1)
        if not bool(live.any()):  # a pad-only block keeps its far point
            continue
        vs = torch.cat([v0[st:st + blk][live],
                        (v0 + eb)[st:st + blk][live],
                        (v0 + ea)[st:st + blk][live]])
        geo[st, 9:12] = vs.min(dim=0).values - 1e-4
        geo[st, 12:15] = vs.max(dim=0).values + 1e-4
    return (geo, rec), row, near, far


def tie_case(dev):
    """mesh_showcase at 32x32, 4 spp, depth 8 on the tie tables: the
    inputs, and the (original, near, far) rows and the sphere pad."""
    w = 32
    scene, tables, tri, kw = showcase_inputs(w, w, dev)
    n = w * w
    args = (torch.full((n,), 4, dtype=torch.int32, device=dev),
            torch.zeros(n, device=dev), *tables, 9)
    kw = dict(kw, samples=4, trace_depth=8, want_tape=True)
    s_pad = megatrace.sphere_pad_count(scene.spheres.center.shape[0])
    plain = megatrace.sample_batch_reference(*args, tri_tables=tri, **kw)
    tied, row, near, far = tie_tables(tri, plain["tape"], s_pad)
    return args, kw, tied, (row, near, far), s_pad


def test_plain_version_keeps_the_earliest_row_on_ties():
    args, kw, tied, (row, near, far), s_pad = tie_case(torch.device("cpu"))
    got = megatrace.sample_batch_reference(*args, tri_tables=tied, **kw)
    codes = got["tape"][got["tape"] >= s_pad] - s_pad
    first, *later = sorted((row, near, far))
    assert int((codes == first).sum()) > 0
    # the later copies meet every ray the earliest one meets, at the same
    # t, and never win
    for r in later:
        assert int((codes == r).sum()) == 0, r


def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def assert_identical(got, want):
    for k in ("tape", "count", "rays"):
        assert torch.equal(got[k], want[k]), k
    for k in FLOAT_CHANNELS:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
def test_cuda_triangle_build_matches_plain_version_on_ragged_lanes():
    dev = cuda_dev()
    w, h = 100, 37  # not a multiple of 8; n = 3700, not of 128
    _, tables, tri, kw = showcase_inputs(w, h, dev)
    n = w * h
    g = torch.Generator().manual_seed(5)
    lane_count = torch.randint(0, 9, (n,), generator=g).to(torch.int32)
    lane_count[:40] = 0  # whole idle warps' worth of lanes
    count_in = torch.randint(0, 4, (n,), generator=g).to(torch.float32)
    args = (lane_count.to(dev), count_in.to(dev), *tables, 17)
    kw = dict(kw, samples=8, trace_depth=8, want_tape=True, tri_tables=tri,
              lane_base=3 * n)
    before = (megatrace.LAUNCHES, megatrace.TRI_LAUNCHES)
    got = megatrace.sample_batch(*args, **kw)
    assert (megatrace.LAUNCHES, megatrace.TRI_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    want = megatrace.sample_batch_reference(*args, **kw)
    assert_identical(got, want)


@pytest.mark.cuda
def test_cuda_triangle_build_keeps_the_earliest_row_on_ties():
    dev = cuda_dev()
    args, kw, tied, _, _ = tie_case(dev)
    got = megatrace.sample_batch(*args, tri_tables=tied, **kw)
    want = megatrace.sample_batch_reference(*args, tri_tables=tied, **kw)
    assert_identical(got, want)
