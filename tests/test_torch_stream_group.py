"""The batch kernel's streamed build sweeps triangles group by group: its
traversal (csrc/group_sweep.cuh, shared with the bounce-synchronous
sampler) against the index-order sweep of the plain version.

* (a) A plain mesh_large batch (`megatrace.sample_batch_reference`, Morton
  lanes of a 32x32 image, the first 1000 of them, 2 spp, depth 8, uneven
  lane counts of 0, 1 and 2 samples, one group of 128 lanes with a single
  live lane and one with none) is recorded bounce by bounce: the lanes
  that bounce and the rays, sphere hits and (t, row, u, v) of each
  `_tri_stream_sweep` call (chip_smoke.recorded_sweeps).  The kernel's
  model then sweeps the same rays in their lane places, in groups of
  SYNC_GROUP lanes in lane order (the last one partial), each visiting the
  supers in tile_super_order's order over its live lanes
  (chip_smoke.group_traversal: meshtrace.sync_traversal).  On every live
  lane of every bounce the winner is the index-order sweep's, bit for bit:
  whether a triangle beats the spheres and, where one does, its (t, row,
  u, v).  A triangle that loses to a sphere is not compared: the early
  stop may skip it, and the shading never reads it.
* (b) cuda-marked: the kernel against its plain version on mesh_large with
  uneven lane counts and a partial last group: count and rays identical,
  the float channels within atol=rtol=1e-4 on >= 99% of lanes (chip_smoke
  phase 3's criterion).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from raytracing_in_one_weekend_tpu_torch.core import camera, materials
from raytracing_in_one_weekend_tpu_torch.models import meshes
from raytracing_in_one_weekend_tpu_torch.ops import megatrace, meshtrace

GROUP = meshtrace.SYNC_GROUP


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process (tests/test_torch_integrator.py):
    the tier-1 run puts six of them on the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def uneven_batch(dev, width, lanes, spp, seed):
    """sample_batch's arguments for the first `lanes` Morton lanes of a
    width x width mesh_large image: lane counts drawn from 0..spp (numpy,
    `seed`), group 2 with one live lane (spp samples), group 5 with none;
    and the keyword arguments of a depth-8 batch."""
    scene, cs = meshes.mesh_large()
    scene = scene.to(dev)
    cam = camera.make_camera(cs.origin, cs.look_at, cs.up, cs.vertical_fov,
                             1.0, aperture=cs.aperture,
                             focus_distance=cs.focus_distance, device=dev)
    pk = materials.pack_materials(scene)
    counts = np.random.default_rng(seed).integers(0, spp + 1, lanes)
    counts[2 * GROUP:3 * GROUP] = 0
    counts[2 * GROUP + 77] = spp
    counts[5 * GROUP:6 * GROUP] = 0
    order, _ = megatrace.morton_order(width, width)
    args = (torch.from_numpy(counts.astype(np.int32)).to(dev),
            torch.zeros(lanes, device=dev),
            megatrace.pack_camera_row(cam, width, width),
            scene.spheres.center, scene.spheres.radius,
            megatrace.pack_sphere_records(scene, pk),
            scene.environment.sky_bottom, scene.environment.sky_top, seed)
    stream = megatrace.pack_tri_stream_tables(scene, pk)
    kwargs = dict(samples=spp, trace_depth=8,
                  pixel_index=order[:lanes].to(dev), tri_stream_tables=stream,
                  has_dielectrics=scene.flags.has_dielectrics)
    return args, kwargs


@pytest.fixture(scope="module")
def recorded():
    args, kwargs = uneven_batch(torch.device("cpu"), 32, 1000, 2, 3)
    with chip_smoke.recorded_sweeps() as calls:
        megatrace.sample_batch_reference(*args, **kwargs)
    return calls, kwargs["tri_stream_tables"]


def test_group_traversal_finds_the_index_order_winners(recorded):
    calls, stream = recorded
    assert len(calls) > 8  # the lanes with two samples run a second path
    empty_groups = wins_total = 0
    for call in calls:
        live = call["live"]
        assert live.shape[0] == 1000 and bool(live.any())
        got, counts = chip_smoke.group_traversal(call, stream)
        want, best_t = call["hit"], call["best_t"]
        wins = want[0] < best_t
        np.testing.assert_array_equal((got[0] < best_t).numpy(),
                                      wins.numpy())
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[wins].numpy(), w[wins].numpy())
        assert counts["lane_pairs"] <= counts["warp_pairs"] \
            <= 32 * counts["group_pairs"]
        groups = torch.cat([live, live.new_zeros(24)]).reshape(-1, GROUP)
        empty_groups += int((~groups.any(dim=1)).sum())
        wins_total += int(wins.sum())
        # group 2 bounces its one live lane alone
        assert int(groups[2].sum()) <= 1
    assert empty_groups > len(calls)  # group 5 and the groups that finish
    assert wins_total > 300  # triangle winners compared


@pytest.mark.cuda
def test_cuda_streamed_kernel_matches_plain_version_with_uneven_lanes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args, kwargs = uneven_batch(torch.device("cuda"), 64, 64 * 64 - 45, 4, 5)
    before = megatrace.LAUNCHES
    got = megatrace.sample_batch(*args, **kwargs)
    assert megatrace.LAUNCHES == before + 1
    want = megatrace.sample_batch_reference(*args, **kwargs)
    assert torch.equal(got["count"], want["count"])
    assert torch.equal(got["rays"], want["rays"])
    share, _ = chip_smoke.lane_agreement(got, want)
    assert share >= 0.99


def test_kernel_arguments_refuse_what_the_kernels_cannot_take(recorded):
    """The streamed kernels copy 192-row blocks with TMA and order at most
    MAX_SUPERS supers: the wrappers' argument check refuses rows that are
    not 16-byte aligned and more supers, before any launch."""
    _, stream = recorded
    dev = stream.geo.device
    megatrace._kernel_stream_args(stream, dev)  # the packer's tables
    shifted = torch.empty(stream.geo.numel() + 1)[1:].view_as(stream.geo)
    shifted.copy_(stream.geo)
    with pytest.raises(ValueError, match="16-byte"):
        megatrace._kernel_stream_args(stream._replace(geo=shifted), dev)
    n_sup = megatrace.MAX_SUPERS + 1
    rows = n_sup * megatrace.TRI_SUP * megatrace.TRI_BLOCK
    big = megatrace.TriStream(
        torch.zeros((rows, 12)), torch.zeros((rows, megatrace.TRI_REC_ROWS)),
        torch.zeros((n_sup * megatrace.TRI_SUP, 8)), torch.zeros((n_sup, 8)))
    with pytest.raises(ValueError, match="supers"):
        megatrace._kernel_stream_args(big, dev)
