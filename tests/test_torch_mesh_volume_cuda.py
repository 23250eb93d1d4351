"""The builds of ROADMAP step 7.2b against their plain versions on the card:
the triangle build's and the streamed kernel's volume builds (convex
volumes beside a mesh, with rects and boxes and without), white and with
BLUE (the tables and the pre-drawn rows for the triangle build, the
pre-drawn rows on Morton lanes for the streamed kernel), on a 128x128
batch with adaptive lane counts, 4 spp, depth 8, every output held bit
for bit and each launch counted in its family's counter
(TRI_VOL_LAUNCHES, STREAM_VOL_LAUNCHES, NOISE_BUILDS); the backward's
MESH_VOL and MESH_AUX_VOL builds against the plain replay within 5e-4 of
each leaf's max (floored at 1e-4 of the largest leaf's, as
tests/test_torch_volume_grad.py).  Needs a CUDA device; this file imports
nothing of JAX, so that it runs on the card as it is.
"""

import pytest
import torch

import chip_smoke
from raytracing_in_one_weekend_tpu_torch.core import materials, randomsource
from raytracing_in_one_weekend_tpu_torch.ops import megatrace
from raytracing_in_one_weekend_tpu_torch.ops import megatrace_bwd as mb
from raytracing_in_one_weekend_tpu_torch.utils.config import NoiseColor

W, SPP, DEPTH = 128, 4, 8
TOL = 5e-4
FLOOR = 1e-4


def call(name, route, dev):
    """(args, kwargs) of a sample_batch call on the scene: adaptive lane
    counts and count_in, white ("white") or BLUE ("tables", "pre_drawn");
    a streamed mesh on Morton lanes."""
    scene, cs = chip_smoke.mesh_volume_scene(name)
    scene = scene.to(dev)
    camera, tables = chip_smoke.batch_inputs(scene, cs, W, W, dev)
    packed = materials.pack_materials(scene)
    n = W * W
    gen = torch.Generator(dev).manual_seed(1)
    lane_count = torch.randint(0, SPP + 1, (n,), device=dev, generator=gen)
    count_in = torch.randint(0, 3, (n,), device=dev,
                             generator=gen).to(torch.float32)
    rect, box = megatrace.pack_aux_tables(scene, packed)
    kw = dict(samples=SPP, trace_depth=DEPTH,
              has_dielectrics=scene.flags.has_dielectrics,
              sky_on=scene.flags.sky == 1, rect_tables=rect, box_tables=box,
              vol0=megatrace.camera_containment_row(scene, packed,
                                                    camera.origin))
    order = torch.arange(n, device=dev)
    if scene.triangles.vert0.shape[0] > megatrace.TRI_MAX:
        kw["tri_stream_tables"] = megatrace.pack_tri_stream_tables(scene,
                                                                   packed)
        order = megatrace.morton_order(W, W)[0].to(dev)
        kw["pixel_index"] = order
    else:
        kw["tri_tables"] = megatrace.pack_tri_tables(scene, packed)
        kw["want_tape"] = route == "white"
    if route != "white":
        state = randomsource.make_noise_state(NoiseColor.BLUE, seed=7,
                                              device=dev)
        if route == "tables":
            tbl, meta = megatrace.pack_noise_tables(state)
            kw.update(noise_tbl=tbl, noise_meta=meta, noise_draw_base=8187)
        else:
            for key, fn in (("noise_uniforms", megatrace.pack_noise_uniforms),
                            ("noise_cosine", megatrace.pack_noise_cosine)):
                rows = fn(state, count_in, W, W, SPP)
                kw[key] = None if rows is None else rows[:, order]
    return (lane_count[order], count_in[order], *tables, 21), kw


@pytest.mark.cuda
@pytest.mark.parametrize("name,route", [
    ("cornell_mesh_volumes", "white"), ("mesh_fog", "white"),
    ("mesh_fog_inside", "white"), ("cornell_mesh_volumes", "tables"),
    ("mesh_fog", "pre_drawn"), ("cornell_mesh_large_volumes", "white"),
    ("mesh_large_fog", "white"), ("cornell_mesh_large_volumes", "pre_drawn"),
    ("mesh_large_fog", "pre_drawn"),
])
def test_cuda_mesh_volume_builds_match_plain_version(name, route):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args, kw = call(name, route, torch.device("cuda"))
    streamed = kw.get("tri_stream_tables") is not None
    aux = kw["rect_tables"] is not None or kw["box_tables"] is not None
    counter = "STREAM_VOL_LAUNCHES" if streamed else "TRI_VOL_LAUNCHES"
    build = megatrace.noise_build(args[3].shape[0], **kw)
    assert build == ("stream" if streamed else "tri") + (
        "+aux" if aux else "") + "+vol"
    before = (megatrace.LAUNCHES, getattr(megatrace, counter),
              megatrace.NOISE_BUILDS.get(build, 0))
    got = megatrace.sample_batch(*args, **kw)
    torch.cuda.synchronize()
    white = route == "white"
    assert (megatrace.LAUNCHES, getattr(megatrace, counter),
            megatrace.NOISE_BUILDS.get(build, 0)) == (
        before[0] + 1, before[1] + white, before[2] + (not white))
    want = megatrace.sample_batch_reference(*args, **kw)
    share, err = chip_smoke.lane_agreement(got, want)
    for k, v in got.items():
        assert torch.equal(v, want[k]), (k, share, err)
    assert float(got["count"].sum()) > 0
    if "tape" in got:
        tri_base = megatrace.tri_code_base(args[3].shape[0],
                                           kw["rect_tables"],
                                           kw["box_tables"])
        assert bool((got["tape"] >= tri_base).any())


@pytest.mark.cuda
@pytest.mark.parametrize("name,depth", [
    ("cornell_mesh_volumes", 8), ("mesh_fog_inside", 8),
    ("cornell_mesh_volumes", 35),
])
def test_cuda_mesh_volume_backward_matches_plain_replay(name, depth):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    scene, cs = chip_smoke.mesh_volume_scene(name)
    scene = scene.to(dev)
    camera, tables = chip_smoke.batch_inputs(scene, cs, 64, 64, dev)
    packed = materials.pack_materials(scene)
    rect, box = megatrace.pack_aux_tables(scene, packed)
    kw = dict(samples=2, trace_depth=depth, sky_on=scene.flags.sky == 1,
              has_dielectrics=scene.flags.has_dielectrics,
              tri_tables=megatrace.pack_tri_tables(scene, packed),
              rect_tables=rect, box_tables=box,
              vol0=megatrace.camera_containment_row(scene, packed,
                                                    camera.origin))
    n = 64 * 64
    lane_count = torch.full((n,), 2, dtype=torch.int32, device=dev)
    out = megatrace.sample_batch(lane_count, torch.zeros(n, device=dev),
                                 *tables, 9, want_tape=True, **kw)
    gen = torch.Generator(dev).manual_seed(2)
    cots = (torch.randn((n, 3), device=dev, generator=gen),
            torch.randn(n, device=dev, generator=gen))
    aux = rect is not None or box is not None
    kind = mb.MESH_AUX_VOL if aux else mb.MESH_VOL
    assert mb.build_kind(True, aux, True) == kind
    counter = "MESH_AUX_VOL_LAUNCHES" if aux else "MESH_VOL_LAUNCHES"
    before = (mb.LAUNCHES, getattr(mb, counter))
    got = mb.replay_grad(out["tape"], lane_count, *tables, 9, *cots, **kw)
    assert (mb.LAUNCHES, getattr(mb, counter)) == (before[0] + 1,
                                                   before[1] + 1)
    want = mb.replay_grad_reference(out["tape"], lane_count, *tables, 9,
                                    *cots, **kw)
    largest = max(float(r.abs().max()) for r in want if r.numel())
    moved = 0
    for g, r in zip(got, want):
        if r.numel() == 0 or float(r.abs().max()) == 0.0:
            continue
        moved += 1
        scale = max(float(r.abs().max()), FLOOR * largest)
        assert float((g - r).abs().max()) <= TOL * scale
    assert moved >= 6
