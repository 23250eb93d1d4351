"""The builds of ROADMAP step 7.1b against their plain versions on the card:
the triangle build's and the streamed kernel's aux builds (rects and boxes
beside a mesh), white and with BLUE (the tables and the pre-drawn rows for
the triangle build, the pre-drawn rows on Morton lanes for the streamed
kernel), with and without a sphere, on a 128x128 batch, 4 spp, depth 8,
every output held bit for bit and each launch counted in its family's
counter (TRI_AUX_LAUNCHES, STREAM_AUX_LAUNCHES, NOISE_BUILDS); the
streamed kernel and the sync sampler's bounce on a mesh without spheres,
bit for bit; the backward's MESH_AUX build against the plain replay within
5e-4 of each leaf's max.  Needs a CUDA device; this file imports nothing
of JAX, so that it runs on the card as it is.
"""

import pytest
import torch

import chip_smoke
from raytracing_in_one_weekend_tpu_torch.core import materials, randomsource
from raytracing_in_one_weekend_tpu_torch.models import book_scenes, meshes
from raytracing_in_one_weekend_tpu_torch.ops import megatrace, meshtrace
from raytracing_in_one_weekend_tpu_torch.ops import megatrace_bwd as mb
from raytracing_in_one_weekend_tpu_torch.scene import scene as scene_mod
from raytracing_in_one_weekend_tpu_torch.utils.config import NoiseColor

W, SPP, DEPTH = 128, 4, 8
TOL = 5e-4


def streamed_box(sphere: bool):
    """The Cornell box around an icosphere(4) (5,120 triangles, streamed),
    with a glass sphere or without."""
    b = scene_mod.SceneBuilder()
    cam = book_scenes.add_cornell_box(b, scene_mod.axis_angle_quat)
    if sphere:
        b.add_sphere((0.3, 0.3, 0.35), 0.2, b.dielectric(1.5))
    v, f, n, _ = meshes.icosphere(4)
    b.add_mesh(v, f, b.metal((0.8, 0.7, 0.5), glossiness=0.9), normals=n,
               translation=(-0.35, 0.15, -0.3), scale=0.25)
    return b.build(), cam


def bare_soup():
    """An icosphere(4) alone, no sphere, gradient sky."""
    b = scene_mod.SceneBuilder()
    v, f, n, _ = meshes.icosphere(4)
    b.add_mesh(v, f, b.metal((0.8, 0.7, 0.5), glossiness=0.6), normals=n)
    b.set_gradient_sky()
    return b.build(), chip_smoke.mesh_aux_scene("mesh_huge_bare")[1]


def call(scene_cs, route, dev):
    """(args, kwargs) of a sample_batch call on the scene: adaptive lane
    counts and count_in, white ("white") or BLUE ("tables", "pre_drawn");
    a streamed mesh on Morton lanes."""
    scene, cs = scene_cs
    scene = scene.to(dev)
    _, tables = chip_smoke.batch_inputs(scene, cs, W, W, dev)
    packed = materials.pack_materials(scene)
    n = W * W
    gen = torch.Generator(dev).manual_seed(1)
    lane_count = torch.randint(0, SPP + 1, (n,), device=dev, generator=gen)
    count_in = torch.randint(0, 3, (n,), device=dev,
                             generator=gen).to(torch.float32)
    rect, box = megatrace.pack_aux_tables(scene, packed)
    kw = dict(samples=SPP, trace_depth=DEPTH,
              has_dielectrics=scene.flags.has_dielectrics,
              sky_on=scene.flags.sky == 1, rect_tables=rect, box_tables=box)
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


SCENES = {
    "cornell_mesh": lambda: chip_smoke.mesh_aux_scene("cornell_mesh"),
    "cornell_mesh_sphere": lambda: chip_smoke.mesh_aux_scene(
        "cornell_mesh", sphere=True),
    "streamed_box": lambda: streamed_box(False),
    "streamed_box_sphere": lambda: streamed_box(True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name,route", [
    ("cornell_mesh", "white"), ("cornell_mesh_sphere", "white"),
    ("cornell_mesh", "tables"), ("cornell_mesh_sphere", "pre_drawn"),
    ("streamed_box", "white"), ("streamed_box_sphere", "white"),
    ("streamed_box", "pre_drawn"), ("streamed_box_sphere", "pre_drawn"),
])
def test_cuda_mesh_aux_builds_match_plain_version(name, route):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args, kw = call(SCENES[name](), route, torch.device("cuda"))
    streamed = kw.get("tri_stream_tables") is not None
    counter = "STREAM_AUX_LAUNCHES" if streamed else "TRI_AUX_LAUNCHES"
    build = megatrace.noise_build(args[3].shape[0], **kw)
    assert build == ("stream+aux" if streamed else "tri+aux")
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
    if "tape" in got:  # rects, boxes and triangles win, past the box pad
        tri_base = megatrace.tri_code_base(args[3].shape[0],
                                           kw["rect_tables"],
                                           kw["box_tables"])
        assert bool((got["tape"] >= tri_base).any())
        assert bool(((got["tape"] >= 128) & (got["tape"] < tri_base)).any())


@pytest.mark.cuda
def test_cuda_sphere_free_streamed_and_sync_match_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    scene_cs = bare_soup()
    args, kw = call(scene_cs, "white", dev)
    assert args[3].shape[0] == 0
    got = megatrace.sample_batch(*args, **kw)
    want = megatrace.sample_batch_reference(*args, **kw)
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
    # the sync sampler's bounce, each bounce of a recorded wave
    scene = scene_cs[0].to(dev)
    bounces, _, _ = chip_smoke.recorded_wave(scene, scene_cs[1], W, W, dev)
    assert len(bounces) == DEPTH
    before = meshtrace.SYNC_LAUNCHES
    for b_args, b_kw, _ in bounces:
        state = b_args[0].clone()
        meshtrace.bounce_sync(state, *b_args[1:], **b_kw)
        plain = meshtrace.bounce_sync_reference(b_args[0].clone(),
                                                *b_args[1:], **b_kw)
        assert torch.equal(state, plain)
    assert meshtrace.SYNC_LAUNCHES == before + DEPTH


@pytest.mark.cuda
@pytest.mark.parametrize("sphere,depth", [(False, 8), (True, 35)])
def test_cuda_mesh_aux_backward_matches_plain_replay(sphere, depth):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    scene, cs = chip_smoke.mesh_aux_scene("cornell_mesh", sphere=sphere)
    scene = scene.to(dev)
    _, tables = chip_smoke.batch_inputs(scene, cs, 64, 64, dev)
    packed = materials.pack_materials(scene)
    rect, box = megatrace.pack_aux_tables(scene, packed)
    kw = dict(samples=2, trace_depth=depth, sky_on=False,
              has_dielectrics=scene.flags.has_dielectrics,
              tri_tables=megatrace.pack_tri_tables(scene, packed),
              rect_tables=rect, box_tables=box)
    n = 64 * 64
    lane_count = torch.full((n,), 2, dtype=torch.int32, device=dev)
    out = megatrace.sample_batch(lane_count, torch.zeros(n, device=dev),
                                 *tables, 9, want_tape=True, **kw)
    gen = torch.Generator(dev).manual_seed(2)
    cots = (torch.randn((n, 3), device=dev, generator=gen),
            torch.randn(n, device=dev, generator=gen))
    assert mb.build_kind(True, True, False) == mb.MESH_AUX
    before = mb.LAUNCHES
    got = mb.replay_grad(out["tape"], lane_count, *tables, 9, *cots, **kw)
    assert mb.LAUNCHES == before + 1
    want = mb.replay_grad_reference(out["tape"], lane_count, *tables, 9,
                                    *cots, **kw)
    moved = 0
    for g, r in zip(got, want):
        if r.numel() == 0 or float(r.abs().max()) == 0.0:
            continue
        moved += 1
        assert float((g - r).abs().max()) <= TOL * float(r.abs().max())
    assert moved >= 6
