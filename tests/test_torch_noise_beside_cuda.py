"""The noise builds of ROADMAP step 11b against their plain version on the
card: each build the batch kernel gained for a sampler flavor (the 14
aux, volume, motion and texture mixes beside the two of step 11, the five
cube builds, the two blocked builds, the triangle build and the streamed
kernel) on a 128x128 batch, 4 spp, depth 8, with BLUE: the tables where
the renderer takes them, the pre-drawn rows for the Morton-lane classes
(more than SPH_CULL_MIN spheres, streamed meshes, their columns permuted
with the lanes) and for the whole mix once more.  The mixes take
final_book2's tables (rects, boxes, convex volumes, motion, textures),
the cube builds those under a cubemap sky.  Every output is held bit for
bit, and the launch counts in megatrace.NOISE_BUILDS under the build's
name.  Needs a CUDA device; this file imports nothing of JAX, so that it
runs on the card as it is.
"""

import itertools

import pytest
import torch

import chip_smoke
from raytracing_in_one_weekend_tpu_torch.core import materials, randomsource
from raytracing_in_one_weekend_tpu_torch.models import meshes, testbeds
from raytracing_in_one_weekend_tpu_torch.ops import megatrace
from raytracing_in_one_weekend_tpu_torch.utils.config import NoiseColor

ARMS = ("aux", "volume", "motion", "texture")
# the sphere kernel's mixes of step 11b: every subset of ARMS but the
# empty one and the volume alone (step 11's builds)
MIXES = ["+".join(c) for k in range(1, 5)
         for c in itertools.combinations(ARMS, k) if c != ("volume",)]
CUBES = ["cube"] + [f"{arm}+cube" for arm in ARMS]
W, SPP, DEPTH = 128, 4, 8


def flavored_call(build, route, dev):
    """(args, kwargs) of a flavored sample_batch call that takes the noise
    build named `build` (megatrace.noise_build's names)."""
    arms = set(build.split("+"))
    if arms & {"tri", "stream"}:
        scene, cs = (meshes.mesh_showcase() if "tri" in arms
                     else meshes.mesh_large())
    else:
        scene, cs = testbeds.SCENES["sphere_field" if "blocked" in arms
                                    else "final_book2"]()
    scene = scene.to(dev)
    if "cube" in arms:
        faces = torch.rand((6, 8, 8, 3), device=dev,
                           generator=torch.Generator(dev).manual_seed(3))
        scene = chip_smoke.with_cube_sky(scene, faces)
    cam, tables = chip_smoke.batch_inputs(scene, cs, W, W, dev)
    packed = materials.pack_materials(scene)
    n = W * W
    gen = torch.Generator(dev).manual_seed(1)
    lane_count = torch.randint(0, SPP + 1, (n,), device=dev, generator=gen)
    count_in = torch.randint(0, 3, (n,), device=dev,
                             generator=gen).to(torch.float32)
    kw = dict(samples=SPP, trace_depth=DEPTH,
              has_dielectrics=scene.flags.has_dielectrics,
              sky_on=scene.flags.sky == 1)
    rect, box = megatrace.pack_aux_tables(scene, packed)
    tables_of = dict(
        aux=dict(rect_tables=rect, box_tables=box),
        volume=dict(vol0=megatrace.camera_containment_row(
            scene, packed, cam.origin) if scene.flags.has_volumes else None),
        motion=dict(move_offsets=scene.spheres.move_offset),
        texture=dict(tex_tables=megatrace.pack_texture_tables(scene)))
    for arm in arms & set(ARMS):
        kw.update(tables_of[arm])
    if "cube" in arms:
        cube, dims = megatrace.pack_cubemap_table(scene)
        kw.update(cube=cube, cube_dims=dims)
    if "blocked" in arms and "motion" in arms:
        move = torch.zeros_like(scene.spheres.center)
        move[::5, 1] = 0.3
        kw["move_offsets"] = move
    order = torch.arange(n, device=dev)
    if "tri" in arms:
        kw["tri_tables"] = megatrace.pack_tri_tables(scene, packed)
    if "stream" in arms:
        kw["tri_stream_tables"] = megatrace.pack_tri_stream_tables(scene,
                                                                   packed)
        order = megatrace.morton_order(W, W)[0].to(dev)
        kw["pixel_index"] = order
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
@pytest.mark.parametrize("build,route", [
    *((b, "tables") for b in MIXES + CUBES),
    ("aux+volume+motion+texture", "pre_drawn"),
    ("blocked", "pre_drawn"), ("blocked+motion", "pre_drawn"),
    ("tri", "tables"), ("tri", "pre_drawn"), ("stream", "pre_drawn"),
])
def test_cuda_noise_beside_builds_match_plain_version(build, route):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args, kw = flavored_call(build, route, torch.device("cuda"))
    assert megatrace.noise_build(args[3].shape[0], **kw) == build
    launches = megatrace.NOISE_BUILDS.get(build, 0)
    got = megatrace.sample_batch(*args, **kw)
    torch.cuda.synchronize()
    assert megatrace.NOISE_BUILDS[build] == launches + 1
    want = megatrace.sample_batch_reference(*args, **kw)
    share, err = chip_smoke.lane_agreement(got, want)
    for k, v in got.items():
        assert torch.equal(v, want[k]), (k, share, err)
    # the rays met the scene (a mix without final_book2's light may render
    # black)
    assert float(got["normal"].abs().sum()) > 0.0
