"""The batch kernel's noise builds (#1, kNoise) against their plain
version on the card: the sphere build with BLUE and STBN tables and with
pre-drawn rows on the cover, the volume build with the four-set state
(`chip_smoke.four_set_state`) on `volume`, tables and pre-drawn rows.  A
lane agrees when its count and ray count are identical and its float
channels within atol=rtol=1e-4 (`chip_smoke.lane_agreement`); >= 99% of
lanes must (measured on the card: every lane, bit for bit).  Each launch
counts in megatrace.NOISE_LAUNCHES.  Needs a CUDA device; this file
imports nothing of JAX, so that it runs on the card as it is.
"""

import pytest
import torch

import chip_smoke
from raytracing_in_one_weekend_tpu_torch.core import materials, randomsource
from raytracing_in_one_weekend_tpu_torch.models import book_scenes
from raytracing_in_one_weekend_tpu_torch.ops import megatrace
from raytracing_in_one_weekend_tpu_torch.utils.config import NoiseColor


@pytest.mark.cuda
@pytest.mark.parametrize("name,flavor,route,w,h", [
    ("cover", "blue", "tables", 128, 64),
    ("cover", "stbn", "tables", 192, 40),
    ("cover", "blue", "pre_drawn", 100, 60),
    ("volume", "four", "tables", 128, 64),
    ("volume", "four", "pre_drawn", 90, 50),
])
def test_cuda_noise_builds_match_plain_version(name, flavor, route, w, h):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    if flavor == "four":
        state, _ = chip_smoke.four_set_state(device=dev)
    else:
        state = randomsource.make_noise_state(
            NoiseColor.BLUE if flavor == "blue"
            else NoiseColor.SPATIO_TEMPORAL_BLUE, seed=7, device=dev)
    scene, cs = book_scenes.SCENES[name]()
    scene = scene.to(dev)
    cam, tables = chip_smoke.batch_inputs(scene, cs, w, h, dev)
    n, spp = w * h, 3
    lane_count = torch.randint(0, spp + 1, (n,), device=dev,
                               generator=torch.Generator(dev).manual_seed(1))
    count_in = torch.zeros(n, device=dev)
    kw = dict(samples=spp, trace_depth=9,
              has_dielectrics=scene.flags.has_dielectrics,
              sky_on=scene.flags.sky == 1)
    if scene.flags.has_volumes:
        kw["vol0"] = megatrace.camera_containment_row(
            scene, materials.pack_materials(scene), cam.origin)
    if route == "tables":
        tbl, meta = megatrace.pack_noise_tables(state)
        kw.update(noise_tbl=tbl, noise_meta=meta, noise_draw_base=8187)
    else:
        kw.update(
            noise_uniforms=megatrace.pack_noise_uniforms(state, count_in, w,
                                                         h, spp),
            noise_cosine=megatrace.pack_noise_cosine(state, count_in, w, h,
                                                     spp))
    launches = megatrace.NOISE_LAUNCHES
    got = megatrace.sample_batch(lane_count, count_in, *tables, 21, **kw)
    torch.cuda.synchronize()
    assert megatrace.NOISE_LAUNCHES == launches + 1
    want = megatrace.sample_batch_reference(lane_count, count_in, *tables, 21,
                                            **kw)
    share, err = chip_smoke.lane_agreement(got, want)
    assert share >= 0.99, (share, err)
    assert float(got["color"].mean()) > 0.0
