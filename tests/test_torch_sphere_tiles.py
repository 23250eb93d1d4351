"""The batch kernel's sphere build deals lanes to threads in 8x4 pixel
tiles (csrc/megatrace_batch.cu::tile_lane), so that a warp's 32 rays
leave neighbouring pixels.  A lane keeps its hash key, its pixel, its
output column and its tape column; only which thread runs it changes.

* The map's plain twin, `megatrace.tile_lane_order(n, width)`, is a
  permutation of range(n) for 512x512, for widths that are not a multiple
  of the tile, for a few lanes and for n that is not a multiple of 128,
  and equals the map built from its definition (whole tiles of the whole
  rows, a warp a tile, tile rows top down; then the lanes left over, in
  lane order).
* Each warp's 32 threads run one 8x4 pixel rectangle wherever the image
  has whole tiles; at the ragged right strip and below the last whole
  tile row the threads run the remaining lanes in lane order.
* The plain version, which the kernel matches bit for bit, against the
  JAX batch kernel in interpret mode on the inputs the map must handle: a
  width that is not a multiple of 8, uneven lane counts with some lanes
  at 0, count_in > 0 (an adaptive batch).  Criterion of
  tests/test_torch_megatrace.py: the winner tape identical on >= 99% of
  lanes, count and rays equal there.
* cuda-marked: the map the kernel's threads compute, read back, equals
  the twin; the kernel equals its plain version with uneven lanes,
  adaptive counts and ragged shapes (tape, count and rays identical,
  floats within atol=rtol=1e-4 on >= 99% of lanes: chip_smoke phase 3's
  criterion).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from raytracing_in_one_weekend_tpu.core import camera as jax_camera
from raytracing_in_one_weekend_tpu.core import materials as jax_materials
from raytracing_in_one_weekend_tpu.models import book_scenes as jax_scenes
from raytracing_in_one_weekend_tpu.ops import pallas_megatrace
from raytracing_in_one_weekend_tpu_torch.core import camera, materials
from raytracing_in_one_weekend_tpu_torch.models import book_scenes
from raytracing_in_one_weekend_tpu_torch.ops import megatrace

TW, TH = megatrace.TILE_W, megatrace.TILE_H

SHAPES = [
    (512 * 512, 512),  # the main path
    (45 * 37, 45),  # a width that is not a multiple of the tile
    (5, 512),  # a few lanes, less than a row
    (64 * 64 - 45, 64),  # not a multiple of 128, a ragged last row
    (1000, 37),
    (129, 8),  # one whole tile column and one lane more
    (0, 16),
]


def defined_order(n: int, width: int) -> list:
    """The map by its definition, one thread at a time."""
    rows = n // width // TH * TH
    tiles_x = width // TW
    order = []
    for ty in range(rows // TH):
        for tx in range(tiles_x):
            for q in range(TW * TH):
                order.append((ty * TH + q // TW) * width + tx * TW + q % TW)
    tiled = set(order)
    order += [i for i in range(n) if i not in tiled]
    return order


@pytest.mark.parametrize("n,width", SHAPES)
def test_tile_lane_order_is_a_permutation(n, width):
    order = megatrace.tile_lane_order(n, width)
    assert order.dtype == torch.int64 and order.shape == (n,)
    assert torch.equal(torch.sort(order).values, torch.arange(n))


@pytest.mark.parametrize("n,width", [s for s in SHAPES if s[0] < 100_000])
def test_tile_lane_order_follows_its_definition(n, width):
    assert megatrace.tile_lane_order(n, width).tolist() == \
        defined_order(n, width)


@pytest.mark.parametrize("n,width", SHAPES)
def test_warps_run_pixel_tiles(n, width):
    order = megatrace.tile_lane_order(n, width)
    rows = n // width // TH * TH
    tiles = (width // TW) * (rows // TH)
    whole = order[:tiles * 32].reshape(-1, 32)
    x, y = whole % width, whole // width
    # each warp of whole tiles: one 8x4 rectangle, rows of 8 in x order
    assert torch.equal(x - x[:, :1], torch.arange(32).repeat(
        whole.shape[0], 1) % TW)
    assert torch.equal(y - y[:, :1], torch.arange(32).repeat(
        whole.shape[0], 1) // TW)
    assert bool((x[:, 0] % TW == 0).all()) and bool((y[:, 0] % TH == 0).all())
    # the rest in lane order: first the right strip of the tiled rows,
    # then every lane below them
    rest = order[tiles * 32:]
    assert bool((rest[1:] > rest[:-1]).all())
    strip = rest[rest < rows * width]
    assert bool((strip % width >= width // TW * TW).all())
    assert torch.equal(rest[strip.numel():],
                       torch.arange(rows * width, n))
    if (n, width) == (512 * 512, 512):
        assert tiles * 32 == n  # every warp of the main path is a tile


def test_lane_use_share_reads_each_warps_longest_lane():
    """chip_smoke.lane_use_share: the lanes' rays over 32 times each
    warp's longest, with warps of 32 lanes of one row in lane order and of
    one 8x4 tile under the map."""
    rays = torch.arange(64, dtype=torch.int32)
    assert chip_smoke.lane_use_share(rays, torch.arange(64)) == \
        pytest.approx(float(rays.sum()) / (32 * (31 + 63)))
    tiles = megatrace.tile_lane_order(64, 16)
    # 16 wide: the first warp runs columns 0-7 of rows 0-3
    assert tiles[:32].reshape(4, 8)[:, 0].tolist() == [0, 16, 32, 48]
    assert chip_smoke.lane_use_share(rays, tiles) == pytest.approx(
        float(rays.sum()) / (32 * (55 + 63)))


def cover_tables(w, h):
    """The port's batch tables of the cover at w x h."""
    scene, cs = book_scenes.cover_scene()
    cam = camera.make_camera(cs.origin, cs.look_at, cs.up, cs.vertical_fov,
                             w / h, aperture=cs.aperture,
                             focus_distance=cs.focus_distance)
    records = megatrace.pack_sphere_records(
        scene, materials.pack_materials(scene))
    return (megatrace.pack_camera_row(cam, w, h), scene.spheres.center,
            scene.spheres.radius, records, scene.environment.sky_bottom,
            scene.environment.sky_top)


def jax_cover_tables(w, h):
    """The same tables made by the JAX package."""
    scene, cs = jax_scenes.cover_scene()
    cam = jax_camera.make_camera(cs.origin, cs.look_at, cs.up,
                                 cs.vertical_fov, w / h,
                                 aperture=cs.aperture,
                                 focus_distance=cs.focus_distance)
    records = pallas_megatrace.pack_sphere_records(
        scene, jax_materials.pack_materials(scene))
    return (pallas_megatrace.pack_camera_row(cam, w, h),
            scene.spheres.center, scene.spheres.radius, records,
            scene.environment.sky_bottom, scene.environment.sky_top)


def ragged_batch(dev, w, h, lanes, spp, seed):
    """sample_batch's positional arguments for the cover at w x h (the
    camera's row width w), the first `lanes` lanes: lane counts 0..spp and
    count_in 0..3 drawn by numpy from `seed`."""
    rng = np.random.default_rng(seed)
    tables = cover_tables(w, h)
    lane_count = torch.from_numpy(rng.integers(0, spp + 1, lanes)
                                  .astype(np.int32))
    count_in = torch.from_numpy(rng.integers(0, 4, lanes).astype(np.float32))
    return [t.to(dev) for t in (lane_count, count_in, *tables)]


def test_ragged_adaptive_plain_version_matches_jax_kernel():
    w, h, spp, seed = 20, 12, 3, 4
    lane_count, count_in, *tables = ragged_batch(torch.device("cpu"), w, h,
                                                 w * h, spp, 17)
    kw = dict(samples=spp, trace_depth=8, sky_on=True)
    want = pallas_megatrace.sample_batch(
        jnp.asarray(lane_count.numpy()), jnp.asarray(count_in.numpy()),
        *jax_cover_tables(w, h), jnp.int32(seed), has_dielectrics=True,
        interpret=True, hw_prng=False, want_tape=True, **kw)
    got = megatrace.sample_batch(lane_count, count_in, *tables, seed,
                                 has_dielectrics=True, want_tape=True, **kw)
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    same = np.all(got["tape"] == want["tape"], axis=0)
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_array_equal(got["count"][same], want["count"][same])
    np.testing.assert_array_equal(got["rays"][same], want["rays"][same])
    idle = lane_count.numpy() == 0
    assert idle.any() and np.all(got["rays"][idle] == 0)
    assert np.all(got["tape"][:, idle] == -2)


@pytest.mark.cuda
@pytest.mark.parametrize("n,width", SHAPES)
def test_cuda_kernel_map_is_the_plain_twin(n, width):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    got = megatrace.kernel_tile_lanes(n, width, torch.device("cuda")).cpu()
    assert torch.equal(got, megatrace.tile_lane_order(n, width))


@pytest.mark.cuda
@pytest.mark.parametrize("w,h,lanes", [
    (64, 64, 64 * 64 - 45),  # not a multiple of 128, a ragged last row
    (45, 37, 45 * 37),  # a width that is not a multiple of the tile
    (512, 4, 300),  # less than a tile row
])
def test_cuda_sphere_build_matches_plain_version_with_uneven_lanes(
        w, h, lanes):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = ragged_batch(torch.device("cuda"), w, h, lanes, 4, 5)
    kw = dict(samples=4, trace_depth=8, sky_on=True, has_dielectrics=True,
              want_tape=True)
    before = megatrace.LAUNCHES
    got = megatrace.sample_batch(*args, 11, **kw)
    assert megatrace.LAUNCHES == before + 1
    want = megatrace.sample_batch_reference(*args, 11, **kw)
    assert torch.equal(got["tape"], want["tape"])
    assert torch.equal(got["count"], want["count"])
    assert torch.equal(got["rays"], want["rays"])
    share, _ = chip_smoke.lane_agreement(got, want)
    assert share >= 0.99
