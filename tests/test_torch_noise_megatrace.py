"""The batch kernel's sampler-flavor arm in the port (its plain version,
`megatrace.sample_batch` on CPU tensors) against the JAX kernel in
interpret mode with the hash PRNG (`hw_prng=False`), on the same lanes
and seed.

* The in-kernel tables (`pack_noise_tables`: the port's (rows, S) table
  is JAX's without its 128-column padding) at 128x8, 4 spp, depth 5, with
  BLUE and STBN on `three_spheres` and a state holding all four sets
  (`chip_smoke.four_set_state`) on `volume` (its scalar draws, every
  bounce's cosine and the isotropic direction from the unitvec3 set);
  the pre-drawn rows (`pack_noise_uniforms`, `pack_noise_cosine`) at
  24x24 with BLUE and the four-set state.
* JAX's tape mode refuses a flavor (its sample_batch asserts so), so a
  lane is held by its outputs: count and rays identical and the float
  channels within atol=rtol=1e-4, on >= 99.9% of lanes (measured: every
  lane of the five cases).  The floats are not bitwise: XLA's fusion
  contracts products the port rounds on their own (0.8-13.2% of the lanes'
  colours differ in their last bits; the largest gap of any channel
  9.1e-5, the four-set volume's pre-drawn case); the rotation's
  multiply-add is the one contraction the flavored draws depend on, and
  the port fuses it as XLA does (unfused, STBN kept 0.959 of lanes).
* The packers, `renderer.noise_draw_base` and the refusals.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from raytracing_in_one_weekend_tpu.core import camera as jax_camera
from raytracing_in_one_weekend_tpu.core import materials as jax_materials
from raytracing_in_one_weekend_tpu.core import randomsource as jax_rs
from raytracing_in_one_weekend_tpu.models import book_scenes as jax_scenes
from raytracing_in_one_weekend_tpu.ops import pallas_megatrace
from raytracing_in_one_weekend_tpu.render import renderer as jax_renderer
from raytracing_in_one_weekend_tpu.utils.config import NoiseColor as JaxColor
from raytracing_in_one_weekend_tpu_torch.core import camera, materials
from raytracing_in_one_weekend_tpu_torch.core import randomsource
from raytracing_in_one_weekend_tpu_torch.models import book_scenes
from raytracing_in_one_weekend_tpu_torch.ops import megatrace
from raytracing_in_one_weekend_tpu_torch.render import renderer
from raytracing_in_one_weekend_tpu_torch.utils.config import NoiseColor

TOL = dict(atol=1e-4, rtol=1e-4)
FLOAT_CHANNELS = ("color", "normal", "albedo", "weight", "fallback_normal",
                  "fallback_albedo")
LANE_SHARE = 0.999
SPP, DEPTH, SEED, DRAW_BASE = 4, 5, 3, 4133


def states(name):
    if name == "four":
        state, arrays = chip_smoke.four_set_state()
        return state, jax_rs.NoiseState(*(jnp.asarray(a) for a in arrays))
    color = {"blue": 1, "stbn": 2}[name]
    return (randomsource.make_noise_state(NoiseColor(color), seed=7),
            jax_rs.make_noise_state(JaxColor(color), seed=7))


def jax_meta(meta, width):
    """JAX sample_batch's static noise_meta tuple (renderer.py:425-446)."""
    exact = pallas_megatrace.RAY_TILE % width == 0
    rows = max(1, pallas_megatrace.RAY_TILE // width) + (0 if exact else 2)
    return (meta["size"], meta["T"], meta["cam"], meta["cos"], meta["scal"],
            rows, meta.get("uv3", -1), meta.get("scalT", meta["T"]))


def run_both(scene_name, flavor, route, w, h):
    """(port outputs, JAX outputs, port outputs in white noise) as numpy
    dicts of one batch on the same lanes and seed."""
    n = w * h
    lane_count = np.full(n, SPP, np.int32)
    count_in = np.random.default_rng(2).integers(0, 3, n).astype(np.float32)
    state, jstate = states(flavor)

    js, cs = jax_scenes.SCENES[scene_name]()
    jcam = jax_camera.make_camera(cs.origin, cs.look_at, cs.up,
                                  cs.vertical_fov, w / h,
                                  aperture=cs.aperture,
                                  focus_distance=cs.focus_distance)
    jp = jax_materials.pack_materials(js)
    jkw = {}
    if route == "tables":
        tbl, meta = pallas_megatrace.pack_noise_tables(jstate)
        jkw = dict(noise_tbl=tbl, noise_meta=jax_meta(meta, w),
                   noise_draw_base=DRAW_BASE)
    else:
        cin = jnp.asarray(count_in)
        jkw = dict(
            noise_uniforms=pallas_megatrace.pack_noise_uniforms(
                jstate, cin, w, h, SPP),
            noise_cosine=pallas_megatrace.pack_noise_cosine(
                jstate, cin, w, h, SPP))
    vol = (pallas_megatrace.camera_containment_row(js, jp, jcam.origin)
           if js.flags.has_volumes else None)
    want = pallas_megatrace.sample_batch(
        jnp.asarray(lane_count), jnp.asarray(count_in),
        pallas_megatrace.pack_camera_row(jcam, w, h), js.spheres.center,
        js.spheres.radius, pallas_megatrace.pack_sphere_records(js, jp),
        js.environment.sky_bottom, js.environment.sky_top, jnp.int32(SEED),
        vol0=vol, samples=SPP, trace_depth=DEPTH,
        has_dielectrics=js.flags.has_dielectrics, sky_on=js.flags.sky == 1,
        interpret=True, hw_prng=False, **jkw)

    ts, _ = book_scenes.SCENES[scene_name]()
    cam = camera.make_camera(cs.origin, cs.look_at, cs.up, cs.vertical_fov,
                             w / h, aperture=cs.aperture,
                             focus_distance=cs.focus_distance)
    packed = materials.pack_materials(ts)
    args = (torch.from_numpy(lane_count), torch.from_numpy(count_in),
            megatrace.pack_camera_row(cam, w, h), ts.spheres.center,
            ts.spheres.radius, megatrace.pack_sphere_records(ts, packed),
            ts.environment.sky_bottom, ts.environment.sky_top, SEED)
    kw = dict(samples=SPP, trace_depth=DEPTH,
              has_dielectrics=ts.flags.has_dielectrics,
              sky_on=ts.flags.sky == 1,
              vol0=(megatrace.camera_containment_row(ts, packed, cam.origin)
                    if ts.flags.has_volumes else None))
    if route == "tables":
        tbl, meta = megatrace.pack_noise_tables(state)
        nkw = dict(noise_tbl=tbl, noise_meta=meta, noise_draw_base=DRAW_BASE)
    else:
        cin = torch.from_numpy(count_in)
        nkw = dict(
            noise_uniforms=megatrace.pack_noise_uniforms(state, cin, w, h,
                                                         SPP),
            noise_cosine=megatrace.pack_noise_cosine(state, cin, w, h, SPP))
    got = megatrace.sample_batch(*args, **kw, **nkw)
    white = megatrace.sample_batch(*args, **kw)
    as_np = lambda d: {k: np.asarray(v) for k, v in d.items()}  # noqa: E731
    return as_np(got), as_np(want), as_np(white)


def agreeing_lanes(got, want):
    same = (got["count"] == want["count"]) & (got["rays"] == want["rays"])
    for k in FLOAT_CHANNELS:
        close = np.isclose(got[k], want[k], **TOL)
        same &= close.all(axis=-1) if close.ndim == 2 else close
    return same


@pytest.mark.parametrize("scene_name,flavor,route,w,h", [
    ("three_spheres", "blue", "tables", 128, 8),
    ("three_spheres", "stbn", "tables", 128, 8),
    ("volume", "four", "tables", 128, 8),
    ("three_spheres", "blue", "pre_drawn", 24, 24),
    ("volume", "four", "pre_drawn", 24, 24),
])
def test_plain_version_matches_jax_kernel(scene_name, flavor, route, w, h):
    got, want, white = run_both(scene_name, flavor, route, w, h)
    assert got["color"].shape == (w * h, 3)
    same = agreeing_lanes(got, want)
    assert same.mean() >= LANE_SHARE, same.mean()
    assert float(got["color"].mean()) > 0.0
    # the flavor reached the paths: the white batch takes other ones
    assert not np.array_equal(got["color"], white["color"])


@pytest.mark.parametrize("flavor", ["blue", "stbn", "four"])
def test_pack_noise_tables_matches_jax(flavor):
    state, jstate = states(flavor)
    tbl, meta = megatrace.pack_noise_tables(state)
    jtbl, jmeta = pallas_megatrace.pack_noise_tables(jstate)
    assert meta == {**jmeta, "scalT": jmeta.get("scalT", jmeta["T"])}
    size = meta["size"]
    assert tbl.shape == (jtbl.shape[0], size) and tbl.dtype == torch.float32
    np.testing.assert_array_equal(tbl.numpy(), np.asarray(jtbl)[:, :size])
    assert megatrace.pack_noise_tables(None) is None


@pytest.mark.parametrize("flavor", ["blue", "four"])
def test_pre_drawn_rows_match_jax(flavor):
    state, jstate = states(flavor)
    w, h, samples = 24, 20, 3
    count_in = np.random.default_rng(4).integers(0, 9, w * h)
    count_in = count_in.astype(np.float32)
    for port_fn, jax_fn in (
            (megatrace.pack_noise_uniforms,
             pallas_megatrace.pack_noise_uniforms),
            (megatrace.pack_noise_cosine,
             pallas_megatrace.pack_noise_cosine)):
        got = port_fn(state, torch.from_numpy(count_in), w, h, samples)
        want = jax_fn(jstate, jnp.asarray(count_in), w, h, samples)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_noise_draw_base_matches_jax():
    for draw_base in (0, 1, 48, 96, 4096, 123456):
        for samples, depth in ((64, 8), (48, 35), (4, 5), (1, 1)):
            want = int(jax_renderer.noise_draw_base(draw_base, samples,
                                                    depth))
            assert renderer.noise_draw_base(draw_base, samples,
                                            depth) == want
    # an odd stride: all 8192 residues before a repeat (64 spp, depth 8)
    bases = {renderer.noise_draw_base(k * 64, 64, 8) % megatrace.NOISE_WRAP
             for k in range(megatrace.NOISE_WRAP)}
    assert len(bases) == megatrace.NOISE_WRAP


def test_noise_refusals():
    state, _ = states("blue")
    tbl, meta = megatrace.pack_noise_tables(state)
    scene, cs = book_scenes.cornell_box()
    cam = camera.make_camera(cs.origin, cs.look_at, cs.up, cs.vertical_fov,
                             1.0, aperture=cs.aperture,
                             focus_distance=cs.focus_distance)
    packed = materials.pack_materials(scene)
    rect, box = megatrace.pack_aux_tables(scene, packed)
    args = (torch.ones(64, dtype=torch.int32), torch.zeros(64),
            megatrace.pack_camera_row(cam, 8, 8), scene.spheres.center,
            scene.spheres.radius, megatrace.pack_sphere_records(scene, packed),
            scene.environment.sky_bottom, scene.environment.sky_top, 1)
    kw = dict(samples=1, trace_depth=2, noise_tbl=tbl, noise_meta=meta)
    # the tables take lanes in pixel order: a Morton launch takes the
    # pre-drawn rows (JAX's sample_batch asserts pixel_index is None)
    with pytest.raises(ValueError, match="pixel order"):
        megatrace.sample_batch(*args, rect_tables=rect, box_tables=box,
                               pixel_index=torch.arange(64), **kw)
    cover, _ = book_scenes.three_spheres()
    cargs = (args[0], args[1], args[2], cover.spheres.center,
             cover.spheres.radius, megatrace.pack_sphere_records(
                 cover, materials.pack_materials(cover)), *args[6:])
    with pytest.raises(ValueError, match="tape"):
        megatrace.sample_batch(*cargs, want_tape=True, **kw)
    with pytest.raises(ValueError, match="clash"):
        megatrace.sample_batch(*cargs, noise_uniforms=torch.zeros(4, 64),
                               **kw)
    with pytest.raises(ValueError, match="noise_uniforms has shape"):
        megatrace.sample_batch(*cargs, samples=1, trace_depth=2,
                               noise_uniforms=torch.zeros(4, 63))
