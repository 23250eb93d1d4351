"""The noise arm beside the batch kernel's other arms (ROADMAP step 11b):
the port's plain version of `megatrace.sample_batch` with a sampler
flavor against the JAX kernel in interpret mode with the hash PRNG
(`hw_prng=False`), on the same lanes, seed and draw base, with the tables
the renderers pack for the scene (rects and boxes, the camera's medium,
move offsets, textures, a cubemap, triangles).

* This file: `cornell` (the aux build) on the in-kernel tables with
  BLUE; `cover_motion` on the tables with BLUE, whose scalar set gives
  the shutter time (purpose 9, rotated, the JAX kernel's :2745-2760).
  Its siblings hold every arm at once (final_book2,
  tests/test_torch_noise_beside_book2.py), the texture and cube arms
  (tests/test_torch_noise_beside_sky.py) and the triangle, blocked and
  streamed arms (tests/test_torch_noise_beside_mesh.py).
* A lane agrees when its count and ray count are identical and its float
  channels within atol=rtol=1e-4 (JAX's tape mode refuses a flavor, so
  no tape).  Each class is held to the tighter of its white JAX test's
  bounds and the flavored sphere build's (>= 0.999 of lanes,
  tests/test_torch_noise_megatrace.py); its docstring says which.
* The flavor reached the paths: the white batch on the same inputs
  differs.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_in_one_weekend_tpu.core import camera as jax_camera
from raytracing_in_one_weekend_tpu.core import materials as jax_materials
from raytracing_in_one_weekend_tpu.core import randomsource as jax_rs
from raytracing_in_one_weekend_tpu.models import book_scenes as jax_books
from raytracing_in_one_weekend_tpu.models import testbeds as jax_testbeds
from raytracing_in_one_weekend_tpu.ops import pallas_megatrace
from raytracing_in_one_weekend_tpu.utils.config import NoiseColor as JaxColor
from raytracing_in_one_weekend_tpu_torch.core import camera, materials
from raytracing_in_one_weekend_tpu_torch.core import randomsource
from raytracing_in_one_weekend_tpu_torch.models import book_scenes, testbeds
from raytracing_in_one_weekend_tpu_torch.ops import megatrace
from raytracing_in_one_weekend_tpu_torch.utils.config import NoiseColor

TOL = dict(atol=1e-4, rtol=1e-4)
FLOAT_CHANNELS = ("color", "normal", "albedo", "weight", "fallback_normal",
                  "fallback_albedo")
SPP, DEPTH, SEED, DRAW_BASE = 3, 5, 5, 4133


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process (tests/test_torch_integrator.py):
    the tier-1 run puts six of them on the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def registered(name):
    """(JAX scene, port scene, camera settings) of a registered scene."""
    jmod = jax_books if name in jax_books.SCENES else jax_testbeds
    pmod = book_scenes if name in book_scenes.SCENES else testbeds
    js, cs = jmod.SCENES[name]()
    return js, pmod.SCENES[name]()[0], cs


def camera_settings(origin, look_at, vertical_fov, focus_distance):
    return types.SimpleNamespace(origin=origin, look_at=look_at,
                                 up=(0.0, 1.0, 0.0), vertical_fov=vertical_fov,
                                 aperture=0.0, focus_distance=focus_distance)


def jax_call(js, cs, w, h):
    """(positional tables, keyword tables) of JAX's sample_batch for the
    scene, as the JAX renderer packs them (render/renderer.py:357-497)."""
    pm = pallas_megatrace
    cam = jax_camera.make_camera(cs.origin, cs.look_at, cs.up,
                                 cs.vertical_fov, w / h, aperture=cs.aperture,
                                 focus_distance=cs.focus_distance)
    packed = jax_materials.pack_materials(js)
    rect, box = pm.pack_aux_tables(js, packed)
    t = js.triangles.vert0.shape[0]
    tex = pm.pack_texture_tables(js)
    cube = pm.pack_cubemap_table(js) if js.flags.sky == 2 else None
    args = (pm.pack_camera_row(cam, w, h), js.spheres.center,
            js.spheres.radius, pm.pack_sphere_records(js, packed),
            js.environment.sky_bottom, js.environment.sky_top)
    kw = dict(
        rect_tables=rect, box_tables=box,
        tri_tables=pm.pack_tri_tables(js, packed) if t <= pm.TRI_MAX
        else None,
        tri_stream_tables=(pm.pack_tri_stream_tables(js, packed)
                           if t > pm.TRI_MAX else None),
        tex_tables=None if tex is None else tex[:3],
        img_dims=(0, 0) if tex is None else tex[3],
        cube_table=None if cube is None else cube[0],
        cube_dims=(0, 0) if cube is None else cube[1],
        vol0=(pm.camera_containment_row(js, packed, cam.origin)
              if js.flags.has_volumes else None),
        move_offsets=js.spheres.move_offset if js.flags.has_motion else None,
        has_dielectrics=bool(js.flags.has_dielectrics),
        sky_on=js.flags.sky == 1)
    return args, kw


def port_call(ts, cs, w, h):
    """The port's counterpart of jax_call (render/renderer.py)."""
    cam = camera.make_camera(cs.origin, cs.look_at, cs.up, cs.vertical_fov,
                             w / h, aperture=cs.aperture,
                             focus_distance=cs.focus_distance)
    packed = materials.pack_materials(ts)
    rect, box = megatrace.pack_aux_tables(ts, packed)
    t = ts.triangles.vert0.shape[0]
    cube, cube_dims = (megatrace.pack_cubemap_table(ts)
                       if ts.flags.sky == 2 else (None, (0, 0)))
    args = (megatrace.pack_camera_row(cam, w, h), ts.spheres.center,
            ts.spheres.radius, megatrace.pack_sphere_records(ts, packed),
            ts.environment.sky_bottom, ts.environment.sky_top)
    kw = dict(
        rect_tables=rect, box_tables=box,
        tri_tables=(megatrace.pack_tri_tables(ts, packed)
                    if t <= megatrace.TRI_MAX else None),
        tri_stream_tables=(megatrace.pack_tri_stream_tables(ts, packed)
                           if t > megatrace.TRI_MAX else None),
        tex_tables=megatrace.pack_texture_tables(ts), cube=cube,
        cube_dims=cube_dims,
        vol0=(megatrace.camera_containment_row(ts, packed, cam.origin)
              if ts.flags.has_volumes else None),
        move_offsets=ts.spheres.move_offset if ts.flags.has_motion else None,
        has_dielectrics=bool(ts.flags.has_dielectrics),
        sky_on=ts.flags.sky == 1)
    return args, kw


def jax_meta(meta, width):
    """JAX sample_batch's static noise_meta tuple (renderer.py:425-446)."""
    exact = pallas_megatrace.RAY_TILE % width == 0
    rows = max(1, pallas_megatrace.RAY_TILE // width) + (0 if exact else 2)
    return (meta["size"], meta["T"], meta["cam"], meta["cos"], meta["scal"],
            rows, meta.get("uv3", -1), meta.get("scalT", meta["T"]))


def run_both(js, ts, cs, route, w, h, *, flavor="blue", morton=False,
             spp=SPP, depth=DEPTH, seed=SEED):
    """(port outputs, JAX outputs, port outputs in white noise) as numpy
    dicts of one flavored batch on the same lanes, seed and draw base: the
    in-kernel tables (`route` "tables") or the pre-drawn rows, with
    `morton` in Morton lane order (pixel_index, the pre-drawn columns
    permuted with the lanes, as both renderers do)."""
    n = w * h
    color = {"blue": 1, "stbn": 2}[flavor]
    state = randomsource.make_noise_state(NoiseColor(color), seed=7)
    jstate = jax_rs.make_noise_state(JaxColor(color), seed=7)
    lane_count = np.full(n, spp, np.int32)
    count_in = np.random.default_rng(2).integers(0, 3, n).astype(np.float32)
    order = (megatrace.morton_order(w, h)[0].numpy() if morton
             else np.arange(n))

    jargs, jkw = jax_call(js, cs, w, h)
    if route == "tables":
        tbl, meta = pallas_megatrace.pack_noise_tables(jstate)
        jnoise = dict(noise_tbl=tbl, noise_meta=jax_meta(meta, w),
                      noise_draw_base=DRAW_BASE)
    else:
        cin = jnp.asarray(count_in)
        jnoise = {k: None if r is None else r[:, jnp.asarray(order)]
                  for k, r in (
                      ("noise_uniforms", pallas_megatrace.pack_noise_uniforms(
                          jstate, cin, w, h, spp)),
                      ("noise_cosine", pallas_megatrace.pack_noise_cosine(
                          jstate, cin, w, h, spp)))}
    jorder = jnp.asarray(order.astype(np.int32))
    want = pallas_megatrace.sample_batch(
        jnp.asarray(lane_count)[jorder], jnp.asarray(count_in)[jorder],
        *jargs, jnp.int32(seed), samples=spp, trace_depth=depth,
        pixel_index=jorder if morton else None, interpret=True,
        hw_prng=False, **jkw, **jnoise)

    targs, tkw = port_call(ts, cs, w, h)
    torder = torch.from_numpy(order)
    args = (torch.from_numpy(lane_count)[torder],
            torch.from_numpy(count_in)[torder], *targs, seed)
    kw = dict(tkw, samples=spp, trace_depth=depth,
              pixel_index=torder if morton else None)
    if route == "tables":
        tbl, meta = megatrace.pack_noise_tables(state)
        noise = dict(noise_tbl=tbl, noise_meta=meta,
                     noise_draw_base=DRAW_BASE)
    else:
        cin = torch.from_numpy(count_in)
        noise = {k: None if r is None else r[:, torder] for k, r in (
            ("noise_uniforms", megatrace.pack_noise_uniforms(
                state, cin, w, h, spp)),
            ("noise_cosine", megatrace.pack_noise_cosine(
                state, cin, w, h, spp)))}
    got = megatrace.sample_batch(*args, **kw, **noise)
    white = megatrace.sample_batch(*args, **kw)
    as_np = lambda d: {k: np.asarray(v) for k, v in d.items()}  # noqa: E731
    return as_np(got), as_np(want), as_np(white)


def check(got, want, white, lane_share, float_share=1.0,
          normal_share=None):
    """Hold the flavored batch to JAX's: count and rays identical on >=
    `lane_share` of the lanes, and on those lanes each float channel
    within TOL on >= `float_share` of them (the normals on >=
    `normal_share` where given); the flavor changed the image."""
    same = (got["count"] == want["count"]) & (got["rays"] == want["rays"])
    assert same.mean() >= lane_share, same.mean()
    for k in FLOAT_CHANNELS:
        close = np.isclose(got[k], want[k], **TOL)
        close = close.all(axis=-1) if close.ndim == 2 else close
        share = (normal_share if normal_share is not None
                 and k.endswith("normal") else float_share)
        assert close[same].mean() >= share, (k, close[same].mean())
    assert float(got["color"].mean()) > 0.0
    assert not np.array_equal(got["color"], white["color"])
    return same


def test_aux_build_on_tables_matches_jax():
    """cornell (6 rects, 2 boxes) at 64x16 with BLUE tables: held to the
    white aux test's bounds, the tighter ones (every agreeing lane's
    floats within 1e-4, tests/test_torch_aux.py) with >= 0.999 of lanes
    agreeing (the flavored sphere build's).  Measured: every lane, the
    largest float gap 4.8e-7."""
    js, ts, cs = registered("cornell")
    got, want, white = run_both(js, ts, cs, "tables", 64, 16)
    check(got, want, white, 0.999)


def test_motion_shutter_time_from_the_scalar_set_matches_jax():
    """cover_motion at 64x16 with BLUE tables: the shutter time is the
    scalar set's purpose 9 (rotated).  Held to the white motion test's
    cover bounds (tests/test_torch_motion.py: 0.99 of lanes, the normals
    on 0.95 of them: XLA's rsqrt) with >= 0.999 of lanes agreeing.
    Measured: every lane's count and rays, the colours within 1e-4 on
    0.9990 of them, the normals on 0.954 (the largest gap 2.6e-3); with
    the shutter time's salt moved to 8, 0.64 of lanes agree."""
    js, ts, cs = registered("cover_motion")
    got, want, white = run_both(js, ts, cs, "tables", 64, 16)
    check(got, want, white, 0.999, float_share=0.999, normal_share=0.95)
