"""Scene arrays and packed tables: the port against the JAX package.

Scenes must build the same arrays exactly (same dtypes, same values).
Packed tables match with rtol=1e-6, atol=0: the camera row goes through
tan, whose float32 result may differ in the last bit between libraries.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from raytracing_in_one_weekend_tpu.core import camera as jax_camera
from raytracing_in_one_weekend_tpu.core import materials as jax_materials
from raytracing_in_one_weekend_tpu.models import book_scenes as jax_scenes
from raytracing_in_one_weekend_tpu.ops import pallas_megatrace
from raytracing_in_one_weekend_tpu_torch.core import camera, materials
from raytracing_in_one_weekend_tpu_torch.models import book_scenes, meshes
from raytracing_in_one_weekend_tpu_torch.ops import megatrace
from raytracing_in_one_weekend_tpu_torch.render import renderer
from raytracing_in_one_weekend_tpu_torch.scene import scene as scene_mod

SCENES = ["cover", "three_spheres", "single_sphere", "cover_motion",
          "volume", "cornell"]
SPHERE_SCENES = ["cover", "three_spheres", "single_sphere"]
PACK_TOL = dict(rtol=1e-6, atol=0)


def jax_leaves(scene) -> dict:
    """The JAX Scene's array leaves keyed "<group>.<field>"."""
    out = {}
    for group in ("spheres", "rects", "boxes", "triangles", "materials",
                  "textures", "environment"):
        nt = getattr(scene, group)
        for field in nt._fields:
            value = getattr(nt, field)
            if value is not None:
                out[f"{group}.{field}"] = np.asarray(value)
    return out


def port_leaves(scene) -> dict:
    out = {}
    for group in ("spheres", "rects", "boxes", "triangles", "materials",
                  "textures", "environment"):
        g = getattr(scene, group)
        for f in dataclasses.fields(g):
            value = getattr(g, f.name)
            if value is not None:
                out[f"{group}.{f.name}"] = value.numpy()
    return out


def assert_same_leaves(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@functools.lru_cache(maxsize=None)
def build_both(name):
    """Both packages' scene and camera settings (immutable, so shared)."""
    js, jcs = jax_scenes.SCENES[name]()
    ts, tcs = book_scenes.SCENES[name]()
    return js, jcs, ts, tcs


@pytest.mark.parametrize("name", SCENES)
def test_scene_arrays_equal(name):
    js, jcs, ts, tcs = build_both(name)
    assert_same_leaves(port_leaves(ts), jax_leaves(js))
    assert dataclasses.asdict(ts.flags) == dataclasses.asdict(js.flags)
    assert dataclasses.asdict(tcs) == dataclasses.asdict(jcs)


@pytest.mark.parametrize("name", SCENES)
def test_scene_from_arrays_round_trips(name):
    js, _, ts, _ = build_both(name)
    carried = scene_mod.scene_from_arrays(
        jax_leaves(js), dataclasses.asdict(js.flags)
    )
    assert_same_leaves(port_leaves(carried), jax_leaves(js))
    assert carried.flags == ts.flags
    np.testing.assert_array_equal(
        materials.pack_materials(carried).numpy(),
        materials.pack_materials(ts).numpy(),
    )


@pytest.mark.parametrize("name", SPHERE_SCENES)
def test_packed_tables_match(name):
    js, cs, ts, _ = build_both(name)
    w, h = 32, 24
    jpacked = jax_materials.pack_materials(js)
    tpacked = materials.pack_materials(ts)
    np.testing.assert_allclose(tpacked.numpy(), np.asarray(jpacked),
                               **PACK_TOL)
    jrec = pallas_megatrace.pack_sphere_records(js, jpacked)
    trec = megatrace.pack_sphere_records(ts, tpacked)
    np.testing.assert_allclose(trec.numpy(), np.asarray(jrec), **PACK_TOL)

    jsph, jrec_t, js_pad = pallas_megatrace._pack_scene_tables(
        js.spheres.center, js.spheres.radius, jrec
    )
    tsph, trec_t, ts_pad = megatrace._pack_scene_tables(
        ts.spheres.center, ts.spheres.radius, trec
    )
    assert ts_pad == js_pad == megatrace.sphere_pad_count(
        ts.spheres.center.shape[0]
    )
    np.testing.assert_allclose(tsph.numpy(), np.asarray(jsph), **PACK_TOL)
    np.testing.assert_allclose(trec_t.numpy(), np.asarray(jrec_t),
                               **PACK_TOL)
    np.testing.assert_allclose(
        megatrace._pack_sky_row(ts.environment.sky_bottom,
                                ts.environment.sky_top).numpy(),
        np.asarray(pallas_megatrace._pack_sky_row(
            js.environment.sky_bottom, js.environment.sky_top)),
        **PACK_TOL,
    )

    jcam = jax_camera.make_camera(
        cs.origin, cs.look_at, cs.up, cs.vertical_fov, w / h,
        aperture=cs.aperture, focus_distance=cs.focus_distance,
    )
    tcam = camera.make_camera(
        cs.origin, cs.look_at, cs.up, cs.vertical_fov, w / h,
        aperture=cs.aperture, focus_distance=cs.focus_distance,
    )
    np.testing.assert_allclose(
        megatrace.pack_camera_row(tcam, w, h).numpy(),
        np.asarray(pallas_megatrace.pack_camera_row(jcam, w, h)),
        **PACK_TOL,
    )


def test_scene_to_device_keeps_values():
    ts, _ = book_scenes.three_spheres()
    moved = ts.to("cpu")
    assert moved.flags == ts.flags
    assert_same_leaves(port_leaves(moved), port_leaves(ts))


def _textured_triangle(b, texture=None):
    """Triangles and textures are ported; a textured triangle is refused by
    the renderer (textures in mesh scenes, step 7.5b)."""
    if texture is None:
        texture = scene_mod.checker((1, 1, 1), (0, 0, 0))
    b.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), b.lambert(texture))
    renderer.check_scope(b.build())


def _streamed_mesh(b):
    """Meshes are ported, those without spheres not yet (step 7.1b)."""
    v, f, _, _ = meshes.icosphere(4)  # 5120 faces
    b.add_mesh(v, f, b.lambert((0.5, 0.5, 0.5)))
    renderer.check_scope(b.build())


@pytest.mark.parametrize("call", [
    lambda b: _textured_triangle(
        b, b.add_image("img", np.zeros((2, 2, 3), np.float32))),
    lambda b: b.set_cubemap_sky(np.zeros((6, 2, 2, 3), np.float32)),
    _textured_triangle,
    _streamed_mesh,
    lambda b: _textured_triangle(b, scene_mod.perlin((1, 1, 1))),
], ids=["image", "cubemap", "triangle", "mesh", "perlin"])
def test_unported_builder_calls_raise(call):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        call(scene_mod.SceneBuilder())


def test_big_scenes_sort_spheres_like_jax():
    from raytracing_in_one_weekend_tpu.scene import scene as jax_scene_mod

    rng = np.random.default_rng(0)
    centers = rng.random((megatrace.SPH_CULL_MIN + 1, 3)).astype(np.float32)
    builders = (scene_mod.SceneBuilder(), jax_scene_mod.SceneBuilder())
    for b in builders:
        m = b.lambert((0.5, 0.5, 0.5))
        for c in centers:
            b.add_sphere(c, 0.01, m)
    port, ref = (b.build() for b in builders)
    np.testing.assert_array_equal(port.spheres.center.numpy(),
                                  np.asarray(ref.spheres.center))
    kept = builders[0].build(sort_spheres=False)
    np.testing.assert_array_equal(kept.spheres.center.numpy(), centers)
    assert not torch.equal(port.spheres.center, kept.spheres.center)
