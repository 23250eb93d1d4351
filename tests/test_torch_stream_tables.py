"""Streamed-mesh tables and Morton lanes: the port against the JAX
package, bit for bit.

* `megatrace.morton_order` against `pallas_megatrace.morton_order` (order
  and rank) at 16x8, 64x64 and 512x512;
* `megatrace.pack_tri_stream_tables` against JAX's, on the icosphere(4)
  scene of tests/test_meshtrace.py::_stream_scene (5120 triangles, 32
  blocks, 2 supers) and on `mesh_large` (20,748 triangles).  JAX packs three
  triangles into each 128-column row (slot j of row b*64 + s holds
  triangle b*192 + j*64 + s, columns 0-8 geometry, 9-40 the record); the
  test un-interleaves them, then the same triangles must stand in the same
  order with the same records, and the block and super AABBs must be
  equal;
* eligibility at TRI_MAX + 1 (streamed) and TRI_STREAM_MAX + 1 (refused),
  as JAX's `scene_eligible` decides.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_in_one_weekend_tpu.core import materials as jax_materials
from raytracing_in_one_weekend_tpu.models import meshes as jax_meshes
from raytracing_in_one_weekend_tpu.ops import pallas_megatrace
from raytracing_in_one_weekend_tpu.scene import scene as jax_scene_mod
from raytracing_in_one_weekend_tpu_torch.core import materials
from raytracing_in_one_weekend_tpu_torch.models import meshes
from raytracing_in_one_weekend_tpu_torch.ops import megatrace
from raytracing_in_one_weekend_tpu_torch.render import renderer
from raytracing_in_one_weekend_tpu_torch.scene import scene as scene_mod


def stream_scene(mod, meshes_mod):
    """tests/test_meshtrace.py::_stream_scene: icosphere(4) (5120 smooth
    triangles, above TRI_MAX) over a ground sphere, gradient sky."""
    b = mod.SceneBuilder()
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, b.lambert((0.5, 0.5, 0.5)))
    v, f, n, _ = meshes_mod.icosphere(4)
    b.add_mesh(v, f, b.metal((0.8, 0.7, 0.5), glossiness=0.9),
               normals=n, translation=(0.0, 1.0, 0.0))
    b.set_gradient_sky()
    return b.build()


SCENES = {
    "stream_scene": stream_scene,
    "mesh_large": lambda m, mm: mm.mesh_large()[0],
}


@pytest.mark.parametrize("size", [(16, 8), (64, 64), (512, 512)])
def test_morton_order_matches_jax(size):
    order, rank = megatrace.morton_order(*size)
    want_order, want_rank = pallas_megatrace.morton_order(*size)
    np.testing.assert_array_equal(order.numpy(), want_order)
    np.testing.assert_array_equal(rank.numpy(), want_rank)
    assert megatrace.morton_order(*size)[0] is order  # cached


def uninterleave(tbl: np.ndarray) -> np.ndarray:
    """JAX's (n_blk * 64, 128) streamed rows -> (n_blk * 192, 42), one
    triangle a row in triangle order."""
    rows, slot = pallas_megatrace.TRI_ROWS, pallas_megatrace.TRI_SLOT
    cols = pallas_megatrace.TRI_SLOT_COLS
    n_blk = tbl.shape[0] // rows
    return (tbl[:, :slot * cols].reshape(n_blk, rows, slot, cols)
            .transpose(0, 2, 1, 3).reshape(n_blk * rows * slot, cols))


@pytest.mark.parametrize("name", list(SCENES))
def test_stream_tables_match_jax(name):
    js = SCENES[name](jax_scene_mod, jax_meshes)
    ts = SCENES[name](scene_mod, meshes)
    tbl, aabb_row, sup_row = (np.asarray(a) for a in
                              pallas_megatrace.pack_tri_stream_tables(
                                  js, jax_materials.pack_materials(js)))
    got = megatrace.pack_tri_stream_tables(ts, materials.pack_materials(ts))
    t = ts.triangles.vert0.shape[0]
    n_blk = -(-t // megatrace.TRI_BLOCK)
    n_blk = -(-n_blk // megatrace.TRI_SUP) * megatrace.TRI_SUP
    assert got.geo.shape == (n_blk * megatrace.TRI_BLOCK, 12)
    assert got.aabb.shape == (n_blk, 8)
    assert got.sup.shape == (n_blk // megatrace.TRI_SUP, 8)
    if name == "stream_scene":
        assert (t, n_blk, got.sup.shape[0]) == (5120, 32, 2)
    rows = uninterleave(tbl)
    base = pallas_megatrace.TRI_STREAM_REC_BASE
    np.testing.assert_array_equal(got.geo[:, :9].numpy(), rows[:, :9])
    assert not got.geo[:, 9:].any()
    np.testing.assert_array_equal(
        got.rec.numpy(), rows[:, base:base + megatrace.TRI_REC_ROWS])
    for mine, theirs in ((got.aabb, aabb_row), (got.sup, sup_row)):
        theirs = theirs.reshape(-1, 8)
        np.testing.assert_array_equal(mine[:, 0:3].numpy(), theirs[:, 0:3])
        np.testing.assert_array_equal(mine[:, 4:7].numpy(), theirs[:, 3:6])
    # pad-only blocks carry the far point, real ones contain their rows
    real = torch.arange(n_blk) * megatrace.TRI_BLOCK < t
    assert bool((got.aabb[~real][:, :3] == 1e30).all())
    assert bool((got.aabb[real][:, :3] < got.aabb[real][:, 4:7]).all())


def resized(scene, count: int):
    return dataclasses.replace(scene, triangles=dataclasses.replace(
        scene.triangles, vert0=torch.zeros((count, 3))))


@pytest.mark.parametrize("count, eligible", [
    (megatrace.TRI_MAX + 1, True),
    (megatrace.TRI_STREAM_MAX + 1, False),
])
def test_eligibility_matches_jax(count, eligible):
    assert megatrace.TRI_STREAM_MAX == pallas_megatrace.TRI_STREAM_MAX
    assert megatrace.TRI_SUP == pallas_megatrace.TRI_SUP
    ts = resized(stream_scene(scene_mod, meshes), count)
    js = stream_scene(jax_scene_mod, jax_meshes)
    js = js._replace(triangles=js.triangles._replace(
        vert0=jnp.zeros((count, 3))))
    assert pallas_megatrace.scene_eligible(
        js, allow_rect_box=True, allow_triangles=True) is eligible
    assert megatrace.scene_eligible(ts, allow_triangles=True) is eligible
    if eligible:
        renderer.check_scope(ts)
    else:
        with pytest.raises(NotImplementedError, match="262144"):
            renderer.check_scope(ts)
