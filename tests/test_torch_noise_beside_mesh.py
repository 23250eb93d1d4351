"""The noise arm beside the triangle, blocked-sphere and streamed arms
(ROADMAP step 11b): the port's plain version with BLUE against the JAX
kernel in interpret mode, through tests/test_torch_noise_beside.py's
harness (its docstring says how lanes are held).

* A small triangle scene (tests/test_torch_mesh_megatrace.py's one-block
  mesh: an icosphere(1) and a cube over a ground sphere) at 64x16 on the
  in-kernel tables: the white mesh test's 0.99 of agreeing lanes is
  looser, so the flavored sphere build's 0.999, every agreeing lane's
  floats within 1e-4.
* The blocked sweep on pre-drawn rows (the route of scenes past
  SPH_CULL_MIN spheres): the 3x3 cover grid at 16x16 with the port's
  SPH_CULL_MIN patched to 4 and SPH_BLOCK to 8, as
  tests/test_torch_sphere_blocks.py does, lanes in pixel order on both
  sides (the port's blocked builds take no pixel_index).  The JAX side
  keeps its threshold: its sample_batch never sets `has_sph_blocks`, so
  past SPH_CULL_MIN its kernel sweeps densely and leaves the blocks row
  among its positional refs, where a flavor's pre-drawn rows would be
  read (a shape error; ROADMAP §3); the dense sweep gives the blocked
  sweep's winners.  Its white bounds (0.99 of lanes; the cover's normals
  on 0.95) are looser, so 0.999 of lanes, the normals on 0.95 of them.
* The streamed arm on pre-drawn rows: tests/test_torch_stream_megatrace.py's
  fixture (5120 triangles over a ground sphere) at 16x16 with Morton
  `pixel_index` and the pre-drawn columns permuted with the lanes, as
  both renderers do: 0.999 of lanes (its white test's 0.99 is looser).
"""

import pytest

from raytracing_in_one_weekend_tpu.models import book_scenes as jax_books
from raytracing_in_one_weekend_tpu.models import meshes as jax_meshes
from raytracing_in_one_weekend_tpu.scene import scene as jax_scene_mod
from raytracing_in_one_weekend_tpu_torch.models import book_scenes, meshes
from raytracing_in_one_weekend_tpu_torch.ops import megatrace
from raytracing_in_one_weekend_tpu_torch.scene import scene as scene_mod

from test_torch_mesh_megatrace import CAMERA as MESH_CAMERA, mesh_scene
from test_torch_noise_beside import camera_settings, check, run_both
from test_torch_noise_beside import _one_torch_thread  # noqa: F401
from test_torch_stream_megatrace import CAMERA as STREAM_CAMERA
from test_torch_stream_tables import stream_scene


def test_triangle_build_on_tables_matches_jax():
    js = mesh_scene(jax_scene_mod, jax_meshes, 1)
    ts = mesh_scene(scene_mod, meshes, 1)
    assert 0 < ts.triangles.vert0.shape[0] <= megatrace.TRI_MAX
    got, want, white = run_both(js, ts, camera_settings(**MESH_CAMERA),
                                "tables", 64, 16)
    check(got, want, white, 0.999)


def test_blocked_build_on_pre_drawn_rows_matches_jax(monkeypatch):
    js, cs = jax_books.cover_scene(grid=3)
    ts, _ = book_scenes.cover_scene(grid=3)
    monkeypatch.setattr(megatrace, "SPH_CULL_MIN", 4)
    monkeypatch.setattr(megatrace, "SPH_BLOCK", 8)
    assert ts.spheres.center.shape[0] > megatrace.SPH_CULL_MIN
    got, want, white = run_both(js, ts, cs, "pre_drawn", 16, 16)
    check(got, want, white, 0.999, float_share=0.999, normal_share=0.95)


def test_streamed_kernel_on_pre_drawn_rows_matches_jax():
    js = stream_scene(jax_scene_mod, jax_meshes)
    ts = stream_scene(scene_mod, meshes)
    assert ts.triangles.vert0.shape[0] > megatrace.TRI_MAX
    got, want, white = run_both(js, ts, camera_settings(**STREAM_CAMERA),
                                "pre_drawn", 16, 16, morton=True)
    check(got, want, white, 0.999)
