"""The port's mesh sources, scene builder triangle block and triangle
packer against the JAX package's, bit for bit.

* the generators (`cube`, `icosphere`, `torus`) and the OBJ reader
  (`load_obj`, the JAX package's `load_obj_py`) on a small OBJ with
  normals, uvs, negative indices and a quad fan;
* the built scenes `mesh_showcase` and `triangle`: every leaf after the
  Morton sort of the triangle rows, the flags and the camera settings;
  `scene_from_arrays` carries the triangle leaves across;
* `pack_tri_tables` (geometry with the per-block AABBs, records), on
  `mesh_showcase` and on a mesh whose last TRI_BLOCK is pad only (its
  AABB is a point at 1e30 that no slab test passes);
* the scope: the batch kernel takes meshes up to TRI_STREAM_MAX (beyond
  TRI_MAX streamed, without the tape replay), the driver's scope check
  refuses bigger ones naming ROADMAP step 9, the per-ray megatrace
  refuses triangles;
* the CLI renders `--scene triangle` and `--scene mesh_showcase` on the
  CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from raytracing_in_one_weekend_tpu.core import materials as jax_materials
from raytracing_in_one_weekend_tpu.models import meshes as jax_meshes
from raytracing_in_one_weekend_tpu.models import testbeds as jax_testbeds
from raytracing_in_one_weekend_tpu.ops import pallas_megatrace
from raytracing_in_one_weekend_tpu.scene import scene as jax_scene_mod
from raytracing_in_one_weekend_tpu_torch import __main__ as cli
from raytracing_in_one_weekend_tpu_torch.core import materials
from raytracing_in_one_weekend_tpu_torch.models import meshes, testbeds
from raytracing_in_one_weekend_tpu_torch.ops import megatrace
from raytracing_in_one_weekend_tpu_torch.ops import megatrace_replay as mr
from raytracing_in_one_weekend_tpu_torch.render import renderer
from raytracing_in_one_weekend_tpu_torch.scene import scene as scene_mod

from test_torch_scene import assert_same_leaves, jax_leaves, port_leaves

OBJ = """\
# a quad (fan-triangulated), a triangle with negative indices
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 0.5 1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
vn 0 0.6 0.8
f 1/1/1 2/2/1 3/3/1 4/4/2
f -1//2 -4//1 -3//1
"""


@pytest.mark.parametrize("name,args", [
    ("cube", ()), ("icosphere", (0,)), ("icosphere", (2,)), ("torus", ()),
    ("torus", (1.5, 0.2, 8, 6)),
])
def test_generators_match_jax(name, args):
    got = getattr(meshes, name)(*args)
    want = getattr(jax_meshes, name)(*args)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_load_obj_matches_jax_reader(tmp_path):
    path = tmp_path / "mesh.obj"
    path.write_text(OBJ)
    got = meshes.load_obj(str(path))
    want = jax_meshes.load_obj_py(str(path))
    assert got[1].shape == (3, 3)  # the quad's fan and the triangle
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _scenes(name):
    return jax_testbeds.SCENES[name](), testbeds.SCENES[name]()


TRIANGLES = {"mesh_showcase": 908, "triangle": 2, "mesh_large": 20748,
             "mesh_huge": 102656}


@pytest.mark.parametrize("name", list(TRIANGLES))
def test_mesh_scenes_equal_jax(name):
    (js, jcs), (ts, tcs) = _scenes(name)
    assert ts.triangles.vert0.shape[0] == TRIANGLES[name]
    assert_same_leaves(port_leaves(ts), jax_leaves(js))
    assert dataclasses.asdict(ts.flags) == dataclasses.asdict(js.flags)
    assert dataclasses.asdict(tcs) == dataclasses.asdict(jcs)
    carried = scene_mod.scene_from_arrays(jax_leaves(js),
                                          dataclasses.asdict(js.flags))
    assert_same_leaves(port_leaves(carried), jax_leaves(js))


def test_builder_morton_sort_matches_jax():
    """add_triangle and add_mesh chunks in any order sort like JAX's."""
    rng = np.random.default_rng(5)
    verts = rng.normal(size=(40, 3)).astype(np.float32)
    faces = rng.integers(0, 40, size=(60, 3))
    normals = rng.normal(size=(40, 3)).astype(np.float32)
    uvs = rng.random((40, 2)).astype(np.float32)
    built = []
    for mod in (scene_mod, jax_scene_mod):
        b = mod.SceneBuilder()
        m = b.lambert((0.3, 0.4, 0.5))
        b.add_sphere((0.0, -100.0, 0.0), 99.0, m)
        b.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), m)
        b.add_mesh(verts, faces, m, normals=normals, uvs=uvs,
                   translation=(0.5, 0.0, -1.0), scale=0.7)
        b.add_mesh(verts, faces[:7], b.metal((0.9, 0.9, 0.9), 0.5),
                   face_normals=True)
        built.append(b.build())
    assert_same_leaves(port_leaves(built[0]), jax_leaves(built[1]))


def _pad_only_scene(mod, meshes_mod):
    """129-192 triangles: padded to 256 rows, the block at row 192 is pure
    padding (tests/test_megakernel.py:451-481)."""
    b = mod.SceneBuilder()
    v, f, n, _ = meshes_mod.icosphere(1)
    b.add_mesh(v, f, b.lambert((0.5, 0.5, 0.5)), normals=n)
    b.add_mesh(v, f, b.lambert((0.5, 0.5, 0.5)), normals=n,
               translation=(3.0, 0.0, 0.0))
    v, f, _, _ = meshes_mod.cube()
    b.add_mesh(v, f, b.lambert((0.8, 0.3, 0.2)),
               translation=(-3.0, 0.0, 0.0), face_normals=True)
    b.set_gradient_sky()
    return b.build()


@pytest.mark.parametrize("case", ["mesh_showcase", "pad_only"])
def test_pack_tri_tables_match_jax(case):
    if case == "mesh_showcase":
        (js, _), (ts, _) = _scenes(case)
    else:
        js = _pad_only_scene(jax_scene_mod, jax_meshes)
        ts = _pad_only_scene(scene_mod, meshes)
    jgeo, jrec = pallas_megatrace.pack_tri_tables(
        js, jax_materials.pack_materials(js))
    geo, rec = megatrace.pack_tri_tables(ts, materials.pack_materials(ts))
    np.testing.assert_array_equal(geo.numpy(), np.asarray(jgeo))
    np.testing.assert_array_equal(rec.numpy(), np.asarray(jrec))
    assert geo.shape[0] == megatrace.tri_pad_count(ts.triangles.vert0.shape[0])
    # the kernel's tables and the replay's entity rows from the same pack
    tri_geo, aabb, trec = megatrace.kernel_tri_tables((geo, rec))
    assert aabb.shape[0] == -(-geo.shape[0] // megatrace.TRI_BLOCK)
    np.testing.assert_array_equal(aabb[:, 0:3].numpy(),
                                  geo[::megatrace.TRI_BLOCK, 9:12].numpy())
    np.testing.assert_array_equal(trec.numpy(), rec.T.numpy())
    records = megatrace.pack_sphere_records(ts, materials.pack_materials(ts))
    jrecords = pallas_megatrace.pack_sphere_records(
        js, jax_materials.pack_materials(js))
    from raytracing_in_one_weekend_tpu.ops import megatrace_replay as jr
    want, layout = jr.build_entity_rows(
        js.spheres.center, js.spheres.radius, jrecords,
        tri_tables=(jgeo, jrec))
    got = mr.build_entity_rows(ts.spheres.center, ts.spheres.radius,
                               records, (geo, rec))
    assert layout["cols"] == mr.TRI_ENTITY_COLS == got.shape[1]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pad_only_block_fails_the_slab_test():
    ts = _pad_only_scene(scene_mod, meshes)
    t = ts.triangles.vert0.shape[0]
    assert megatrace.TRI_PAD < t <= megatrace.TRI_BLOCK
    geo, _ = megatrace.pack_tri_tables(ts, materials.pack_materials(ts))
    assert geo.shape[0] == 256
    lo = geo[megatrace.TRI_BLOCK, 9:12]
    hi = geo[megatrace.TRI_BLOCK, 12:15]
    assert torch.equal(lo, hi) and float(lo[0]) >= 1e29
    # on-axis rays from the origin, through the plain version's slab test:
    # no lane may sweep the pad block (its rows have zero edges, never hit)
    dirs = torch.cat([torch.eye(3), -torch.eye(3)])
    o = tuple(torch.zeros(6) for _ in range(3))
    d = tuple(dirs[:, k] for k in range(3))
    t_got, idx, _, _ = megatrace._tri_sweep(o, d, torch.full((6,), 1e30),
                                            geo, 0.0)
    assert bool((idx < megatrace.TRI_BLOCK).all())
    inv = [megatrace._inv_d(c) for c in d]
    near = torch.stack([torch.minimum((lo[k] - o[k]) * inv[k],
                                      (hi[k] - o[k]) * inv[k])
                        for k in range(3)]).max(dim=0).values
    far = torch.stack([torch.maximum((lo[k] - o[k]) * inv[k],
                                     (hi[k] - o[k]) * inv[k])
                       for k in range(3)]).min(dim=0).values
    assert not bool((far >= torch.clamp(near, min=0.0)).any())
    assert bool((t_got < 1e30).all())  # each axis ray hits a sphere mesh


def test_scope_of_mesh_scenes():
    scene, _ = meshes.mesh_showcase()
    # the batch kernel and the replay take meshes up to TRI_MAX; the
    # per-ray megatrace (the wavefront's mega arm) stays sphere-only
    assert megatrace.scene_eligible(scene, allow_triangles=True)
    assert mr.replay_eligible(scene)
    assert not megatrace.scene_eligible(scene)
    assert "sphere-only" in megatrace.unsupported_feature(scene)
    renderer.check_scope(scene)
    # beyond TRI_MAX the batch kernel streams the triangles (no replay);
    # beyond TRI_STREAM_MAX the driver's scope check refuses the mesh
    big, cs = meshes.mesh_large()
    assert big.triangles.vert0.shape[0] > megatrace.TRI_MAX
    assert megatrace.scene_eligible(big, allow_triangles=True)
    assert not mr.replay_eligible(big)
    renderer.check_scope(big)
    huge = dataclasses.replace(big, triangles=dataclasses.replace(
        big.triangles,
        vert0=torch.zeros((megatrace.TRI_STREAM_MAX + 1, 3))))
    assert not megatrace.scene_eligible(huge, allow_triangles=True)
    with pytest.raises(NotImplementedError, match="step 9"):
        renderer.check_scope(huge)


@pytest.mark.parametrize("scene", ["triangle", "mesh_showcase"])
def test_cli_renders_mesh_scenes_on_cpu(tmp_path, scene):
    out = tmp_path / f"{scene}.png"
    rc = cli.main([
        "--scene", scene, "--width", "24", "--height", "16", "--spp", "2",
        "--depth", "3", "--device", "cpu", "--output", str(out), "--quiet",
    ])
    assert rc == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_jax_and_port_agree_on_tri_constants():
    assert megatrace.TRI_PAD == pallas_megatrace.TRI_PAD
    assert megatrace.TRI_BLOCK == pallas_megatrace.TRI_BLOCK
    assert megatrace.TRI_MAX == pallas_megatrace.TRI_MAX
    assert megatrace.TRI_REC_ROWS == pallas_megatrace.TRI_REC_ROWS
