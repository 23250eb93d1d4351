"""Mesh sources: a Wavefront OBJ reader and procedural generators
(counterpart of the JAX package's models/meshes.py).

Reference slot: the Unity mesh pipeline feeding AddMeshRuntimeEntitiesJob
(Jobs/AddMeshRuntimeEntitiesJob.cs:15-92) and the mesh legacy scenes
(Assets/Scenes/Legacy/{Bunny,Teapot,Mesh Cube,Polysphere}.asset).  Same
generators and the same float order as the JAX package, so the triangle
soups are equal bit for bit.  `load_obj` is the JAX package's pure-Python
reader (its oracle); the native C++ loader is ROADMAP queue 1, step 14.

`mesh_large` and `mesh_huge` hold more than TRI_MAX triangles: the
renderer takes the streamed tables for them (the batch kernel's streamed
arm, and above meshtrace.SYNC_TRI_MIN the bounce-synchronous sampler).
"""

from __future__ import annotations

import numpy as np

from raytracing_in_one_weekend_tpu_torch.scene.scene import SceneBuilder
from raytracing_in_one_weekend_tpu_torch.utils.config import CameraSettings


def load_obj(path: str):
    """Wavefront OBJ reader: v / vn / vt / f (fans are triangulated).

    Returns (vertices (V,3), faces (F,3) int, normals (V,3) or None,
    uvs (V,2) or None).  Normals and uvs are re-indexed per position index
    (the last one wins), which serves the smooth meshes of this slot."""
    verts: list[list[float]] = []
    norms: list[list[float]] = []
    uvs: list[list[float]] = []
    v_norm: dict[int, list[float]] = {}
    v_uv: dict[int, list[float]] = {}
    faces: list[tuple[int, int, int]] = []

    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif tag == "vn":
                norms.append([float(x) for x in parts[1:4]])
            elif tag == "vt":
                uvs.append([float(x) for x in parts[1:3]])
            elif tag == "f":
                refs = []
                for ref in parts[1:]:
                    fields = ref.split("/")
                    vi = int(fields[0])
                    vi = vi - 1 if vi > 0 else len(verts) + vi
                    if len(fields) > 1 and fields[1]:
                        ti = int(fields[1])
                        v_uv[vi] = uvs[ti - 1 if ti > 0 else len(uvs) + ti]
                    if len(fields) > 2 and fields[2]:
                        ni = int(fields[2])
                        v_norm[vi] = norms[
                            ni - 1 if ni > 0 else len(norms) + ni]
                    refs.append(vi)
                for k in range(1, len(refs) - 1):  # fan triangulation
                    faces.append((refs[0], refs[k], refs[k + 1]))

    vertices = np.asarray(verts, np.float32)
    faces_arr = np.asarray(faces, np.int64)
    normals = None
    if v_norm:
        normals = np.zeros_like(vertices)
        for vi, nrm in v_norm.items():
            normals[vi] = nrm
        missing = np.linalg.norm(normals, axis=-1) == 0
        if missing.any():
            normals[missing] = [0.0, 1.0, 0.0]
    uvs_out = None
    if v_uv:
        uvs_out = np.zeros((vertices.shape[0], 2), np.float32)
        for vi, uv in v_uv.items():
            uvs_out[vi] = uv
    return vertices, faces_arr, normals, uvs_out


def cube():
    """Unit cube centred at the origin (Mesh Cube.asset), face normals."""
    v = np.array(
        [[sx, sy, sz] for sx in (-0.5, 0.5) for sy in (-0.5, 0.5)
         for sz in (-0.5, 0.5)],
        np.float32,
    )
    # 12 triangles, outward winding
    f = np.array(
        [
            [0, 1, 3], [0, 3, 2],  # -x
            [4, 6, 7], [4, 7, 5],  # +x
            [0, 4, 5], [0, 5, 1],  # -y
            [2, 3, 7], [2, 7, 6],  # +y
            [0, 2, 6], [0, 6, 4],  # -z
            [1, 5, 7], [1, 7, 3],  # +z
        ],
        np.int64,
    )
    return v, f, None, None


def icosphere(subdivisions: int = 2):
    """Geodesic sphere of radius 1 (Polysphere.asset), smooth vertex
    normals (the positions on the unit sphere)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    f = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    verts = [tuple(p) for p in v]
    index = {p: i for i, p in enumerate(verts)}

    def midpoint(a, b):
        s = np.asarray(verts[a]) + np.asarray(verts[b])
        m = tuple(float(x) for x in s / np.linalg.norm(s))
        if m not in index:
            index[m] = len(verts)
            verts.append(m)
        return index[m]

    for _ in range(subdivisions):
        nf = []
        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nf += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        f = nf

    vertices = np.asarray(verts, np.float32)
    faces = np.asarray(f, np.int64)
    normals = vertices.copy()  # unit sphere: normal == position
    return vertices, faces, normals, None


def torus(major: float = 1.0, minor: float = 0.35, nu: int = 24,
          nv: int = 12):
    """Torus in the xz plane with smooth normals (a teapot-class curved
    mesh)."""
    us = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    vs = np.linspace(0, 2 * np.pi, nv, endpoint=False)
    verts, norms = [], []
    for u in us:
        cu, su = np.cos(u), np.sin(u)
        for v in vs:
            cv, sv = np.cos(v), np.sin(v)
            verts.append(
                [(major + minor * cv) * cu, minor * sv,
                 (major + minor * cv) * su]
            )
            norms.append([cv * cu, sv, cv * su])
    faces = []
    for i in range(nu):
        for j in range(nv):
            a = i * nv + j
            b = ((i + 1) % nu) * nv + j
            c = ((i + 1) % nu) * nv + (j + 1) % nv
            d = i * nv + (j + 1) % nv
            faces += [(a, b, c), (a, c, d)]
    return (
        np.asarray(verts, np.float32),
        np.asarray(faces, np.int64),
        np.asarray(norms, np.float32),
        None,
    )


def _mesh_camera(look_y: float) -> CameraSettings:
    return CameraSettings(
        origin=(0.0, 2.5, 7.0), look_at=(0.0, look_y, 0.0),
        vertical_fov=35.0, focus_distance=7.0,
    )


def mesh_large():
    """Beyond-TRI_MAX mesh testbed (~21k triangles): a dense geodesic
    sphere, a torus and a cube over a ground sphere."""
    b = SceneBuilder()
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, b.lambert((0.5, 0.5, 0.5)))
    cam = add_mesh_large_meshes(b)
    return b.build(), cam


def add_mesh_large_meshes(b) -> CameraSettings:
    """mesh_large's meshes (icosphere(5), a torus(16, 8) at (-2.4, 0.4,
    0.6) scaled 0.9 and a cube: 20,748 triangles) and its gradient sky into
    the SceneBuilder `b`.  Returns its camera."""
    v, f, n, _ = icosphere(5)  # 20480 faces
    b.add_mesh(v, f, b.metal((0.8, 0.7, 0.5), glossiness=0.9),
               normals=n, translation=(0.0, 1.0, 0.0))
    v, f, n, _ = torus(nu=16, nv=8)
    b.add_mesh(v, f, b.lambert((0.2, 0.4, 0.8)),
               normals=n, translation=(-2.4, 0.4, 0.6), scale=0.9)
    v, f, _, _ = cube()
    b.add_mesh(v, f, b.lambert((0.8, 0.3, 0.2)),
               translation=(2.4, 0.5, 0.4), scale=1.1, face_normals=True)
    b.set_gradient_sky()
    return _mesh_camera(0.8)


def add_mesh_huge_meshes(b) -> CameraSettings:
    """mesh_huge's meshes (icosphere(6), icosphere(5) and a torus: 102,656
    triangles) and its gradient sky into the SceneBuilder `b`.  Returns
    its camera."""
    v, f, n, _ = icosphere(6)  # 81920 faces
    b.add_mesh(v, f, b.metal((0.8, 0.7, 0.5), glossiness=0.9),
               normals=n, translation=(0.0, 1.0, 0.0))
    v, f, n, _ = icosphere(5)  # 20480 faces
    b.add_mesh(v, f, b.dielectric(1.5),
               normals=n, translation=(-2.4, 0.7, 0.6), scale=0.7)
    v, f, n, _ = torus(nu=16, nv=8)
    b.add_mesh(v, f, b.lambert((0.2, 0.4, 0.8)),
               normals=n, translation=(2.4, 0.4, 0.4), scale=0.9)
    b.set_gradient_sky()
    return _mesh_camera(0.8)


def mesh_huge():
    """Mesh testbed beyond 65536 triangles (~103k): icosphere(6),
    icosphere(5) and a torus over a ground sphere."""
    b = SceneBuilder()
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, b.lambert((0.5, 0.5, 0.5)))
    cam = add_mesh_huge_meshes(b)
    return b.build(), cam


def mesh_showcase():
    """Mesh testbed (Bunny/Teapot-class slot): icosphere(2) (320 faces), a
    torus (576) and a cube (12) over a ground sphere: 908 triangles."""
    b = SceneBuilder()
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, b.lambert((0.5, 0.5, 0.5)))
    cam = add_mesh_showcase_meshes(b)
    return b.build(), cam


def add_mesh_showcase_meshes(b) -> CameraSettings:
    """mesh_showcase's meshes (icosphere(2), a torus at (0, 0.5, 0) and a
    cube: 908 triangles) and its gradient sky into the SceneBuilder `b`.
    Returns its camera."""
    v, f, n, _ = icosphere(2)
    b.add_mesh(v, f, b.metal((0.8, 0.7, 0.5), glossiness=0.9),
               normals=n, translation=(-2.2, 1.0, 0.0))
    v, f, n, _ = torus()
    b.add_mesh(v, f, b.lambert((0.2, 0.4, 0.8)),
               normals=n, translation=(0.0, 0.5, 0.0))
    v, f, _, _ = cube()
    b.add_mesh(v, f, b.lambert((0.8, 0.3, 0.2)),
               translation=(2.2, 0.5, 0.0), scale=1.2, face_normals=True)
    b.set_gradient_sky()
    return _mesh_camera(0.7)
