"""Scene representation and builder (counterpart of the JAX package's
scene/scene.py).

One struct-of-arrays group per primitive kind (spheres, rects, boxes,
triangles), a material table, a texture table and the environment, each
a frozen dataclass of tensors with `.to(device)`.  `SceneBuilder.build`
produces the same arrays as the JAX builder, including the empty
rect/box/triangle arrays.  `scene_from_arrays` carries a scene built by
the JAX package across as numpy arrays.

Triangles (`add_triangle`, `add_mesh`) are baked to world space in the
reference's edge form and Morton-sorted by centroid at build, as the JAX
builder does.  Image textures (`add_image`) are padded into one (A, H, W,
3) atlas and Perlin tables made from `perlin_seed` (core/noise.py), as the
JAX builder does.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence, Union

import numpy as np
import torch

from raytracing_in_one_weekend_tpu_torch.core import noise as noise_mod
from raytracing_in_one_weekend_tpu_torch.core.textures import (
    TextureTable,
    TextureType,
)
from raytracing_in_one_weekend_tpu_torch.utils.tensors import TensorGroup

PLASTIC_IOR = 1.5  # reference: Material.cs PlasticIor
METAL_IOR = 1.1  # reference: Material.cs MetalIor


class MaterialType(enum.IntEnum):
    """Reference: Material.cs:9-14."""

    STANDARD = 0
    DIELECTRIC = 1
    PROBABILISTIC_VOLUME = 2


class EntityKind(enum.IntEnum):
    """Reference: Entity.cs:13-20."""

    SPHERE = 0
    RECT = 1
    BOX = 2
    TRIANGLE = 3


class SkyType(enum.IntEnum):
    """Reference: Environment.cs:5-11."""

    NONE = 0
    GRADIENT = 1
    CUBEMAP = 2


@dataclasses.dataclass(frozen=True)
class MaterialTable(TensorGroup):
    type: torch.Tensor  # (M,) int32
    albedo_tex: torch.Tensor  # (M,) int32
    emission_tex: torch.Tensor  # (M,) int32
    glossiness_tex: torch.Tensor  # (M,) int32
    metallic_tex: torch.Tensor  # (M,) int32
    parameter: torch.Tensor  # (M,) IOR (standard/dielectric) or density
    perfect_specular: torch.Tensor  # (M,) bool (Material.cs:181-196)


@dataclasses.dataclass(frozen=True)
class Spheres(TensorGroup):
    center: torch.Tensor  # (S, 3)
    radius: torch.Tensor  # (S,)
    material: torch.Tensor  # (S,) int32
    move_offset: Optional[torch.Tensor] = None  # (S, 3) when motion blur
    time_range: Optional[torch.Tensor] = None  # (S, 2)


@dataclasses.dataclass(frozen=True)
class Rects(TensorGroup):
    rot: torch.Tensor  # (R, 4) world-from-local quaternion (x, y, z, w)
    pos: torch.Tensor  # (R, 3)
    xy_from: torch.Tensor  # (R, 2)
    xy_to: torch.Tensor  # (R, 2)
    material: torch.Tensor  # (R,) int32


@dataclasses.dataclass(frozen=True)
class Boxes(TensorGroup):
    rot: torch.Tensor  # (B, 4)
    pos: torch.Tensor  # (B, 3)
    extents: torch.Tensor  # (B, 3) half-sizes
    material: torch.Tensor  # (B,) int32


@dataclasses.dataclass(frozen=True)
class Triangles(TensorGroup):
    edge_a: torch.Tensor  # (T, 3) v2 - v0
    edge_b: torch.Tensor  # (T, 3) v1 - v0
    vert0: torch.Tensor  # (T, 3)
    normals: torch.Tensor  # (T, 3, 3) per-vertex normals as columns
    uvs: torch.Tensor  # (T, 2, 3) per-vertex texcoords as columns
    material: torch.Tensor  # (T,) int32


@dataclasses.dataclass(frozen=True)
class Environment(TensorGroup):
    sky_type: torch.Tensor  # () int32
    sky_bottom: torch.Tensor  # (3,)
    sky_top: torch.Tensor  # (3,)
    cubemap: Optional[torch.Tensor] = None  # (6, H, W, 3) float32 faces
    #   +x, -x, +y, -y, +z, -z (set_cubemap_sky), or None


@dataclasses.dataclass(frozen=True)
class SceneFlags:
    """Scene facts the renderer dispatches on (same fields as the JAX
    package's SceneFlags)."""

    has_volumes: bool = False
    has_dielectrics: bool = False
    has_motion: bool = False
    has_emissive: bool = False
    has_procedural_textures: bool = False
    sky: int = 1
    has_nonconvex_volumes: bool = False
    motion_unit_time: bool = True
    procedural_albedo_only: bool = True


@dataclasses.dataclass(frozen=True)
class Scene(TensorGroup):
    spheres: Spheres
    rects: Rects
    boxes: Boxes
    triangles: Triangles
    materials: MaterialTable
    textures: TextureTable
    environment: Environment
    flags: SceneFlags = SceneFlags()


# Leaves of each group, in the JAX package's field order.
_GROUPS = {
    "spheres": Spheres,
    "rects": Rects,
    "boxes": Boxes,
    "triangles": Triangles,
    "materials": MaterialTable,
    "textures": TextureTable,
    "environment": Environment,
}


def scene_from_arrays(
    arrays: dict[str, np.ndarray],
    flags: dict,
    device: torch.device | str = "cpu",
) -> Scene:
    """Build the port's Scene from a scene's leaves as numpy arrays.

    `arrays` is keyed "<group>.<field>" ("spheres.center",
    "materials.type", ...), with the JAX package's group and field names;
    optional leaves (motion offsets, image atlas, cubemap) may be absent.
    `flags` holds the SceneFlags fields; Perlin tables come as
    "textures.perlin.<field>" (the PerlinTables fields).  Values are
    copied."""
    groups = {}
    for name, cls in _GROUPS.items():
        leaves = {}
        for f in dataclasses.fields(cls):
            key = f"{name}.{f.name}"
            if key == "textures.perlin" and f"{key}.perm_x" in arrays:
                leaves["perlin"] = noise_mod.PerlinTables(**{
                    p.name: torch.tensor(np.array(arrays[f"{key}.{p.name}"]),
                                         device=device)
                    for p in dataclasses.fields(noise_mod.PerlinTables)})
            elif key in arrays:
                leaves[f.name] = torch.tensor(
                    np.array(arrays[key]), device=device
                )
            elif f.default is dataclasses.MISSING:
                raise KeyError(f"scene_from_arrays: missing leaf {key!r}")
        groups[name] = cls(**leaves)
    return Scene(**groups, flags=SceneFlags(**flags))


# ---------------------------------------------------------------------------
# Builder (host-side, numpy)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TextureSpec:
    """Host-side texture description, interned into the TextureTable."""

    type: TextureType = TextureType.NONE
    main_color: tuple = (0.0, 0.0, 0.0)
    secondary_color: tuple = (0.0, 0.0, 0.0)
    parameter: float = 0.0
    scalar_channel: int = 0
    image: Optional[tuple] = None


ColorLike = Union[None, float, Sequence[float], TextureSpec]


def constant(color) -> TextureSpec:
    color = np.broadcast_to(np.asarray(color, np.float32), (3,))
    return TextureSpec(TextureType.CONSTANT, tuple(float(c) for c in color))


def constant_scalar(value: float) -> TextureSpec:
    return TextureSpec(TextureType.CONSTANT_SCALAR, parameter=float(value))


def _color3(value) -> tuple:
    return tuple(
        float(c) for c in np.broadcast_to(np.asarray(value, np.float32), (3,))
    )


def checker(main, secondary, scale: float = 10.0) -> TextureSpec:
    return TextureSpec(
        TextureType.CHECKER, _color3(main), _color3(secondary), float(scale)
    )


def perlin(main, frequency: float = 1.0) -> TextureSpec:
    return TextureSpec(
        TextureType.PERLIN, _color3(main), parameter=float(frequency)
    )


def _as_texture(value: ColorLike) -> TextureSpec:
    if value is None:
        return TextureSpec()
    if isinstance(value, TextureSpec):
        return value
    arr = np.asarray(value, np.float32)
    if arr.ndim == 0:
        return constant_scalar(float(arr))
    return constant(arr)


def _rotation_to_quat(rotation) -> np.ndarray:
    """Accept None / quaternion (4,) / 3x3 matrix; return (x, y, z, w)."""
    if rotation is None:
        return np.array([0.0, 0.0, 0.0, 1.0], np.float32)
    rotation = np.asarray(rotation, np.float32)
    if rotation.shape == (4,):
        return rotation / np.linalg.norm(rotation)
    if rotation.shape == (3, 3):
        m = rotation
        w = np.sqrt(max(0.0, 1.0 + m[0, 0] + m[1, 1] + m[2, 2])) / 2.0
        if w > 1e-6:
            x = (m[2, 1] - m[1, 2]) / (4 * w)
            y = (m[0, 2] - m[2, 0]) / (4 * w)
            z = (m[1, 0] - m[0, 1]) / (4 * w)
        else:  # degenerate 180-degree rotations
            x, y, z = 1.0, 0.0, 0.0
        q = np.array([x, y, z, w], np.float32)
        return q / np.linalg.norm(q)
    raise ValueError(f"unsupported rotation spec: {rotation.shape}")


def axis_angle_quat(axis, degrees: float) -> np.ndarray:
    axis = np.asarray(axis, np.float32)
    axis = axis / np.linalg.norm(axis)
    half = np.deg2rad(degrees) / 2.0
    return np.concatenate(
        [axis * np.sin(half), [np.cos(half)]]
    ).astype(np.float32)


def _morton_sphere_order(centers: np.ndarray) -> np.ndarray:
    """Stable Z-order permutation of sphere centres (10 bits per axis)."""
    cen = centers.astype(np.float64)
    lo = cen.min(axis=0)
    span = np.maximum(cen.max(axis=0) - lo, 1e-30)
    q = np.clip((cen - lo) / span * 1023.0, 0, 1023).astype(np.uint32)

    def spread(x):
        x = (x | (x << 16)) & np.uint32(0x030000FF)
        x = (x | (x << 8)) & np.uint32(0x0300F00F)
        x = (x | (x << 4)) & np.uint32(0x030C30C3)
        x = (x | (x << 2)) & np.uint32(0x09249249)
        return x

    key = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    return np.argsort(key, kind="stable")


def _morton_perm(centroids: np.ndarray) -> np.ndarray:
    """Stable Z-order permutation of triangle centroids (10 bits per axis
    over their bounding box), the JAX builder's: consecutive TRI_BLOCK
    rows then cover compact regions, so the batch kernel's per-block
    AABB test skips most blocks."""
    cen = np.asarray(centroids, np.float64)
    lo = cen.min(axis=0)
    span = np.maximum(cen.max(axis=0) - lo, 1e-12)
    q = np.clip((cen - lo) / span * 1024.0, 0.0, 1023.0).astype(np.uint32)

    def spread(v):  # 10 bits -> every 3rd bit of a 30-bit code
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    return np.argsort(code, kind="stable")


class SceneBuilder:
    """Imperative scene assembly -> Scene of tensors (the analog of the
    reference's material conversion + entity-buffer rebuild,
    Raytracer.cs:1185-1304)."""

    def __init__(self):
        self._textures: list[TextureSpec] = [TextureSpec()]  # id 0 = NONE
        self._texture_ids: dict[TextureSpec, int] = {TextureSpec(): 0}
        self._materials: list[dict] = []
        self._spheres: list[tuple] = []
        self._rects: list[tuple] = []
        self._boxes: list[tuple] = []
        self._triangles: list[tuple] = []
        self._images: list[np.ndarray] = []
        self._image_keys: dict[str, int] = {}
        self._sky = (SkyType.GRADIENT, (1.0, 1.0, 1.0), (0.5, 0.7, 1.0))
        self._cubemap: Optional[np.ndarray] = None

    # -- textures / images --------------------------------------------------

    def add_image(self, name: str, data: np.ndarray) -> TextureSpec:
        """Register an image texture (H, W, 3+) in linear color; every
        image is padded into one atlas at build."""
        if name not in self._image_keys:
            self._image_keys[name] = len(self._images)
            self._images.append(np.asarray(data, np.float32))
        return TextureSpec(TextureType.IMAGE, (1.0, 1.0, 1.0),
                           image=(name, self._image_keys[name]))

    def _intern_texture(self, spec: TextureSpec) -> int:
        """The id of the first texture equal to `spec`, added if new (a
        dict, so that scenes of thousands of materials build in
        linear time)."""
        if spec not in self._texture_ids:
            self._texture_ids[spec] = len(self._textures)
            self._textures.append(spec)
        return self._texture_ids[spec]

    # -- materials -----------------------------------------------------------

    def _add_material(
        self, mat_type, albedo, emission, glossiness, metallic, parameter
    ) -> int:
        albedo = _as_texture(albedo)
        emission = _as_texture(emission)
        glossiness = _as_texture(glossiness)
        metallic = _as_texture(metallic)
        # IsPerfectSpecular (reference: Material.cs:181-196)
        if mat_type == MaterialType.DIELECTRIC:
            perfect = True
        elif mat_type == MaterialType.STANDARD:
            perfect = (
                metallic.type == TextureType.CONSTANT
                and np.allclose(metallic.main_color, 1.0)
                and glossiness.type == TextureType.CONSTANT
                and np.allclose(glossiness.main_color, 1.0)
            ) or (
                metallic.type == TextureType.CONSTANT_SCALAR
                and metallic.parameter == 1.0
                and glossiness.type == TextureType.CONSTANT_SCALAR
                and glossiness.parameter == 1.0
            )
        else:
            perfect = False
        self._materials.append(
            dict(
                type=int(mat_type),
                albedo=self._intern_texture(albedo),
                emission=self._intern_texture(emission),
                glossiness=self._intern_texture(glossiness),
                metallic=self._intern_texture(metallic),
                parameter=float(parameter),
                perfect_specular=bool(perfect),
            )
        )
        return len(self._materials) - 1

    def standard(
        self, albedo, glossiness=0.0, metallic=0.0, emission=None,
        ior=PLASTIC_IOR,
    ) -> int:
        """Unified Lambert/metal/glossy material (Material.cs:75-119)."""
        return self._add_material(
            MaterialType.STANDARD, albedo, emission, glossiness, metallic, ior
        )

    def lambert(self, albedo, emission=None) -> int:
        return self.standard(
            albedo, glossiness=0.0, metallic=0.0, emission=emission
        )

    def metal(self, albedo, glossiness=1.0) -> int:
        """Book 'metal': fully metallic standard material; fuzz = 1-gloss."""
        return self.standard(albedo, glossiness=glossiness, metallic=1.0)

    def dielectric(
        self, ior: float, glossiness=1.0, albedo=(1.0, 1.0, 1.0)
    ) -> int:
        """Reference: Material.cs:121-161."""
        return self._add_material(
            MaterialType.DIELECTRIC, albedo, None, glossiness, None, ior
        )

    def volume(self, density: float, albedo, emission=None) -> int:
        """Probabilistic (Beer-Lambert) volume (Material.cs:49-65)."""
        return self._add_material(
            MaterialType.PROBABILISTIC_VOLUME, albedo, emission, None, None,
            density,
        )

    def emissive(self, emission, albedo=(0.0, 0.0, 0.0)) -> int:
        return self.standard(albedo, emission=emission)

    # -- entities ------------------------------------------------------------

    def add_sphere(
        self, center, radius, material: int, move_offset=None,
        time_range=(0.0, 1.0),
    ):
        self._spheres.append(
            (
                np.asarray(center, np.float32),
                float(radius),
                int(material),
                None if move_offset is None
                else np.asarray(move_offset, np.float32),
                np.asarray(time_range, np.float32),
            )
        )

    def add_rect(self, center, size, material: int, rotation=None):
        """Local-XY rect, one-sided +Z normal (EntityTypes/Rect.cs:8-20)."""
        size = np.broadcast_to(np.asarray(size, np.float32), (2,))
        self._rects.append(
            (
                _rotation_to_quat(rotation),
                np.asarray(center, np.float32),
                -size / 2.0,
                size / 2.0,
                int(material),
            )
        )

    def add_box(self, center, size, material: int, rotation=None):
        """Oriented box via half-extents (EntityTypes/Box.cs:7-19)."""
        size = np.broadcast_to(np.asarray(size, np.float32), (3,))
        self._boxes.append(
            (
                _rotation_to_quat(rotation),
                np.asarray(center, np.float32),
                size / 2.0,
                int(material),
            )
        )

    def add_triangle(self, v0, v1, v2, material: int, normals=None,
                     uvs=None):
        """World-space triangle in the reference's edge form
        (EntityTypes/Triangle.cs:7-51: Data = {v2 - v0, v1 - v0, v0})."""
        v0 = np.asarray(v0, np.float32)
        v1 = np.asarray(v1, np.float32)
        v2 = np.asarray(v2, np.float32)
        if normals is None:
            face_n = np.cross(v1 - v0, v2 - v0)
            norm = np.linalg.norm(face_n)
            face_n = face_n / (norm if norm > 0 else 1.0)
            normals = np.stack([face_n] * 3, axis=-1)  # (3, 3) columns
        else:
            normals = np.stack(
                [np.asarray(n, np.float32) for n in normals], axis=-1
            )
        if uvs is None:
            uvs = np.zeros((2, 3), np.float32)
        else:
            uvs = np.stack([np.asarray(u, np.float32) for u in uvs], axis=-1)
        self._triangles.append((
            (v2 - v0)[None], (v1 - v0)[None], v0[None], normals[None],
            uvs[None], np.full((1,), material, np.int32),
        ))

    def add_mesh(
        self, vertices, faces, material: int, normals=None, uvs=None,
        translation=(0, 0, 0), scale=1.0, face_normals=False,
    ):
        """Triangle soup from an indexed mesh, the transform baked into
        world space (Jobs/AddMeshRuntimeEntitiesJob.cs:15-92), appended
        as one (F, ...) chunk."""
        vertices = np.asarray(vertices, np.float32) * float(scale) \
            + np.asarray(translation, np.float32)
        faces = np.asarray(faces, np.int64)
        if faces.shape[0] == 0:
            return
        v0 = vertices[faces[:, 0]]
        v1 = vertices[faces[:, 1]]
        v2 = vertices[faces[:, 2]]
        if normals is None or face_normals:
            # the face normal in the three vertex slots
            # (AddMeshRuntimeEntitiesJob.cs:70-78, add_triangle's rule)
            fn = np.cross(v1 - v0, v2 - v0)
            nrm = np.linalg.norm(fn, axis=-1, keepdims=True)
            fn = fn / np.where(nrm > 0, nrm, 1.0)
            tri_normals = np.repeat(fn[:, :, None], 3, axis=2)
        else:
            nsrc = np.asarray(normals, np.float32)
            tri_normals = np.stack(
                [nsrc[faces[:, 0]], nsrc[faces[:, 1]], nsrc[faces[:, 2]]],
                axis=-1,
            )
        if uvs is None:
            tri_uvs = np.zeros((faces.shape[0], 2, 3), np.float32)
        else:
            usrc = np.asarray(uvs, np.float32)
            tri_uvs = np.stack(
                [usrc[faces[:, 0]], usrc[faces[:, 1]], usrc[faces[:, 2]]],
                axis=-1,
            )
        self._triangles.append((
            (v2 - v0).astype(np.float32), (v1 - v0).astype(np.float32),
            v0.astype(np.float32), tri_normals.astype(np.float32),
            tri_uvs.astype(np.float32),
            np.full((faces.shape[0],), material, np.int32),
        ))

    # -- environment -----------------------------------------------------------

    def set_gradient_sky(self, bottom=(1.0, 1.0, 1.0), top=(0.5, 0.7, 1.0)):
        self._sky = (SkyType.GRADIENT, tuple(bottom), tuple(top))

    def set_no_sky(self):
        self._sky = (SkyType.NONE, (0.0, 0.0, 0.0), (0.0, 0.0, 0.0))

    def set_cubemap_sky(self, faces: np.ndarray):
        """faces: (6, H, W, 3) in +x, -x, +y, -y, +z, -z order
        (reference: Texture.cs:141-211 Cubemap)."""
        self._sky = (SkyType.CUBEMAP, (0.0, 0.0, 0.0), (0.0, 0.0, 0.0))
        self._cubemap = np.asarray(faces, np.float32)

    # -- build -----------------------------------------------------------------

    def build(
        self, perlin_seed: int = 1, sort_spheres: bool | None = None,
        device: torch.device | str = "cpu",
    ) -> Scene:
        """Assemble the Scene on `device`.

        sort_spheres: Morton-order the spheres by centre.  None sorts
        exactly when the scene has more than `ops.megatrace.SPH_CULL_MIN`
        spheres (as the JAX builder does with its own constant); pass
        False to keep insertion order."""
        from raytracing_in_one_weekend_tpu_torch.ops import megatrace

        def t(values, dtype):
            return torch.tensor(np.asarray(values), dtype=dtype,
                                device=device)

        def empty(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        f32, i32 = torch.float32, torch.int32
        mats = self._materials or [
            dict(type=0, albedo=0, emission=0, glossiness=0, metallic=0,
                 parameter=PLASTIC_IOR, perfect_specular=False)
        ]
        materials = MaterialTable(
            type=t([m["type"] for m in mats], i32),
            albedo_tex=t([m["albedo"] for m in mats], i32),
            emission_tex=t([m["emission"] for m in mats], i32),
            glossiness_tex=t([m["glossiness"] for m in mats], i32),
            metallic_tex=t([m["metallic"] for m in mats], i32),
            parameter=t(np.asarray([m["parameter"] for m in mats],
                                   np.float32), f32),
            perfect_specular=t([m["perfect_specular"] for m in mats],
                               torch.bool),
        )
        tex = self._textures
        atlas = None
        if self._images:
            max_h = max(im.shape[0] for im in self._images)
            max_w = max(im.shape[1] for im in self._images)
            atlas = np.zeros((len(self._images), max_h, max_w, 3),
                             np.float32)
            for i, im in enumerate(self._images):
                atlas[i, :im.shape[0], :im.shape[1]] = im[..., :3]
        needs_perlin = any(s.type == TextureType.PERLIN for s in tex)
        textures = TextureTable(
            type=t([int(s.type) for s in tex], i32),
            main_color=t(np.asarray([s.main_color for s in tex],
                                    np.float32), f32),
            secondary_color=t(np.asarray([s.secondary_color for s in tex],
                                         np.float32), f32),
            parameter=t(np.asarray([s.parameter for s in tex], np.float32),
                        f32),
            scalar_channel=t([s.scalar_channel for s in tex], i32),
            image_index=t([(s.image[1] if s.image else -1) for s in tex],
                          i32),
            atlas=None if atlas is None else t(atlas, f32),
            perlin=(noise_mod.make_perlin_tables(perlin_seed, device)
                    if needs_perlin else None),
        )

        has_motion = any(s[3] is not None for s in self._spheres)
        if sort_spheres is None:
            sort_spheres = len(self._spheres) > megatrace.SPH_CULL_MIN
        spheres_in = self._spheres
        if sort_spheres and spheres_in:
            order = _morton_sphere_order(np.stack([s[0] for s in spheres_in]))
            spheres_in = [spheres_in[i] for i in order]
        if spheres_in:
            zero3 = np.zeros(3, np.float32)
            spheres = Spheres(
                center=t(np.stack([s[0] for s in spheres_in]), f32),
                radius=t(np.asarray([s[1] for s in spheres_in], np.float32),
                         f32),
                material=t([s[2] for s in spheres_in], i32),
                move_offset=(
                    t(np.stack([zero3 if s[3] is None else s[3]
                                for s in spheres_in]), f32)
                    if has_motion else None
                ),
                time_range=(
                    t(np.stack([s[4] for s in spheres_in]), f32)
                    if has_motion else None
                ),
            )
        else:
            spheres = Spheres(
                center=empty(0, 3), radius=empty(0),
                material=empty(0, dtype=i32),
            )

        if self._rects:
            rects = Rects(
                rot=t(np.stack([r[0] for r in self._rects]), f32),
                pos=t(np.stack([r[1] for r in self._rects]), f32),
                xy_from=t(np.stack([r[2] for r in self._rects]), f32),
                xy_to=t(np.stack([r[3] for r in self._rects]), f32),
                material=t([r[4] for r in self._rects], i32),
            )
        else:
            rects = Rects(
                rot=empty(0, 4), pos=empty(0, 3), xy_from=empty(0, 2),
                xy_to=empty(0, 2), material=empty(0, dtype=i32),
            )

        if self._boxes:
            boxes = Boxes(
                rot=t(np.stack([b[0] for b in self._boxes]), f32),
                pos=t(np.stack([b[1] for b in self._boxes]), f32),
                extents=t(np.stack([b[2] for b in self._boxes]), f32),
                material=t([b[3] for b in self._boxes], i32),
            )
        else:
            boxes = Boxes(
                rot=empty(0, 4), pos=empty(0, 3), extents=empty(0, 3),
                material=empty(0, dtype=i32),
            )

        if self._triangles:
            # each entry is a (k, ...) chunk: k = 1 for add_triangle, F
            # for add_mesh
            edge_a, edge_b, vert0, normals, uvs, tri_mat = (
                np.concatenate([tr[k] for tr in self._triangles])
                for k in range(6)
            )
            # Morton order by centroid, once at build (the JAX builder's
            # float32 expression), so TRI_BLOCK row blocks are compact
            perm = _morton_perm(vert0 + (edge_a + edge_b) * (1.0 / 3.0))
            triangles = Triangles(
                edge_a=t(edge_a[perm], f32), edge_b=t(edge_b[perm], f32),
                vert0=t(vert0[perm], f32), normals=t(normals[perm], f32),
                uvs=t(uvs[perm], f32), material=t(tri_mat[perm], i32),
            )
        else:
            triangles = Triangles(
                edge_a=empty(0, 3), edge_b=empty(0, 3), vert0=empty(0, 3),
                normals=empty(0, 3, 3), uvs=empty(0, 2, 3),
                material=empty(0, dtype=i32),
            )

        sky_type, bottom, top = self._sky
        environment = Environment(
            sky_type=torch.tensor(int(sky_type), dtype=i32, device=device),
            sky_bottom=t(np.asarray(bottom, np.float32), f32),
            sky_top=t(np.asarray(top, np.float32), f32),
            cubemap=None if self._cubemap is None else t(self._cubemap, f32),
        )

        mat_types = [m["type"] for m in mats]
        vol_ids = {
            i for i, mt in enumerate(mat_types)
            if mt == int(MaterialType.PROBABILISTIC_VOLUME)
        }
        procedural = (TextureType.CHECKER, TextureType.PERLIN,
                      TextureType.IMAGE)
        flags = SceneFlags(
            has_volumes=int(MaterialType.PROBABILISTIC_VOLUME) in mat_types,
            has_dielectrics=int(MaterialType.DIELECTRIC) in mat_types,
            has_motion=has_motion,
            has_emissive=any(
                tex[m["emission"]].type != TextureType.NONE for m in mats
            ),
            has_procedural_textures=any(s.type in procedural for s in tex),
            sky=int(sky_type),
            has_nonconvex_volumes=(
                any(r[4] in vol_ids for r in self._rects)
                or any(bool(np.isin(tr[5], list(vol_ids)).any())
                       for tr in self._triangles)
            ),
            motion_unit_time=all(
                s[3] is None
                or (float(s[4][0]) == 0.0 and float(s[4][1]) == 1.0)
                for s in self._spheres
            ),
            procedural_albedo_only=all(
                not any(
                    tex[m[slot]].type in procedural
                    for slot in ("emission", "glossiness", "metallic")
                )
                and not (
                    tex[m["albedo"]].type in procedural
                    and m["type"] == int(MaterialType.PROBABILISTIC_VOLUME)
                )
                for m in mats
            ),
        )
        return Scene(
            spheres=spheres, rects=rects, boxes=boxes, triangles=triangles,
            materials=materials, textures=textures, environment=environment,
            flags=flags,
        )
