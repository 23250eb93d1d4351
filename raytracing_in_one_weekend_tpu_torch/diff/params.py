"""Parameter plumbing for inverse rendering (counterpart of the JAX
package's diff/params.py).

Scenes are frozen dataclasses of tensors; these helpers splice optimizable
parameter tensors (sphere centers and radii, texture colors, material
IOR, ...) into a scene template with `dataclasses.replace`, so that
autograd differentiates the render with respect to exactly the chosen
parameters.  The rect and box setters reach the renderer's pack of their
tables (`ops/megatrace.pack_aux_tables`), so `diff/inverse.optimize` fits
them like the spheres'; so do the move offsets, the texture colours and
the image atlas (`pack_texture_tables`, the motion and texture builds).
The cubemap setter is a plain setter too; the renderer's `check_scope`
refuses cubemap scenes (ROADMAP step 7.6).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from raytracing_in_one_weekend_tpu_torch.scene.scene import Scene


def _set(scene: Scene, group: str, **fields) -> Scene:
    return dataclasses.replace(
        scene, **{group: dataclasses.replace(getattr(scene, group), **fields)}
    )


def set_sphere_centers(scene: Scene, centers: torch.Tensor) -> Scene:
    return _set(scene, "spheres", center=centers)


def set_sphere_radii(scene: Scene, radii: torch.Tensor) -> Scene:
    return _set(scene, "spheres", radius=radii)


def set_texture_colors(scene: Scene, main_color: torch.Tensor) -> Scene:
    """Replace the whole texture main-color table (albedos and emissions
    live here for constant textures)."""
    return _set(scene, "textures", main_color=main_color)


def set_material_parameters(scene: Scene, parameter: torch.Tensor) -> Scene:
    """IOR (standard/dielectric) / density (volume) table."""
    return _set(scene, "materials", parameter=parameter)


def set_sphere_move_offsets(scene: Scene, move: torch.Tensor) -> Scene:
    """Motion-blur destination offsets (S, 3) (Entity.cs:124-127)."""
    return _set(scene, "spheres", move_offset=move)


def set_box_rotations(scene: Scene, rot: torch.Tensor) -> Scene:
    """Raw world-from-local quaternions (x, y, z, w); consumers
    normalize them."""
    return _set(scene, "boxes", rot=rot)


def set_box_positions(scene: Scene, pos: torch.Tensor) -> Scene:
    return _set(scene, "boxes", pos=pos)


def set_box_extents(scene: Scene, extents: torch.Tensor) -> Scene:
    return _set(scene, "boxes", extents=extents)


def set_rect_rotations(scene: Scene, rot: torch.Tensor) -> Scene:
    return _set(scene, "rects", rot=rot)


def set_rect_positions(scene: Scene, pos: torch.Tensor) -> Scene:
    return _set(scene, "rects", pos=pos)


def set_rect_from(scene: Scene, xy_from: torch.Tensor) -> Scene:
    return _set(scene, "rects", xy_from=xy_from)


def set_rect_to(scene: Scene, xy_to: torch.Tensor) -> Scene:
    return _set(scene, "rects", xy_to=xy_to)


def set_environment_cubemap(scene: Scene, cubemap: torch.Tensor) -> Scene:
    """HDR environment-map faces (6, H, W, 3)."""
    return _set(scene, "environment", cubemap=cubemap)


def set_texture_atlas(scene: Scene, atlas: torch.Tensor) -> Scene:
    """Image-texture texel grid (A, H, W, 3)."""
    return _set(scene, "textures", atlas=atlas)


def set_triangle_normals(scene: Scene, normals: torch.Tensor) -> Scene:
    """Per-vertex shading normals (T, 3, 3): component rows, vertex
    columns (Triangles.normals layout)."""
    return _set(scene, "triangles", normals=normals)


def set_triangle_vertices(scene: Scene, verts: torch.Tensor) -> Scene:
    """Soup vertices (T, 3, 3) in (v0, v1, v2) order, re-packed to the
    edge form (Triangle.cs: edge_a = v2 - v0, edge_b = v1 - v0)."""
    v0, v1, v2 = verts[:, 0], verts[:, 1], verts[:, 2]
    return _set(scene, "triangles", vert0=v0, edge_b=v1 - v0, edge_a=v2 - v0)


def soup_vertices(scene: Scene) -> torch.Tensor:
    """(T, 3, 3) world vertices (v0, v1, v2) from the edge-form soup: the
    inverse of set_triangle_vertices' re-pack."""
    tri = scene.triangles
    return torch.stack(
        [tri.vert0, tri.vert0 + tri.edge_b, tri.vert0 + tri.edge_a], dim=1
    )


_SETTERS: dict[str, Callable[[Scene, torch.Tensor], Scene]] = {
    "sphere_centers": set_sphere_centers,
    "sphere_radii": set_sphere_radii,
    "sphere_move_offsets": set_sphere_move_offsets,
    "texture_colors": set_texture_colors,
    "material_parameters": set_material_parameters,
    "box_rotations": set_box_rotations,
    "box_positions": set_box_positions,
    "box_extents": set_box_extents,
    "rect_rotations": set_rect_rotations,
    "rect_positions": set_rect_positions,
    "rect_from": set_rect_from,
    "rect_to": set_rect_to,
    "triangle_vertices": set_triangle_vertices,
    "triangle_normals": set_triangle_normals,
    "texture_atlas": set_texture_atlas,
    "environment_cubemap": set_environment_cubemap,
}

_GETTERS: dict[str, Callable[[Scene], torch.Tensor]] = {
    "sphere_centers": lambda s: s.spheres.center,
    "sphere_radii": lambda s: s.spheres.radius,
    "sphere_move_offsets": lambda s: s.spheres.move_offset,
    "texture_colors": lambda s: s.textures.main_color,
    "material_parameters": lambda s: s.materials.parameter,
    "box_rotations": lambda s: s.boxes.rot,
    "box_positions": lambda s: s.boxes.pos,
    "box_extents": lambda s: s.boxes.extents,
    "rect_rotations": lambda s: s.rects.rot,
    "rect_positions": lambda s: s.rects.pos,
    "rect_from": lambda s: s.rects.xy_from,
    "rect_to": lambda s: s.rects.xy_to,
    "texture_atlas": lambda s: s.textures.atlas,
    "environment_cubemap": lambda s: s.environment.cubemap,
    "triangle_vertices": soup_vertices,
    "triangle_normals": lambda s: s.triangles.normals,
}


def apply_params(scene: Scene, params: dict[str, Any]) -> Scene:
    """Splice a {name: tensor} parameter dict into the scene template."""
    for name, value in params.items():
        scene = _SETTERS[name](scene, value)
    return scene


def extract_params(scene: Scene,
                   names: tuple[str, ...]) -> dict[str, torch.Tensor]:
    return {n: _GETTERS[n](scene) for n in names}
