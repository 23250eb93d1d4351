"""Feature-matrix testbed scenes (counterpart of the JAX package's
models/testbeds.py), holding the entries the port renders: the raw
triangle test, the mesh scenes (the showcase, and `mesh_large` and
`mesh_huge` beyond TRI_MAX triangles), `simple_light` (spheres and an
emissive rect), `probabilistic` (fog spheres of three densities) and
`cornell_volumes` (Book 2's Cornell smoke: volume boxes).  The other
testbeds follow with their ROADMAP steps.

Reference: the legacy scene assets (Assets/Scenes/Legacy/*.asset); each
function covers the same feature axis with the scene builder, with the
JAX package's arrays.
"""

from __future__ import annotations

import numpy as np

from raytracing_in_one_weekend_tpu_torch.models import book_scenes, meshes
from raytracing_in_one_weekend_tpu_torch.scene.scene import (
    Scene, SceneBuilder, axis_angle_quat,
)
from raytracing_in_one_weekend_tpu_torch.utils.config import CameraSettings


def _front_camera(distance: float = 4.0, fov: float = 40.0) -> CameraSettings:
    return CameraSettings(
        origin=(0.0, 1.0, distance),
        look_at=(0.0, 0.5, 0.0),
        vertical_fov=fov,
        focus_distance=distance,
    )


def probabilistic_test() -> tuple[Scene, CameraSettings]:
    """Probabilistic Test.asset: probabilistic volumes of varied density."""
    b = SceneBuilder()
    ground = b.lambert((0.6, 0.6, 0.6))
    b.add_sphere((0.0, -100.5, 0.0), 100.0, ground)
    inner = b.lambert((0.8, 0.2, 0.2))
    b.add_sphere((0.0, 0.0, -1.0), 0.2, inner)
    for i, density in enumerate((0.5, 2.0, 8.0)):
        fog = b.volume(density, (0.9, 0.9, 0.9))
        b.add_sphere((1.3 * (i - 1), 0.0, 0.0), 0.5, fog)
    b.set_gradient_sky()
    return b.build(), _front_camera(distance=4.0)


def triangle_test() -> tuple[Scene, CameraSettings]:
    """Triangle Test.asset: raw triangles with face and vertex normals."""
    b = SceneBuilder()
    ground = b.lambert((0.5, 0.5, 0.5))
    b.add_sphere((0.0, -100.5, 0.0), 100.0, ground)
    red = b.lambert((0.8, 0.2, 0.2))
    blue = b.lambert((0.2, 0.3, 0.8))
    b.add_triangle((-1.2, 0.0, 0.0), (-0.2, 0.0, 0.0), (-0.7, 1.0, 0.0), red)
    # vertex-normal triangle (the smooth shading path, Triangle.cs:22-29)
    n = np.array([[0.3, 0.2, 0.93], [-0.3, 0.2, 0.93], [0.0, 0.4, 0.92]])
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    b.add_triangle(
        (0.2, 0.0, 0.0), (1.2, 0.0, 0.0), (0.7, 1.0, 0.0), blue, normals=n
    )
    b.set_gradient_sky()
    cam = CameraSettings(origin=(0.0, 1.0, 3.0), look_at=(0.0, 0.5, 0.0),
                         vertical_fov=40.0, focus_distance=3.0)
    return b.build(), cam


def simple_light() -> tuple[Scene, CameraSettings]:
    """Simple Light (Book 2).asset: emissive rect + sphere, no sky."""
    b = SceneBuilder()
    grey = b.lambert((0.5, 0.5, 0.5))
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, grey)
    b.add_sphere((0.0, 2.0, 0.0), 2.0, grey)
    light = b.emissive((4.0, 4.0, 4.0))
    b.add_rect((3.0, 2.0, -2.0), (2.0, 2.0), light,
               rotation=axis_angle_quat((0, 1, 0), -90.0))
    b.add_sphere((0.0, 7.0, 0.0), 2.0, light)
    b.set_no_sky()
    cam = CameraSettings(
        origin=(26.0, 3.0, 6.0), look_at=(0.0, 2.0, 0.0), vertical_fov=20.0
    )
    return b.build(), cam


def cornell_with_volumes() -> tuple[Scene, CameraSettings]:
    """Cornell With Volumes (Book 2).asset: smoke and fog boxes in a
    Cornell box (volumes are convex hulls, Entity.cs:24), with the port's
    cornell camera."""
    b = SceneBuilder()
    red = b.lambert((0.65, 0.05, 0.05))
    green = b.lambert((0.12, 0.45, 0.15))
    white = b.lambert((0.73, 0.73, 0.73))
    light = b.emissive((7.0, 7.0, 7.0))
    smoke = b.volume(8.0, (0.05, 0.05, 0.05))
    fog = b.volume(8.0, (0.95, 0.95, 0.95))

    s = 1.0
    b.add_rect((0, 0, -s), (2 * s, 2 * s), white)
    b.add_rect((-s, 0, 0), (2 * s, 2 * s), red,
               rotation=axis_angle_quat((0, 1, 0), 90.0))
    b.add_rect((s, 0, 0), (2 * s, 2 * s), green,
               rotation=axis_angle_quat((0, 1, 0), -90.0))
    b.add_rect((0, -s, 0), (2 * s, 2 * s), white,
               rotation=axis_angle_quat((1, 0, 0), -90.0))
    b.add_rect((0, s, 0), (2 * s, 2 * s), white,
               rotation=axis_angle_quat((1, 0, 0), 90.0))
    b.add_rect((0, s - 1e-3, 0), (s, s), light,
               rotation=axis_angle_quat((1, 0, 0), 90.0))
    b.add_box((-0.35, -0.55, -0.3), (0.55, 0.9, 0.55), smoke,
              rotation=axis_angle_quat((0, 1, 0), 18.0))
    b.add_box((0.4, -0.75, 0.25), (0.5, 0.5, 0.5), fog,
              rotation=axis_angle_quat((0, 1, 0), -15.0))
    b.set_no_sky()
    _, cam = book_scenes.cornell_box()
    return b.build(), cam


SCENES = {
    "mesh_showcase": meshes.mesh_showcase,
    "mesh_large": meshes.mesh_large,
    "mesh_huge": meshes.mesh_huge,
    "triangle": triangle_test,
    "simple_light": simple_light,
    "probabilistic": probabilistic_test,
    "cornell_volumes": cornell_with_volumes,
}
