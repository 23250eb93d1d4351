"""Feature-matrix testbed scenes (counterpart of the JAX package's
models/testbeds.py), holding the entries the port renders: the raw
triangle test, the mesh scenes (the showcase, and `mesh_large` and
`mesh_huge` beyond TRI_MAX triangles), `simple_light` (spheres and an
emissive rect), `probabilistic` (fog spheres of three densities),
`cornell_volumes` (Book 2's Cornell smoke: volume boxes), the textured
spheres `checkered`, `perlin` and `textured_sphere` (the JAX package's
procedural earth stand-in: the reference's earthmap.jpg and its image
reader are ROADMAP step 7.6), and `final_book2`, Book 2's composite (boxes,
a rect light, a moving sphere, glass, fog in a glass shell, an image and a
Perlin texture).  The other testbeds follow with their ROADMAP steps.

Reference: the legacy scene assets (Assets/Scenes/Legacy/*.asset); each
function covers the same feature axis with the scene builder, with the
JAX package's arrays.
"""

from __future__ import annotations

import numpy as np

from raytracing_in_one_weekend_tpu_torch.models import book_scenes, meshes
from raytracing_in_one_weekend_tpu_torch.scene.scene import (
    Scene, SceneBuilder, axis_angle_quat, checker, perlin,
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


def perlin_spheres() -> tuple[Scene, CameraSettings]:
    """Perlin Noise (Book 2).asset: turbulence-marble textured spheres."""
    b = SceneBuilder()
    noisy = b.lambert(perlin((1.0, 1.0, 1.0), frequency=4.0))
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, noisy)
    b.add_sphere((0.0, 2.0, 0.0), 2.0, noisy)
    b.set_gradient_sky()
    cam = CameraSettings(origin=(13.0, 2.0, 3.0), look_at=(0.0, 0.0, 0.0),
                         vertical_fov=20.0)
    return b.build(), cam


def checkered_spheres() -> tuple[Scene, CameraSettings]:
    """Two Checkered Spheres (Book 2).asset."""
    b = SceneBuilder()
    check = b.lambert(checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9)))
    b.add_sphere((0.0, -10.0, 0.0), 10.0, check)
    b.add_sphere((0.0, 10.0, 0.0), 10.0, check)
    b.set_gradient_sky()
    cam = CameraSettings(origin=(13.0, 2.0, 3.0), look_at=(0.0, 0.0, 0.0),
                         vertical_fov=20.0)
    return b.build(), cam


def textured_sphere() -> tuple[Scene, CameraSettings]:
    """Textured Sphere (Book 2).asset: an image-textured albedo, the JAX
    package's procedural earth-like stand-in (64x128 texels)."""
    h, w = 64, 128
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    land = (np.sin(xx * 0.21) * np.cos(yy * 0.17) + np.sin(xx * 0.05)) > 0.4
    img = np.where(land[..., None], np.array([0.25, 0.5, 0.15], np.float32),
                   np.array([0.1, 0.2, 0.6], np.float32)).astype(np.float32)
    b = SceneBuilder()
    tex = b.add_image("earth", img)
    b.add_sphere((0.0, 0.0, 0.0), 2.0, b.lambert(tex))
    b.set_gradient_sky()
    cam = CameraSettings(origin=(13.0, 2.0, 3.0), look_at=(0.0, 0.0, 0.0),
                         vertical_fov=20.0)
    return b.build(), cam


def final_scene_book2(seed: int = 9) -> tuple[Scene, CameraSettings]:
    """Final Scene (Book 2).asset analog: a box-grid ground, a rect light,
    a motion-blurred sphere, glass and metal spheres, a glass shell around
    a fog sphere, an image-textured earth, a Perlin sphere and a cube of
    small spheres: every entity kind but triangles, motion, volumes and
    every texture type in one scene."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    ground = b.lambert((0.48, 0.83, 0.53))
    n = 8
    for i in range(n):
        for j in range(n):
            w = 100.0 / n
            x0 = -50.0 + i * w
            z0 = -50.0 + j * w
            y1 = float(rng.uniform(1.0, 8.0))
            b.add_box((x0 + w / 2, y1 / 2, z0 + w / 2), (w, y1, w), ground)
    light = b.emissive((7.0, 7.0, 7.0))
    b.add_rect((273.0 / 100, 5.54, 2.795), (3.0, 2.65), light,
               rotation=axis_angle_quat((1, 0, 0), 90.0))
    moving = b.lambert((0.7, 0.3, 0.1))
    b.add_sphere((4.0, 4.0, 2.0), 0.5, moving, move_offset=(0.3, 0.0, 0.0))
    b.add_sphere((2.6, 1.5, 0.45), 0.5, b.dielectric(1.5))
    b.add_sphere((0.0, 1.5, 1.45), 0.5, b.metal((0.8, 0.8, 0.9), 0.0))
    # a subsurface blue sphere: a glass shell around a fog sphere
    b.add_sphere((3.6, 1.5, 1.45), 0.7, b.dielectric(1.5))
    b.add_sphere((3.6, 1.5, 1.45), 0.69, b.volume(2.0, (0.2, 0.4, 0.9)))
    # an earth and a Perlin sphere
    h, w2 = 32, 64
    yy, xx = np.mgrid[0:h, 0:w2].astype(np.float32)
    land = (np.sin(xx * 0.3) * np.cos(yy * 0.25)) > 0.2
    img = np.where(land[..., None], np.array([0.2, 0.5, 0.2], np.float32),
                   np.array([0.1, 0.2, 0.55], np.float32)).astype(np.float32)
    b.add_sphere((4.0, 2.0, 4.0), 1.0, b.lambert(b.add_image("earth2", img)))
    b.add_sphere((2.2, 2.8, 3.0), 0.8, b.lambert(perlin((1, 1, 1), 2.0)))
    # a cube of small diffuse spheres
    white = b.lambert((0.73, 0.73, 0.73))
    for _ in range(64):
        p = rng.uniform(0.0, 1.65, 3) + np.array([-1.0, 2.7, 2.95])
        b.add_sphere(tuple(p), 0.1, white)
    b.set_no_sky()
    cam = CameraSettings(origin=(4.78, 2.78, -6.0), look_at=(2.78, 2.78, 0.0),
                         vertical_fov=40.0)
    return b.build(), cam


SCENES = {
    "mesh_showcase": meshes.mesh_showcase,
    "mesh_large": meshes.mesh_large,
    "mesh_huge": meshes.mesh_huge,
    "triangle": triangle_test,
    "simple_light": simple_light,
    "probabilistic": probabilistic_test,
    "cornell_volumes": cornell_with_volumes,
    "checkered": checkered_spheres,
    "perlin": perlin_spheres,
    "textured_sphere": textured_sphere,
    "final_book2": final_scene_book2,
}
