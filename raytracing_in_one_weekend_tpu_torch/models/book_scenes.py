"""Canonical "Ray Tracing in One Weekend" scenes (counterpart of the JAX
package's models/book_scenes.py).

Same builders, same numpy seeds, so the arrays equal the JAX package's.
`cover_motion` is the cover with its small diffuse spheres moving over
the unit shutter (motion blur).
"""

from __future__ import annotations

import numpy as np

from raytracing_in_one_weekend_tpu_torch.scene.scene import (
    Scene,
    SceneBuilder,
    axis_angle_quat,
)
from raytracing_in_one_weekend_tpu_torch.utils.config import CameraSettings


def single_sphere() -> tuple[Scene, CameraSettings]:
    """Config 1: single diffuse sphere + ground sphere, gradient sky."""
    b = SceneBuilder()
    diffuse = b.lambert((0.5, 0.5, 0.5))
    ground = b.lambert((0.5, 0.5, 0.5))
    b.add_sphere((0.0, 0.0, -1.0), 0.5, diffuse)
    b.add_sphere((0.0, -100.5, -1.0), 100.0, ground)
    b.set_gradient_sky()
    cam = CameraSettings(
        origin=(0.0, 0.0, 0.0),
        look_at=(0.0, 0.0, -1.0),
        vertical_fov=90.0,
        aperture=0.0,
        focus_distance=1.0,
    )
    return b.build(), cam


def three_spheres() -> tuple[Scene, CameraSettings]:
    """Config 2: the book's lambert/metal/dielectric triple."""
    b = SceneBuilder()
    center = b.lambert((0.1, 0.2, 0.5))
    ground = b.lambert((0.8, 0.8, 0.0))
    metal = b.metal((0.8, 0.6, 0.2), glossiness=1.0)
    glass = b.dielectric(1.5)
    b.add_sphere((0.0, 0.0, -1.0), 0.5, center)
    b.add_sphere((0.0, -100.5, -1.0), 100.0, ground)
    b.add_sphere((1.0, 0.0, -1.0), 0.5, metal)
    b.add_sphere((-1.0, 0.0, -1.0), 0.5, glass)
    # Hollow glass: the book nests a negative-radius inner shell.
    b.add_sphere((-1.0, 0.0, -1.0), -0.45, glass)
    b.set_gradient_sky()
    cam = CameraSettings(
        origin=(0.0, 0.0, 0.0),
        look_at=(0.0, 0.0, -1.0),
        vertical_fov=90.0,
        focus_distance=1.0,
    )
    return b.build(), cam


def cover_scene(
    seed: int = 45,
    grid: int = 11,
    motion_blur: bool = False,
) -> tuple[Scene, CameraSettings]:
    """Config 3: the book cover, ~480 random small spheres + 3 landmark
    spheres + ground (jittered-grid material lottery of the reference's
    legacy generator, Unity/Raytracer.cs:1426-1505)."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    ground = b.lambert((0.5, 0.5, 0.5))
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, ground)

    for a in range(-grid, grid):
        for c in range(-grid, grid):
            choose = rng.random()
            center = np.array(
                [a + 0.9 * rng.random(), 0.2, c + 0.9 * rng.random()],
                np.float32,
            )
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose < 0.8:
                albedo = rng.random(3) * rng.random(3)
                mat = b.lambert(albedo)
                move = (
                    (0.0, 0.5 * rng.random(), 0.0) if motion_blur else None
                )
                b.add_sphere(center, 0.2, mat, move_offset=move)
            elif choose < 0.95:
                albedo = 0.5 * (1.0 + rng.random(3))
                gloss = 1.0 - 0.5 * rng.random()
                mat = b.metal(albedo, glossiness=gloss)
                b.add_sphere(center, 0.2, mat)
            else:
                mat = b.dielectric(1.5)
                b.add_sphere(center, 0.2, mat)

    b.add_sphere((0.0, 1.0, 0.0), 1.0, b.dielectric(1.5))
    b.add_sphere((-4.0, 1.0, 0.0), 1.0, b.lambert((0.4, 0.2, 0.1)))
    b.add_sphere(
        (4.0, 1.0, 0.0), 1.0, b.metal((0.7, 0.6, 0.5), glossiness=1.0)
    )
    b.set_gradient_sky()
    cam = CameraSettings(
        origin=(13.0, 2.0, 3.0),
        look_at=(0.0, 0.0, 0.0),
        vertical_fov=20.0,
        aperture=0.1,
        focus_distance=10.0,
    )
    return b.build(), cam


def volume_test() -> tuple[Scene, CameraSettings]:
    """Probabilistic-volume scene (reference legacy 'Probabilistic Test')."""
    b = SceneBuilder()
    ground = b.lambert((0.6, 0.6, 0.6))
    fog = b.volume(1.5, (0.9, 0.9, 0.9))
    solid = b.lambert((0.8, 0.2, 0.2))
    b.add_sphere((0.0, -100.5, -1.0), 100.0, ground)
    b.add_sphere((0.0, 0.0, -1.0), 0.5, fog)
    b.add_sphere((1.2, 0.0, -1.0), 0.4, solid)
    b.set_gradient_sky()
    cam = CameraSettings(
        origin=(0.0, 0.0, 1.0),
        look_at=(0.0, 0.0, -1.0),
        vertical_fov=60.0,
        focus_distance=2.0,
    )
    return b.build(), cam


def cornell_box() -> tuple[Scene, CameraSettings]:
    """Rect/box showcase: an emissive-lit Cornell-style box."""
    b = SceneBuilder()
    red = b.lambert((0.65, 0.05, 0.05))
    green = b.lambert((0.12, 0.45, 0.15))
    white = b.lambert((0.73, 0.73, 0.73))
    light = b.emissive((15.0, 15.0, 15.0))

    s = 1.0  # half-size of the box interior
    b.add_rect((0, 0, -s), (2 * s, 2 * s), white)
    b.add_rect((-s, 0, 0), (2 * s, 2 * s), red,
               rotation=axis_angle_quat((0, 1, 0), 90.0))
    b.add_rect((s, 0, 0), (2 * s, 2 * s), green,
               rotation=axis_angle_quat((0, 1, 0), -90.0))
    b.add_rect((0, -s, 0), (2 * s, 2 * s), white,
               rotation=axis_angle_quat((1, 0, 0), -90.0))
    b.add_rect((0, s, 0), (2 * s, 2 * s), white,
               rotation=axis_angle_quat((1, 0, 0), 90.0))
    b.add_rect((0, s - 1e-3, 0), (0.7 * s, 0.7 * s), light,
               rotation=axis_angle_quat((1, 0, 0), 90.0))

    b.add_box((-0.35, -0.55, -0.3), (0.55, 0.9, 0.55), white,
              rotation=axis_angle_quat((0, 1, 0), 18.0))
    b.add_box((0.4, -0.75, 0.25), (0.5, 0.5, 0.5), white,
              rotation=axis_angle_quat((0, 1, 0), -15.0))
    b.set_no_sky()
    cam = CameraSettings(
        origin=(0.0, 0.0, 3.2),
        look_at=(0.0, 0.0, 0.0),
        vertical_fov=40.0,
        focus_distance=3.2,
    )
    return b.build(), cam


SCENES = {
    "single_sphere": single_sphere,
    "three_spheres": three_spheres,
    "cover": cover_scene,
    "cover_motion": lambda: cover_scene(motion_blur=True),
    "volume": volume_test,
    "cornell": cornell_box,
}
