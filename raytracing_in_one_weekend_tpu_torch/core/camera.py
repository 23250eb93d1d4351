"""Thin-lens camera (counterpart of the JAX package's core/camera.py).

Reference: Runtime/View.cs:6-49.  The batch kernel (ops/megatrace.py)
generates its own camera rays; `pixel_coords` and `generate_rays` make
the wavefront integrator's, from threefry keys (core/rng.py), as the JAX
package does.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from raytracing_in_one_weekend_tpu_torch.core import math3, rng, sampling
from raytracing_in_one_weekend_tpu_torch.core.ray import Rays
from raytracing_in_one_weekend_tpu_torch.utils.tensors import TensorGroup


@dataclasses.dataclass(frozen=True)
class Camera(TensorGroup):
    origin: torch.Tensor  # (3,)
    lower_left_corner: torch.Tensor  # (3,)
    horizontal: torch.Tensor  # (3,)
    vertical: torch.Tensor  # (3,)
    forward: torch.Tensor  # (3,)
    up: torch.Tensor  # (3,)
    right: torch.Tensor  # (3,)
    lens_radius: torch.Tensor  # ()


def make_camera(
    origin,
    look_at,
    up,
    vertical_fov_degrees,
    aspect,
    aperture=0.0,
    focus_distance=None,
    device: torch.device | str = "cpu",
) -> Camera:
    """Build the view basis (reference: View.cs:16-36), in float32.

    Right-handed Shirley basis u = up x w, v = w x u, which keeps world +x
    on the image's right for the canonical book camera."""
    f32 = dict(dtype=torch.float32, device=device)
    origin = torch.as_tensor(origin, **f32)
    look_at = torch.as_tensor(look_at, **f32)
    up = torch.as_tensor(up, **f32)

    if focus_distance is None:
        focus_distance = math3.length(origin - look_at)
    focus_distance = torch.as_tensor(focus_distance, **f32)

    theta = torch.as_tensor(vertical_fov_degrees, **f32) * math.pi / 180.0
    half_height = torch.tan(theta / 2.0)
    half_width = aspect * half_height

    forward = math3.normalize(origin - look_at)
    right = math3.normalize(torch.linalg.cross(up, forward))
    cam_up = torch.linalg.cross(forward, right)

    lower_left = (
        half_width * focus_distance * -right
        + half_height * focus_distance * -cam_up
        + focus_distance * -forward
    )
    return Camera(
        origin=origin,
        lower_left_corner=lower_left,
        horizontal=2.0 * half_width * focus_distance * right,
        vertical=2.0 * half_height * focus_distance * cam_up,
        forward=forward,
        up=cam_up,
        right=right,
        lens_radius=torch.as_tensor(aperture, **f32) / 2.0,
    )


def generate_rays(
    camera: Camera,
    normalized_coords: torch.Tensor,
    key: torch.Tensor,
    lens_uv: torch.Tensor | None = None,
) -> Rays:
    """Primary rays for normalized pixel coords (N, 2) in [0,1)^2
    (View.cs:38-48 GetRay): a lens-disk defocus offset on the camera's
    right/up axes from the LENS stream (or from `lens_uv`, (N, 2) disk
    uniforms of a sampler flavor, RandomSource.cs InUnitDisk), a shutter
    time from the TIME stream."""
    n = normalized_coords.shape[0]
    dev = normalized_coords.device
    if lens_uv is not None:
        u1, u2 = lens_uv[:, 0], lens_uv[:, 1]
    else:
        u1, u2 = rng.uniform(rng.purpose_key(key, rng.Purpose.LENS), (2, n),
                             device=dev)
    disk = sampling.in_unit_disk(u1, u2)
    rd = camera.lens_radius * disk
    offset = rd[:, 0:1] * camera.right + rd[:, 1:2] * camera.up
    direction = (
        camera.lower_left_corner
        - offset
        + normalized_coords[:, 0:1] * camera.horizontal
        + normalized_coords[:, 1:2] * camera.vertical
    )
    time = rng.uniform(rng.purpose_key(key, rng.Purpose.TIME), (n,),
                       device=dev)
    return Rays(
        origin=camera.origin + offset,
        direction=math3.normalize(direction),
        time=time,
    )


def pixel_coords(
    width: int,
    height: int,
    key: torch.Tensor | None,
    sub_pixel_jitter: bool,
    device: torch.device | str = "cpu",
    jitter_uv: torch.Tensor | None = None,
) -> torch.Tensor:
    """Normalized sample coordinates of the full pixel grid, row-major
    (N, 2) with N = width * height: (coords + jitter, or 0.5) / size
    (SampleBatchJob.cs:134), jitter from `jitter_uv` ((N, 2) uniforms of a
    sampler flavor) or the PIXEL_JITTER stream."""
    xs = torch.arange(width, dtype=torch.float32, device=device)
    ys = torch.arange(height, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")  # (H, W)
    coords = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)
    if sub_pixel_jitter and jitter_uv is not None:
        jitter = jitter_uv
    elif sub_pixel_jitter and key is not None:
        jitter = rng.uniform(
            rng.purpose_key(key, rng.Purpose.PIXEL_JITTER), coords.shape,
            device=device,
        )
    else:
        jitter = 0.5
    size = torch.tensor([width, height], dtype=torch.float32, device=device)
    return (coords + jitter) / size
