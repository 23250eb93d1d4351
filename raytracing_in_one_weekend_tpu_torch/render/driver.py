"""Progressive render driver (counterpart of the JAX package's
render/driver.py).

Reference: the Raytracer MonoBehaviour driver (Unity/Raytracer.cs:73-1508):
its Update() loop drains batches, tracks MRays/s, decides completion and
schedules the next SampleBatchJob, cycling the interlace offset and
feeding the previous batch's noise-weight extrema to the adaptive sampler.

Ported: reset, step, run, completion, MRays/s, combined (no denoise),
images and save, autofocus (the given distance or a nearest-hit raycast)
and the sampler flavors (`settings.noise_color`: the noise state made
with seed + 7, each batch's draws keyed by batch_index * max_lanes), on
every scene `renderer.check_scope` takes (meshes up to TRI_STREAM_MAX
triangles).  Checkpoints, diagnostics, denoisers and the
BVH wait for ROADMAP queue 1, steps 9, 13 and 14.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from raytracing_in_one_weekend_tpu_torch.core import camera as camera_mod
from raytracing_in_one_weekend_tpu_torch.core import math3, randomsource
from raytracing_in_one_weekend_tpu_torch.core.ray import Rays
from raytracing_in_one_weekend_tpu_torch.ops import intersect
from raytracing_in_one_weekend_tpu_torch.render import film, renderer
from raytracing_in_one_weekend_tpu_torch.scene.scene import Scene
from raytracing_in_one_weekend_tpu_torch.utils import image as image_util
from raytracing_in_one_weekend_tpu_torch.utils import ordering
from raytracing_in_one_weekend_tpu_torch.utils.config import (
    CameraSettings,
    DenoiseMode,
    RenderSettings,
)


def autofocus(scene: Scene, cs: CameraSettings) -> float:
    """Focus distance via a nearest-hit raycast along the camera's forward
    ray (Raytracer.cs:608-612, HitWorld on the view ray); |look_at -
    origin| on a miss, and the settings' distance when they give one."""
    if cs.focus_distance is not None:
        return float(cs.focus_distance)
    f32 = dict(dtype=torch.float32, device=scene.spheres.center.device)
    origin = torch.tensor([cs.origin], **f32)
    fwd = torch.tensor([cs.look_at], **f32) - origin
    hit = intersect.nearest_hit(
        scene, Rays(origin, math3.normalize(fwd), torch.zeros(1, **f32))
    )
    t = float(hit.t[0])
    fallback = float(torch.linalg.norm(fwd[0]))
    return t if (bool(hit.hit[0]) and t < intersect.BIG) else fallback


@dataclasses.dataclass
class BatchStats:
    """Host-side per-batch metrics (Raytracer.cs:106-120 live fields)."""

    batch_index: int
    rays: int
    duration_s: float
    mrays_per_second: float
    min_samples: float
    max_samples: float


class ProgressiveRenderer:
    """Progressive accumulation driver with adaptive sampling, interlacing
    and metrics, on an explicit `device`."""

    def __init__(
        self,
        scene: Scene,
        camera_settings: CameraSettings,
        settings: RenderSettings,
        seed: int = 0,
        *,
        device: torch.device | str,
    ):
        if settings.denoise_mode != DenoiseMode.NONE:
            raise NotImplementedError(
                "denoisers are not ported yet (ROADMAP queue 1, step 13)"
            )
        renderer.check_scope(scene)
        self.device = torch.device(device)
        self.scene = scene.to(self.device)
        self.settings = settings
        self.camera_settings = camera_settings
        self.seed = seed
        self.focus_distance = autofocus(scene, camera_settings)
        self.camera = camera_mod.make_camera(
            camera_settings.origin,
            camera_settings.look_at,
            camera_settings.up,
            camera_settings.vertical_fov,
            settings.width / settings.height,
            aperture=camera_settings.aperture,
            focus_distance=self.focus_distance,
            device=self.device,
        )
        self._interlace_order = ordering.space_filling_series(
            settings.interlacing
        )
        # the sampler flavor's tables (RandomSource NoiseColor; None: white)
        self.noise_state = randomsource.make_noise_state(
            settings.noise_color, seed=seed + 7, device=self.device
        )
        self.reset()

    # --- progressive state -------------------------------------------------

    def reset(self) -> None:
        """Restart the trace (reference invalidation, Raytracer.cs:482-516)."""
        s = self.settings
        self.acc = film.zero_accumulators(s.pixel_count, device=self.device)
        self.batch_index = 0
        self.generator = torch.Generator().manual_seed(self.seed)
        self.weight_extrema = torch.zeros(
            2, dtype=torch.float32, device=self.device
        )
        self.history: list[BatchStats] = []
        # Dispatched samples per interlace slice: completion is judged on
        # dispatched (not valid) counts so pixels whose samples always
        # fail cannot stall the trace (Raytracer.cs:537-538).
        self._dispatched = [0] * max(s.interlacing, 1)

    @property
    def min_samples_per_pixel(self) -> float:
        """Valid samples of the slowest pixel (Raytracer.cs:537)."""
        if self.batch_index == 0:
            return 0.0
        return self.history[-1].min_samples

    @property
    def dispatched_samples_per_pixel(self) -> int:
        return min(self._dispatched)

    @property
    def complete(self) -> bool:
        return (
            self.dispatched_samples_per_pixel
            >= self.settings.samples_per_pixel
        )

    @property
    def avg_mrays_per_second(self) -> float:
        if not self.history:
            return 0.0
        rays = sum(b.rays for b in self.history)
        secs = sum(b.duration_s for b in self.history)
        return rays / max(secs, 1e-9) / 1e6

    # --- stepping ------------------------------------------------------------

    def step(self) -> BatchStats:
        """Render one progressive batch (ScheduleSample analog).  The
        duration ends when the batch's ray count reaches the host, which
        waits for the device."""
        s = self.settings
        slice_offset = self._interlace_order[
            self.batch_index % max(s.interlacing, 1)
        ]
        if s.adaptive_sampling:
            sample_range = s.samples_per_batch_range
            max_lanes = s.samples_per_batch_range[1]
            extrema = self.weight_extrema
        else:
            sample_range = None
            max_lanes = s.samples_per_batch_range[0]
            extrema = None

        t0 = time.perf_counter()
        _, metrics = renderer.render_batch(
            self.scene,
            self.camera,
            self.acc,
            self.generator,
            width=s.width,
            height=s.height,
            samples=max_lanes,
            trace_depth=s.trace_depth,
            sub_pixel_jitter=s.sub_pixel_jitter,
            interlace=(slice_offset, max(s.interlacing, 1)),
            sample_range=sample_range,
            weight_extrema=extrema,
            noise_color=int(s.noise_color),
            noise_state=self.noise_state,
            draw_base=self.batch_index * max_lanes,
        )
        rays = int(metrics.total_rays)
        duration = time.perf_counter() - t0
        self.weight_extrema = torch.stack(
            [metrics.weight_min, metrics.weight_max]
        )
        stats = BatchStats(
            batch_index=self.batch_index,
            rays=rays,
            duration_s=duration,
            mrays_per_second=rays / max(duration, 1e-9) / 1e6,
            min_samples=float(metrics.min_sample_count),
            max_samples=float(metrics.max_sample_count),
        )
        self.history.append(stats)
        self._dispatched[slice_offset] += (
            s.samples_per_batch_range[0] if s.adaptive_sampling else max_lanes
        )
        self.batch_index += 1
        return stats

    def run(
        self,
        max_duration_seconds: float | None = None,
        on_batch: Callable[[BatchStats], None] | None = None,
    ) -> None:
        """Trace to completion (Raytracer.cs:96-100,518-550)."""
        start = time.perf_counter()
        while not self.complete:
            stats = self.step()
            if on_batch is not None:
                on_batch(stats)
            if (
                max_duration_seconds is not None
                and time.perf_counter() - start >= max_duration_seconds
            ):
                break

    # --- outputs ---------------------------------------------------------------

    def combined(self, debug_mode: bool = False) -> film.CombinedImage:
        s = self.settings
        return film.combine(
            self.acc, s.width, s.height,
            debug_mode=debug_mode, interlacing=s.interlacing,
        )

    def images(self, tonemap: str = "gamma") -> dict[str, torch.Tensor]:
        s = self.settings
        return film.finalize(self.combined(), s.width, s.height, tonemap)

    def save(self, path: str, channel: str = "color") -> None:
        """PNG save (Raytracer.Editor.cs:22-28)."""
        image_util.write_png(path, self.images()[channel].cpu().numpy())
