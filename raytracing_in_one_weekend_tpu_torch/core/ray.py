"""Ray bundles (counterpart of the JAX package's core/ray.py).

Reference: Runtime/Ray.cs:5-21 — origin/direction/time, `GetPoint`, and the
0.001-normal self-intersection offset (`OffsetTowards`, Ray.cs:19).  A
"ray" here is a whole wavefront: origins (N, 3), directions (N, 3), times
(N,).
"""

from __future__ import annotations

import dataclasses

import torch

from raytracing_in_one_weekend_tpu_torch.utils.tensors import TensorGroup

SELF_INTERSECTION_OFFSET = 1e-3  # reference: Ray.cs:19


@dataclasses.dataclass(frozen=True)
class Rays(TensorGroup):
    origin: torch.Tensor  # (N, 3)
    direction: torch.Tensor  # (N, 3), normalized
    time: torch.Tensor  # (N,)

    def at(self, t: torch.Tensor) -> torch.Tensor:
        """Point along each ray (reference: Ray.cs GetPoint)."""
        return self.origin + t[..., None] * self.direction

    def offset_towards(self, normal: torch.Tensor) -> "Rays":
        """Epsilon-offset origins along `normal` (Ray.cs:19)."""
        return Rays(
            origin=self.origin + SELF_INTERSECTION_OFFSET * normal,
            direction=self.direction,
            time=self.time,
        )
