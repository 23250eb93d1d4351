"""Sky sampling (counterpart of the JAX package's core/environment.py).

Reference: Environment.cs:5-18 with the gradient evaluated at
SampleBatchJob.cs:352-354.  The gradient and no-sky cases are ported; the
HDR cubemap waits for ROADMAP queue 1, step 7.6.
"""

from __future__ import annotations

import torch

from raytracing_in_one_weekend_tpu_torch.scene.scene import SkyType


def sample_sky(env, direction: torch.Tensor) -> torch.Tensor:
    """Radiance from the sky along (N, 3) unit directions:
    lerp(bottom, top, 0.5 * (dir.y + 1)) for the gradient, black for
    none."""
    if env.cubemap is not None:
        raise NotImplementedError(
            "cubemap skies are not ported yet (ROADMAP queue 1, step 7.6)"
        )
    t = 0.5 * (direction[..., 1] + 1.0)
    gradient = env.sky_bottom + (env.sky_top - env.sky_bottom) * t[..., None]
    return torch.where(env.sky_type == SkyType.GRADIENT, gradient,
                       torch.zeros_like(gradient))
