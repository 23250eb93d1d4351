"""Baked blue-noise assets: where they are and the type of their tables
(counterpart of the JAX package's core/stbn.py, as far as
`randomsource.make_noise_state` needs it).

The reference ships the five NVIDIA spatio-temporal blue-noise sets
(128x128x64 PNGs under `Textures/BlueNoise/SpatioTemporalBlueNoise`,
decoded at Runtime/SpatioTemporalBlueNoise.cs:57-78) and HDR blue-noise
EXRs (`Textures/BlueNoise/BlueNoise`).  Decoding them needs the image
readers of ROADMAP queue 1, step 14, which the port does not have yet: an
asset root that holds the sets raises NotImplementedError naming that
step, so that no render quietly takes the synthesized tiles in place of
assets it was given.  Without an asset root the sampler flavors use the
synthesized tiles, as the JAX package does.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np

STBN_DIR = "Textures/BlueNoise/SpatioTemporalBlueNoise"
ASSET_ROOT_ENV = "RTIW_ASSET_ROOT"  # the reference checkout's Assets folder
DECODE_STEP = ("decoding the baked blue-noise sets (image readers, ROADMAP "
               "queue 1, step 14)")


def find_asset_root() -> Optional[str]:
    """The asset root named by $RTIW_ASSET_ROOT when it holds the STBN
    sets, else None (the synthesized tiles apply)."""
    root = os.environ.get(ASSET_ROOT_ENV)
    if root and os.path.isdir(os.path.join(root, STBN_DIR)):
        return root
    return None


class StbnTables(NamedTuple):
    """Decoded STBN sets, slice-major, in the reference's value ranges
    (SpatioTemporalBlueNoise.cs:57-78)."""

    scalar: np.ndarray  # (T, 128, 128) float32 in [0, 1)
    vec2: np.ndarray  # (T, 128, 128, 2) float32 in [0, 1)
    unitvec2: np.ndarray  # (T, 128, 128, 2) float32, ~unit circle
    unitvec3: np.ndarray  # (T, 128, 128, 3) float32, ~unit sphere
    cosine: np.ndarray  # (T, 128, 128, 3) float32 tangent-space (y-up)
    #   cosine-weighted hemisphere directions
