"""The noise arm beside every arm of the sphere kernel at once (ROADMAP
step 11b): `final_book2` (rects, boxes, convex volumes, moving spheres,
checker, Perlin and image albedos) through the port's plain version with
BLUE tables against the JAX kernel in interpret mode, by
tests/test_torch_noise_beside.py's harness (its docstring says how lanes
are held; a file of its own, since JAX's interpret-mode Perlin takes
about a minute).
"""

from test_torch_noise_beside import check, registered, run_both
from test_torch_noise_beside import _one_torch_thread  # noqa: F401


def test_every_arm_on_tables_matches_jax():
    """final_book2 (rects, boxes, convex volumes, moving spheres, checker,
    Perlin and image albedos) at 64x16 with BLUE tables: held to the
    white texture test's float bound (0.99 of the agreeing lanes,
    tests/test_torch_texture.py: a marble sin or a texel edge a few ulps
    off) with >= 0.999 of lanes agreeing.  Measured: every lane, the
    largest float gap 2.7e-5."""
    js, ts, cs = registered("final_book2")
    got, want, white = run_both(js, ts, cs, "tables", 64, 16)
    check(got, want, white, 0.999, float_share=0.99)
