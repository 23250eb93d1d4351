"""The noise arm beside the texture and cube arms (ROADMAP step 11b): the
port's plain version with BLUE tables against the JAX kernel in interpret
mode, through tests/test_torch_noise_beside.py's harness (its docstring
says how lanes are held).

* `checkered` (the texture build: checker albedos) at 64x16: the white
  texture test's bounds (tests/test_torch_texture.py: 0.999 of lanes, the
  floats on 0.99 of the agreeing ones) with the flavored sphere build's
  0.999 of lanes.  Measured: every lane, the largest float gap 6.4e-6.
* `cubemap` (the cube build beside spheres) at 64x16: the white cube
  test's bounds (tests/test_torch_cubemap.py: 0.999 of lanes, the normals
  on 0.99 of the agreeing ones, the other floats on all).  Measured: every
  lane, the largest float gap 3.3e-5 (a normal).
"""

from test_torch_noise_beside import check, registered, run_both
from test_torch_noise_beside import _one_torch_thread  # noqa: F401


def test_texture_build_on_tables_matches_jax():
    js, ts, cs = registered("checkered")
    got, want, white = run_both(js, ts, cs, "tables", 64, 16)
    check(got, want, white, 0.999, float_share=0.99)


def test_cube_build_on_tables_matches_jax():
    js, ts, cs = registered("cubemap")
    got, want, white = run_both(js, ts, cs, "tables", 64, 16)
    check(got, want, white, 0.999, normal_share=0.99)
