"""The sampler flavors' tables and draws in the port against the JAX
package (core/noise.py, core/stbn.py, core/randomsource.py).

* `noise.make_blue_noise_tile` and both synthesized states
  (`randomsource.make_noise_state` for BLUE and SPATIO_TEMPORAL_BLUE) equal
  JAX's bit for bit; `r2_sequence` and `per_pixel_noise_offset` too.
* `pixel_uniforms`, `pixel_cosine`, `pixel_scalar`, `pixel_cosine_at` and
  `pixel_unitvec3` on a 48x32 image at draw indices 0-9 and 4095-4100
  (bounces 0 and 3), on both synthesized states and on a state holding
  all four sets (`chip_smoke.four_set_state`, the baked assets' shape):
  bit for bit against JAX run op by op (tolerance 0), and within 1e-6
  against JAX under jit, where XLA's CPU fusion contracts the rotation's
  multiply-add (measured: 4.8e-7 on pixel_uniforms, 0 on pixel_scalar).
* An asset root holding the STBN sets raises NotImplementedError naming
  step 14 (their decoding); without one the synthesized tiles apply.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from raytracing_in_one_weekend_tpu.core import noise as jax_noise
from raytracing_in_one_weekend_tpu.core import randomsource as jax_rs
from raytracing_in_one_weekend_tpu.utils.config import NoiseColor as JaxColor
from raytracing_in_one_weekend_tpu_torch.core import noise, randomsource, stbn
from raytracing_in_one_weekend_tpu_torch.utils.config import NoiseColor

W, H = 48, 32
DRAWS = list(range(10)) + list(range(4095, 4101))
JIT_TOL = 1e-6


def states(name):
    """(the port's state, JAX's) of a flavor: "blue", "stbn" or "four"."""
    if name == "four":
        state, arrays = chip_smoke.four_set_state()
        return state, jax_rs.NoiseState(*(jnp.asarray(a) for a in arrays))
    color = {"blue": 1, "stbn": 2}[name]
    return (randomsource.make_noise_state(NoiseColor(color), seed=7),
            jax_rs.make_noise_state(JaxColor(color), seed=7))


@pytest.mark.parametrize("seed", [7, 8])
def test_blue_noise_tile_matches_jax(seed):
    got = noise.make_blue_noise_tile(64, 4, seed)
    want = np.asarray(jax_noise.make_blue_noise_tile(64, 4, seed))
    assert got.dtype == np.float32 and got.shape == (64, 64, 4)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("name", ["blue", "stbn"])
def test_synthesized_states_match_jax(name):
    got, want = states(name)
    for field in ("tiles", "cosine", "scalar", "unitvec3"):
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None) == (w is None), field
        if g is not None:
            assert g.numpy().tobytes() == np.asarray(w).tobytes(), field
    assert got.tiles.shape == ((1, 64, 64, 4) if name == "blue"
                               else (8, 64, 64, 4))
    assert (got.scalar is not None) == (name == "blue")
    assert randomsource.make_noise_state(NoiseColor.WHITE) is None


def test_r2_and_offsets_match_jax():
    n = np.array([0, 1, 2, 3.5, 97.0, 4095.5, 8191, 123456], np.float32)
    got = noise.r2_sequence(torch.tensor(n)).numpy()
    assert got.tobytes() == np.asarray(jax_noise.r2_sequence(n)).tobytes()
    for size in (64, 128):
        got = noise.per_pixel_noise_offset(torch.tensor(n), size).numpy()
        want = np.asarray(jax_noise.per_pixel_noise_offset(n, size))
        np.testing.assert_array_equal(got, want)


def _draws(mod, state, draw):
    """Every draw function's output at `draw` (None where the state has
    no set for it), keyed by name."""
    out = {
        "uniforms": mod.pixel_uniforms(state, draw, W, H),
        "cosine": mod.pixel_cosine(state, draw, W, H),
    }
    for bounce in (0, 3):
        out[f"scalar{bounce}"] = mod.pixel_scalar(state, draw, bounce, 2, W,
                                                  H)
        out[f"cosine_at{bounce}"] = mod.pixel_cosine_at(state, draw, bounce,
                                                        W, H)
        out[f"unitvec3{bounce}"] = mod.pixel_unitvec3(state, draw, bounce,
                                                      W, H)
    return out


@pytest.mark.parametrize("name", ["blue", "stbn", "four"])
def test_pixel_draws_match_jax(name):
    got_state, want_state = states(name)
    present = set()
    for draw in DRAWS:
        got = _draws(randomsource, got_state, draw)
        want = _draws(jax_rs, want_state, draw)
        for k, g in got.items():
            assert (g is None) == (want[k] is None), k
            if g is None:
                continue
            present.add(k)
            np.testing.assert_array_equal(g.numpy(), np.asarray(want[k]),
                                          err_msg=f"{k} at draw {draw}")
    expected = {"blue": 3, "stbn": 1, "four": 8}[name]
    assert len(present) == expected, present
    # a per-pixel draw index (the pre-drawn rows' progressive counters)
    counts = np.random.default_rng(1).integers(0, 5000, W * H)
    counts = counts.astype(np.int32)
    got = randomsource.pixel_uniforms(got_state, torch.tensor(counts), W, H)
    want = jax_rs.pixel_uniforms(want_state, jnp.asarray(counts), W, H)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["blue", "four"])
def test_pixel_draws_match_jax_under_jit(name):
    got_state, want_state = states(name)
    uniforms = jax.jit(lambda s, d: jax_rs.pixel_uniforms(s, d, W, H))
    scalar = jax.jit(lambda s, d: jax_rs.pixel_scalar(s, d, 2, 3, W, H))
    for draw in DRAWS:
        g = randomsource.pixel_uniforms(got_state, draw, W, H).numpy()
        np.testing.assert_allclose(g, np.asarray(uniforms(want_state, draw)),
                                   rtol=0, atol=JIT_TOL)
        g = randomsource.pixel_scalar(got_state, draw, 2, 3, W, H).numpy()
        np.testing.assert_allclose(g, np.asarray(scalar(want_state, draw)),
                                   rtol=0, atol=JIT_TOL)


def test_asset_root_with_stbn_sets_raises(tmp_path, monkeypatch):
    monkeypatch.delenv(stbn.ASSET_ROOT_ENV, raising=False)
    assert stbn.find_asset_root() is None
    monkeypatch.setenv(stbn.ASSET_ROOT_ENV, str(tmp_path))
    assert stbn.find_asset_root() is None  # no STBN folder there
    (tmp_path / stbn.STBN_DIR).mkdir(parents=True)
    assert stbn.find_asset_root() == str(tmp_path)
    for color in (NoiseColor.BLUE, NoiseColor.SPATIO_TEMPORAL_BLUE):
        with pytest.raises(NotImplementedError, match="step 14"):
            randomsource.make_noise_state(color)
    assert randomsource.make_noise_state(NoiseColor.WHITE) is None
