"""core/rng.py against jax.random, bit for bit (this JAX's defaults:
jax_threefry_partitionable=True, threefry2x32)."""

import jax
import numpy as np
import pytest

from raytracing_in_one_weekend_tpu.core import rng as jax_rng
from raytracing_in_one_weekend_tpu_torch.core import rng

SEEDS = (0, 1, 42, 2**31 - 1)


def words(key):
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_fold_in(seed):
    jk, pk = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    np.testing.assert_array_equal(pk.numpy(), words(jk))
    for data in (0, 1, 63, 2**31 - 1, rng.Purpose.SAMPLE * 131071 + 63):
        np.testing.assert_array_equal(rng.fold_in(pk, data).numpy(),
                                      words(jax.random.fold_in(jk, data)))
    np.testing.assert_array_equal(rng.split(pk, 3).numpy(),
                                  words(jax.random.split(jk, 3)))


@pytest.mark.parametrize("seed", SEEDS)
def test_discipline_keys(seed):
    jk, pk = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    for sample in (0, 63):
        js, ps = jax_rng.sample_key(jk, sample), rng.sample_key(pk, sample)
        np.testing.assert_array_equal(ps.numpy(), words(js))
        for bounce in (0, 7):
            jb, pb = jax_rng.bounce_key(js, bounce), rng.bounce_key(ps,
                                                                    bounce)
            np.testing.assert_array_equal(pb.numpy(), words(jb))
            for purpose in rng.Purpose:
                np.testing.assert_array_equal(
                    rng.purpose_key(pb, purpose).numpy(),
                    words(jax_rng.purpose_key(jb, jax_rng.Purpose(
                        int(purpose)))))
    np.testing.assert_array_equal(rng.batch_key(pk, 5).numpy(),
                                  words(jax_rng.batch_key(jk, 5)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(), (37,), (6, 37), (37, 2)])
def test_uniform_bits_equal(seed, shape):
    jk, pk = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    want = np.asarray(jax.random.uniform(jk, shape))
    got = rng.uniform(pk, shape).numpy()
    assert got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_range_bits_equal(seed):
    jk, pk = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    for lo, hi in ((-0.3, 2.7), (1.0, 1.5), (-4.0, -1.0)):
        want = np.asarray(jax.random.uniform(jk, (301,), minval=lo,
                                             maxval=hi))
        got = rng.uniform(pk, (301,), lo, hi).numpy()
        assert got.tobytes() == want.tobytes(), (lo, hi)


def test_randint_equal():
    base = rng.PRNGKey(9)
    jbase = jax.random.PRNGKey(9)
    for i in range(200):
        pk, jk = rng.fold_in(base, i), jax.random.fold_in(jbase, i)
        assert int(rng.randint(pk, (), 0, 2**31 - 1)) == int(
            jax.random.randint(jk, (), 0, 2**31 - 1))
    for seed in SEEDS:
        got = rng.randint(rng.PRNGKey(seed), (5, 3), -7, 1000).numpy()
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed),
                                             (5, 3), -7, 1000))
        np.testing.assert_array_equal(got, want)
