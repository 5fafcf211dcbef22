"""The port's threefry (``repro_torch.prng``) against ``jax.random``.

Uniform draws, fold_in and split are integer hashing plus one exact
float mapping, so they must be bitwise equal. ``normal`` goes through
``erfinv``, whose float32 implementations differ between the two
frameworks by a few ulps: rtol 1e-5.
"""
import jax
import numpy as np
import pytest

from repro_torch import prng


@pytest.mark.parametrize("seed", [0, 1, 12345])
@pytest.mark.parametrize("t", [0, 3, 77])
def test_uniform_after_fold_in_bitwise(seed, t):
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), t)
    tkey = prng.fold_in(prng.PRNGKey(seed), t)
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(jkey)),
                                  tkey.numpy())
    for n in (1, 3590, 4099):
        for minval in (0.0, 1e-12):
            j = np.asarray(jax.random.uniform(jkey, (n,), minval=minval,
                                              maxval=1.0))
            p = prng.uniform(tkey, (n,), minval=minval, maxval=1.0).numpy()
            np.testing.assert_array_equal(p.view(np.uint32),
                                          j.view(np.uint32))


def test_uniform_shape_and_range():
    u = prng.uniform(prng.PRNGKey(4), (3, 5), minval=1e-12)
    assert u.shape == (3, 5)
    assert float(u.min()) >= 1e-12 and float(u.max()) < 1.0


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_split_bitwise(seed):
    jk = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(jk)),
                                  prng.PRNGKey(seed).numpy())
    for num in (2, 5):
        j = np.asarray(jax.random.key_data(jax.random.split(jk, num)))
        np.testing.assert_array_equal(
            prng.split(prng.PRNGKey(seed), num).numpy(), j)


@pytest.mark.parametrize("seed", [0, 3])
def test_normal_close(seed):
    shape = (60, 128)
    j = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    p = prng.normal(prng.PRNGKey(seed), shape).numpy()
    np.testing.assert_allclose(p, j, rtol=1e-5, atol=0)
