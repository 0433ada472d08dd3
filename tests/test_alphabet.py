import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qamreconciliation_jax import PAMAlphabet


def test_uniform_constellation_geometry():
    pa = PAMAlphabet(2, 2.0)
    assert pa.order == 4
    np.testing.assert_allclose(pa.constellation, [-3.0, -1.0, 1.0, 3.0])
    # interior thresholds are midpoints, sentinels at 100x the edges
    # (reference: qamreconciliation/alphabet.pyx:69-73)
    np.testing.assert_allclose(pa.thresholds[1:4], [-2.0, 0.0, 2.0])
    assert pa.thresholds[0] == -300.0
    assert pa.thresholds[-1] == 300.0
    # uniform M-PAM energy: step^2 (M^2 - 1) / 12
    np.testing.assert_allclose(pa.variance, 4.0 * 15 / 12)


def test_probability_validation():
    with pytest.raises(ValueError):
        PAMAlphabet(0, 2.0)
    with pytest.raises(ValueError):
        PAMAlphabet(2, 2.0, probabilities=[0.5, 0.5])
    with pytest.raises(ValueError):
        PAMAlphabet(2, 2.0, probabilities=[0.5, 0.5, 0.25, -0.25])
    with pytest.raises(ValueError):
        PAMAlphabet(2, 2.0, probabilities=[0.5, 0.3, 0.1, 0.2])  # sums to 1.1


def test_shaped_variance():
    p = np.array([0.4, 0.1, 0.1, 0.4])
    pa = PAMAlphabet(2, 2.0, probabilities=p)
    np.testing.assert_allclose(pa.variance, np.sum(p * pa.constellation**2))


def test_random_symbols_distribution():
    p = np.array([0.55, 0.2, 0.15, 0.1])
    pa = PAMAlphabet(2, 2.0, probabilities=p)
    key = jax.random.key(0)
    x = np.asarray(pa.random_symbols(key, 200_000))
    freq = np.bincount(x, minlength=4) / x.size
    np.testing.assert_allclose(freq, p, atol=5e-3)
    assert x.min() >= 0 and x.max() <= 3


def test_index_to_value_and_bits_batched():
    pa = PAMAlphabet(2, 2.0)
    idx = jnp.array([[0, 3], [2, 1]])
    vals = np.asarray(pa.index_to_value(idx))
    np.testing.assert_allclose(vals, [[-3.0, 3.0], [1.0, -1.0]])
    bits = np.asarray(pa.demap_symbols_to_bits(idx))
    # Gray: 0->00, 3->01, 2->11, 1->10 (bit k = column k)
    np.testing.assert_array_equal(bits, [[0, 0, 0, 1], [1, 1, 1, 0]])
