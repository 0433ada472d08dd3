"""Mutual-information estimator tests.

Validates the analytic estimators against information-theoretic invariants
and the Monte-Carlo estimators against the analytic values — including the
reference's sign conventions (SURVEY.md §2: the MC accumulators for
I(X;Xhat) and I(X;Y) are the NEGATIVES of the information, while I(X,N;Xhat)
comes out positive)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qamreconciliation_jax import PAMAlphabet, NoiseMapper
from qamreconciliation_jax.models import mutual_information as mi


@pytest.fixture(scope="module")
def setup():
    pa = PAMAlphabet(2, 2.0)
    Es = pa.variance
    N0 = Es * 10 ** (-5.0 / 10) / 2  # 5 dB
    nm = NoiseMapper(pa, N0, dtype=jnp.float64)
    p_Xhat = mi.P_xhat(nm)
    return pa, nm, p_Xhat


def test_p_xhat_is_distribution(setup):
    pa, nm, p_Xhat = setup
    np.testing.assert_allclose(p_Xhat.sum(), 1.0, rtol=1e-12)
    assert (p_Xhat > 0).all()


def test_analytic_ordering(setup):
    """Softening shares more than the hard decision but no more than Y:
    I(X;Xhat) <= I(X,N;Xhat) <= I(X;Y) <= log2 M."""
    pa, nm, p_Xhat = setup
    i_xxh = mi.mutual_information_X_Xhat(nm, p_Xhat)
    i_base = mi.mutual_information_base_scheme(nm, p_Xhat)
    i_xy = mi.mutual_information_X_Y(nm)
    assert 0.0 < i_xxh <= i_base + 1e-9
    assert i_base <= i_xy + 1e-6
    assert i_xy <= pa.bit_per_symbol


def test_montecarlo_matches_analytic(setup):
    pa, nm, p_Xhat = setup
    i_xxh = mi.mutual_information_X_Xhat(nm, p_Xhat)
    i_base = mi.mutual_information_base_scheme(nm, p_Xhat)
    i_xy = mi.mutual_information_X_Y(nm)

    key = jax.random.key(0)
    acc = np.zeros(3)
    iters = 8
    for i in range(iters):
        res = mi.montecarlo_information(
            jax.random.fold_in(key, i), pa, nm, p_Xhat, 1 << 13
        )
        acc += np.asarray(res)
    acc /= iters

    # reference sign conventions: first two estimators are negated
    np.testing.assert_allclose(acc[0], -i_xxh, atol=0.02)
    np.testing.assert_allclose(acc[1], -i_xy, atol=0.02)
    np.testing.assert_allclose(acc[2], i_base, atol=0.02)


def test_which_mask(setup):
    pa, nm, p_Xhat = setup
    res = mi.montecarlo_information(
        jax.random.key(1), pa, nm, p_Xhat, 256, which=(False, True, False)
    )
    assert res[0] == 0.0 and res[2] == 0.0 and res[1] != 0.0


def test_high_snr_limits():
    pa = PAMAlphabet(2, 2.0)
    nm = NoiseMapper(pa, pa.variance * 1e-3, dtype=jnp.float64)
    p_Xhat = mi.P_xhat(nm)
    # noiseless limit: all MIs -> H(X) = 2 bits
    assert mi.mutual_information_X_Xhat(nm, p_Xhat) > 1.99
    assert mi.mutual_information_X_Y(nm) > 1.99
