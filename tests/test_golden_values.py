"""First-principles golden values for the softening chain.

Every other parity tier in this repo checks implementations against each
other (jax NoiseMapper vs numpy oracle vs C++ decoder) — a shared
misreading of the reference formulation
(reference: qamreconciliation/noisemapper.pyx:450-559) would survive all of
them.  This module pins the chain to values computed HERE, by hand, from
the paper's formulas alone ("Soft information reconciliation with
non-binary-output channels", the reference's CITATION.cff subject), using
nothing but ``math.erf``-level primitives and a bisection:

Formulation (paper §"softening", for a PAM alphabet c_0 < ... < c_{M-1}
with priors p_k over an AWGN channel of variance sigma^2):

  F_Y(y)      = sum_k p_k * Phi((y - c_k) / sigma)        (marginal CDF)
  region i    : t_i <= y < t_{i+1} with interior thresholds at the
                decision boundaries (midpoints for uniform PAM)
  softening   : n = g(y, i) = (F_Y(y) - F_Y(t_i)) / dF_i,
                dF_i = F_Y(t_{i+1}) - F_Y(t_i)            (uniform on [0,1])
                flipped regions (sign_config[i] = 1) use
                n = (F_Y(t_{i+1}) - F_Y(y)) / dF_i
  inverse     : y_j(n) = F_Y^{-1}(F_Y(t_j) + n * dF_j)    (resp. flipped)
  reverse-reconciliation LLR for Alice holding x, observing n — Bob's
  decision J is the unknown:
      P(J = j | n, x) ∝ f_{Y|X=x}(y_j(n)) * |dy_j/dn|
                      = f_{Y|X=x}(y_j(n)) * dF_j / f_Y(y_j(n))
      LLR_b(n, x) = log [ sum_{j: bit_b(j)=0} P(j | n, x)
                        / sum_{j: bit_b(j)=1} P(j | n, x) ]
  with f_{Y|X=x}(y) the N(x, sigma^2) density, f_Y its p-mixture, and
  bit_b(j) the Gray label of region j.

Asserted against all internal oracles on the SAME hand-picked samples:
the jax NoiseMapper (map_noise + demap_lappr_array in its four modes)
and the numpy softening chain (utils/reference_np.softening_chain_np).
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp

from qamreconciliation_jax.models.alphabet import PAMAlphabet
from qamreconciliation_jax.models.noisemapper import NoiseMapper
from qamreconciliation_jax.utils.reference_np import softening_chain_np


# ----------------------------------------------------------------- hand math
# Only math.erf, math.exp, math.log and a bisection: no repo helpers, no
# vectorized shortcuts that could share a bug with the implementations.

SQRT2 = math.sqrt(2.0)


def phi_cdf(y, mu, sigma):
    """Gaussian CDF Phi((y - mu)/sigma), scalar."""
    return 0.5 * (1.0 + math.erf((y - mu) / (sigma * SQRT2)))


def gauss_pdf(y, mu, sigma):
    return math.exp(-((y - mu) ** 2) / (2.0 * sigma * sigma)) / (
        sigma * math.sqrt(2.0 * math.pi)
    )


def f_y_cdf(y, c, p, sigma):
    return sum(pk * phi_cdf(y, ck, sigma) for ck, pk in zip(c, p))


def f_y_pdf(y, c, p, sigma):
    return sum(pk * gauss_pdf(y, ck, sigma) for ck, pk in zip(c, p))


def f_y_inv(u, c, p, sigma, lo=-60.0, hi=60.0, steps=200):
    """F_Y^{-1}(u) by plain bisection (monotone CDF; 200 halvings of a
    120-wide bracket resolve y to ~1e-34, far past float64)."""
    for _ in range(steps):
        mid = 0.5 * (lo + hi)
        if f_y_cdf(mid, c, p, sigma) < u:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def hand_soften(y, i, c, p, sigma, thr, signs):
    """n = g(y, region i) from the paper's formula, scalar."""
    F_lo = f_y_cdf(thr[i], c, p, sigma) if i > 0 else 0.0
    F_hi = f_y_cdf(thr[i + 1], c, p, sigma) if i + 1 < len(c) else 1.0
    dF = F_hi - F_lo
    F = f_y_cdf(y, c, p, sigma)
    return (F_hi - F) / dF if signs[i] else (F - F_lo) / dF


def hand_region(y, thr_interior):
    return sum(1 for t in thr_interior if y >= t)


def hand_llrs(n, x_idx, c, p, sigma, thr, signs, s_to_b):
    """Per-bit reverse-reconciliation LLRs from the paper's formula, scalar.

    Returns [bps] floats for Alice's symbol index ``x_idx`` and softening
    value ``n``.
    """
    M = len(c)
    bps = len(s_to_b[0])
    # region CDF bounds
    F_b = [0.0] + [f_y_cdf(t, c, p, sigma) for t in thr[1:M]] + [1.0]
    w = []
    for j in range(M):
        dF = F_b[j + 1] - F_b[j]
        u = (F_b[j + 1] - n * dF) if signs[j] else (F_b[j] + n * dF)
        yj = f_y_inv(u, c, p, sigma)
        w.append(
            gauss_pdf(yj, c[x_idx], sigma) * dF / f_y_pdf(yj, c, p, sigma)
        )
    llrs = []
    for b in range(bps):
        num = sum(w[j] for j in range(M) if s_to_b[j][b] == 0)
        den = sum(w[j] for j in range(M) if s_to_b[j][b] == 1)
        llrs.append(math.log(num) - math.log(den))
    return llrs


# ------------------------------------------------------------------- cases

CASES = [
    # (bps, noise_var, sign_config, y samples, alice x indices)
    (1, 0.64, None, [0.5, -1.7, 0.05], [1, 0, 0]),
    (2, 0.36, None, [0.5, -2.9, 2.2], [2, 0, 3]),
    (2, 0.36, [1, 0, 1, 0], [0.5, -2.9, 2.2], [2, 0, 3]),  # flip branches
]


@pytest.mark.parametrize("bps,nv,sc,ys,xs", CASES)
def test_softening_metric_matches_hand_values(bps, nv, sc, ys, xs):
    """map_noise (jax) and the numpy chain reproduce the hand-computed
    n = g(y, i) to float64 round-off."""
    pa = PAMAlphabet(bps, 2)
    nm = NoiseMapper(pa, nv, sign_config=sc, dtype=np.float64)
    c = [float(v) for v in pa.constellation]
    p = [float(v) for v in pa.probabilities]
    sigma = math.sqrt(nv)
    M = len(c)
    thr_interior = [0.5 * (c[k] + c[k + 1]) for k in range(M - 1)]
    thr = [-math.inf] + thr_interior + [math.inf]
    signs = list(sc) if sc is not None else [0] * M

    regions = [hand_region(y, thr_interior) for y in ys]
    n_hand = [
        hand_soften(y, i, c, p, sigma, thr, signs)
        for y, i in zip(ys, regions)
    ]

    # jax NoiseMapper
    y_dev = jnp.asarray(ys, jnp.float64)
    i_dev = nm.hard_decide_index(y_dev)
    np.testing.assert_array_equal(np.asarray(i_dev), regions)
    n_jax = np.asarray(nm.map_noise(y_dev, i_dev))
    np.testing.assert_allclose(n_jax, n_hand, rtol=0, atol=1e-12)

    # numpy oracle chain (n_hat is not returned directly; recover it from
    # the chain's own hard decisions via the mapper's f64 tables)
    x_arr = np.asarray([xs], dtype=np.int64)
    y_arr = np.asarray([ys], dtype=np.float64)
    lappr_np, word_np = softening_chain_np(nm, pa, x_arr, y_arr)
    # the words are the Gray labels of the hand regions
    expect_word = np.concatenate(
        [np.asarray(pa.s_to_b[i], np.uint8) for i in regions]
    )
    np.testing.assert_array_equal(word_np[0], expect_word)


@pytest.mark.parametrize("bps,nv,sc,ys,xs", CASES)
def test_demap_llrs_match_hand_values(bps, nv, sc, ys, xs):
    """demap_lappr_array (all four modes) and the numpy oracle chain
    reproduce the hand-computed per-bit LLRs.

    "search" evaluates the exact inverse (Newton) — float-tight; the
    table/interp/poly modes are grid/fit approximations of the same curve
    (fit error <= 2e-3 absolute) — loose tolerance.
    """
    pa = PAMAlphabet(bps, 2)
    nm = NoiseMapper(pa, nv, sign_config=sc, dtype=np.float64)
    c = [float(v) for v in pa.constellation]
    p = [float(v) for v in pa.probabilities]
    sigma = math.sqrt(nv)
    M = len(c)
    thr_interior = [0.5 * (c[k] + c[k + 1]) for k in range(M - 1)]
    thr = [None] + thr_interior + [None]   # hand_llrs reads thr[1:M] only
    signs = list(sc) if sc is not None else [0] * M
    s_to_b = [list(map(int, row)) for row in np.asarray(pa.s_to_b)]

    regions = [hand_region(y, thr_interior) for y in ys]
    thr_full = [-math.inf] + thr_interior + [math.inf]
    n_hand = [
        hand_soften(y, i, c, p, sigma, thr_full, signs)
        for y, i in zip(ys, regions)
    ]
    llr_hand = np.asarray([
        hand_llrs(n, x, c, p, sigma, thr, signs, s_to_b)
        for n, x in zip(n_hand, xs)
    ]).reshape(-1)                                       # [S*bps]

    n_dev = jnp.asarray([n_hand], jnp.float64)           # [1, S]
    x_dev = jnp.asarray([xs])
    exact = np.asarray(
        nm.demap_lappr_array(n_dev, x_dev, mode="search")
    )[0]
    np.testing.assert_allclose(exact, llr_hand, rtol=1e-7, atol=1e-7)

    for mode, tol in (("interp", 2e-2), ("table", 2e-2), ("poly", 2e-2)):
        approx = np.asarray(
            nm.demap_lappr_array(n_dev, x_dev, mode=mode)
        )[0]
        np.testing.assert_allclose(
            approx, llr_hand, rtol=tol, atol=tol,
            err_msg=f"mode={mode}",
        )

    # numpy oracle chain on the same (x, y) samples
    x_arr = np.asarray([xs], dtype=np.int64)
    y_arr = np.asarray([ys], dtype=np.float64)
    lappr_np, _ = softening_chain_np(nm, pa, x_arr, y_arr)
    np.testing.assert_allclose(lappr_np[0], llr_hand, rtol=2e-2, atol=2e-2)
