"""NoiseMapper tests.

The reference has no tests for this layer (SURVEY.md §4); here every table
and mapping is validated against an independent float64 numpy oracle written
directly from the math (not shared with the implementation).
"""

import numpy as np
from scipy.special import erf
import jax.numpy as jnp
import pytest

from qamreconciliation_jax import (
    PAMAlphabet,
    NoiseMapper,
    NoiseMapperFlipSign,
    NoiseMapperAntiFlipSign,
)
from qamreconciliation_jax.models.bicm import generate_table_s_to_b

SQRT2 = np.sqrt(2.0)


def gauss_cdf(y, mu, sigma):
    return 0.5 * (1.0 + erf((y - mu) / (SQRT2 * sigma)))


def oracle_F(pa, sigma, y):
    """Probability-weighted marginal CDF of Y."""
    y = np.atleast_1d(np.asarray(y, dtype=np.float64))
    return sum(
        pa.probabilities[i] * gauss_cdf(y, pa.constellation[i], sigma)
        for i in range(pa.order)
    )


@pytest.fixture(params=[2, 4])
def setup(request):
    bps = request.param
    pa = PAMAlphabet(bps, 2.0)
    noise_var = pa.variance * 10 ** (-3.0 / 10) / 2  # SNR = 3 dB
    nm = NoiseMapper(pa, noise_var, dtype=jnp.float64)
    return pa, nm, np.sqrt(noise_var)


def test_rejects_bad_noise_var():
    pa = PAMAlphabet(2, 2.0)
    with pytest.raises(ValueError):
        NoiseMapper(pa, 0.0)
    with pytest.raises(ValueError):
        NoiseMapper(pa, -1.0)
    with pytest.raises(ValueError):
        NoiseMapper(pa, 1.0, sign_config=np.zeros(2, dtype=np.uint8))


def test_threshold_cdf_table(setup):
    pa, nm, sigma = setup
    M = pa.order
    F_thr = nm.F_Y_thresholds
    assert F_thr[0] == 0.0
    assert F_thr[M] == 1.0
    for i in range(1, M):
        np.testing.assert_allclose(
            F_thr[i], oracle_F(pa, sigma, pa.thresholds[i])[0], rtol=1e-12
        )
    assert (np.diff(F_thr) > 0).all()
    np.testing.assert_allclose(nm.delta_F_Y.sum(), 1.0, rtol=1e-12)


def test_forward_transition_rows(setup):
    pa, nm, sigma = setup
    M = pa.order
    fwd = nm.fwrd_transition_probability
    np.testing.assert_allclose(fwd.sum(axis=1), np.ones(M), rtol=1e-12)
    # oracle: P{Xhat=i | X=j} = F_Z(thr_{i+1}; a_j) - F_Z(thr_i; a_j) with
    # the outer intervals extending to +-inf
    for j in range(M):
        for i in range(M):
            hi = 1.0 if i == M - 1 else gauss_cdf(
                pa.thresholds[i + 1], pa.constellation[j], sigma
            )
            lo = 0.0 if i == 0 else gauss_cdf(
                pa.thresholds[i], pa.constellation[j], sigma
            )
            # difference-of-erf cancellation limits relative accuracy for
            # deep-tail probabilities; absolute agreement is what matters
            np.testing.assert_allclose(fwd[j, i], hi - lo, rtol=1e-7, atol=1e-15)


def test_back_transition_bayes(setup):
    pa, nm, sigma = setup
    M = pa.order
    fwd = nm.fwrd_transition_probability
    back = nm.back_transition_probability
    for i in range(M):
        denom = sum(pa.probabilities[k] * fwd[k, i] for k in range(M))
        for j in range(M):
            np.testing.assert_allclose(
                back[i, j], pa.probabilities[j] * fwd[j, i] / denom, rtol=1e-12
            )
        np.testing.assert_allclose(back[i].sum(), 1.0, rtol=1e-12)


def test_bare_llr_table(setup):
    pa, nm, sigma = setup
    M, bps = pa.order, pa.bit_per_symbol
    fwd = nm.fwrd_transition_probability
    bits = generate_table_s_to_b(bps)
    for j in range(M):
        for k in range(bps):
            N = sum(fwd[j, i] for i in range(M) if bits[i, k] == 0)
            D = sum(fwd[j, i] for i in range(M) if bits[i, k] == 1)
            if D == 0:
                assert nm.bare_llr_table[j, k] >= 1e30
            else:
                np.testing.assert_allclose(
                    nm.bare_llr_table[j, k], np.log(N / D), rtol=1e-10
                )


def test_inf_erf_table(setup):
    pa, nm, sigma = setup
    M = pa.order
    t = nm.inf_erf_table
    np.testing.assert_array_equal(t[0], -np.ones(M))
    for i in range(1, M):
        for j in range(M):
            np.testing.assert_allclose(
                t[i, j],
                erf((pa.thresholds[i] - pa.constellation[j]) / (SQRT2 * sigma)),
                rtol=1e-12,
            )


def test_hard_decide_index(setup):
    pa, nm, sigma = setup
    y = np.linspace(pa.constellation[0] - 3, pa.constellation[-1] + 3, 501)
    got = np.asarray(nm.hard_decide_index(y))
    # oracle: nearest constellation point (uniform grid, midpoint thresholds);
    # exclude exact threshold ties, which are checked separately below
    expect = np.argmin(np.abs(y[:, None] - pa.constellation[None, :]), axis=1)
    off_thr = ~np.isin(y, pa.thresholds)
    np.testing.assert_array_equal(got[off_thr], expect[off_thr])
    # boundary goes right (reference __binsearch recurses right on equality)
    thr = pa.thresholds[1]
    assert int(nm.hard_decide_index(np.array([thr]))[0]) == 1


def test_map_noise_in_unit_interval_and_matches_formula(setup):
    pa, nm, sigma = setup
    rng = np.random.default_rng(0)
    x = rng.integers(0, pa.order, 4096)
    y = pa.constellation[x] + sigma * rng.standard_normal(4096)
    idx = np.asarray(nm.hard_decide_index(y))
    n = np.asarray(nm.map_noise(y, idx))
    assert (n >= 0).all() and (n <= 1).all()
    # oracle for the base (all-zeros) sign config
    F = oracle_F(pa, sigma, y)
    F_thr = nm.F_Y_thresholds
    expect = (F - F_thr[idx]) / (F_thr[idx + 1] - F_thr[idx])
    np.testing.assert_allclose(n, expect, rtol=1e-9)


def test_g_ginv_roundtrip(setup):
    pa, nm, sigma = setup
    rng = np.random.default_rng(1)
    y = np.linspace(pa.constellation[0], pa.constellation[-1], 257)
    idx = np.asarray(nm.hard_decide_index(y))
    n = np.asarray(nm.map_noise(y, idx))
    y_back = np.asarray(nm.g_inv(jnp.asarray(n), jnp.asarray(idx)))
    np.testing.assert_allclose(y_back, y, atol=2e-3 * pa.step)
    y_back_search = np.asarray(nm.g_inv_search(jnp.asarray(n), jnp.asarray(idx)))
    np.testing.assert_allclose(y_back_search, y, atol=1e-9)


def test_ginv_search_matches_interp(setup):
    pa, nm, sigma = setup
    rng = np.random.default_rng(2)
    n = rng.uniform(0.001, 0.999, 256)
    i = rng.integers(0, pa.order, 256)
    a = np.asarray(nm.g_inv(jnp.asarray(n), jnp.asarray(i)))
    b = np.asarray(nm.g_inv_search(jnp.asarray(n), jnp.asarray(i)))
    np.testing.assert_allclose(a, b, atol=2e-3 * pa.step)


def test_sign_config_flips_direction():
    pa = PAMAlphabet(2, 2.0)
    nv = pa.variance / 4
    base = NoiseMapper(pa, nv, dtype=jnp.float64)
    alt = NoiseMapper(
        pa, nv, sign_config=np.array([0, 1, 0, 1], np.uint8), dtype=jnp.float64
    )
    y = np.array([-1.2])
    i = np.array([1])
    n0 = float(base.g(y, i)[0])
    n1 = float(alt.g(y, i)[0])
    np.testing.assert_allclose(n0 + n1, 1.0, rtol=1e-12)


def test_flip_sign_variants():
    pa = PAMAlphabet(2, 2.0)
    nv = pa.variance / 4
    flip = NoiseMapperFlipSign(pa, nv, dtype=jnp.float64)
    anti = NoiseMapperAntiFlipSign(pa, nv, dtype=jnp.float64)
    base = NoiseMapper(pa, nv, dtype=jnp.float64)
    y = np.array([-2.5, -1.0, 1.0, 2.5])
    i = np.array([0, 1, 2, 3])
    n_flip = np.asarray(flip.g(y, i))
    n_anti = np.asarray(anti.g(y, i))
    n_base = np.asarray(base.g(y, i))
    # flip reverses the lower half, anti the upper half
    np.testing.assert_allclose(n_flip[:2], 1.0 - n_base[:2], rtol=1e-12)
    np.testing.assert_allclose(n_flip[2:], n_base[2:], rtol=1e-12)
    np.testing.assert_allclose(n_anti[:2], n_base[:2], rtol=1e-12)
    np.testing.assert_allclose(n_anti[2:], 1.0 - n_base[2:], rtol=1e-12)
    # g_inv inverts g for the variants too
    y_back = np.asarray(flip.g_inv(jnp.asarray(n_flip), jnp.asarray(i)))
    np.testing.assert_allclose(y_back, y, atol=2e-3 * pa.step)


def oracle_demap_lappr(nm, pa, sigma, n, j, quirk=False):
    """Scalar float64 oracle for Formulation 2/4, written from the math
    (probability-weighted exponential sums over reconstructed samples)."""
    M, bps = pa.order, pa.bit_per_symbol
    bits = generate_table_s_to_b(bps)
    N = np.zeros(bps)
    D = np.zeros(bps)
    for i in range(M):
        y_hat = float(nm.g_inv_search(jnp.asarray([n]), jnp.asarray([i]))[0])
        s = 0.0
        for k in range(M):
            e = (2 * y_hat - pa.constellation[k] - pa.constellation[j]) * (
                pa.constellation[k] - pa.constellation[j]
            )
            if not (quirk and k < j):
                e = e / (2 * sigma**2)
            with np.errstate(over="ignore"):
                # quirk mode leaves the exponent unscaled -> exp may overflow
                # to inf; w = dF/inf = 0 is the intended quirk semantics
                s += pa.probabilities[k] * np.exp(e)
        w = nm.delta_F_Y[i] / s
        for k in range(bps):
            if bits[i, k]:
                D[k] += w
            else:
                N[k] += w
    return np.log(N) - np.log(D)


@pytest.mark.parametrize("quirk", [False, True])
def test_demap_lappr_vs_oracle(setup, quirk):
    pa, nm, sigma = setup
    rng = np.random.default_rng(3)
    S = 8
    n = rng.uniform(0.05, 0.95, S)
    j = rng.integers(0, pa.order, S)
    got = np.asarray(
        nm.demap_lappr_array(jnp.asarray(n), jnp.asarray(j), ref_compat=quirk)
    ).reshape(S, pa.bit_per_symbol)
    for s in range(S):
        expect = oracle_demap_lappr(nm, pa, sigma, n[s], int(j[s]), quirk)
        np.testing.assert_allclose(got[s], expect, rtol=1e-6, atol=1e-9)


def test_demap_lappr_interp_close_to_search(setup):
    pa, nm, sigma = setup
    rng = np.random.default_rng(4)
    S = 64
    n = rng.uniform(0.02, 0.98, S)
    j = rng.integers(0, pa.order, S)
    a = np.asarray(nm.demap_lappr_array(jnp.asarray(n), jnp.asarray(j), mode="search"))
    b = np.asarray(nm.demap_lappr_array(jnp.asarray(n), jnp.asarray(j), mode="interp"))
    np.testing.assert_allclose(a, b, rtol=5e-3, atol=5e-3)


def test_demap_lappr_simplified_vs_oracle(setup):
    pa, nm, sigma = setup
    rng = np.random.default_rng(5)
    S = 8
    n = rng.uniform(0.05, 0.95, S)
    j = rng.integers(0, pa.order, S)
    bits = generate_table_s_to_b(pa.bit_per_symbol)
    got = np.asarray(
        nm.demap_lappr_simplified_array(jnp.asarray(n), jnp.asarray(j))
    ).reshape(S, pa.bit_per_symbol)
    for s in range(S):
        N = np.zeros(pa.bit_per_symbol)
        D = np.zeros(pa.bit_per_symbol)
        for i in range(pa.order):
            y_hat = float(nm.g_inv(jnp.asarray([n[s]]), jnp.asarray([i]))[0])
            w = np.exp(
                -((y_hat - pa.constellation[j[s]]) ** 2) / (2 * sigma**2)
            )
            for k in range(pa.bit_per_symbol):
                if bits[i, k]:
                    D[k] += w
                else:
                    N[k] += w
        np.testing.assert_allclose(
            got[s], np.log(N) - np.log(D), rtol=1e-7, atol=1e-9
        )


def test_demap_lappr_sofisticated_runs(setup):
    pa, nm, sigma = setup
    rng = np.random.default_rng(6)
    S = 16
    n = rng.uniform(0.05, 0.95, S)
    j = rng.integers(0, pa.order, S)
    out = np.asarray(
        nm.demap_lappr_sofisticated_array(jnp.asarray(n), jnp.asarray(j))
    )
    assert out.shape == (S * pa.bit_per_symbol,)
    out_compat = np.asarray(
        nm.demap_lappr_sofisticated_array(
            jnp.asarray(n), jnp.asarray(j), ref_compat=True
        )
    )
    assert out_compat.shape == (S * pa.bit_per_symbol,)


def test_bare_llr_gather(setup):
    pa, nm, sigma = setup
    symb = np.array([0, pa.order - 1, 1])
    out = np.asarray(nm.bare_llr(jnp.asarray(symb)))
    expect = nm.bare_llr_table[symb].reshape(-1)
    np.testing.assert_allclose(out, expect, rtol=1e-12)


def test_shaped_alphabet_tables_consistent():
    p = np.array([0.4, 0.1, 0.1, 0.4])
    pa = PAMAlphabet(2, 2.0, probabilities=p)
    nm = NoiseMapper(pa, 0.5, dtype=jnp.float64)
    # correct-math grid: interp and search inverses agree for shaped input
    rng = np.random.default_rng(7)
    n = rng.uniform(0.05, 0.95, 128)
    i = rng.integers(0, 4, 128)
    a = np.asarray(nm.g_inv(jnp.asarray(n), jnp.asarray(i)))
    b = np.asarray(nm.g_inv_search(jnp.asarray(n), jnp.asarray(i)))
    np.testing.assert_allclose(a, b, atol=2e-3 * pa.step)
    # ref-compat grid reproduces the reference's uniform weighting quirk:
    # interp inverse now disagrees with the exact search inverse
    nm_q = NoiseMapper(pa, 0.5, dtype=jnp.float64, ref_compat_fy_grid=True)
    a_q = np.asarray(nm_q.g_inv(jnp.asarray(n), jnp.asarray(i)))
    b_q = np.asarray(nm_q.g_inv_search(jnp.asarray(n), jnp.asarray(i)))
    assert np.abs(a_q - b_q).max() > 1e-2 * pa.step


def test_ginv_search_tail_parity_vs_bisection():
    """Newton inverse == 200-step erfc-bisection ground truth, measured in
    CDF-value space (y-space comparison is ill-posed where the CDF is flat
    to machine precision, e.g. target exactly 0/1)."""
    from scipy.special import erfc as serfc

    for bps, p in [(2, None), (2, [0.4, 0.1, 0.1, 0.4]), (4, None)]:
        pa = PAMAlphabet(bps, 2.0, probabilities=p)
        nm = NoiseMapper(pa, pa.variance * 10 ** (-0.3), dtype=jnp.float64)
        c = np.asarray(nm.constellation)
        pr = np.asarray(nm.probabilities)
        s = nm.noise_sigma

        def F(y):
            z = (np.atleast_1d(y)[:, None] - c) / (np.sqrt(2) * s)
            return np.sum(pr * 0.5 * serfc(-z), axis=-1)

        vals = np.array([1e-12, 1e-6, 1e-3, 0.5, 1 - 1e-3, 1 - 1e-6])
        n = np.tile(vals, pa.order)
        i = np.repeat(np.arange(pa.order), vals.size)
        target = np.asarray(
            nm._g_target(jnp.asarray(n), jnp.asarray(i), nm._sign_cfg)
        )
        y = np.asarray(nm.g_inv_search(jnp.asarray(n), jnp.asarray(i)))
        # CDF value at the returned y matches the target to near-f64
        # relative accuracy on both tails
        resid = np.abs(F(y) - target)
        scale = np.minimum(np.maximum(target, 1e-300),
                           np.maximum(1 - target, 1e-300))
        assert (resid <= 1e-6 * scale + 1e-15).all(), (
            bps, p, float(resid.max())
        )


def test_demap_lappr_table_mode_close_to_interp(setup):
    """The tabulated (n, j)->LLR map matches the per-sample interp path to
    interpolation accuracy for every alphabet/config the fixture covers."""
    pa, nm, sigma = setup
    rng = np.random.default_rng(9)
    S = 512
    n = jnp.asarray(rng.uniform(0.001, 0.999, S))
    j = jnp.asarray(rng.integers(0, pa.order, S))
    a = np.asarray(nm.demap_lappr_array(n, j, mode="interp"))
    b = np.asarray(nm.demap_lappr_array(n, j, mode="table"))
    rel = np.abs(a - b) / (np.abs(a) + 1e-3)
    assert rel.max() < 2e-3, rel.max()


def test_host_leaf_mapper_matches_device_mapper():
    """NoiseMapper(device=False) keeps numpy leaves and produces the same
    batched-MC values as the default device-leaf mapper (the mass-
    enumeration path of the sign study)."""
    import jax
    import numpy as np

    from qamreconciliation_jax.models.alphabet import PAMAlphabet
    from qamreconciliation_jax.models.mutual_information import (
        P_xhat, montecarlo_information_batched,
    )
    from qamreconciliation_jax.models.noisemapper import NoiseMapper

    pa = PAMAlphabet(2, 2.0)
    cfg = np.array([0, 1, 0, 1], np.uint8)
    host = NoiseMapper(pa, 0.2, cfg, dtype=np.float64, device=False)
    dev = NoiseMapper(pa, 0.2, cfg, dtype=np.float64)
    assert isinstance(host._fwd, np.ndarray)
    leaves = jax.tree_util.tree_leaves(host)
    assert any(isinstance(x, np.ndarray) for x in leaves)
    keys = jax.random.split(jax.random.key(3), 2)
    out_h = montecarlo_information_batched(
        keys, pa, [host, host], np.stack([P_xhat(host)] * 2), 256,
        which=(True, True, True),
    )
    out_d = montecarlo_information_batched(
        keys, pa, [dev, dev], np.stack([P_xhat(dev)] * 2), 256,
        which=(True, True, True),
    )
    np.testing.assert_allclose(out_h, out_d, rtol=1e-12, atol=1e-12)


def test_with_sign_config_clone_matches_fresh_ctor():
    """with_sign_config shares every table leaf with the base mapper and is
    indistinguishable from a fresh constructor call with the same config —
    the mass-enumeration fast path of the sign study (reference:
    sims/sim_mutual_information_compare_signs.py:67-95)."""
    import jax
    import numpy as np

    from qamreconciliation_jax.models.alphabet import PAMAlphabet
    from qamreconciliation_jax.models.mutual_information import (
        P_xhat, montecarlo_information_batched,
        mutual_information_base_scheme,
    )
    from qamreconciliation_jax.models.noisemapper import NoiseMapper

    pa = PAMAlphabet(2, 2.0)
    cfg = np.array([1, 0, 0, 1], np.uint8)
    base = NoiseMapper(pa, 0.2, dtype=np.float64, device=False)
    clone = base.with_sign_config(cfg)
    fresh = NoiseMapper(pa, 0.2, cfg, dtype=np.float64, device=False)

    # every non-sign table leaf is shared BY REFERENCE with the base mapper
    np.testing.assert_array_equal(clone.sign_config, cfg)
    assert clone._fwd is base._fwd and clone._y_of_u is base._y_of_u
    assert isinstance(clone._sign_cfg, np.ndarray)  # host-leaf preserved
    assert clone._llr_tab is None and clone._llr_poly is None
    assert base.sign_config.max() == 0  # base unmodified

    # identical flattened leaves vs the fresh constructor
    lc = jax.tree_util.tree_leaves(clone)
    lf = jax.tree_util.tree_leaves(fresh)
    assert len(lc) == len(lf)
    for a, b in zip(lc, lf):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # MC-identical through the batched estimator
    keys = jax.random.split(jax.random.key(7), 2)
    p = np.stack([P_xhat(base)] * 2)
    out_c = montecarlo_information_batched(
        keys, pa, [clone, clone], p, 256, which=(True, True, True))
    out_f = montecarlo_information_batched(
        keys, pa, [fresh, fresh], p, 256, which=(True, True, True))
    np.testing.assert_allclose(out_c, out_f, rtol=1e-12, atol=1e-12)

    # analytic-identical (host quad path reads sign_config on the host)
    np.testing.assert_allclose(
        mutual_information_base_scheme(clone, P_xhat(base)),
        mutual_information_base_scheme(fresh, P_xhat(fresh)),
        rtol=1e-12,
    )

    # the device-leaf flavor clones to device leaves
    dev = NoiseMapper(pa, 0.2, dtype=np.float64)
    dclone = dev.with_sign_config(cfg)
    assert not isinstance(dclone._sign_cfg, np.ndarray)


@pytest.mark.parametrize("bps", [2, 4])
def test_ginv_poly_matches_interp(bps):
    """The gather-free probit-warped Chebyshev inverse tracks the grid-
    interpolated g_inv it replaces to well below MC-estimator noise,
    across sign configurations (which only transform the CDF target)."""
    import numpy as np

    from qamreconciliation_jax.models.alphabet import PAMAlphabet
    from qamreconciliation_jax.models.noisemapper import NoiseMapper

    pa = PAMAlphabet(bps, 2.0)
    M = pa.order
    rng = np.random.default_rng(0)
    cfgs = [np.zeros(M, np.uint8), (np.arange(M) % 2).astype(np.uint8)]
    nm0 = NoiseMapper(pa, pa.variance * 10 ** (-0.8), dtype=np.float64,
                      device=False)
    nm0._ensure_ginv_poly()
    assert nm0._ginv_poly_fit_err < 1e-4 * pa.step
    n = np.linspace(0.0, 1.0, 4001)
    for cfg in cfgs:
        nm = nm0.with_sign_config(cfg)
        assert nm._ginv_poly is nm0._ginv_poly  # shared by reference
        for i in range(M):
            ii = np.full(n.shape, i)
            y_interp = np.asarray(nm.g_inv(n, ii))
            y_poly = np.asarray(nm.g_inv_poly(n, ii))
            # interior: fit-level agreement; the clamped extreme tails
            # (u within half a table cell of 0/1) may differ by the
            # table's own end-cell lerp
            err = np.abs(y_poly - y_interp)
            assert np.median(err) < 1e-5 * pa.step
            assert np.percentile(err, 99.5) < 1e-3 * pa.step


def test_mc_estimator_poly_ginv_statistically_equivalent():
    """I(X,N;Xhat) MC estimates with ginv_mode='poly' match 'interp' far
    inside MC noise (same key: only the k != xhat candidate inverses
    differ, by the fit residual)."""
    import jax
    import numpy as np

    from qamreconciliation_jax.models.alphabet import PAMAlphabet
    from qamreconciliation_jax.models.mutual_information import (
        P_xhat, montecarlo_information,
    )
    from qamreconciliation_jax.models.noisemapper import NoiseMapper

    pa = PAMAlphabet(2, 2.0)
    nm = NoiseMapper(pa, 0.35, dtype=np.float64)
    nm._ensure_ginv_poly()
    p = P_xhat(nm)
    key = jax.random.key(3)
    _, _, a = montecarlo_information(key, pa, nm, p, 8192,
                                     which=(False, False, True))
    _, _, b = montecarlo_information(key, pa, nm, p, 8192,
                                     which=(False, False, True),
                                     ginv_mode="poly")
    # the fit-residual-induced shift (tail candidates amplify y errors
    # through dF/denom) stays ~3e-4 relative — an order below the
    # estimator's own MC standard error (~1% at 8192 samples)
    assert abs(a - b) < 2e-3 * max(1.0, abs(a))


def test_sign_config_owns_its_array():
    """Mappers must not alias caller memory through sign_config: mutating
    the caller's config array (e.g. a row of an enumeration buffer) after
    construction/cloning must not desync the host analytic paths (which
    read ``sign_config`` lazily) from the device ``_sign_cfg`` copy."""
    import numpy as np

    from qamreconciliation_jax.models.alphabet import PAMAlphabet
    from qamreconciliation_jax.models.noisemapper import NoiseMapper

    pa = PAMAlphabet(2, 2.0)
    cfg = np.array([1, 0, 0, 1], np.uint8)
    built = NoiseMapper(pa, 0.2, cfg, dtype=np.float64, device=False)
    clone = NoiseMapper(
        pa, 0.2, dtype=np.float64, device=False
    ).with_sign_config(cfg)
    cfg[:] = 0  # caller reuses its buffer
    np.testing.assert_array_equal(built.sign_config, [1, 0, 0, 1])
    np.testing.assert_array_equal(clone.sign_config, [1, 0, 0, 1])


@pytest.mark.parametrize("bps,snr_dB", [(2, 4.0), (4, 12.0)])
def test_fy_flat_matches_exact_mixture(bps, snr_dB):
    """F_Y_flat (static-float lane-flat unroll) is the exact mixture to
    float round-off, and map_noise under fy_mode='erf_flat' matches the
    default to round-off."""
    pa = PAMAlphabet(bps, 2)
    Es = pa.variance
    N0 = Es * (10.0 ** (-snr_dB / 10.0)) / 2.0
    nm = NoiseMapper(pa, N0, dtype=np.float64)
    nm_f = NoiseMapper(pa, N0, dtype=np.float64, fy_mode="erf_flat")
    rng = np.random.default_rng(5)
    y = jnp.asarray(rng.normal(0.0, 3.0, (17, 9)), jnp.float64)
    np.testing.assert_allclose(
        np.asarray(nm_f.F_Y_flat(y)), np.asarray(nm.F_Y(y)),
        rtol=1e-13, atol=1e-13,
    )
    i = nm.hard_decide_index(y)
    np.testing.assert_allclose(
        np.asarray(nm_f.map_noise(y, i)), np.asarray(nm.map_noise(y, i)),
        rtol=1e-10, atol=1e-12,
    )


@pytest.mark.parametrize("bps,snr_dB", [(2, 4.0), (4, 12.0)])
def test_fy_poly_fit_accuracy(bps, snr_dB):
    """The probit-warped Chebyshev F_Y fit tracks the exact mixture on the
    CDF scale well below the softening-LLR fit tolerance (2e-3), and the
    softening metric n under fy_mode='poly' stays within 1e-4 of exact at
    operating SNRs."""
    pa = PAMAlphabet(bps, 2)
    Es = pa.variance
    N0 = Es * (10.0 ** (-snr_dB / 10.0)) / 2.0
    nm = NoiseMapper(pa, N0, dtype=np.float64)
    nm_p = NoiseMapper(pa, N0, dtype=np.float64, fy_mode="poly")
    nm_p._ensure_fy_poly()
    assert nm_p._fy_poly_fit_err < 1e-4
    rng = np.random.default_rng(6)
    x = rng.integers(0, pa.order, (11, 13))
    y = jnp.asarray(
        np.asarray(pa.constellation)[x]
        + np.sqrt(N0) * rng.standard_normal(x.shape),
        jnp.float64,
    )
    np.testing.assert_allclose(
        np.asarray(nm_p.F_Y_poly(y)), np.asarray(nm.F_Y(y)),
        rtol=0, atol=2e-4,
    )
    i = nm.hard_decide_index(y)
    np.testing.assert_allclose(
        np.asarray(nm_p.map_noise(y, i)), np.asarray(nm.map_noise(y, i)),
        rtol=0, atol=2e-3,
    )
