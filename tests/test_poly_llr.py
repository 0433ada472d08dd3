"""Piecewise-Chebyshev ("poly") softening-LLR path.

The poly formulation replaces the tabulated (n, j)->LLR map's random
gathers with a one-hot coefficient-select contraction + Clenshaw
recurrence.  These tests pin its
accuracy against the exact float64 LLR chain and its statistical
equivalence to the tabulated path end-to-end.

Reference semantics: qamreconciliation/noisemapper.pyx:450-559 (the
per-sample sofisticated demapper the table/poly formulations re-express).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from qamreconciliation_jax.models.alphabet import PAMAlphabet
from qamreconciliation_jax.models.noisemapper import (
    NoiseMapper,
    NoiseMapperAntiFlipSign,
    NoiseMapperFlipSign,
)


def _mk(cls, bps, snr_db, cfg, dtype=jnp.float64):
    pa = PAMAlphabet(bps, 2.0)
    N0 = pa.variance * (10.0 ** (-snr_db / 10.0)) / 2.0
    return cls(pa, N0, cfg, dtype=dtype)


@pytest.mark.parametrize(
    "cls,bps,snr,cfg,tol",
    [
        (NoiseMapper, 2, 3.5, "base", 5e-3),
        (NoiseMapper, 2, 0.0, "base", 5e-3),
        (NoiseMapper, 4, 10.0, "base", 5e-3),
        (NoiseMapper, 2, 3.5, "alt", 0.15),
        (NoiseMapperFlipSign, 2, 3.5, None, 0.15),
        (NoiseMapperAntiFlipSign, 4, 10.0, None, 0.15),
    ],
)
def test_poly_matches_exact_f64(cls, bps, snr, cfg, tol):
    """Poly LLRs track the exact float64 chain; base sign configs to ~1e-3,
    flipped ones to ~1e-1 worst-case (the error concentrates on the ~1e-4
    tail fraction of n where the y_of_u inverse-CDF lerp is itself kinked
    — the tabulated path shares that artifact)."""
    M = 1 << bps
    if cfg == "base":
        cfg = np.zeros(M, np.uint8)
    elif cfg == "alt":
        cfg = (np.arange(M) % 2).astype(np.uint8)
    nm = _mk(cls, bps, snr, cfg)
    nm._ensure_llr_poly()
    rng = np.random.default_rng(3)
    n = rng.random(4096)
    j = rng.integers(0, M, 4096)
    exact = nm._llr_eval_f64(n)[np.arange(n.size), j]       # [T, bps]
    got = np.stack(
        [np.asarray(v) for v in
         nm._poly_llr_bits(jnp.asarray(n), jnp.asarray(j, jnp.int32))],
        axis=-1,
    )
    assert np.abs(got - exact).max() < tol


def test_poly_fit_residual_small():
    nm = _mk(NoiseMapper, 2, 3.5, None)
    nm._ensure_llr_poly()
    assert nm._llr_poly_fit_err < 0.05


def test_poly_vs_table_demap_lappr_array():
    """demap_lappr_array('poly') == demap_lappr_array('table') within the
    combined fit + lerp tolerance on the flattened [.., S*bps] contract."""
    nm = _mk(NoiseMapper, 2, 4.0, None)
    nm._ensure_llr_tab()
    nm._ensure_llr_poly()
    rng = np.random.default_rng(5)
    n = jnp.asarray(rng.random((3, 64)))
    j = jnp.asarray(rng.integers(0, 4, (3, 64)), jnp.int32)
    a = np.asarray(nm.demap_lappr_array(n, j, mode="poly"))
    b = np.asarray(nm.demap_lappr_array(n, j, mode="table"))
    assert a.shape == b.shape == (3, 128)
    assert np.abs(a - b).max() < 1e-2


def test_poly_engine_round_matches_table_counters():
    """End-to-end softening rounds with identical keys: the ~1e-3 LLR
    deltas must not move the (ber, fer, iters) counters at these stats."""
    from qamreconciliation_jax.models.decoder import Decoder
    from qamreconciliation_jax.models.matrix import Matrix
    from qamreconciliation_jax.sims.engine import ReconciliationEngine
    from qamreconciliation_jax.utils.edgefile import make_regular_ldpc

    vid, cid = make_regular_ldpc(1024, dv=3, dc=6, seed=11)
    dec = Decoder(vid, cid, dtype=jnp.float32)
    mat = Matrix(vid, cid)
    pa = PAMAlphabet(2, 2.0)
    out = {}
    for llr in ("table", "poly"):
        eng = ReconciliationEngine(
            dec, mat, pa, batch=32, dtype=jnp.float32, llr_mode=llr
        )
        r = eng.run_point("softening", 3.2, 25, 128, 10 ** 9,
                          nmconfig=np.zeros(4, np.uint8), seed=3)
        out[llr] = r
    assert abs(out["poly"].ber - out["table"].ber) < 5e-3
    assert abs(out["poly"].fer - out["table"].fer) < 0.05


def test_poly_pytree_stacking_vmaps():
    """Stacked same-shape poly leaves vmap across SNR points (the sweep
    batching contract, engine.run_sweep_batched)."""
    import jax

    pa = PAMAlphabet(2, 2.0)
    nms = []
    for snr in (2.0, 4.0):
        N0 = pa.variance * (10.0 ** (-snr / 10.0)) / 2.0
        nm = NoiseMapper(pa, N0, np.zeros(4, np.uint8), dtype=jnp.float64)
        nm._ensure_llr_poly()
        nms.append(nm)
    stack = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *nms)
    n = jnp.asarray(np.linspace(0.01, 0.99, 32))
    j = jnp.asarray(np.arange(32) % 4, jnp.int32)

    def f(m):
        return jnp.stack(m._poly_llr_bits(n, j))

    got = jax.vmap(f)(stack)
    want = np.stack([np.asarray(f(m)) for m in nms])
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12)


def _dot_precisions(fn, *args):
    """Precisions of every dot_general in fn's jaxpr (nested jaxprs too)."""
    import jax

    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return found


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_llr_contractions_ask_highest_precision(dtype):
    """The one-hot coefficient select and the sofisticated demapper's
    bit-mask contractions ask for HIGHEST precision: a GPU may otherwise
    run a float32 contraction in TF32, which breaks the exact select and
    the fit's 2e-3 bound."""
    import jax

    nm = _mk(NoiseMapper, 2, 3.5, np.zeros(4, np.uint8), dtype=dtype)
    nm._ensure_llr_poly()
    n = jnp.linspace(0.05, 0.95, 16).astype(dtype)
    j = (jnp.arange(16) % 4).astype(jnp.int32)
    hi = jax.lax.Precision.HIGHEST
    for fn in (lambda a, b: nm._poly_llr_bits(a, b),
               lambda a, b: nm.demap_lappr_sofisticated_array(a, b)):
        precs = _dot_precisions(fn, n, j)
        assert precs, "expected a contraction"
        assert all(p == (hi, hi) for p in precs), precs
