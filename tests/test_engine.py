"""End-to-end sweep engine tests on a small (3,6) LDPC code."""

import numpy as np
import jax.numpy as jnp
import pytest

from qamreconciliation_jax import Decoder, Matrix, PAMAlphabet
from qamreconciliation_jax.sims import ReconciliationEngine
from qamreconciliation_jax.utils import make_regular_ldpc


@pytest.fixture(scope="module")
def code():
    vid, cid = make_regular_ldpc(240, 3, 6, seed=0)
    dec = Decoder(vid, cid, dtype=jnp.float64)
    mat = Matrix(vid, cid)
    return dec, mat


def make_engine(code, bps=2, **kw):
    dec, mat = code
    pa = PAMAlphabet(bps, 2.0)
    return ReconciliationEngine(dec, mat, pa, batch=64, dtype=jnp.float64, **kw)


def test_softening_ber_decreases_with_snr(code):
    eng = make_engine(code)
    nmconfig = np.zeros(4, dtype=np.uint8)
    nmconfig[1::2] = 1  # Alternating configuration (reference default)
    r_low = eng.run_point(
        "softening", 2.0, 30, 256, 10**9, nmconfig=nmconfig, seed=1
    )
    r_high = eng.run_point(
        "softening", 9.0, 30, 256, 10**9, nmconfig=nmconfig, seed=1
    )
    assert r_high.ber < r_low.ber
    assert r_high.fer <= r_low.fer
    assert 0.0 <= r_low.ber <= 1.0
    # at 9 dB a rate-1/2 code over 4-PAM decodes essentially always
    assert r_high.fer < 0.1


def test_direct_mode_runs_and_beats_hard(code):
    eng = make_engine(code)
    snr = 7.0
    r_soft = eng.run_point("direct", snr, 30, 256, 10**9, seed=2)
    r_hard = eng.run_point("hard", snr, 30, 256, 10**9, seed=2)
    assert 0.0 <= r_soft.ber <= 1.0
    assert 0.0 <= r_hard.ber <= 1.0
    # soft direct decoding must not be worse than hard reverse at equal SNR
    assert r_soft.ber <= r_hard.ber + 0.01


def test_early_exit(code):
    eng = make_engine(code)
    # at very low SNR every frame errors: with ferr_count_min=1 the engine
    # must stop after the early-exit rule unlocks (frames > simloops/20)
    r = eng.run_point("softening", -5.0, 5, 1280, 1,
                      nmconfig=np.zeros(4, np.uint8), seed=3)
    assert r.frames < 1280
    assert r.frames > 1280 / 20


def test_result_tuple_schema(code):
    eng = make_engine(code)
    r = eng.run_point("direct", 8.0, 10, 64, 10**9, seed=4)
    t = r.as_tuple()
    assert len(t) == 4
    assert t[0] == 8.0


def test_llr_modes_agree_statistically(code):
    eng_i = make_engine(code, llr_mode="interp")
    eng_s = make_engine(code, llr_mode="search")
    cfg = np.zeros(4, np.uint8)
    ri = eng_i.run_point("softening", 6.0, 30, 128, 10**9, nmconfig=cfg, seed=5)
    rs = eng_s.run_point("softening", 6.0, 30, 128, 10**9, nmconfig=cfg, seed=5)
    # identical keys + near-identical LLRs -> (almost) identical counters
    assert abs(ri.fer - rs.fer) < 0.05
    assert abs(ri.ber - rs.ber) < 0.01


def test_bfloat16_round_runs():
    """--dtype bfloat16 end-to-end (regression: finite_llr_max used np.finfo
    which rejects ml_dtypes)."""
    import jax.numpy as jnp
    import numpy as np
    from qamreconciliation_jax import Decoder, Matrix, PAMAlphabet
    from qamreconciliation_jax.sims.engine import ReconciliationEngine
    from qamreconciliation_jax.utils import make_regular_ldpc

    vid, cid = make_regular_ldpc(120, 3, 6, seed=8)
    dec = Decoder(vid, cid, dtype=jnp.bfloat16)
    mat = Matrix(vid, cid)
    pa = PAMAlphabet(2, 2.0)
    eng = ReconciliationEngine(dec, mat, pa, batch=8, dtype=jnp.bfloat16)
    r = eng.run_point("softening", 6.0, 15, 16, 10**9,
                      nmconfig=np.zeros(4, np.uint8))
    assert 0.0 <= r.ber <= 1.0
    assert r.frames == 16


def test_table_vs_interp_llr_mode_statistical_equivalence():
    """Default 'table' LLR path matches the per-sample 'interp' path within
    Monte-Carlo error at a partially-failing operating point."""
    import numpy as np
    from qamreconciliation_jax import Decoder, Matrix, PAMAlphabet
    from qamreconciliation_jax.sims.engine import ReconciliationEngine
    from qamreconciliation_jax.utils import make_regular_ldpc

    vid, cid = make_regular_ldpc(512, 3, 6, seed=17)
    dec = Decoder(vid, cid)
    mat = Matrix(vid, cid)
    pa = PAMAlphabet(2, 2.0)
    bers = {}
    for mode in ["table", "interp"]:
        eng = ReconciliationEngine(dec, mat, pa, batch=64, llr_mode=mode)
        r = eng.run_point("softening", 4.0, 30, 256, 10**9,
                          nmconfig=np.zeros(4, np.uint8), seed=5)
        bers[mode] = r.ber
        assert 0.0 < r.ber < 0.2
    assert abs(bers["table"] - bers["interp"]) < 0.03


def test_bfloat16_error_counters_exact():
    """Bit-error counters are exact int32 XOR counts even in bfloat16: a
    frame with K >> 256 wrong bits must report exactly K errors (a bf16
    float accumulator silently rounds above ~256 — the bug class this
    guards against)."""
    import numpy as np
    import jax.numpy as jnp
    from qamreconciliation_jax import Decoder, Matrix, PAMAlphabet
    from qamreconciliation_jax.sims.engine import ReconciliationEngine
    from qamreconciliation_jax.utils import make_regular_ldpc

    vid, cid = make_regular_ldpc(2048, 3, 6, seed=21)
    dec = Decoder(vid, cid, dtype=jnp.bfloat16)
    mat = Matrix(vid, cid)
    pa = PAMAlphabet(2, 2.0)
    eng = ReconciliationEngine(dec, mat, pa, batch=4, dtype=jnp.bfloat16)

    B, K = 4, eng.K
    # final LLRs all strongly positive -> decided bits all 0; word all 1s
    # over the K info bits -> exactly K errors per frame (K = 1024 > 256)
    lappr = jnp.full((2048, B), 8.0, jnp.bfloat16)
    word = jnp.ones((2048, B), jnp.int32)
    errs, ferrs, _, _ = eng._decode_and_count_nb(lappr, word, jnp.int32(0))
    assert int(errs) == B * K, (int(errs), B * K)
    assert int(ferrs) == B


def test_rounds_per_dispatch_scan_equals_sequential(code):
    """The device-side lax.scan over R sub-rounds (rounds_per_dispatch)
    must produce EXACTLY the sum of R sequential base rounds on the same
    fold_in key chain — one dispatch, identical counters."""
    import jax

    eng1 = make_engine(code)
    engR = make_engine(code, rounds_per_dispatch=3)
    assert engR.frames_per_round == 3 * eng1.frames_per_round

    from qamreconciliation_jax.models.noisemapper import NoiseMapper

    pa = eng1.pa
    N0 = pa.variance * 10 ** (-4.5 / 10) / 2
    nm = NoiseMapper(pa, N0, np.zeros(4, np.uint8), dtype=jnp.float64)
    nm._ensure_llr_poly()
    sig = jnp.asarray(float(np.sqrt(N0)), jnp.float64)
    alp = jnp.asarray(1.0, jnp.float64)
    key = jax.random.key(11)

    got = np.asarray(
        engR._build_round("softening")(key, jnp.int32(12), nm, sig, alp)
    )
    base = eng1._build_round_body("softening")
    want = sum(
        np.asarray(
            base(jax.random.fold_in(key, r), jnp.int32(12), nm, sig, alp)
        )
        for r in range(3)
    )
    assert np.array_equal(got, want), (got, want)


def test_rounds_per_dispatch_point_batch(code):
    """--point-batch composes with rounds_per_dispatch: the scanned vmapped
    sweep returns the same per-point counters as R sequential vmapped
    rounds."""
    eng = make_engine(code, rounds_per_dispatch=2)
    res = eng.run_sweep_batched(
        "softening", [3.0, 6.0], 10, 256, 10**9,
        nmconfig=np.zeros(4, np.uint8), seed=5,
    )
    assert len(res) == 2
    assert all(r.frames == 256 for r in res)
    assert res[1].ber <= res[0].ber


def test_int32_counter_guard(code):
    with pytest.raises(ValueError, match="2\\^31"):
        make_engine(code, rounds_per_dispatch=10 ** 9)


@pytest.mark.parametrize("bps", [1, 2, 4])
def test_lane_flat_direct_llrs_match_reference_form(bps):
    """y_to_lappr_gray_bits (the [S, B] lane-flat direct-mode builder)
    is the same math as y_to_lappr_gray: per-bit values
    agree to float64 round-off on random samples, every M."""
    from qamreconciliation_jax.ops.llr import (
        y_to_lappr_gray, y_to_lappr_gray_bits,
    )

    pa = PAMAlphabet(bps, 2)
    rng = np.random.default_rng(7)
    S, B = 37, 8
    y_sb = rng.normal(0.0, 2.5, (S, B))
    two_var = 0.9
    ref = np.asarray(y_to_lappr_gray(
        jnp.asarray(y_sb.T), pa.constellation, two_var, jnp.float64
    ))                                           # [B, S*bps]
    new = np.asarray(y_to_lappr_gray_bits(
        jnp.asarray(y_sb), pa.constellation, jnp.float64(two_var),
        jnp.float64,
    ))                                           # [bps, S, B]
    # interleave to the reference's [B, S*bps] per-symbol-contiguous order
    new_bn = new.transpose(2, 1, 0).reshape(B, -1)
    np.testing.assert_allclose(new_bn, ref, rtol=1e-12, atol=1e-12)


def test_lane_flat_direct_llrs_finite_at_high_snr():
    """Underflow guard: at very high SNR a tail sample can underflow one
    Gray group's exponentials against the shared max; the lane-flat
    builder must stay FINITE (saturating), never +/-inf/NaN, and must
    agree with the reference form wherever the reference is moderate."""
    from qamreconciliation_jax.ops.llr import (
        y_to_lappr_gray, y_to_lappr_gray_bits,
    )

    pa = PAMAlphabet(4, 2)
    y_sb = np.array([[1.6], [14.9], [-15.2], [0.05]])
    two_var = 0.02
    new = np.asarray(y_to_lappr_gray_bits(
        jnp.asarray(y_sb, jnp.float32), pa.constellation,
        jnp.float32(two_var), jnp.float32,
    ))
    assert np.isfinite(new).all(), new
    ref = np.asarray(y_to_lappr_gray(
        jnp.asarray(y_sb.T, jnp.float32), pa.constellation, two_var,
        jnp.float32,
    ))
    new_bn = new.transpose(2, 1, 0).reshape(1, -1)
    moderate = np.abs(ref) < 80.0
    np.testing.assert_allclose(
        new_bn[moderate], ref[moderate], rtol=1e-4, atol=1e-3
    )
    # saturated entries keep the reference's SIGN
    sat = ~moderate & np.isfinite(ref)
    assert (np.sign(new_bn[sat]) == np.sign(ref[sat])).all()
