"""Sweep-wide compile reuse + numpy-oracle sanity.

The engine passes the NoiseMapper as a pytree argument with SNR-independent
table shapes (models/noisemapper.py), so one compiled round function must
serve every SNR point: a DVB-S2-size round compiles for tens of seconds.
"""

import math

import pytest

import numpy as np
import jax
import jax.numpy as jnp

from qamreconciliation_jax import Decoder, Matrix, PAMAlphabet
from qamreconciliation_jax.models.noisemapper import NoiseMapper
from qamreconciliation_jax.sims import ReconciliationEngine
from qamreconciliation_jax.sims.bitchannel import BitChannelEngine
from qamreconciliation_jax.utils import make_regular_ldpc


def _setup(n=120, dtype=jnp.float32):
    vid, cid = make_regular_ldpc(n, 3, 6, seed=2)
    return Decoder(vid, cid, dtype=dtype), Matrix(vid, cid), PAMAlphabet(2, 2.0)


def test_one_compile_serves_all_snr_points():
    dec, mat, pa = _setup()
    eng = ReconciliationEngine(dec, mat, pa, batch=8)
    for snr in [1.0, 3.0, 5.0]:
        eng.run_point("softening", snr, 10, 8, 10**9)
    assert list(eng._round_cache) == ["softening"]
    # the jitted round retraced exactly once across all three SNR points
    assert eng._round_cache["softening"]._cache_size() == 1


def test_one_compile_serves_flip_sign_configs():
    """Different sign_config VALUES (same shape) must not retrace."""
    dec, mat, pa = _setup()
    eng = ReconciliationEngine(dec, mat, pa, batch=8)
    base = np.zeros(pa.order, np.uint8)
    alt = base.copy()
    alt[1::2] = 1
    eng.run_point("softening", 4.0, 10, 8, 10**9, nmconfig=base)
    eng.run_point("softening", 4.0, 10, 8, 10**9, nmconfig=alt)
    assert eng._round_cache["softening"]._cache_size() == 1


def test_bitchannel_one_compile_per_flavor():
    dec, mat, _ = _setup()
    eng = BitChannelEngine(dec, mat, batch=8)
    for f in [0.01, 0.03, 0.05]:
        eng.run_bsc_point(f, 10, 8, 10**9)
    assert eng._round_cache["bsc"]._cache_size() == 1
    for snr in [1.0, 2.0]:
        eng.run_biawgn_point(snr, 10, 8, 10**9)
    assert eng._round_cache[("biawgn", False)]._cache_size() == 1


def test_noisemapper_is_pytree():
    pa = PAMAlphabet(2, 2.0)
    nm = NoiseMapper(pa, 0.5)
    leaves, treedef = jax.tree_util.tree_flatten(nm)
    assert len(leaves) > 10
    nm2 = jax.tree_util.tree_unflatten(treedef, leaves)
    # reconstructed instance supports the traced ops
    y = jnp.linspace(-4.0, 4.0, 64)
    np.testing.assert_allclose(
        np.asarray(nm2.F_Y(y)), np.asarray(nm.F_Y(y)), rtol=1e-6
    )
    idx = nm2.hard_decide_index(y)
    np.testing.assert_array_equal(
        np.asarray(idx), np.asarray(nm.hard_decide_index(y))
    )


def test_numpy_oracle_end_to_end_decodes():
    """Oracle-generated frames decode cleanly at high SNR: the float64 host
    pipeline and the device decoder agree on the Gray-word convention."""
    from qamreconciliation_jax.utils.reference_np import softening_frames_np

    dec, mat, pa = _setup(n=120, dtype=jnp.float64)
    snr = 10.0
    N0 = pa.variance * 10 ** (-snr / 10) / 2
    nm = NoiseMapper(pa, N0, dtype=jnp.float64)
    lappr, word = softening_frames_np(nm, pa, 4, 60, seed=3)
    assert lappr.shape == (4, 120) and word.shape == (4, 120)
    synd = np.asarray(mat.eval_syndrome(word))
    success, iters, final = dec.decode_batch(lappr, synd, 30)
    assert bool(jnp.all(success))
    hard = np.asarray(final) < 0
    np.testing.assert_array_equal(hard.astype(np.uint8), word)


def test_numpy_oracle_matches_device_llr_distribution():
    """Oracle LLR signs at moderate SNR mostly agree with Bob's word —
    basic direction/scale sanity for the host pipeline."""
    from qamreconciliation_jax.utils.reference_np import softening_frames_np

    pa = PAMAlphabet(2, 2.0)
    snr = 6.0
    N0 = pa.variance * 10 ** (-snr / 10) / 2
    nm = NoiseMapper(pa, N0, dtype=jnp.float64)
    lappr, word = softening_frames_np(nm, pa, 8, 256, seed=11)
    agree = np.mean((lappr < 0).astype(np.uint8) == word)
    assert agree > 0.9


def test_point_batched_sweep_matches_manual_vmap_lanes():
    """run_sweep_batched counters == manually replayed per-point rounds with
    the identical key construction (exact, not statistical)."""
    import jax

    dec, mat, pa = _setup()
    eng = ReconciliationEngine(dec, mat, pa, batch=8)
    snrs = [3.0, 4.5]
    res = eng.run_sweep_batched(
        "softening", snrs, 10, 16, 10**9,
        nmconfig=np.zeros(4, np.uint8), seed=7,
    )
    assert [r.snr_dB for r in res] == snrs

    body = eng._build_round_body("softening")
    key = jax.random.key(7)
    for p, snr in enumerate(snrs):
        N0 = pa.variance * 10 ** (-snr / 10) / 2
        nm = NoiseMapper(pa, N0, np.zeros(4, np.uint8), dtype=eng.dtype)
        nm._ensure_llr_poly()  # default poly-mode consumer: build before jit
        sigma = jnp.asarray(math.sqrt(N0), eng.dtype)
        alpha = jnp.asarray(1.0, eng.dtype)
        pk = jax.random.fold_in(key, p)
        errs = ferrs = 0
        for r in range(2):  # 16 loops / 8 per round
            out = jax.jit(body)(
                jax.random.fold_in(pk, r), jnp.int32(10), nm, sigma, alpha
            )
            errs += int(out[0])
            ferrs += int(out[1])
        got = res[p]
        assert got.frames == 16
        assert got.ber == pytest.approx(errs / (16 * eng.K))
        assert got.fer == pytest.approx(ferrs / 16)


def test_point_batched_sweep_direct_mode():
    """nm=None pytree path under vmap (direct mode)."""
    dec, mat, pa = _setup()
    eng = ReconciliationEngine(dec, mat, pa, batch=8)
    res = eng.run_sweep_batched("direct", [6.0, 8.0], 10, 8, 10**9)
    assert len(res) == 2
    assert all(0.0 <= r.ber <= 1.0 for r in res)


def test_lazy_llr_table_not_built_for_non_table_paths():
    """Flattening a NoiseMapper (jit arg) must NOT force the O(K*M^3) LLR
    table build; non-table consumers see a size-0 placeholder leaf."""
    pa = PAMAlphabet(4, 2.0)            # M=16: the expensive case
    nm = NoiseMapper(pa, 1.0)
    leaves, _ = jax.tree_util.tree_flatten(nm)
    assert nm._llr_tab is None          # still unbuilt after flatten
    assert any(l.size == 0 for l in leaves)
    # hard mode never needs it either
    dec, mat, _ = _setup()
    pa2 = PAMAlphabet(2, 2.0)
    eng = ReconciliationEngine(dec, mat, pa2, batch=8)
    eng.run_point("hard", 8.0, 10, 8, 10**9)
    # table mode builds it eagerly before the flatten
    r = eng.run_point("softening", 5.0, 10, 8, 10**9,
                      nmconfig=np.zeros(4, np.uint8))
    assert 0.0 <= r.ber <= 1.0


def test_point_batched_sweep_with_qc_decoder():
    """--point-batch composes with the QC roll decoder (run_sweep_batched
    vmaps the round over stacked NoiseMapper pytrees; the decoder rides in
    the closure regardless of its message-movement strategy)."""
    from qamreconciliation_jax.models.qc_decoder import QCDecoder, make_qc_ldpc

    base, vid, cid = make_qc_ldpc(12, 16, dv=3, dc=6, seed=4)
    dec = QCDecoder(base, 16)
    mat = Matrix(vid, cid)
    pa = PAMAlphabet(2, 2.0)
    eng = ReconciliationEngine(dec, mat, pa, batch=8)
    snrs = [4.0, 5.0]
    res = eng.run_sweep_batched(
        "softening", snrs, 15, 16, 10**9,
        nmconfig=np.zeros(4, np.uint8), seed=3,
    )
    assert [r.snr_dB for r in res] == snrs
    for r in res:
        assert r.frames == 16 and 0.0 <= r.ber <= 1.0
        assert r.fer >= r.ber  # a frame error needs >= 1 bit error


def test_point_batched_sweep_with_layered_schedule():
    """--point-batch also composes with the layered (serial-C) schedule:
    the chunked while_loop + per-sweep DUS updates vmap cleanly over the
    stacked SNR-point axis."""
    from qamreconciliation_jax.models.qc_decoder import QCDecoder, make_qc_ldpc

    base, vid, cid = make_qc_ldpc(12, 16, dv=3, dc=6, seed=4)
    dec = QCDecoder(base, 16, schedule="layered", check_rule="minsum")
    mat = Matrix(vid, cid)
    pa = PAMAlphabet(2, 2.0)
    eng = ReconciliationEngine(dec, mat, pa, batch=8)
    snrs = [4.0, 5.5]
    res = eng.run_sweep_batched(
        "softening", snrs, 15, 16, 10**9,
        nmconfig=np.zeros(4, np.uint8), seed=3,
    )
    assert [r.snr_dB for r in res] == snrs
    for r in res:
        assert r.frames == 16 and 0.0 <= r.ber <= 1.0
    assert res[1].ber <= res[0].ber  # higher SNR decodes no worse
