"""QAM = I/Q PAM factoring: sampling, bit layout, end-to-end reconciliation."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qamreconciliation_jax import Decoder, Matrix, PAMAlphabet
from qamreconciliation_jax.models.noisemapper import NoiseMapper
from qamreconciliation_jax.models.qam import QAMAlphabet
from qamreconciliation_jax.utils import make_regular_ldpc


def test_rejects_odd_bps():
    with pytest.raises(ValueError):
        QAMAlphabet(3, 2.0)


def test_constellation_and_variance():
    qam = QAMAlphabet(4, 2.0)          # 16-QAM = 4-PAM x 4-PAM
    assert qam.order == 16
    assert qam.variance == pytest.approx(2 * qam.pam.variance)
    key = jax.random.key(0)
    iq = qam.random_symbols(key, (2048,))
    y = qam.index_to_value(iq)
    assert y.dtype == jnp.complex64
    # empirical symbol energy ~ Es
    es = float(jnp.mean(jnp.abs(y) ** 2))
    assert es == pytest.approx(qam.variance, rel=0.1)


def test_bit_layout_roundtrip():
    qam = QAMAlphabet(4, 2.0)
    i_idx = jnp.asarray([[0, 1, 2, 3]])
    q_idx = jnp.asarray([[3, 2, 1, 0]])
    bits = np.asarray(qam.demap_symbols_to_bits((i_idx, q_idx)))
    s2b = qam.pam.s_to_b
    expect = []
    for i, q in zip([0, 1, 2, 3], [3, 2, 1, 0]):
        expect.extend(list(s2b[i]) + list(s2b[q]))
    np.testing.assert_array_equal(bits[0], np.asarray(expect, np.uint8))


def test_interleave_matches_demap_layout():
    qam = QAMAlphabet(4, 2.0)
    rng = np.random.default_rng(0)
    S = 16
    li = jnp.asarray(rng.normal(0, 1, (2, S * 2)))
    lq = jnp.asarray(rng.normal(0, 1, (2, S * 2)))
    out = np.asarray(qam.interleave_llrs(li, lq))
    assert out.shape == (2, S * 4)
    # symbol 0: first 2 entries from I, next 2 from Q
    np.testing.assert_array_equal(out[0, :2], np.asarray(li)[0, :2])
    np.testing.assert_array_equal(out[0, 2:4], np.asarray(lq)[0, :2])


def test_qam_softening_reconciliation_end_to_end():
    """Full 16-QAM reverse reconciliation via two PAM quadrature pipelines."""
    n = 240
    vid, cid = make_regular_ldpc(n, 3, 6, seed=19)
    dec = Decoder(vid, cid, dtype=jnp.float64)
    mat = Matrix(vid, cid)
    qam = QAMAlphabet(4, 2.0)
    snr_db = 16.0                      # per-symbol Es/N0 (16-QAM needs more)
    N0 = qam.variance * 10 ** (-snr_db / 10) / 2
    nm = NoiseMapper(qam.pam, N0 / 2, dtype=jnp.float64)  # per-quadrature var

    key = jax.random.key(5)
    B = 8
    S = n // qam.bit_per_symbol        # complex symbols per frame
    kx, kn = jax.random.split(key)
    iq = qam.random_symbols(kx, (B, S))
    y = qam.awgn(kn, qam.index_to_value(iq, jnp.float64), N0, jnp.float64)

    # Bob: per-quadrature hard decisions + softening
    yi, yq = qam.quadrature_streams(y)
    xi_hat = nm.hard_decide_index(yi)
    xq_hat = nm.hard_decide_index(yq)
    word = np.asarray(qam.demap_symbols_to_bits((xi_hat, xq_hat)))
    synd = np.asarray(mat.eval_syndrome(word))
    ni = nm.map_noise(yi, xi_hat)
    nq = nm.map_noise(yq, xq_hat)

    # Alice: per-quadrature LLRs from her own symbols, interleaved
    li = nm.demap_lappr_array(ni, iq[0], mode="interp")
    lq = nm.demap_lappr_array(nq, iq[1], mode="interp")
    lappr = qam.interleave_llrs(li, lq)

    success, iters, final = dec.decode_batch(lappr, synd, 30)
    assert bool(jnp.all(success))
    hard = (np.asarray(final) < 0).astype(np.uint8)
    np.testing.assert_array_equal(hard, word)
