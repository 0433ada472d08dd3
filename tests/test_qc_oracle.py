"""QC decoder paths against the float64 numpy oracle and each other.

The dense flooding loop (models/qc_decoder._build_dense) is checked against
models/decoder_np.DecoderNp — an independent tanh-form sum-product decoder
— on the code shapes real standards have: regular, irregular QC-IRA
(mixed check degrees, parallel circulants), rate-3/4 IRA (wide rows) and a
lifting size that is no power of two.  Convergence semantics per
reference: qamreconciliation/decoder.pyx:391-436.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from qamreconciliation_jax import Matrix
from qamreconciliation_jax.models.decoder_np import DecoderNp
from qamreconciliation_jax.models.qc_decoder import (
    QCDecoder, make_qc_ira, make_qc_ldpc,
)

CODES = {
    "regular": lambda: (make_qc_ldpc(nb_v=12, z=16, dv=3, dc=6, seed=4), 16),
    "ira": lambda: (make_qc_ira(nb_info=8, nb_acc=4, z=16, dv=3, seed=2), 16),
    "rate34": lambda: (make_qc_ira(nb_info=9, nb_acc=3, z=16, dv=3, seed=5),
                       16),
    "odd_z": lambda: (make_qc_ldpc(nb_v=12, z=13, dv=3, dc=6, seed=8), 13),
}


def _frames(vid, cid, V, B, seed, noise):
    rng = np.random.default_rng(seed)
    word = rng.integers(0, 2, (B, V))
    synd = np.array(Matrix(vid, cid).eval_syndrome(word))
    llr = (1 - 2 * word) * 3.0 + rng.normal(0, noise, (B, V))
    return llr, synd


def _oracle(vid, cid, llr, synd, maxiter):
    ref = DecoderNp(vid, cid)
    out = [ref.decode(l, s, maxiter) for l, s in zip(llr, synd)]
    return (np.array([o[0] for o in out]), np.array([o[1] for o in out]),
            np.stack([o[2] for o in out]))


def _assert_matches_oracle(got, want):
    """(success, iters) exact; identical hard decisions; final LLRs to
    float64 tolerance below the oracle's tanh clip (|LLR| ~ 38)."""
    (s1, i1, f1), (s2, i2, f2) = got, want
    np.testing.assert_array_equal(np.asarray(s1), s2)
    np.testing.assert_array_equal(np.asarray(i1), i2)
    f1 = np.asarray(f1)
    np.testing.assert_array_equal(f1 < 0, f2 < 0)
    m = np.abs(f2) < 30.0
    np.testing.assert_allclose(f1[m], f2[m], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("code", sorted(CODES))
def test_dense_matches_numpy_oracle(code):
    (base, vid, cid), z = CODES[code]()
    dec = QCDecoder(base, z, dtype=jnp.float64)
    # the rate-3/4 code needs a cleaner channel to converge at all
    noise = 1.2 if code == "rate34" else 2.0
    llr, synd = _frames(vid, cid, dec.vnum, B=6, seed=7, noise=noise)
    got = dec.decode_batch(llr, synd, 30)
    _assert_matches_oracle(got, _oracle(vid, cid, llr, synd, 30))
    assert 0 < int(np.asarray(got[0]).sum())


@pytest.mark.parametrize("maxiter", [0, 1, 7])
def test_dense_maxiter_and_passthrough(maxiter):
    """Failed frames return their totals at exactly ``maxiter``; a
    consistent input passes through with iters == 0 (reference:
    decoder.pyx:402-405)."""
    (base, vid, cid), z = CODES["ira"]()
    dec = QCDecoder(base, z, dtype=jnp.float64)
    llr, synd = _frames(vid, cid, dec.vnum, B=6, seed=9, noise=3.0)
    word = (llr[:2] < 0).astype(np.int64)          # two consistent frames
    synd[:2] = np.asarray(Matrix(vid, cid).eval_syndrome(word))
    got = dec.decode_batch(llr, synd, maxiter)
    _assert_matches_oracle(got, _oracle(vid, cid, llr, synd, maxiter))
    assert np.asarray(got[0])[:2].all()
    np.testing.assert_array_equal(np.asarray(got[1])[:2], 0)
    np.testing.assert_array_equal(np.asarray(got[2])[:2], llr[:2])


def test_dense_sumproduct_tanhfb_equivalence(fused_check):
    """check_phi="tanhfb" on the DENSE path (XLA, then the fused check-
    phase kernel): same success/iters as the phi form on these frames,
    LLRs close below the tanhfb saturation."""
    (base, vid, cid), z = CODES["regular"]()
    phi = QCDecoder(base, z, dtype=jnp.bfloat16)
    llr, synd = _frames(vid, cid, phi.vnum, B=8, seed=13, noise=2.0)
    s1, i1, f1 = phi.decode_batch(llr, synd, 25)
    for fused in (False, True):
        if fused:
            fused_check()
        fb = QCDecoder(base, z, dtype=jnp.bfloat16, check_phi="tanhfb")
        s2, i2, f2 = fb.decode_batch(llr, synd, 25)
        np.testing.assert_array_equal(np.asarray(s1), np.asarray(s2))
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
        a = np.asarray(f1, np.float32)
        b = np.asarray(f2, np.float32)
        m = (np.abs(a) < 14.0) & (np.abs(b) < 14.0)
        assert m.mean() > 0.5
        np.testing.assert_allclose(a[m], b[m], rtol=0.05, atol=0.3)


def test_generic_decoder_tanhfb_equivalence():
    """check_phi="tanhfb" on the GENERIC gather decoder (padded slots
    riding the large sentinel): same success/iters as the phi form, LLRs
    close below saturation."""
    from qamreconciliation_jax.models.decoder import Decoder
    from qamreconciliation_jax.utils.edgefile import make_regular_ldpc

    vid, cid = make_regular_ldpc(192, dv=3, dc=6, seed=9)
    llr, synd = _frames(vid, cid, 192, B=8, seed=21, noise=2.0)
    phi = Decoder(vid, cid, dtype=jnp.bfloat16)
    fb = Decoder(vid, cid, dtype=jnp.bfloat16, check_phi="tanhfb")
    s1, i1, f1 = phi.decode_batch(llr, synd, 25)
    s2, i2, f2 = fb.decode_batch(llr, synd, 25)
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(s2))
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    a = np.asarray(f1, np.float32)
    b = np.asarray(f2, np.float32)
    m = (np.abs(a) < 14.0) & (np.abs(b) < 14.0)
    assert m.mean() > 0.5
    np.testing.assert_allclose(a[m], b[m], rtol=0.05, atol=0.3)
