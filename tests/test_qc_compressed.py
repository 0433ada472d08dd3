"""Compressed-state min-sum QC decoder: bit-parity with the dense path.

The compressed loop (models/qc_decoder.py:_build_compressed) stores each
check's messages as (m1, m2, argmin, packed signs) instead of the dense
c2v [nb_c, dc, z, B] array.  Min-sum magnitudes are selections, so the
reconstruction is exact: success/iters must be bit-identical and the final
LLRs equal to the dense min-sum decoder, which also subtracts
bf16-stored operands in f32.  Convergence semantics per
reference: qamreconciliation/decoder.pyx:391-436.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from qamreconciliation_jax import Matrix, PAMAlphabet
from qamreconciliation_jax.models.qc_decoder import QCDecoder, make_qc_ldpc
from qamreconciliation_jax.sims import ReconciliationEngine


@pytest.fixture(scope="module")
def qc():
    base, vid, cid = make_qc_ldpc(nb_v=12, z=16, dv=3, dc=6, seed=4)
    return base, vid, cid


def _frames(qc, B, seed=1, noise=2.0):
    base, vid, cid = qc
    mat = Matrix(vid, cid)
    rng = np.random.default_rng(seed)
    V = 12 * 16
    word = rng.integers(0, 2, (B, V))
    synd = np.asarray(mat.eval_syndrome(word))
    llr = (1 - 2 * word) * 3.0 + rng.normal(0, noise, (B, V))
    return llr, synd


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_compressed_matches_dense_minsum(qc, dtype):
    """(success, iters) bit-identical, final LLRs identical, vs the dense
    min-sum decoder: both paths subtract bf16-stored operands in f32."""
    base, vid, cid = qc
    dense = QCDecoder(base, 16, dtype=dtype, check_rule="minsum",
                      compressed=False)
    comp = QCDecoder(base, 16, dtype=dtype, check_rule="minsum",
                     compressed=True)
    llr, synd = _frames(qc, B=8)
    s1, i1, f1 = dense.decode_batch(llr, synd, 30)
    s2, i2, f2 = comp.decode_batch(llr, synd, 30)
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(s2))
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_array_equal(
        np.asarray(f1, np.float32), np.asarray(f2, np.float32)
    )
    assert int(np.asarray(s1).sum()) > 0       # some frames converge
    assert int(np.asarray(s1).sum()) < 8 or int(np.asarray(i1).max()) > 0


def test_compressed_consistent_input_passthrough(qc):
    """iters == 0 and LLR passthrough for an already-consistent input
    (reference: qamreconciliation/decoder.pyx:402-405)."""
    base, vid, cid = qc
    comp = QCDecoder(base, 16, dtype=jnp.float32, check_rule="minsum",
                     compressed=True)
    llr, synd = _frames(qc, B=4, noise=0.0)    # noiseless: consistent
    s, i, f = comp.decode_batch(llr, synd, 30)
    assert bool(np.asarray(s).all())
    np.testing.assert_array_equal(np.asarray(i), 0)
    np.testing.assert_allclose(np.asarray(f, np.float32),
                               np.asarray(llr, np.float32))


def test_compressed_requires_minsum(qc):
    base, vid, cid = qc
    dec = QCDecoder(base, 16, check_rule="sumproduct", compressed=True)
    with pytest.raises(ValueError, match="minsum"):
        dec._build()


def test_compressed_engine_drop_in(qc):
    """Compressed decoder drives the reconciliation engine end-to-end."""
    base, vid, cid = qc
    dec = QCDecoder(base, 16, check_rule="minsum", compressed=True)
    mat = Matrix(vid, cid)
    pa = PAMAlphabet(2, 2.0)
    eng = ReconciliationEngine(dec, mat, pa, batch=8)
    r = eng.run_point("softening", 4.5, 20, 16, 10**9,
                      nmconfig=np.zeros(4, np.uint8))
    assert 0.0 <= r.ber <= 1.0 and r.frames == 16
