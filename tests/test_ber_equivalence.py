"""End-to-end BER/FER statistical equivalence (SURVEY.md §4 test tier).

The batched JAX engine and the independent float64 oracle chain
(numpy softening pipeline -> native C++ scalar decoder) simulate the same
(code, alphabet, SNR) configuration with different RNGs; their BER estimates
must agree within joint Monte-Carlo error bars.
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest

from qamreconciliation_jax import Decoder, Matrix, PAMAlphabet
from qamreconciliation_jax.models.noisemapper import NoiseMapper
from qamreconciliation_jax.sims.engine import ReconciliationEngine
from qamreconciliation_jax.utils import make_regular_ldpc
from qamreconciliation_jax.utils.reference_np import softening_frames_np

graphcore = pytest.importorskip(
    "qamreconciliation_jax._graphcore",
    reason="no C++ toolchain on this host",
)


def test_softening_ber_matches_oracle_chain():
    n, snr_db, maxiter = 512, 4.0, 30
    vid, cid = make_regular_ldpc(n, 3, 6, seed=17)
    pa = PAMAlphabet(2, 2.0)
    N0 = pa.variance * 10 ** (-snr_db / 10) / 2

    # --- engine estimate (float64 so dtype is not a confounder) ----------
    dec = Decoder(vid, cid, dtype=jnp.float64)
    mat = Matrix(vid, cid)
    eng = ReconciliationEngine(
        dec, mat, pa, batch=64, dtype=jnp.float64, llr_mode="interp"
    )
    frames_eng = 512
    r = eng.run_point("softening", snr_db, maxiter, frames_eng, 10 ** 9,
                      nmconfig=np.zeros(4, np.uint8), seed=3)
    K = eng.K

    # --- oracle chain estimate -------------------------------------------
    nm = NoiseMapper(pa, N0, dtype=jnp.float64)
    sd = graphcore.ScalarDecoder(vid, cid)
    frames_ora = 256
    lappr, word = softening_frames_np(nm, pa, frames_ora, eng.N_symb, seed=11)
    errs = 0
    for f in range(frames_ora):
        synd = sd.eval_syndrome(word[f])
        _, _, final = sd.decode(lappr[f], synd, maxiter)
        errs += int(np.sum((final[:K] < 0).astype(np.uint8) != word[f, :K]))
    ber_ora = errs / (frames_ora * K)

    # --- agreement within joint Monte-Carlo error ------------------------
    # BER samples are correlated within a frame; use a conservative
    # per-frame-error normal bound on the frame-averaged BER.
    def frame_std(ber, frames):
        return math.sqrt(max(ber * (1 - ber), 1e-6) / frames) * 3.0

    tol = 4.0 * (frame_std(r.ber, frames_eng) + frame_std(ber_ora, frames_ora))
    assert abs(r.ber - ber_ora) < max(tol, 0.02), (r.ber, ber_ora, tol)
    # both see a partially-failing operating point (not degenerate 0/0.5)
    assert 0.0 <= r.ber < 0.4
    assert 0.0 <= ber_ora < 0.4
