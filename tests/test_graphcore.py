"""Native graphcore runtime: CSV parser + scalar decoder oracle parity.

The native scalar decoder implements the reference's exact algorithm
(reference: qamreconciliation/decoder.pyx:391-455); here it is cross-validated
against the batched JAX decoder — mirroring how the reference validates its
compiled decoder against the pure-Python oracle (SURVEY.md §4).
"""

import numpy as np
import pytest

from qamreconciliation_jax.models.decoder import Decoder
from qamreconciliation_jax.models.matrix import Matrix
from qamreconciliation_jax.utils import edgefile

graphcore = pytest.importorskip(
    "qamreconciliation_jax._graphcore",
    reason="no C++ toolchain on this host",
)


@pytest.fixture(scope="module")
def small_code():
    return edgefile.make_regular_ldpc(256, dv=3, dc=6, seed=3)


def test_csv_parse_matches_numpy(tmp_path, small_code):
    vid, cid = small_code
    path = str(tmp_path / "code.csv")
    edgefile.save_edge_csv(path, vid, cid)
    eid_n, cid_n, vid_n = (
        np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.int64, ndmin=2).T
    )
    eid_c, cid_c, vid_c = graphcore.load_edge_csv(path)
    np.testing.assert_array_equal(eid_c, eid_n)
    np.testing.assert_array_equal(cid_c, cid_n)
    np.testing.assert_array_equal(vid_c, vid_n)
    # load_edge_csv applies the first-row convention on top of either parser
    v2, c2 = edgefile.load_edge_csv(path)
    np.testing.assert_array_equal(v2, vid)
    np.testing.assert_array_equal(c2, cid)


def test_syndrome_parity(small_code):
    vid, cid = small_code
    sd = graphcore.ScalarDecoder(vid, cid)
    mat = Matrix(vid, cid)
    rng = np.random.default_rng(0)
    word = rng.integers(0, 2, sd.vnum)
    np.testing.assert_array_equal(
        sd.eval_syndrome(word.astype(np.uint8)),
        np.asarray(mat.eval_syndrome(word[None, :]))[0],
    )


def test_decode_parity_with_jax_decoder(small_code):
    """success/iters bit-identical, final LLRs close, over random decodes."""
    vid, cid = small_code
    sd = graphcore.ScalarDecoder(vid, cid)
    dec = Decoder(vid, cid, dtype="float64")
    rng = np.random.default_rng(7)
    n_match = 0
    for _ in range(10):
        word = rng.integers(0, 2, sd.vnum).astype(np.uint8)
        synd = sd.eval_syndrome(word)
        llr = (1 - 2 * word.astype(np.float64)) * 4.0 + rng.normal(
            0, 3.0, sd.vnum
        )
        s_c, i_c, f_c = sd.decode(llr, synd, 30)
        s_j, i_j, f_j = dec.decode(llr, synd, 30)
        assert s_c == s_j
        assert i_c == i_j
        np.testing.assert_allclose(f_c, f_j, rtol=1e-8, atol=1e-8)
        n_match += s_c
    assert 0 < n_match  # at least some decodes succeed at this noise level


def test_decode_consistent_input_passthrough(small_code):
    """iters == 0 and LLR passthrough for an already-consistent input
    (reference: qamreconciliation/decoder.pyx:402-405)."""
    vid, cid = small_code
    sd = graphcore.ScalarDecoder(vid, cid)
    rng = np.random.default_rng(1)
    word = rng.integers(0, 2, sd.vnum).astype(np.uint8)
    synd = sd.eval_syndrome(word)
    llr = (1 - 2 * word.astype(np.float64)) * 5.0
    success, iters, final = sd.decode(llr, synd, 30)
    assert success and iters == 0
    np.testing.assert_array_equal(final, llr)


def test_decode_failure_semantics(small_code):
    """success=0 with iters == max_iterations on failure."""
    vid, cid = small_code
    sd = graphcore.ScalarDecoder(vid, cid)
    rng = np.random.default_rng(2)
    word = rng.integers(0, 2, sd.vnum).astype(np.uint8)
    synd = sd.eval_syndrome(word)
    llr = rng.normal(0, 1.0, sd.vnum)  # pure noise: hopeless
    success, iters, _ = sd.decode(llr, synd, 5)
    if not success:
        assert iters == 5
