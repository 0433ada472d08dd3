"""Pure-numpy oracle decoder: three-way parity with the device + native decoders."""

import numpy as np
import pytest

from qamreconciliation_jax import Decoder
from qamreconciliation_jax.models.decoder_np import DecoderNp
from qamreconciliation_jax.utils import make_regular_ldpc


@pytest.fixture(scope="module")
def code():
    return make_regular_ldpc(96, 3, 6, seed=13)


def test_three_way_decoder_parity(code):
    vid, cid = code
    np_dec = DecoderNp(vid, cid)
    jx_dec = Decoder(vid, cid, dtype="float64")
    rng = np.random.default_rng(21)
    agree = 0
    for _ in range(8):
        word = rng.integers(0, 2, np_dec.vnum)
        synd = np_dec.eval_syndrome(word)
        llr = (1 - 2 * word) * 3.5 + rng.normal(0, 2.5, np_dec.vnum)
        s_np, i_np, f_np = np_dec.decode(llr, synd, 25)
        s_jx, i_jx, f_jx = jx_dec.decode(llr, synd, 25)
        assert s_np == s_jx
        assert i_np == i_jx
        # tanh form vs phi form agree to float64 working precision
        np.testing.assert_allclose(f_np, f_jx, rtol=1e-6, atol=1e-6)
        agree += s_np
    assert agree > 0


def test_numpy_decoder_consistency_semantics(code):
    vid, cid = code
    dec = DecoderNp(vid, cid)
    rng = np.random.default_rng(5)
    word = rng.integers(0, 2, dec.vnum)
    synd = dec.eval_syndrome(word)
    llr = (1 - 2 * word) * 6.0
    success, iters, final = dec.decode(llr, synd, 10)
    assert success and iters == 0
    np.testing.assert_array_equal(final, llr)
    # hopeless input: success=False, iters == max
    success, iters, _ = dec.decode(rng.normal(0, 0.5, dec.vnum), synd, 4)
    if not success:
        assert iters == 4


def test_first_row_convention(code):
    vid, cid = code
    E = vid.size
    vid2 = np.concatenate([[E], vid])
    cid2 = np.concatenate([[dec_c := int(cid.max()) + 1], cid])
    dec = DecoderNp(vid2, cid2, num_data_first_row=True)
    assert dec.ednum == E
    assert dec.cnum == int(cid.max()) + 1
