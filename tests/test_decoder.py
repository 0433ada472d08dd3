"""Decoder tests, mirroring the reference's test strategy (SURVEY.md §4)
plus the batched/multi-frame tiers the reference lacks."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qamreconciliation_jax import Decoder, Matrix
from qamreconciliation_jax.ops.boxplus import box_plus, phi_llr
from qamreconciliation_jax.utils import load_edge_csv, make_regular_ldpc

HAMMING_CSV = os.path.join(os.path.dirname(__file__), "data", "hamming_7-4.csv")


# --------------------------------------------------------------------- #
# Construction + check functions (cf. reference test/test_decoder.py:8-128)

@pytest.fixture
def small_decoder():
    # 3 vars, 2 checks, 4 edges
    vid = np.array([0, 1, 1, 2])
    cid = np.array([0, 0, 1, 1])
    return Decoder(vid, cid, dtype=jnp.float64)


def test_counts(small_decoder):
    assert small_decoder.cnum == 2
    assert small_decoder.vnum == 3
    assert small_decoder.ednum == 4


def test_check_synd_node(small_decoder):
    d = small_decoder
    synd0, synd1 = [1, 1], [0, 1]
    words_ok0 = [[1, 0, 1], [0, 1, 0]]
    words_ok1 = [[0, 0, 1], [1, 1, 0]]
    for w in words_ok0:
        assert d.check_synd_node(0, w, synd0)
        assert d.check_synd_node(1, w, synd0)
        assert not d.check_synd_node(0, w, synd1)
        assert d.check_synd_node(1, w, synd1)
    for w in words_ok1:
        assert d.check_synd_node(0, w, synd1)
        assert d.check_synd_node(1, w, synd1)
        assert not d.check_synd_node(0, w, synd0)
        assert d.check_synd_node(1, w, synd0)


def test_check_word(small_decoder):
    d = small_decoder
    assert d.check_word([1, 0, 1], [1, 1])
    assert d.check_word([0, 1, 0], [1, 1])
    assert d.check_word([0, 0, 1], [0, 1])
    assert not d.check_word([1, 0, 1], [0, 1])
    assert not d.check_word([0, 0, 1], [1, 1])


def test_check_lappr(small_decoder):
    d = small_decoder
    # bit = 1 iff lappr < 0
    assert d.check_lappr(np.array([-3.4, 0.8, -0.1]), [1, 1])
    assert not d.check_lappr(np.array([-3.4, 0.8, -0.1]), [0, 1])
    assert d.check_lappr(np.array([-0.77, -0.8, 0.98]), [0, 1])
    assert not d.check_lappr(np.array([-0.77, -0.8, 0.98]), [1, 1])


# --------------------------------------------------------------------- #
# Single-node message updates vs closed form
# (cf. reference test/test_decoder.py:132-220)

@pytest.fixture
def proc_decoder():
    # 5 vars, 3 checks, 8 edges
    cid = np.array([0, 0, 0, 1, 1, 2, 2, 2])
    vid = np.array([0, 1, 3, 1, 2, 1, 3, 4])
    return Decoder(vid, cid, dtype=jnp.float64)


def test_process_var_node(proc_decoder):
    rng = np.random.default_rng(1)
    d = proc_decoder
    c2v = rng.standard_normal(d.ednum)
    v2c = rng.standard_normal(d.ednum)
    prior = rng.standard_normal(d.vnum)
    upd = np.empty(d.vnum)

    # degree 3 (var 1: edges 1, 3, 5)
    v2c1, upd1 = d.process_var_node(1, prior, c2v, v2c, upd)
    t = prior[1] + c2v[1] + c2v[3] + c2v[5]
    np.testing.assert_allclose(upd1[1], t, rtol=1e-12)
    np.testing.assert_allclose(v2c1[1], t - c2v[1], rtol=1e-12)
    np.testing.assert_allclose(v2c1[3], t - c2v[3], rtol=1e-12)
    np.testing.assert_allclose(v2c1[5], t - c2v[5], rtol=1e-12)

    # degree 1 (var 2: edge 4)
    v2c2, upd2 = d.process_var_node(2, prior, c2v, v2c, upd)
    np.testing.assert_allclose(v2c2[4], prior[2], rtol=1e-12)
    np.testing.assert_allclose(upd2[2], prior[2] + c2v[4], rtol=1e-12)

    # degree 2 (var 3: edges 2, 6)
    v2c3, upd3 = d.process_var_node(3, prior, c2v, v2c, upd)
    np.testing.assert_allclose(v2c3[2], prior[3] + c2v[6], rtol=1e-12)
    np.testing.assert_allclose(v2c3[6], prior[3] + c2v[2], rtol=1e-12)


def test_process_check_node_vs_tanh(proc_decoder):
    rng = np.random.default_rng(2)
    d = proc_decoder
    c2v = rng.standard_normal(d.ednum)
    v2c = rng.standard_normal(d.ednum)
    s = np.array([1, 0, 1])

    # degree 2 (check 1: edges 3, 4)
    out = d.process_check_node(1, s, c2v, v2c)
    pre = -2.0 if s[1] else 2.0
    np.testing.assert_allclose(out[3], pre * v2c[4] / 2, rtol=1e-6)
    np.testing.assert_allclose(out[4], pre * v2c[3] / 2, rtol=1e-6)

    # degree 3 (check 2: edges 5, 6, 7)
    out = d.process_check_node(2, s, c2v, v2c)
    pre = -2.0 if s[2] else 2.0
    np.testing.assert_allclose(
        out[5], pre * np.arctanh(np.tanh(v2c[6] / 2) * np.tanh(v2c[7] / 2)),
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        out[6], pre * np.arctanh(np.tanh(v2c[5] / 2) * np.tanh(v2c[7] / 2)),
        rtol=1e-6,
    )


def test_boxplus_equals_tanh_form():
    rng = np.random.default_rng(3)
    a, b = rng.standard_normal(100), rng.standard_normal(100)
    expect = 2 * np.arctanh(np.tanh(a / 2) * np.tanh(b / 2))
    got = np.asarray(box_plus(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, expect, rtol=1e-9, atol=1e-12)


def test_phi_is_involution():
    x = np.linspace(1e-6, 40.0, 1000)
    y = np.asarray(phi_llr(jnp.asarray(x)))
    back = np.asarray(phi_llr(jnp.asarray(y)))
    np.testing.assert_allclose(back, x, rtol=1e-7, atol=1e-9)


def test_phi_check_update_equals_tanh_form():
    """The batched phi-domain check update must agree with the reference's
    box-plus semantics (tanh product form) for a degree-4 node."""
    rng = np.random.default_rng(4)
    cid = np.zeros(4, dtype=int)
    vid = np.arange(4)
    d = Decoder(vid, cid, dtype=jnp.float64)
    v2c = rng.standard_normal(4)
    for synd_bit in (0, 1):
        out = d.process_check_node(0, np.array([synd_bit]), np.zeros(4), v2c)
        # batched path: run one BP iteration manually via the graph
        from qamreconciliation_jax.ops.boxplus import check_node_update

        g = d.graph
        flat = jnp.asarray(v2c, jnp.float64).reshape(-1, 1)
        v2c_c = g.permute_v_to_c(flat)
        _, c_mask = g._masks("float64")
        synd = jnp.full((1, 1), synd_bit, jnp.int32)
        c2v_c = check_node_update(v2c_c, synd, c_mask)
        got = np.asarray(c2v_c).reshape(4)[np.argsort(g.chk_slot_of_edge)]
        np.testing.assert_allclose(got, out, rtol=1e-9, atol=1e-12)


# --------------------------------------------------------------------- #
# End-to-end decoding (cf. reference test/test_decoder.py:225-266)

@pytest.fixture
def hamming_decoder():
    vid, cid = load_edge_csv(HAMMING_CSV)
    return Decoder(vid, cid, dtype=jnp.float64)


def test_decode_consistent_input_passthrough(hamming_decoder):
    lappr = np.array([1.2, -0.8, -1.3, 1.1, -0.4, 0.5, 1.9])
    synd = np.array([1, 1, 0], dtype=np.uint8)
    success, iters, final = hamming_decoder.decode(lappr, synd, 20)
    assert success
    assert iters == 0
    np.testing.assert_array_equal(final, lappr)


def test_decode_corrects_one_unreliable_bit(hamming_decoder):
    lappr = np.array([1.05, -1.075, -1.0, 1.1, -0.4, 0.4, -0.2])
    synd = np.array([1, 1, 0], dtype=np.uint8)
    success, iters, final = hamming_decoder.decode(lappr, synd, 20)
    assert success
    assert 1 <= iters <= 20
    np.testing.assert_array_equal(
        (final < 0).astype(int), [0, 1, 1, 0, 1, 0, 0]
    )


def test_decode_failure_semantics(hamming_decoder):
    # An inconsistent syndrome with zero iterations allowed must report
    # failure with iters == max_iterations.
    lappr = np.array([1.05, -1.075, -1.0, 1.1, -0.4, 0.4, -0.2])
    synd = np.array([1, 1, 0], dtype=np.uint8)
    success, iters, final = hamming_decoder.decode(lappr, synd, 0)
    assert not success
    assert iters == 0


def test_batch_matches_single(hamming_decoder):
    rng = np.random.default_rng(5)
    B = 16
    lappr = rng.standard_normal((B, 7))
    synd = rng.integers(0, 2, size=(B, 3)).astype(np.uint8)
    succ_b, iters_b, final_b = hamming_decoder.decode_batch(lappr, synd, 20)
    for b in range(B):
        s, it, fin = hamming_decoder.decode(lappr[b], synd[b], 20)
        assert bool(succ_b[b]) == s
        assert int(iters_b[b]) == it
        np.testing.assert_allclose(np.asarray(final_b[b]), fin, rtol=1e-10)


def test_decode_regular_ldpc_awgn():
    """Statistical end-to-end test: a (3,6) code at high SNR decodes to the
    transmitted word on (almost) all frames."""
    vid, cid = make_regular_ldpc(256, 3, 6, seed=0)
    dec = Decoder(vid, cid, dtype=jnp.float64)
    mat = Matrix(vid, cid)
    rng = np.random.default_rng(7)
    B = 32
    word = rng.integers(0, 2, size=(B, dec.vnum))
    synd = np.asarray(mat.eval_syndrome(word))
    sigma = 0.5  # Eb/N0 ~ 9 dB at rate 1/2 BPSK
    y = (1 - 2 * word) + sigma * rng.standard_normal((B, dec.vnum))
    llr = 2 * y / sigma**2
    succ, iters, final = dec.decode_batch(llr, synd, 50)
    bits = (np.asarray(final) < 0).astype(int)
    assert np.asarray(succ).mean() >= 0.95
    ok = np.asarray(succ)
    np.testing.assert_array_equal(bits[ok], word[ok])


def test_f32_matches_f64_decisions():
    vid, cid = make_regular_ldpc(128, 3, 6, seed=1)
    dec64 = Decoder(vid, cid, dtype=jnp.float64)
    dec32 = Decoder(vid, cid, dtype=jnp.float32)
    mat = Matrix(vid, cid)
    rng = np.random.default_rng(11)
    B = 8
    word = rng.integers(0, 2, size=(B, dec64.vnum))
    synd = np.asarray(mat.eval_syndrome(word))
    y = (1 - 2 * word) + 0.6 * rng.standard_normal((B, dec64.vnum))
    llr = 2 * y / 0.36
    s64, _, f64v = dec64.decode_batch(llr, synd, 30)
    s32, _, f32v = dec32.decode_batch(llr.astype(np.float32), synd, 30)
    ok = np.asarray(s64) & np.asarray(s32)
    np.testing.assert_array_equal(
        (np.asarray(f64v)[ok] < 0), (np.asarray(f32v)[ok] < 0)
    )
