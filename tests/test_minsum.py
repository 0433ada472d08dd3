"""Normalized min-sum check rule (extension, opt-in check_rule="minsum").

The reference implements exact sum-product only
(reference: qamreconciliation/decoder.pyx:322-369); normalized min-sum
(magnitude = 13/16 * min over the OTHER slots, identical sign rule +
syndrome prefactor) is this framework's transcendental-free fast path.
These tests pin: the tie-correct extrinsic-min decomposition, sign parity
with the sum-product rule, XLA/Pallas-kernel agreement in both layouts,
and end-to-end decoding on both decoders.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from qamreconciliation_jax.ops.boxplus import (
    MINSUM_ALPHA,
    check_node_minsum,
    check_node_minsum_sm,
    check_node_update_sm,
    minsum_extrinsic_mag,
)


def brute_extrinsic_min(m):
    """Per-slot min over the other slots of axis 0 (numpy oracle)."""
    dc = m.shape[0]
    out = np.empty_like(m)
    for d in range(dc):
        out[d] = np.min(np.delete(m, d, axis=0), axis=0)
    return out


def test_extrinsic_min_matches_bruteforce():
    rng = np.random.default_rng(0)
    m = np.abs(rng.normal(0, 3, (6, 40, 8))).astype(np.float32)
    got = np.asarray(minsum_extrinsic_mag(jnp.asarray(m), 0))
    np.testing.assert_array_equal(got, brute_extrinsic_min(m))


def test_extrinsic_min_tie_correct():
    # two slots tied at the global min: EVERY slot's extrinsic min is the
    # tied value (the naive where(m==min1, min2, min1) gets this wrong)
    m = np.array([[1.0], [1.0], [3.0], [4.0]], np.float32)[:, :, None]
    got = np.asarray(minsum_extrinsic_mag(jnp.asarray(m), 0))
    np.testing.assert_array_equal(got, brute_extrinsic_min(m))
    assert got[2, 0, 0] == 1.0 and got[0, 0, 0] == 1.0


def test_minsum_signs_match_sumproduct():
    """Min-sum changes ONLY the magnitude rule: signs (incl. the syndrome
    prefactor and padded-slot masking) must match the phi form exactly."""
    rng = np.random.default_rng(1)
    dc, C, B = 5, 30, 4
    v2c = jnp.asarray(rng.normal(0, 2, (dc, C, B)), jnp.float64)
    synd = jnp.asarray(rng.integers(0, 2, (C, B)), jnp.int32)
    mask = np.ones((dc, C))
    mask[-1, ::3] = 0.0   # padded slots on every third check
    mask = jnp.asarray(mask, jnp.float64)
    ms = np.asarray(check_node_minsum_sm(v2c, synd, mask))
    sp = np.asarray(check_node_update_sm(v2c, synd, mask))
    np.testing.assert_array_equal(np.sign(ms), np.sign(sp))
    # magnitude = alpha * extrinsic min of the REAL slots
    big = np.where(np.asarray(mask)[:, :, None] > 0,
                   np.abs(np.asarray(v2c)), 1e30)
    want = MINSUM_ALPHA * brute_extrinsic_min(big)
    real = np.broadcast_to(np.asarray(mask)[:, :, None] > 0, ms.shape)
    np.testing.assert_allclose(np.abs(ms)[real], want[real], rtol=1e-12)
    assert (ms[~real] == 0).all()


def test_minsum_checkmajor_matches_slotmajor():
    rng = np.random.default_rng(2)
    dc, C, B = 4, 20, 4
    v2c_c = jnp.asarray(rng.normal(0, 2, (C, dc, B)), jnp.float64)
    synd = jnp.asarray(rng.integers(0, 2, (C, B)), jnp.int32)
    mask_c = jnp.asarray(np.ones((C, dc)), jnp.float64)
    a = np.asarray(check_node_minsum(v2c_c, synd, mask_c))
    b = np.asarray(check_node_minsum_sm(
        jnp.moveaxis(v2c_c, 1, 0), synd, jnp.moveaxis(mask_c, 1, 0)
    ))
    np.testing.assert_array_equal(a, np.moveaxis(b, 0, 1))


@pytest.mark.parametrize("layout", ["qc"])
def test_minsum_pallas_kernel_matches_xla(layout):
    """rule='minsum' through the fused QC check-phase kernel (interpret
    mode on CPU) == the check-major XLA min-sum update."""
    from qamreconciliation_jax.ops.pallas_kernels import bp_check_phase_qc

    rng = np.random.default_rng(3)
    nb_c, dc, z, B = 3, 4, 16, 8
    t = jnp.asarray(rng.normal(0, 3, (nb_c, dc, z, B)), jnp.float32)
    c2v = jnp.asarray(rng.normal(0, 1, (nb_c, dc, z, B)), jnp.float32)
    synd = jnp.asarray(rng.integers(0, 2, (nb_c, z, B)), jnp.int32)
    _, out = bp_check_phase_qc(t, c2v, synd, interpret=True, rule="minsum")
    # check-major oracle on the flattened (check-block, z) node axis
    want = check_node_minsum(
        (t - c2v).transpose(0, 2, 1, 3).reshape(-1, dc, B),
        synd.reshape(-1, B),
        jnp.ones((nb_c * z, dc), jnp.float32),
    )
    got = np.asarray(out).transpose(0, 2, 1, 3).reshape(-1, dc, B)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-7)


def test_minsum_decodes_end_to_end(fused_check):
    """Both decoders decode cleanly with check_rule='minsum' at high SNR,
    and the QC XLA / fused-kernel paths agree on (success, iters)."""
    from qamreconciliation_jax import Decoder, Matrix, PAMAlphabet
    from qamreconciliation_jax.models.qc_decoder import (
        QCDecoder, make_qc_ldpc,
    )
    from qamreconciliation_jax.sims import ReconciliationEngine

    vid, cid = make_regular_ldpc_cached()
    dec = Decoder(vid, cid, dtype=jnp.float64, check_rule="minsum")
    mat = Matrix(vid, cid)
    pa = PAMAlphabet(2, 2.0)
    eng = ReconciliationEngine(dec, mat, pa, batch=32, dtype=jnp.float64)
    r = eng.run_point("softening", 9.0, 30, 64, 10**9,
                      nmconfig=np.zeros(4, np.uint8), seed=1)
    assert r.fer < 0.1 and r.ber < 1e-3

    base, _, _ = make_qc_ldpc(12, 16, dv=3, dc=6, seed=4)
    rng = np.random.default_rng(5)
    lappr = jnp.asarray(rng.normal(2.0, 1.0, (8, 12 * 16)), jnp.float64)
    word = jnp.zeros((8, 12 * 16), jnp.int32)
    for pall in (False, True):
        if pall:
            fused_check()
        qc = QCDecoder(base, 16, dtype=jnp.float64, check_rule="minsum")
        synd = qc.syndrome_from_bits(word.T).T
        s, it, fin = qc.decode_batch(lappr, synd, 20)
        if pall is False:
            s0, it0 = np.asarray(s), np.asarray(it)
        else:
            np.testing.assert_array_equal(np.asarray(s), s0)
            np.testing.assert_array_equal(np.asarray(it), it0)


def make_regular_ldpc_cached():
    from qamreconciliation_jax.utils import make_regular_ldpc

    return make_regular_ldpc(240, 3, 6, seed=0)


def test_check_rule_validation():
    from qamreconciliation_jax import Decoder

    vid, cid = make_regular_ldpc_cached()
    with pytest.raises(ValueError, match="check_rule"):
        Decoder(vid, cid, check_rule="bogus")


def test_offset_minsum_paths_agree(fused_check):
    """Offset min-sum (alpha=1, beta=0.4): the XLA, fused-kernel and
    compressed-state QC paths produce bit-identical (success, iters,
    final), and the offset actually changes the messages vs normalized
    min-sum."""
    import numpy as np
    import jax.numpy as jnp

    from qamreconciliation_jax import Matrix
    from qamreconciliation_jax.models.qc_decoder import (
        QCDecoder, make_qc_ldpc,
    )

    base, vid, cid = make_qc_ldpc(nb_v=12, z=16, dv=3, dc=6, seed=4)
    mat = Matrix(vid, cid)
    rng = np.random.default_rng(5)
    word = rng.integers(0, 2, (8, 192))
    synd = np.asarray(mat.eval_syndrome(word))
    llr = (1 - 2 * word) * 3.0 + rng.normal(0, 2.0, (8, 192))
    kw = dict(dtype=jnp.float32, check_rule="minsum", minsum_alpha=1.0,
              minsum_beta=0.4)
    xla = QCDecoder(base, 16, **kw)
    cmp_ = QCDecoder(base, 16, compressed=True, **kw)
    nrm = QCDecoder(base, 16, dtype=jnp.float32, check_rule="minsum")
    outs = [d.decode_batch(llr, synd, 20) for d in (xla, cmp_)]
    s_n, i_n, f_n = nrm.decode_batch(llr, synd, 20)
    fused_check()
    outs.append(QCDecoder(base, 16, **kw).decode_batch(llr, synd, 20))
    for s, i, f in outs[1:]:
        np.testing.assert_array_equal(np.asarray(outs[0][0]), np.asarray(s))
        np.testing.assert_array_equal(np.asarray(outs[0][1]), np.asarray(i))
        np.testing.assert_array_equal(
            np.asarray(outs[0][2], np.float32), np.asarray(f, np.float32)
        )
    assert not np.array_equal(
        np.asarray(outs[0][2], np.float32), np.asarray(f_n, np.float32)
    )


def test_minsum_beta_validation():
    import pytest

    from qamreconciliation_jax.models.qc_decoder import (
        QCDecoder, make_qc_ldpc,
    )

    base, _, _ = make_qc_ldpc(nb_v=12, z=16, dv=3, dc=6, seed=4)
    with pytest.raises(ValueError):
        QCDecoder(base, 16, check_rule="minsum", minsum_beta=-0.1)
