"""Quasi-cyclic decoder: exact parity with the generic decoder + engine drop-in."""

import numpy as np
import jax.numpy as jnp
import pytest

from qamreconciliation_jax import Decoder, Matrix, PAMAlphabet
from qamreconciliation_jax.models.qc_decoder import QCDecoder, make_qc_ldpc
from qamreconciliation_jax.sims import ReconciliationEngine


@pytest.fixture(scope="module")
def qc():
    base, vid, cid = make_qc_ldpc(nb_v=12, z=16, dv=3, dc=6, seed=4)
    return base, vid, cid


def test_expansion_shapes(qc):
    base, vid, cid = qc
    qdec = QCDecoder(base, 16)
    assert qdec.vnum == 12 * 16
    assert qdec.cnum == 6 * 16
    assert qdec.ednum == len(base) * 16
    assert qdec.dc == 6


def test_qc_matches_generic_decoder_exactly(qc):
    """success/iters bit-identical and final LLRs equal (same float pairs,
    different only in the roll-based data movement)."""
    base, vid, cid = qc
    qdec = QCDecoder(base, 16, dtype=jnp.float64)
    gdec = Decoder(vid, cid, dtype=jnp.float64)
    mat = Matrix(vid, cid)
    rng = np.random.default_rng(1)
    B = 6
    word = rng.integers(0, 2, (B, qdec.vnum))
    synd = np.asarray(mat.eval_syndrome(word))
    llr = (1 - 2 * word) * 3.0 + rng.normal(0, 2.0, (B, qdec.vnum))
    s1, i1, f1 = gdec.decode_batch(llr, synd, 30)
    s2, i2, f2 = qdec.decode_batch(llr, synd, 30)
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(s2))
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(f1), np.asarray(f2),
                               rtol=1e-10, atol=1e-10)
    assert int(np.asarray(s1).sum()) > 0


def test_qc_engine_drop_in(qc):
    """QCDecoder drives the full reconciliation engine in all three modes."""
    base, vid, cid = qc
    qdec = QCDecoder(base, 16)
    mat = Matrix(vid, cid)
    pa = PAMAlphabet(2, 2.0)
    eng = ReconciliationEngine(qdec, mat, pa, batch=8)
    r = eng.run_point("softening", 4.5, 20, 16, 10**9,
                      nmconfig=np.zeros(4, np.uint8))
    assert 0.0 <= r.ber <= 1.0 and r.frames == 16
    for mode in ("hard", "direct"):
        r = eng.run_point(mode, 8.0, 20, 16, 10**9)
        assert 0.0 <= r.ber <= 1.0


@pytest.fixture(scope="module")
def irr():
    """Irregular QC-IRA code: mixed check degrees + parallel circulants
    (the I + P accumulator cells) — the regime of real standard codes
    (reference: sims/display_biawgn.py:30-35 consumed by the jagged
    decoder, qamreconciliation/decoder.pyx:60-89)."""
    from qamreconciliation_jax.models.qc_decoder import make_qc_ira

    base, vid, cid = make_qc_ira(nb_info=8, nb_acc=4, z=16, dv=3, seed=2)
    return base, vid, cid


def test_qc_irregular_degrees(irr):
    base, vid, cid = irr
    dec = QCDecoder(base, 16)
    assert not dec.is_regular
    assert len(set(dec.row_degrees)) > 1          # genuinely mixed degrees
    assert min(dec.row_degrees) >= 2


@pytest.mark.parametrize("variant", [
    dict(),                                        # dense XLA, phi
    dict(fused=True),                              # dense fused kernel
    dict(check_phi="tanhfb"),                      # dense tanh-F/B
    dict(check_rule="minsum"),                     # dense min-sum
    dict(schedule="layered"),                      # layered serial-C
    dict(check_rule="minsum", fused=True),         # fused min-sum kernel
    dict(totals_dtype="float32"),                  # f32-totals hybrid
    dict(check_rule="minsum", compressed=True),    # compressed min-sum
])
def test_qc_irregular_matches_generic(irr, variant, fused_check):
    """A mixed-degree QC code must decode bit-identically (success,
    iters) to the generic Decoder on EVERY QC path (``fused``: the GPU's
    fused check-phase kernel, interpreted), with final LLRs to float
    tolerance."""
    base, vid, cid = irr
    variant = dict(variant)
    if variant.pop("fused", False):
        fused_check()
    qdec = QCDecoder(base, 16, dtype=jnp.float32, **variant)
    gdec = Decoder(vid, cid, dtype=jnp.float32,
                   check_rule=variant.get("check_rule", "sumproduct"),
                   check_phi=variant.get("check_phi", "phi"))
    mat = Matrix(vid, cid)
    rng = np.random.default_rng(9)
    B = 6
    word = rng.integers(0, 2, (B, qdec.vnum))
    synd = np.asarray(mat.eval_syndrome(word))
    llr = (1 - 2 * word) * 3.0 + rng.normal(0, 2.0, (B, qdec.vnum))
    s1, i1, f1 = gdec.decode_batch(llr, synd, 30)
    s2, i2, f2 = qdec.decode_batch(llr, synd, 30)
    if variant.get("schedule") == "layered":
        # layered converges on its own (faster) trajectory; semantics
        # checks live in test_layered_*.  Here: no worse success.
        assert np.asarray(s2).sum() >= np.asarray(s1).sum() > 0
        return
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(s2))
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(
        np.asarray(f1, np.float32), np.asarray(f2, np.float32),
        rtol=2e-4, atol=2e-4,
    )
    assert int(np.asarray(s1).sum()) > 0


def test_qc_irregular_syndrome_and_detect(irr):
    """Roll syndrome matches the expanded gather; detect_qc recovers the
    irregular lifting (incl. the parallel-circulant accumulator cells)."""
    from qamreconciliation_jax.models.qc_decoder import detect_qc

    base, vid, cid = irr
    dec = QCDecoder(base, 16)
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.integers(0, 2, (dec.vnum, 4)), jnp.int32)
    np.testing.assert_array_equal(
        np.asarray(dec.syndrome_from_bits(w)),
        np.asarray(dec.graph.syndrome_from_bits(w)),
    )
    got = detect_qc(vid, cid)
    assert got is not None and got[1] == 16
    assert sorted(got[0]) == sorted(base)


def test_qc_minsum_rejects_degree_one_checks():
    # degree-1 check: min-sum's all-but-one extrinsic has no finite value
    with pytest.raises(ValueError):
        QCDecoder([(0, 0, 1), (0, 1, 2), (1, 0, 3)], z=8,
                  check_rule="minsum")


def test_make_qc_no_duplicate_circulants():
    base, vid, cid = make_qc_ldpc(nb_v=24, z=32, dv=3, dc=6, seed=7)
    assert len(set(base)) == len(base)


def test_qc_csv_roundtrip_and_cli(tmp_path):
    from qamreconciliation_jax.models.qc_decoder import save_qc_csv, load_qc_csv
    from qamreconciliation_jax.sims import sim_reconciliation

    base, vid, cid = make_qc_ldpc(nb_v=12, z=16, dv=3, dc=6, seed=4)
    path = str(tmp_path / "qc.csv")
    save_qc_csv(path, base, 16)
    base2, z2 = load_qc_csv(path)
    assert base2 == base and z2 == 16

    out = str(tmp_path / "out.csv")
    df = sim_reconciliation.main([
        path, "--qc", "--out", out, "--snr", "4.5", "4.5", "--nsnr", "1",
        "--maxiter", "15", "--simloops", "16", "--ferr-count-min", "1000000",
        "--batch", "8",
    ])
    assert list(df.dtype.names) == ["EsN0dB", "ber", "fer", "iters"]
    assert 0.0 <= float(df.ber[0]) <= 1.0


def test_qc_roll_syndrome_matches_generic_gather():
    """QCDecoder.syndrome_from_bits (circulant rolls — the engine hot path)
    must agree bit-exactly with the expanded-graph gather+popcount
    (TannerGraph.syndrome_from_bits) for every word."""
    import numpy as np

    base, vid, cid = make_qc_ldpc(nb_v=36, z=50, dv=3, dc=6, seed=3)
    dec = QCDecoder(base, 50)
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.integers(0, 2, (dec.vnum, 8)), jnp.int32)
    got = np.asarray(dec.syndrome_from_bits(w))
    ref = np.asarray(dec.graph.syndrome_from_bits(w))
    assert np.array_equal(got, ref)


def test_detect_qc_roundtrip(qc):
    """detect_qc recovers the exact lifting from an expanded edge list."""
    from qamreconciliation_jax.models.qc_decoder import detect_qc

    base, vid, cid = qc
    got = detect_qc(vid, cid)
    assert got is not None
    got_base, got_z = got
    assert got_z == 16
    assert sorted(got_base) == sorted(base)


def test_detect_qc_lifted_decoder_matches_generic(qc):
    """A decoder lifted from the expanded list decodes identically to the
    generic decoder on the same edges."""
    from qamreconciliation_jax.models.qc_decoder import detect_qc

    base, vid, cid = qc
    got_base, got_z = detect_qc(vid, cid)
    qdec = QCDecoder(got_base, got_z, dtype=jnp.float64)
    gdec = Decoder(vid, cid, dtype=jnp.float64)
    mat = Matrix(vid, cid)
    rng = np.random.default_rng(2)
    B = 4
    word = rng.integers(0, 2, (B, qdec.vnum))
    synd = np.asarray(mat.eval_syndrome(word))
    llr = (1 - 2 * word) * 3.0 + rng.normal(0, 2.0, (B, qdec.vnum))
    s1, i1, f1 = gdec.decode_batch(llr, synd, 25)
    s2, i2, f2 = qdec.decode_batch(llr, synd, 25)
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(s2))
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))


def test_detect_qc_rejects_unstructured():
    from qamreconciliation_jax.models.qc_decoder import detect_qc
    from qamreconciliation_jax.utils.edgefile import make_regular_ldpc

    vid, cid = make_regular_ldpc(120, 3, 6, seed=9)
    assert detect_qc(vid, cid) is None


# --------------------------- layered schedule --------------------------- #


def _layered_np(prior, synd, rows, z, sweeps, rule="sumproduct",
                alpha=0.8125, order=None):
    """Independent numpy float64 oracle of the row-layered schedule.

    Same conventions as QCDecoder._build_layered: check block cb row j
    gathers variable slab roll(total[vb], s), updates extrinsics with the
    phi-form sum-product (or normalized min-sum) and the syndrome
    prefactor, and folds the message delta into the totals immediately.
    Processes blocks STRICTLY SERIALLY in ``order`` (default natural) —
    matching this against the device's grouped sweep also proves the
    variable-disjoint groups are message-identical to a serial schedule.
    """
    nb_v = prior.shape[0]
    total = prior.astype(np.float64).copy()
    c2v = [np.zeros((len(row), z, prior.shape[-1])) for row in rows]
    order = list(range(len(rows))) if order is None else list(order)

    def phi(x):
        return -np.log(np.tanh(np.maximum(x, 1e-30) / 2.0))

    for _ in range(sweeps):
        for cb in order:
            row = rows[cb]
            t = np.stack([np.roll(total[v], s, axis=0) for (v, s) in row])
            v2c = t - c2v[cb]
            if rule == "minsum":
                a = np.abs(v2c)
                min1 = a.min(axis=0, keepdims=True)
                is_min = a == min1
                cnt = is_min.sum(axis=0, keepdims=True)
                min2 = np.where(is_min, 1e30, a).min(axis=0, keepdims=True)
                mag = alpha * np.where(is_min & (cnt == 1), min2, min1)
            else:
                phim = phi(np.abs(v2c))
                mag = phi(phim.sum(axis=0, keepdims=True) - phim)
            neg = (v2c < 0).astype(np.int64)
            parity = neg.sum(axis=0, keepdims=True) & 1
            sign = 1 - 2 * (parity ^ neg)
            pref = (1 - 2 * synd[cb].astype(np.int64))[None]
            new = sign * pref * mag
            delta = new - c2v[cb]
            for d, (v, s) in enumerate(row):
                total[v] += np.roll(delta[d], -s, axis=0)
            c2v[cb] = new
    return total


@pytest.mark.parametrize("rule", ["sumproduct", "minsum"])
def test_layered_matches_numpy_oracle(qc, rule):
    """Message-exact parity of the layered device loop vs an independent
    numpy float64 implementation of the same schedule (2 full sweeps on
    frames too noisy to converge, so final == end-of-sweep totals)."""
    base, vid, cid = qc
    z = 16
    dec = QCDecoder(base, z, dtype=jnp.float64, schedule="layered",
                    check_rule=rule)
    rng = np.random.default_rng(11)
    B = 5
    word = rng.integers(0, 2, (B, dec.vnum))
    synd = np.asarray(Matrix(vid, cid).eval_syndrome(word))
    llr = rng.normal(0, 2.0, (B, dec.vnum))  # ~0 dB: nothing converges
    s, i, f = dec.decode_batch(llr, synd, 2)
    assert not np.asarray(s).any()
    ref = _layered_np(
        llr.T.reshape(dec.nb_v, z, B),
        synd.T.reshape(dec.nb_c, z, B),
        dec._rows, z, sweeps=2, rule=rule,
    ).reshape(dec.vnum, B)
    np.testing.assert_allclose(np.asarray(f).T.reshape(dec.vnum, B), ref,
                               rtol=1e-9, atol=1e-9)


def test_layered_semantics_and_convergence(qc):
    """(success, iters, final) contract: iters==0 passthrough on consistent
    input; successful frames' hard decisions satisfy the syndrome; layered
    needs no more mean sweeps than flooding on the same decodable batch."""
    base, vid, cid = qc
    lay = QCDecoder(base, 16, dtype=jnp.float64, schedule="layered")
    flo = QCDecoder(base, 16, dtype=jnp.float64)
    mat = Matrix(vid, cid)
    rng = np.random.default_rng(3)
    B = 8
    word = rng.integers(0, 2, (B, lay.vnum))
    synd = np.asarray(mat.eval_syndrome(word))

    # consistent input -> iters==0 passthrough (reference decoder.pyx:402-405)
    clean = (1 - 2 * word) * 4.0
    s, i, f = lay.decode_batch(clean, synd, 10)
    assert np.asarray(s).all() and (np.asarray(i) == 0).all()
    np.testing.assert_array_equal(np.asarray(f), clean)

    # decodable noise: both succeed, layered in no more mean sweeps
    llr = (1 - 2 * word) * 3.0 + rng.normal(0, 2.0, (B, lay.vnum))
    s_l, i_l, f_l = lay.decode_batch(llr, synd, 30)
    s_f, i_f, f_f = flo.decode_batch(llr, synd, 30)
    assert np.asarray(s_l).sum() >= np.asarray(s_f).sum() > 0
    ok = np.asarray(s_l) & np.asarray(s_f)
    assert np.asarray(i_l)[ok].mean() <= np.asarray(i_f)[ok].mean()
    # successful hard decisions satisfy the syndrome
    bits = (np.asarray(f_l) < 0).astype(int)
    re_synd = np.asarray(mat.eval_syndrome(bits))
    assert (re_synd[np.asarray(s_l)] == synd[np.asarray(s_l)]).all()


def test_layered_bf16_engine_drop_in(qc):
    """A bf16 layered QCDecoder drives the full engine (the production
    combination: bf16 messages, f32 totals)."""
    base, vid, cid = qc
    dec = QCDecoder(base, 16, dtype=jnp.bfloat16, schedule="layered",
                    check_rule="minsum")
    mat = Matrix(vid, cid)
    pa = PAMAlphabet(2, 2.0)
    eng = ReconciliationEngine(dec, mat, pa, batch=8)
    r = eng.run_point("softening", 4.5, 20, 16, 10**9,
                      nmconfig=np.zeros(4, np.uint8))
    assert 0.0 <= r.ber <= 1.0 and r.frames == 16


def test_layered_chunk_invariance(qc):
    """(success, iters, final) are EXACTLY chunk-size-invariant: the chunk
    only amortizes the while-loop sync; detection, iteration counts, the
    convergence-sweep capture and the failed-frame maxiter snapshot are
    per-sweep exact (incl. maxiter not divisible by the chunk)."""
    base, vid, cid = qc
    mat = Matrix(vid, cid)
    rng = np.random.default_rng(17)
    B = 16
    word = rng.integers(0, 2, (B, 12 * 16))
    synd = np.asarray(mat.eval_syndrome(word))
    llr = (1 - 2 * word) * 2.5 + rng.normal(0, 2.2, (B, 12 * 16))
    outs = []
    for K in (1, 3, 4):
        dec = QCDecoder(base, 16, dtype=jnp.float64, schedule="layered",
                        layered_chunk=K)
        s, i, f = dec.decode_batch(llr, synd, 10)  # 10 % 3 != 0
        outs.append((np.asarray(s), np.asarray(i), np.asarray(f)))
    s0, i0, f0 = outs[0]
    assert 0 < s0.sum() < B  # both successes and failures exercised
    for s, i, f in outs[1:]:
        np.testing.assert_array_equal(s, s0)
        np.testing.assert_array_equal(i, i0)
        np.testing.assert_array_equal(f, f0)
    # every successful frame's captured final satisfies the syndrome
    bits = (f0 < 0).astype(int)
    re_synd = np.asarray(mat.eval_syndrome(bits))
    assert (re_synd[s0] == synd[s0]).all()


def test_layered_cli(tmp_path, qc):
    """--schedule layered runs end-to-end through sim_reconciliation with
    --qc, and is rejected for the generic (non-QC) decoder."""
    from qamreconciliation_jax.models.qc_decoder import save_qc_csv
    from qamreconciliation_jax.sims import sim_reconciliation
    from qamreconciliation_jax.utils.edgefile import save_edge_csv

    base, vid, cid = qc
    path = str(tmp_path / "qc.csv")
    save_qc_csv(path, base, 16)
    out = str(tmp_path / "out.csv")
    df = sim_reconciliation.main([
        path, "--qc", "--schedule", "layered", "--check-rule", "minsum",
        "--out", out, "--snr", "4.5", "4.5", "--nsnr", "1",
        "--maxiter", "15", "--simloops", "16", "--ferr-count-min", "1000000",
        "--batch", "8",
    ])
    assert list(df.dtype.names) == ["EsN0dB", "ber", "fer", "iters"]
    assert 0.0 <= float(df.ber[0]) <= 1.0

    flat = str(tmp_path / "flat.csv")
    save_edge_csv(flat, vid, cid)
    with pytest.raises(SystemExit):
        sim_reconciliation.main([
            flat, "--schedule", "layered", "--out", out,
            "--snr", "4.5", "4.5", "--nsnr", "1", "--simloops", "8",
        ])


def test_layered_rejects_compressed(qc):
    base, _, _ = qc
    with pytest.raises(ValueError):
        QCDecoder(base, 16, schedule="layered", check_rule="minsum",
                  compressed=True)
    with pytest.raises(ValueError):
        QCDecoder(base, 16, schedule="twisted")


# ------------------------------------------------- grouped layered sweep


def test_layered_grouped_matches_reordered_serial_oracle():
    """The grouped layered sweep (layered_groups=True) is bit-equivalent
    to a SERIAL sweep under the layer plan's row order: rows within a
    batch touch pairwise-disjoint variable blocks, so their updates
    commute exactly.  Verified against the numpy float64 oracle run on
    the plan-reordered rows/syndromes."""
    from qamreconciliation_jax.models.qc_decoder import (
        color_disjoint_rows, layered_plan,
    )

    base, vid, cid = make_qc_ldpc(nb_v=40, z=8, dv=3, dc=6, seed=21)
    dec = QCDecoder(base, 8, dtype=jnp.float64, schedule="layered",
                    layered_groups=True)
    # the coloring actually groups (else this test is vacuous) and every
    # color's rows are pairwise variable-disjoint
    colors = color_disjoint_rows(dec._rows)
    assert len(colors) < dec.nb_c
    for members in colors:
        seen = set()
        for cb in members:
            vbs = {v for (v, _) in dec._rows[cb]}
            assert not (seen & vbs)
            seen |= vbs

    rng = np.random.default_rng(5)
    B = 4
    word = rng.integers(0, 2, (B, dec.vnum))
    synd = np.asarray(Matrix(vid, cid).eval_syndrome(word))
    llr = rng.normal(0, 2.0, (B, dec.vnum))   # ~0 dB: nothing converges
    s, i, f = dec.decode_batch(llr, synd, 2)
    assert not np.asarray(s).any()

    plan = layered_plan(dec._rows)
    order = [cb for _, cbs in plan for cb in cbs]
    assert sorted(order) == list(range(dec.nb_c))
    synd_r = synd.T.reshape(dec.nb_c, 8, B)
    ref = _layered_np(
        llr.T.reshape(dec.nb_v, 8, B),
        synd_r[np.asarray(order)],
        [dec._rows[cb] for cb in order],
        8, sweeps=2, rule="sumproduct",
    ).reshape(dec.vnum, B)
    np.testing.assert_allclose(
        np.asarray(f).T.reshape(dec.vnum, B), ref, rtol=1e-9, atol=1e-9
    )


def test_layered_grouped_auto_policy_and_quality(qc):
    """Auto grouping stays OFF for few-row codes (relayout-heavy
    super-layers at nb_c=18) and ON at nb_c >= 32; grouped layered
    still decodes (success semantics intact) on a decodable batch."""
    base, vid, cid = qc
    few = QCDecoder(base, 16, schedule="layered")
    assert few.nb_c < 32 and few.layered_groups is None
    base40, vid40, cid40 = make_qc_ldpc(nb_v=80, z=4, dv=3, dc=6, seed=9)
    many = QCDecoder(base40, 4, dtype=jnp.float64, schedule="layered")
    assert many.nb_c >= 32          # auto groups
    rng = np.random.default_rng(12)
    B = 6
    word = rng.integers(0, 2, (B, many.vnum))
    synd = np.asarray(Matrix(vid40, cid40).eval_syndrome(word))
    llr = (1 - 2 * word) * 4.0 + rng.normal(0, 1.0, (B, many.vnum))
    s, i, f = many.decode_batch(llr, synd, 30)
    assert np.asarray(s).all()
    bits = (np.asarray(f) < 0).astype(int)
    np.testing.assert_array_equal(bits, word)


@pytest.mark.parametrize("rule", ["sumproduct", "minsum"])
@pytest.mark.parametrize("shape", ["ira", "rate34"])
def test_layered_irregular_matches_numpy_oracle(shape, rule):
    """The layered loop on irregular rows (each row updated at its own
    degree; wide rate-3/4 accumulator rows) == the serial numpy oracle
    under the loop's equivalent row order."""
    from qamreconciliation_jax.models.qc_decoder import (
        layered_plan, make_qc_ira,
    )

    nb_info, nb_acc = (8, 4) if shape == "ira" else (9, 3)
    base, vid, cid = make_qc_ira(nb_info=nb_info, nb_acc=nb_acc, z=16,
                                 dv=3, seed=2)
    dec = QCDecoder(base, 16, dtype=jnp.float64, schedule="layered",
                    check_rule=rule)
    rng = np.random.default_rng(5)
    B = 4
    word = rng.integers(0, 2, (B, dec.vnum))
    synd = np.asarray(Matrix(vid, cid).eval_syndrome(word))
    llr = rng.normal(0, 2.0, (B, dec.vnum))  # ~0 dB: nothing converges
    s, _, f = dec.decode_batch(llr, synd, 2)
    assert not np.asarray(s).any()
    grouped = dec.layered_groups or (dec.layered_groups is None
                                     and dec.nb_c >= 32)
    order = ([cb for _, cbs in layered_plan(dec._rows) for cb in cbs]
             if grouped else None)
    ref = _layered_np(
        llr.T.reshape(dec.nb_v, 16, B), synd.T.reshape(dec.nb_c, 16, B),
        dec._rows, 16, sweeps=2, rule=rule, order=order,
    ).reshape(dec.vnum, B)
    np.testing.assert_allclose(np.asarray(f).T, ref, rtol=1e-9, atol=1e-9)
