"""DVB-S2 construction invariants (models/dvbs2.py).

The repository holds no copy of the ETSI integer tables, so these tests pin the *arithmetic* of the Annex B/C
construction — encoder/H consistency, the q-interleaved blocked
re-indexing, the z=360 quasi-cyclic structure and its one-edge-deficient
wrap circulant, and the standard's frame/degree-profile invariants —
against the structure-exact synthetic tables.  The same code paths
consume the exact published rows via parse_address_table().
"""

import numpy as np
import pytest

from qamreconciliation_jax.models.dvbs2 import (
    Z, Dvbs2Table, RATE_PROFILES, blocked_perms, encode, expanded_edges,
    make_table, parse_address_table, to_qc_base,
)


def np_syndrome(vid, cid, word):
    s = np.zeros(int(np.max(cid)) + 1, np.int64)
    np.add.at(s, cid, word[vid])
    return s & 1


@pytest.mark.parametrize("rate", ["1/2", "3/4", "2/3", "5/6"])
def test_frame_structure(rate):
    t = make_table(rate, seed=1)
    num, den = map(int, rate.split("/"))
    assert t.n == 64800
    assert t.k == 64800 * num // den
    assert t.m == t.n - t.k and t.q == t.m // Z
    assert len(t.rows) == t.k // Z
    # degree profile: rows-per-degree exactly as profiled
    degs = sorted(len(r) for r in t.rows)
    want = sorted(
        d for cnt, d in RATE_PROFILES[(64800, rate)] for _ in range(cnt)
    )
    assert degs == want


@pytest.mark.parametrize("rate,cdeg", [("1/2", 7), ("3/4", 14),
                                       ("2/3", 10), ("5/6", 22)])
def test_uniform_check_degrees(rate, cdeg):
    # the standard's tables spread addresses exactly evenly over parity
    # blocks -> uniform check degree (cdeg), except check 0 (no p_{-1})
    t = make_table(rate, seed=0)
    hist = t.check_degrees()
    assert hist == {cdeg - 1: 1, cdeg: t.m - 1}


def test_encoder_satisfies_H():
    t = make_table("1/2", seed=3)
    rng = np.random.default_rng(0)
    word = encode(t, rng.integers(0, 2, t.k))
    assert word.size == t.n
    vid, cid = expanded_edges(t, blocked=False)
    assert np_syndrome(vid, cid, word.astype(np.int64)).sum() == 0
    # blocked relabeling: permuted word satisfies the blocked H
    var_orig, chk_orig = blocked_perms(t)
    vid_b, cid_b = expanded_edges(t, blocked=True)
    wb = word[var_orig].astype(np.int64)
    assert np_syndrome(vid_b, cid_b, wb).sum() == 0


def test_encoder_linearity():
    t = make_table("3/4", seed=5)
    rng = np.random.default_rng(1)
    a = rng.integers(0, 2, t.k)
    b = rng.integers(0, 2, t.k)
    wa, wb, wab = encode(t, a), encode(t, b), encode(t, a ^ b)
    assert np.array_equal(wab, wa ^ wb)


def test_blocked_perms_are_bijections():
    t = make_table("3/4", seed=0)
    var_orig, chk_orig = blocked_perms(t)
    assert np.array_equal(np.sort(var_orig), np.arange(t.n))
    assert np.array_equal(np.sort(chk_orig), np.arange(t.m))
    # info part untouched
    assert np.array_equal(var_orig[: t.k], np.arange(t.k))


def test_qc_structure_and_wrap_deficiency():
    t = make_table("1/2", seed=7)
    base_full = to_qc_base(t, wrap="full")
    base_exact, (miss_c, miss_v) = to_qc_base(t, wrap="exact")
    assert base_full == base_exact
    # the deficient edge is in the wrap circulant: check (0, 0) x the
    # last offset of the last parity block
    nbi = t.k // Z
    assert miss_c == 0 and miss_v == (nbi + t.q - 1) * Z + (Z - 1)
    # exact expansion = full expansion minus exactly that one edge
    k = np.arange(Z)
    Ef = Z * len(base_full)
    vid, cid = expanded_edges(t)
    assert vid.size == Ef - 1
    assert not np.any((vid == miss_v) & (cid == miss_c))
    # block/shift recovery: every expanded edge matches its base cell
    cells = {(c, v): s for (c, v, s) in base_full}
    vb, cb = vid // Z, cid // Z
    s = (cid % Z - vid % Z) % Z
    for i in np.random.default_rng(0).integers(0, vid.size, 64):
        assert cells[(int(cb[i]), int(vb[i]))] == int(s[i])
    # the full-wrap expansion is detected as QC at z=360
    from qamreconciliation_jax.models.qc_decoder import detect_qc

    vidf = np.concatenate([v * Z + k for (_, v, _) in base_full])
    cidf = np.concatenate(
        [c * Z + (k + s_) % Z for (c, _, s_) in base_full]
    )
    got = detect_qc(vidf, cidf, z=Z)
    assert got is not None
    assert sorted(got[0]) == sorted(base_full) and got[1] == Z


def test_parse_roundtrip():
    t = make_table("3/4", seed=2)
    text = "\n".join(" ".join(str(x) for x in row) for row in t.rows)
    t2 = parse_address_table(text, n=t.n, k=t.k)
    assert t2.rows == t.rows and t2.q == t.q


def test_validation_rejects_bad_tables():
    t = make_table("1/2", seed=0)
    bad = Dvbs2Table(n=t.n, k=t.k, rows=t.rows[:-1])
    with pytest.raises(ValueError):
        bad.validate()
    rows = [list(r) for r in t.rows]
    rows[0][1] = rows[0][0]
    with pytest.raises(ValueError):
        Dvbs2Table(n=t.n, k=t.k, rows=rows).validate()
    rows = [list(r) for r in t.rows]
    rows[0][0] = t.m
    with pytest.raises(ValueError):
        Dvbs2Table(n=t.n, k=t.k, rows=rows).validate()


def test_qcdecoder_consumes_full_wrap():
    """The full-wrap QC base rides QCDecoder at the real shape: a
    consistent input (exact codeword LLRs) passes through with
    iters == 0 — exercising the z=360, 180-block graph end to end
    (reference semantics: qamreconciliation/decoder.pyx:402-405)."""
    import jax.numpy as jnp

    from qamreconciliation_jax.models.qc_decoder import QCDecoder

    t = make_table("1/2", seed=11)
    base = to_qc_base(t, wrap="full")
    dec = QCDecoder(base, Z, dtype=jnp.float32)
    assert dec.vnum == t.n and dec.cnum == t.m
    rng = np.random.default_rng(2)
    word = encode(t, rng.integers(0, 2, t.k))
    var_orig, chk_orig = blocked_perms(t)
    wb = word[var_orig].astype(np.int64)
    # full-wrap syndrome differs from the exact-H syndrome only through
    # the one extra edge; evaluate it on the decoder's own graph
    synd = np.asarray(dec.syndrome_from_bits(jnp.asarray(wb[:, None])))
    lappr = jnp.asarray((1.0 - 2.0 * wb)[None, :], jnp.float32)  # [B=1, V]
    ok, iters, final = dec.decode_batch(lappr, jnp.asarray(synd.T), 5)
    assert bool(np.asarray(ok)[0]) and int(np.asarray(iters)[0]) == 0
    assert np.array_equal(np.asarray(final)[0], np.asarray(lappr)[0])


def test_girth6_conditioning():
    """Synthetic tables are 4-cycle-free at block level (expanded girth
    >= 6) — the property the standard's published tables are selected
    for.  The detector counts collisions over (var-pair, shift-diff)
    keys across check blocks + parallel-circulant 180-offsets."""
    from qamreconciliation_jax.models.dvbs2 import four_cycle_count

    for rate in ("1/2", "3/4", "2/3", "5/6"):
        t = make_table(rate, seed=0)
        assert four_cycle_count(t) == 0, rate
    # the detector itself detects: the unconditioned rate-3/4 seed-0
    # draw carries known collisions
    t_raw = make_table("3/4", seed=0, girth6=False)
    assert four_cycle_count(t_raw) > 0


def test_girth8_conditioning_opt_in():
    """girth=8 (opt-in, exceeds the standard's own 4-cycle-freeness)
    breaks every block-level 6-cycle witness too."""
    from qamreconciliation_jax.models.dvbs2 import (
        four_cycle_count, six_cycle_witnesses,
    )

    t = make_table("1/2", seed=0, girth=8)
    assert t.source.endswith("-g8")
    assert four_cycle_count(t) == 0
    assert six_cycle_witnesses(t.rows, t.q, t.k // Z) == []
    # frame structure invariants survive the extra conditioning
    assert t.check_degrees() == {6: 1, 7: t.m - 1}
