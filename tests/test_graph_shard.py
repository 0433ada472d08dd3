"""Graph-sharded decoder: equivalence with the single-device decoder
on the 8-way virtual CPU mesh (SURVEY.md §2 graph-sharding plan)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qamreconciliation_jax import Decoder, Matrix
from qamreconciliation_jax.parallel import make_mesh
from qamreconciliation_jax.parallel.graph_shard import ShardedDecoder
from qamreconciliation_jax.utils import make_regular_ldpc


@pytest.fixture(scope="module", params=[240, 252])
def setup(request):
    # 252 -> cnum=126 not divisible by 8: exercises the check padding
    n = request.param
    vid, cid = make_regular_ldpc(n, 3, 6, seed=31)
    mesh = make_mesh(8, axis_name="gs")
    dec = Decoder(vid, cid, dtype=jnp.float64)
    sdec = ShardedDecoder(vid, cid, mesh, dtype=jnp.float64)
    mat = Matrix(vid, cid)
    return dec, sdec, mat


def test_sharded_matches_single_device(setup):
    dec, sdec, mat = setup
    rng = np.random.default_rng(3)
    B, V = 6, dec.vnum
    word = rng.integers(0, 2, (B, V))
    synd = np.asarray(mat.eval_syndrome(word))
    llr = (1 - 2 * word) * 3.0 + rng.normal(0, 2.0, (B, V))

    s1, i1, f1 = dec.decode_batch(llr, synd, 30)
    s2, i2, f2 = sdec.decode_batch(llr, synd, 30)
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(s2))
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    # per-device partial sums reorder the float adds -> tolerance, not equality
    np.testing.assert_allclose(np.asarray(f1), np.asarray(f2), rtol=1e-9,
                               atol=1e-9)
    assert int(np.asarray(s1).sum()) > 0


def test_sharded_consistent_passthrough(setup):
    dec, sdec, mat = setup
    rng = np.random.default_rng(5)
    word = rng.integers(0, 2, (3, dec.vnum))
    synd = np.asarray(mat.eval_syndrome(word))
    llr = (1 - 2 * word) * 5.0
    s, i, f = sdec.decode_batch(llr, synd, 20)
    assert bool(jnp.all(s))
    np.testing.assert_array_equal(np.asarray(i), np.zeros(3, np.int32))
    np.testing.assert_allclose(np.asarray(f), llr)


def test_sharded_failure_semantics(setup):
    dec, sdec, mat = setup
    rng = np.random.default_rng(7)
    word = rng.integers(0, 2, (2, dec.vnum))
    synd = np.asarray(mat.eval_syndrome(word))
    llr = rng.normal(0, 0.5, (2, dec.vnum))  # hopeless
    s, i, _ = sdec.decode_batch(llr, synd, 5)
    for k in range(2):
        if not bool(s[k]):
            assert int(i[k]) == 5


def test_sharded_engine_sweep_matches_unsharded():
    """A softening sweep runs end-to-end with a graph-sharded decoder
    (the engine _build_decode duck-type contract) and its counters match
    the unsharded engine exactly — same seed, same frames, same stats."""
    from qamreconciliation_jax import PAMAlphabet
    from qamreconciliation_jax.sims.engine import ReconciliationEngine

    vid, cid = make_regular_ldpc(240, 3, 6, seed=13)
    mesh = make_mesh(8, axis_name="gs")
    mat = Matrix(vid, cid)
    pa = PAMAlphabet(2, 2.0)

    kw = dict(batch=16, dtype=jnp.float64)
    eng_ref = ReconciliationEngine(Decoder(vid, cid, dtype=jnp.float64),
                                   mat, pa, **kw)
    eng_sh = ReconciliationEngine(
        ShardedDecoder(vid, cid, mesh, dtype=jnp.float64), mat, pa, **kw
    )

    run = dict(decoder_iterations=15, simulation_loops=32,
               ferr_count_min=10**9, seed=3,
               nmconfig=np.zeros(4, np.uint8))
    r_ref = eng_ref.run_point("softening", 5.0, **run)
    r_sh = eng_sh.run_point("softening", 5.0, **run)
    assert r_sh.frames == r_ref.frames
    assert r_sh.fer == r_ref.fer
    assert r_sh.ber == r_ref.ber
    assert r_sh.iters == r_ref.iters


@pytest.mark.parametrize("variant", [
    dict(check_rule="minsum", minsum_alpha=1.0, minsum_beta=0.3),
    dict(check_rule="minsum"),                   # normalized default
    dict(check_phi="tanhfb"),                    # tanh-F/B sum-product
])
def test_sharded_rule_variants_match_single_device(variant):
    """--minsum-alpha/--minsum-beta (and check_phi) must
    reach the sharded check update — sharded min-sum/tanh-F/B results match
    the single-device decoder with the SAME knobs exactly (min-sum is pure
    select arithmetic; tanhfb to float tolerance)."""
    vid, cid = make_regular_ldpc(240, 3, 6, seed=31)
    mesh = make_mesh(8, axis_name="gs")
    dec = Decoder(vid, cid, dtype=jnp.float64, **variant)
    sdec = ShardedDecoder(vid, cid, mesh, dtype=jnp.float64, **variant)
    mat = Matrix(vid, cid)
    rng = np.random.default_rng(17)
    B, V = 5, dec.vnum
    word = rng.integers(0, 2, (B, V))
    synd = np.asarray(mat.eval_syndrome(word))
    llr = (1 - 2 * word) * 3.0 + rng.normal(0, 2.0, (B, V))
    s1, i1, f1 = dec.decode_batch(llr, synd, 25)
    s2, i2, f2 = sdec.decode_batch(llr, synd, 25)
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(s2))
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(f1), np.asarray(f2), rtol=1e-9,
                               atol=1e-9)
    assert int(np.asarray(s1).sum()) > 0


@pytest.mark.parametrize("irregular", [False, True])
def test_sharded_qc_matches_single_device(irregular):
    """z-sharded QC decoder (rolls across devices): BIT-exact vs the single-device
    QCDecoder — sharding annotations change placement, not arithmetic.
    Covers regular and irregular (QC-IRA) codes."""
    from qamreconciliation_jax.models.qc_decoder import (
        QCDecoder, make_qc_ira, make_qc_ldpc,
    )
    from qamreconciliation_jax.parallel.graph_shard import ShardedQCDecoder

    z = 16  # divisible by the 8-way mesh
    if irregular:
        base, vid, cid = make_qc_ira(nb_info=8, nb_acc=4, z=z, dv=3, seed=2)
    else:
        base, vid, cid = make_qc_ldpc(nb_v=12, z=z, dv=3, dc=6, seed=4)
    mesh = make_mesh(8, axis_name="gs")
    dec = QCDecoder(base, z, dtype=jnp.float32)
    sdec = ShardedQCDecoder(base, z, mesh, dtype=jnp.float32)
    mat = Matrix(vid, cid)
    rng = np.random.default_rng(23)
    B, V = 6, dec.vnum
    word = rng.integers(0, 2, (B, V))
    synd = np.asarray(mat.eval_syndrome(word))
    llr = (1 - 2 * word) * 3.0 + rng.normal(0, 2.0, (B, V))
    s1, i1, f1 = dec.decode_batch(llr, synd, 30)
    s2, i2, f2 = sdec.decode_batch(llr, synd, 30)
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(s2))
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_array_equal(np.asarray(f1), np.asarray(f2))
    assert int(np.asarray(s1).sum()) > 0


def test_sharded_qc_rejects_bad_configs():
    from qamreconciliation_jax.models.qc_decoder import make_qc_ldpc
    from qamreconciliation_jax.parallel.graph_shard import ShardedQCDecoder

    base, _, _ = make_qc_ldpc(nb_v=12, z=12, dv=3, dc=6, seed=4)
    mesh = make_mesh(8, axis_name="gs")
    with pytest.raises(ValueError):   # z % n_dev != 0
        ShardedQCDecoder(base, 12, mesh)
    base16, _, _ = make_qc_ldpc(nb_v=12, z=16, dv=3, dc=6, seed=4)
    for bad in (dict(schedule="layered"),
                dict(compressed=True, check_rule="minsum")):
        with pytest.raises(ValueError):
            ShardedQCDecoder(base16, 16, mesh, **bad)


def test_sharded_qc_cli_sweep(tmp_path):
    """--graph-shard + --qc on the real CLI (z-sharded roll decoder)."""
    from qamreconciliation_jax.models.qc_decoder import (
        make_qc_ldpc, save_qc_csv,
    )
    from qamreconciliation_jax.sims import sim_reconciliation

    base, vid, cid = make_qc_ldpc(nb_v=12, z=16, dv=3, dc=6, seed=4)
    path = str(tmp_path / "qc.csv")
    save_qc_csv(path, base, 16)
    out = str(tmp_path / "gsqc.csv")
    df = sim_reconciliation.main([
        path, "--qc", "--out", out, "--maxiter", "10", "--simloops", "32",
        "--snr", "6", "6", "--nsnr", "1", "--batch", "16",
        "--graph-shard", "--devices", "8", "--check-rule", "minsum",
        "--minsum-alpha", "1.0", "--minsum-beta", "0.25",
    ])
    assert len(df) == 1
    assert list(df.dtype.names) == ["EsN0dB", "ber", "fer", "iters"]


def test_sharded_cli_sweep(tmp_path):
    """--graph-shard on the real CLI, 8-way virtual mesh."""
    from qamreconciliation_jax.sims import sim_reconciliation
    from qamreconciliation_jax.utils import save_edge_csv

    path = str(tmp_path / "code.csv")
    vid, cid = make_regular_ldpc(240, 3, 6, seed=13)
    save_edge_csv(path, vid, cid)
    out = str(tmp_path / "gs.csv")
    df = sim_reconciliation.main([
        path, "--out", out, "--maxiter", "10", "--simloops", "32",
        "--snr", "6", "6", "--nsnr", "1", "--batch", "16",
        "--dtype", "float64", "--graph-shard", "--devices", "8",
    ])
    assert len(df) == 1
    assert list(df.dtype.names) == ["EsN0dB", "ber", "fer", "iters"]
