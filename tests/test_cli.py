"""CLI driver tests: flags, CSV schemas, resume."""

import os

import numpy as np
import pandas as pd
import pytest

from qamreconciliation_jax.utils import make_regular_ldpc, save_edge_csv


@pytest.fixture(scope="module")
def edgefile(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("code") / "code.csv")
    vid, cid = make_regular_ldpc(120, 3, 6, seed=9)
    save_edge_csv(path, vid, cid)
    return path


def test_sim_reconciliation_csv_schema(edgefile, tmp_path):
    from qamreconciliation_jax.sims import sim_reconciliation

    out = str(tmp_path / "r.csv")
    sim_reconciliation.main([
        edgefile, "--out", out, "--maxiter", "10", "--simloops", "64",
        "--snr", "4", "8", "--nsnr", "2", "--batch", "32",
        "--dtype", "float64",
    ])
    df = pd.read_csv(out, index_col=0)
    assert list(df.columns) == ["EsN0dB", "ber", "fer", "iters"]
    assert len(df) == 2
    np.testing.assert_allclose(df.EsN0dB.to_numpy(), [4.0, 8.0])


def test_sim_reconciliation_modes(edgefile, tmp_path):
    from qamreconciliation_jax.sims import sim_reconciliation

    for extra in (["--hard"], ["--direct"], ["--configuration-base"]):
        out = str(tmp_path / f"m{extra[0][2:4]}.csv")
        df = sim_reconciliation.main([
            edgefile, "--out", out, "--maxiter", "5", "--simloops", "32",
            "--snr", "6", "6", "--nsnr", "1", "--batch", "32",
            "--dtype", "float64", *extra,
        ])
        assert len(df) == 1


def test_sim_reconciliation_resume(edgefile, tmp_path):
    from qamreconciliation_jax.sims import sim_reconciliation
    from qamreconciliation_jax.utils.checkpoint import SweepState

    out = str(tmp_path / "resume.csv")
    # pre-complete the first point with sentinel values
    state = SweepState(out)
    state.record(4.0, dict(ber=0.123, fer=0.5, iters=1.0))
    df = sim_reconciliation.main([
        edgefile, "--out", out, "--maxiter", "5", "--simloops", "32",
        "--snr", "4", "8", "--nsnr", "2", "--batch", "32",
        "--dtype", "float64", "--resume",
    ])
    assert df.ber[0] == 0.123  # first point taken from the journal
    assert not os.path.exists(out + ".partial.jsonl")  # cleaned up


def test_sim_bsc(edgefile, tmp_path):
    from qamreconciliation_jax.sims import sim_bsc

    out = str(tmp_path / "bsc.csv")
    df = sim_bsc.main([
        edgefile, "--out", out, "--maxiter", "10", "--simloops", "64",
        "--rber", "0.01", "0.02", "--rpoints", "2", "--batch", "32",
        "--dtype", "float64",
    ])
    got = pd.read_csv(out, index_col=0)
    assert list(got.columns) == ["f", "ber", "fer", "iters"]
    assert len(got) == 2


def test_sim_bsc_qc(tmp_path):
    """--qc on the BSC sweep: QC base-edge CSV drives the circulant-roll
    decoder + roll syndromes through the BitChannelEngine (an extension;
    reference sim_bsc.py reads expanded edge lists only)."""
    from qamreconciliation_jax.models.qc_decoder import make_qc_ldpc, save_qc_csv
    from qamreconciliation_jax.sims import sim_bsc

    qcfile = str(tmp_path / "qc.csv")
    base, vid, cid = make_qc_ldpc(12, 8, dv=3, dc=6, seed=3)
    save_qc_csv(qcfile, base, 8)
    out = str(tmp_path / "bsc_qc.csv")
    sim_bsc.main([
        qcfile, "--qc", "--out", out, "--maxiter", "10", "--simloops", "64",
        "--rber", "0.01", "0.02", "--rpoints", "2", "--batch", "32",
    ])
    got = pd.read_csv(out, index_col=0)
    assert list(got.columns) == ["f", "ber", "fer", "iters"]
    assert len(got) == 2
    assert (got.ber <= 1).all() and (got.ber >= 0).all()


def test_sim_bsc_lift_qc(tmp_path):
    """--lift-qc detects circulant structure in an EXPANDED edge CSV and
    decodes with the roll decoder (real standards ship expanded lists)."""
    from qamreconciliation_jax.models.qc_decoder import make_qc_ldpc
    from qamreconciliation_jax.sims import sim_bsc
    from qamreconciliation_jax.utils.edgefile import save_edge_csv

    base, vid, cid = make_qc_ldpc(12, 8, dv=3, dc=6, seed=3)
    expanded = str(tmp_path / "expanded.csv")
    save_edge_csv(expanded, vid, cid)
    out = str(tmp_path / "bsc_lift.csv")
    sim_bsc.main([
        expanded, "--lift-qc", "--out", out, "--maxiter", "10",
        "--simloops", "64", "--rber", "0.01", "0.02", "--rpoints", "2",
        "--batch", "32",
    ])
    got = pd.read_csv(out, index_col=0)
    assert list(got.columns) == ["f", "ber", "fer", "iters"]
    assert len(got) == 2
    # the lift really engaged (not the generic-decoder fallback)
    import argparse

    from qamreconciliation_jax.models.qc_decoder import QCDecoder
    from qamreconciliation_jax.sims.common import load_decoder

    ns = argparse.Namespace(edgefile=expanded, qc=False, lift_qc=True,
                            dtype="float32", check_rule="sumproduct",
                            first_row=True)
    dec, _, _ = load_decoder(ns)
    assert isinstance(dec, QCDecoder) and dec.z == 8


def test_sim_decode_qc(tmp_path):
    """--qc on the BI-AWGN sweep (soft and hard LLR flavors)."""
    from qamreconciliation_jax.models.qc_decoder import make_qc_ldpc, save_qc_csv
    from qamreconciliation_jax.sims import sim_decode

    qcfile = str(tmp_path / "qc.csv")
    base, vid, cid = make_qc_ldpc(12, 8, dv=3, dc=6, seed=3)
    save_qc_csv(qcfile, base, 8)
    out = str(tmp_path / "dec_qc.csv")
    sim_decode.main([
        qcfile, "--qc", "--out", out, "--maxiter", "10", "--simloops", "64",
        "--snr", "3", "3", "--nsnr", "1", "--batch", "32", "--hard",
    ])
    got = pd.read_csv(out, index_col=0)
    assert list(got.columns) == ["EbN0dB", "ber", "fer", "iters"]
    assert len(got) == 1


def test_sim_decode_and_direct(edgefile, tmp_path):
    from qamreconciliation_jax.sims import sim_decode, sim_direct

    out1 = str(tmp_path / "dec.csv")
    df1 = sim_decode.main([
        edgefile, "--out", out1, "--maxiter", "10", "--simloops", "64",
        "--snr", "3", "3", "--nsnr", "1", "--batch", "32",
        "--dtype", "float64",
    ])
    assert list(df1.dtype.names) == ["EbN0dB", "ber", "fer", "iters"]

    out2 = str(tmp_path / "dir.csv")
    df2 = sim_direct.main([
        edgefile, "--out", out2, "--maxiter", "10", "--simloops", "64",
        "--snr", "3", "3", "--nsnr", "1", "--batch", "32",
        "--dtype", "float64", "--hard",
    ])
    # reference quirk: sim_direct's SNR column is named EsN0dB
    assert list(df2.dtype.names) == ["EsN0dB", "ber", "fer", "iters"]


def test_sim_montecarlo_information(tmp_path):
    from qamreconciliation_jax.sims import sim_montecarlo_information as smi

    out = str(tmp_path / "mi.csv")
    df = smi.main([
        "--out", out, "--snr", "0", "5", "--nsnr", "2", "--niters", "2",
        "--samples-per-iter", "512", "--dtype", "float64", "--gnuplot",
    ])
    assert list(df.dtype.names) == ["EsN0dB", "I(X;Xhat)", "I(X;Y)", "I(N,X;Xhat)"]
    assert os.path.exists(out + ".gnuplot")


def test_sim_mutual_information_base_scheme(tmp_path):
    from qamreconciliation_jax.sims import (
        sim_mutual_information_base_scheme as smib,
    )

    out = str(tmp_path / "mib.csv")
    df = smib.main(["--out", out, "--snr", "3", "3", "--nsnr", "1"])
    assert list(df.dtype.names)[0] == "EsN0dB"
    assert len(df.dtype.names) == 7
    assert df["I(X;Y)"][0] > df["I(X;Xhat)"][0]


def test_sim_mutual_information_compare_signs(tmp_path):
    from qamreconciliation_jax.sims import (
        sim_mutual_information_compare_signs as smics,
    )

    out = str(tmp_path / "cs.csv")
    df = smics.main(["--out", out, "--snr", "3", "3", "--nsnr", "1"])
    # M=4: config_count = 2^1 * (2^2+1) = 10 configs + the SNR column
    assert len(df.dtype.names) == 11
    # the alternating config should not be worse than the base config
    base_col = "I(X,N;Xhat)_0"
    alt_col = "I(X,N;Xhat)_10"  # 0b1010 = alternate [0,1,0,1]
    assert df[alt_col][0] >= df[base_col][0] - 1e-9


def test_sim_compare_signs_montecarlo_batched_resume(tmp_path):
    """Config-batched MC path (one vmapped program over stacked mappers,
    chunk-padded) agrees with the sequential estimator to MC accuracy and
    honors --resume."""
    import jax
    import numpy as np

    from qamreconciliation_jax.models.alphabet import PAMAlphabet
    from qamreconciliation_jax.models.mutual_information import (
        P_xhat, montecarlo_information,
    )
    from qamreconciliation_jax.models.noisemapper import NoiseMapper
    from qamreconciliation_jax.sims import (
        sim_mutual_information_compare_signs as smics,
    )
    from qamreconciliation_jax.utils.checkpoint import SweepState

    out = str(tmp_path / "csmc.csv")
    args = ["--out", out, "--snr", "4", "4", "--nsnr", "1", "--montecarlo",
            "--nloops", "8", "--nmontecarlo", "4096", "--config-chunk", "3"]
    df = smics.main(args)
    assert len(df.dtype.names) == 11

    # statistical agreement with the sequential estimator on the base config
    pa = PAMAlphabet(2, 2)
    N0 = pa.variance * 10 ** (-0.4) / 2
    nm = NoiseMapper(pa, N0, np.zeros(4, np.uint8), dtype=np.float64)
    p = P_xhat(nm)
    key = jax.random.key(99)
    seq = np.mean([
        montecarlo_information(
            jax.random.fold_in(key, ln), pa, nm, p, 4096,
            which=(False, False, True),
        )[2]
        for ln in range(8)
    ])
    assert abs(df["I(X,N;Xhat)_0"][0] - seq) < 0.05

    # resume: pre-record a sentinel row and check it is honored
    state = SweepState(out)
    state.record(4.0, dict(values=[float(k) for k in range(10)]))
    df2 = smics.main(args + ["--resume"])
    assert df2["I(X,N;Xhat)_0"][0] == 0.0
    assert df2["I(X,N;Xhat)_12"][0] == 9.0


def test_sim_to_display_schema_roundtrip(tmp_path):
    """The sweep CSVs feed the display CLIs unchanged (schema contract)."""
    import matplotlib

    matplotlib.use("Agg")
    from qamreconciliation_jax.sims import sim_bsc, display_bsc
    from qamreconciliation_jax.utils.edgefile import make_regular_ldpc, save_edge_csv

    code = str(tmp_path / "code.csv")
    vid, cid = make_regular_ldpc(120, 3, 6, seed=3)
    save_edge_csv(code, vid, cid)
    out = str(tmp_path / "bsc.csv")
    sim_bsc.main(
        [code, "--out", out, "--rber", "0.02", "0.05", "--rpoints", "2",
         "--simloops", "16", "--batch", "8"])
    png = str(tmp_path / "bsc.png")
    display_bsc.main(["--file", out, "sweep", "--rate", "0.5", "--save", png])
    assert (tmp_path / "bsc.png").stat().st_size > 0


def test_sweep_csv_reads_back_identically(tmp_path):
    """The sweep CSV written without pandas has the reference's
    DataFrame.to_csv layout byte for byte, and every value reads back
    exactly (shortest round-trip float text)."""
    import csv

    from qamreconciliation_jax.sims.common import write_csv

    cols = ("EsN0dB", "ber", "fer", "iters")
    rows = [(3.0, 0.0019227731963734568, 0.568359375, 46.39718309859155),
            (3.25, 9.946469907407407e-07, 1 / 3, 37.0)]
    out = tmp_path / "w.csv"
    table = write_csv(str(out), cols, rows)
    assert list(table.dtype.names) == list(cols) and len(table) == 2
    text = out.read_text()
    assert text == pd.DataFrame(rows, columns=list(cols)).to_csv()
    with open(out, newline="") as f:
        back = list(csv.reader(f))
    assert back[0] == [""] + list(cols)
    for i, (line, row) in enumerate(zip(back[1:], rows)):
        assert line[0] == str(i)
        assert tuple(float(v) for v in line[1:]) == row
        assert tuple(table[i]) == row
