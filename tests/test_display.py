"""Display CLIs render headless from synthetic sweep CSVs."""

import numpy as np
import pandas as pd
import pytest

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")


@pytest.fixture()
def ber_csv(tmp_path):
    path = str(tmp_path / "ber.csv")
    snr = np.linspace(0, 5, 6)
    pd.DataFrame({
        "EsN0dB": snr,
        "ber": 10.0 ** (-1 - snr / 2),
        "fer": 10.0 ** (-0.5 - snr / 2),
        "iters": np.full(6, 12.0),
    }).to_csv(path)
    return path


@pytest.fixture()
def bsc_csv(tmp_path):
    path = str(tmp_path / "bsc.csv")
    f = np.linspace(0.01, 0.1, 10)
    pd.DataFrame({
        "f": f,
        "ber": f ** 1.5,
        "fer": f,
        "iters": np.full(10, 9.0),
    }).to_csv(path)
    return path


@pytest.fixture()
def mi_csv(tmp_path):
    path = str(tmp_path / "mi.csv")
    snr = np.linspace(-5, 15, 11)
    sat = 1 / (1 + 10 ** (-snr / 10))
    pd.DataFrame({
        "EsN0dB": snr,
        "I(X;Xhat)": sat * 1.6,
        "I(X;Y)": sat * 2.0,
        "I(N,X;Xhat)": sat * 1.8,
    }).to_csv(path)
    return path


def test_display_mi(mi_csv, tmp_path):
    from qamreconciliation_jax.sims import display_mi

    out = str(tmp_path / "mi.png")
    display_mi.main([mi_csv, "--rescalex", "--title", "t", "--save", out])
    assert (tmp_path / "mi.png").stat().st_size > 0


def test_display_monotonicity(mi_csv, tmp_path):
    from qamreconciliation_jax.sims import display_monotonicity

    out = str(tmp_path / "mono.png")
    display_monotonicity.main(
        [mi_csv, "--reference-file", mi_csv, "--save", out]
    )
    assert (tmp_path / "mono.png").stat().st_size > 0


def test_display_softened(ber_csv, tmp_path):
    from qamreconciliation_jax.sims import display_softened

    out = str(tmp_path / "soft.png")
    display_softened.main([
        "--file", ber_csv, "run A", "--bps", "2", "--rate", "0.5",
        "--nsnr", "5", "--save", out,
    ])
    assert (tmp_path / "soft.png").stat().st_size > 0


def test_display_softened_uncoded_floor_decreasing():
    from qamreconciliation_jax.sims.display_softened import uncoded_ber

    snr = np.array([-5.0, 0.0, 5.0, 10.0, 15.0])
    p_b = uncoded_ber(2, snr)
    assert np.all(np.diff(p_b) < 0)
    assert np.all((p_b > 0) & (p_b < 0.5))


def test_display_bsc(bsc_csv, tmp_path):
    from qamreconciliation_jax.sims import display_bsc

    out = str(tmp_path / "bsc.png")
    display_bsc.main([
        "--file", bsc_csv, "jax decoder", "--rate", "0.75", "--save", out,
    ])
    assert (tmp_path / "bsc.png").stat().st_size > 0


def test_display_bsc_shannon_locus_monotone():
    from qamreconciliation_jax.sims.display_bsc import shannon_limit_bsc

    f_grid, p_b_grid = shannon_limit_bsc(0.75, [0.01, 0.1], n=20)
    # A rate-R code tolerating a larger residual BER tolerates more raw flips
    assert np.all(np.diff(f_grid) > 0)
    assert np.all((f_grid > 0) & (f_grid < 0.5))


def test_display_biawgn(ber_csv, tmp_path):
    from qamreconciliation_jax.sims import display_biawgn

    out = str(tmp_path / "biawgn.png")
    display_biawgn.main([
        "--file", ber_csv, "soft 50 iter", "--rate", "0.5", "--shannon",
        "--save", out,
    ])
    assert (tmp_path / "biawgn.png").stat().st_size > 0


def test_biawgn_capacity_limits():
    from qamreconciliation_jax.sims.display_biawgn import biawgn_capacity

    c = biawgn_capacity(np.array([1e-6, 0.1, 1.0, 10.0, 100.0]))
    assert np.all(np.diff(c) > 0)
    assert c[0] == pytest.approx(0.0, abs=1e-3)
    assert c[-1] == pytest.approx(1.0, abs=1e-3)
