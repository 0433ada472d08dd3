"""Render the 16-PAM (bps=4) mode/sign-configuration waterfall artifact.

Consumes four sim_reconciliation CSVs run with identical
seeds/code/maxiter (reference:
sims/reconciliation.pyx:173/253 via sim_reconciliation.py --hard/--direct/
--configuration-base):

  softening, Alternating sign configuration (the CLI default)
  softening, Base configuration (--configuration-base)
  hard reverse (--hard)
  soft direct (--direct)

Usage: python scripts/plot_bps4_waterfall.py ALT.csv BASE.csv HARD.csv \
           DIRECT.csv OUT.png
"""

import sys

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import pandas as pd


def main(alt_csv, base_csv, hard_csv, direct_csv, out_png):
    curves = [
        (pd.read_csv(alt_csv), "o-", "softening, Alternating config"),
        (pd.read_csv(base_csv), "v-", "softening, Base config"),
        (pd.read_csv(hard_csv), "s--", "hard reverse"),
        (pd.read_csv(direct_csv), "d-.", "soft direct"),
    ]
    fig, axes = plt.subplots(1, 2, figsize=(10, 4), sharex=True)
    for ax, col, ylab in zip(axes, ("ber", "fer"), ("BER", "FER")):
        for df, fmt, label in curves:
            ax.semilogy(df.EsN0dB, df[col].clip(lower=1e-7), fmt, label=label)
        ax.set_xlabel("$E_s/N_0$ [dB]")
        ax.set_ylabel(ylab)
        ax.grid(True, which="both", alpha=0.3)
    axes[0].legend(fontsize=8)
    fig.suptitle(
        "16-PAM (bps=4) reconciliation modes, QC(3,6) N=64800 rate-1/2, "
        "maxiter=50, 1024 frames/point", fontsize=10,
    )
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    print(f"wrote {out_png}")


if __name__ == "__main__":
    main(*sys.argv[1:6])
