"""Render the sum-product vs normalized-min-sum BER/FER waterfall artifact.

Consumes two CSVs produced by sim_reconciliation (schema ``EsN0dB,ber,fer,
iters`` — reference: sims/sim_reconciliation.py:96-102) run with
identical seeds/code, and writes the comparison figure used
in README/docs (docs/img/checkrule_waterfall.png).

Usage: python scripts/plot_checkrule_waterfall.py SP.csv MS.csv OUT.png
"""

import sys

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import pandas as pd


def main(sp_csv, ms_csv, out_png):
    sp = pd.read_csv(sp_csv)
    ms = pd.read_csv(ms_csv)
    fig, axes = plt.subplots(1, 2, figsize=(10, 4), sharex=True)
    for ax, col, ylab in zip(axes, ("ber", "fer"), ("BER", "FER")):
        ax.semilogy(sp.EsN0dB, sp[col].clip(lower=1e-7), "o-",
                    label="exact sum-product (reference math)")
        ax.semilogy(ms.EsN0dB, ms[col].clip(lower=1e-7), "s--",
                    label="normalized min-sum (alpha=13/16)")
        ax.set_xlabel("$E_s/N_0$ [dB]")
        ax.set_ylabel(ylab)
        ax.grid(True, which="both", alpha=0.3)
    axes[0].legend(fontsize=8)
    fig.suptitle(
        "Softening reverse reconciliation, QC(3,6) N=64800 rate-1/2, "
        "maxiter=50", fontsize=10,
    )
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    print(f"wrote {out_png}")


if __name__ == "__main__":
    main(*sys.argv[1:4])
