"""Render the flooding vs layered schedule waterfall artifact.

Consumes three sim_reconciliation CSVs (schema ``EsN0dB,ber,fer,iters`` —
reference: sims/sim_reconciliation.py:96-102) run with identical
seeds/code/maxiter:

  sum-product flooding (the reference's math + schedule),
  min-sum flooding, and min-sum layered (--schedule layered)

and writes a BER / FER / mean-iterations comparison
(docs/img/schedule_waterfall.png): layered halves the sweeps to converge
and recovers most of min-sum's threshold penalty at fixed maxiter.

Usage: python scripts/plot_schedule_waterfall.py SP.csv MS.csv LAY.csv OUT.png
"""

import sys

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import pandas as pd


def main(sp_csv, ms_csv, lay_csv, out_png):
    curves = [
        (pd.read_csv(sp_csv), "o-", "sum-product, flooding (reference math)"),
        (pd.read_csv(ms_csv), "s--", "min-sum, flooding"),
        (pd.read_csv(lay_csv), "d-.", "min-sum, layered (serial-C)"),
    ]
    fig, axes = plt.subplots(1, 3, figsize=(13, 4), sharex=True)
    for ax, col, ylab in zip(axes[:2], ("ber", "fer"), ("BER", "FER")):
        for df, fmt, label in curves:
            ax.semilogy(df.EsN0dB, df[col].clip(lower=1e-7), fmt, label=label)
        ax.set_xlabel("$E_s/N_0$ [dB]")
        ax.set_ylabel(ylab)
        ax.grid(True, which="both", alpha=0.3)
    ax = axes[2]
    for df, fmt, label in curves:
        conv = df[df.fer < 1.0]
        ax.plot(conv.EsN0dB, conv.iters, fmt, label=label)
    ax.set_xlabel("$E_s/N_0$ [dB]")
    ax.set_ylabel("mean iterations (successes)")
    ax.grid(True, alpha=0.3)
    axes[0].legend(fontsize=8)
    fig.suptitle(
        "Softening reverse reconciliation, QC(3,6) N=64800 rate-1/2, "
        "maxiter=50, 1024 frames/point", fontsize=10,
    )
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    print(f"wrote {out_png}")


if __name__ == "__main__":
    main(*sys.argv[1:5])
