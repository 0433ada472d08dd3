"""Render the IRREGULAR-code engine waterfall artifact.

QC-IRA mixed-degree code (the structure class of real DVB-S2/5G
standards, models/qc_decoder.make_qc_ira) at DVB-S2 scale, run with
identical seeds/protocol (sim_reconciliation CLI via
scripts/run_waterfall.py --irregular; CSV schema ``EsN0dB,ber,fer,
iters`` — reference: sims/sim_reconciliation.py:96-102).  The figure
compares two decode engines on the same frames: the dense roll path and
a row-grouped single-kernel engine that an earlier version of this
repository carried (docs/DESIGN.md); their BER/FER agree at every grid
point.

Usage: python scripts/plot_irregular_waterfall.py \
           RESIDENT.csv DENSE.csv OUT.png
"""

import sys

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import pandas as pd


def main(res_csv, dense_csv, out_png):
    res = pd.read_csv(res_csv)
    den = pd.read_csv(dense_csv)
    fig, axes = plt.subplots(1, 2, figsize=(10, 4), sharex=True)
    for ax, col, ylab in zip(axes, ("ber", "fer"), ("BER", "FER")):
        ax.semilogy(den.EsN0dB, den[col].clip(lower=1e-7), "o-",
                    label="dense roll path")
        ax.semilogy(res.EsN0dB, res[col].clip(lower=1e-7), "^--",
                    label="row-grouped single-kernel engine")
        ax.set_xlabel("$E_s/N_0$ [dB]")
        ax.set_ylabel(ylab)
        ax.grid(True, which="both", alpha=0.3)
    axes[0].legend(fontsize=8)
    fig.suptitle(
        "Irregular QC-IRA rate-1/2 N=64800 (mixed check degrees 4..10), "
        "bf16 tanh-F/B, maxiter=50"
    )
    fig.tight_layout()
    fig.savefig(out_png, dpi=130)
    print(f"wrote {out_png}")


if __name__ == "__main__":
    main(*sys.argv[1:])
