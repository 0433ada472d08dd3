"""Render the sum-product ENGINE comparison waterfall artifact.

Sum-product decode engines run at DVB-S2 scale
with identical seeds/code/protocol (sim_reconciliation CLI sweeps,
schema ``EsN0dB,ber,fer,iters`` — reference: sims/sim_reconciliation.py:
96-102).  Two facts in one figure: (1) at bf16 the dense phi-form path
and a single-kernel tanh-F/B engine (an earlier version of this
repository, docs/DESIGN.md) are BER/FER-IDENTICAL
at every grid point (knee FER 0.584 both — the engines share the bf16
rounding that dominates the error budget); (2) the bf16-vs-float32
message-storage cost itself is visible and small: knee FER 0.58 vs
0.42 at 3.5 dB, ~0.05 dB of threshold (Alternating sign config).

Usage: python scripts/plot_sumproduct_engines_waterfall.py \
           SP_BF16.csv FB_RES.csv SP_F32.csv OUT.png [HYBRID.csv]

The optional HYBRID.csv overlays the f32-totals/bf16-messages resident
hybrid (--totals-dtype float32) — knee-NEUTRAL vs bf16 (the knee cost
is message rounding, not totals).
"""

import sys

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import pandas as pd


def main(sp_csv, fb_csv, f32_csv, out_png, hybrid_csv=None):
    sp = pd.read_csv(sp_csv)
    fb = pd.read_csv(fb_csv)
    f32 = pd.read_csv(f32_csv)
    hy = pd.read_csv(hybrid_csv) if hybrid_csv else None
    fig, axes = plt.subplots(1, 2, figsize=(10, 4), sharex=True)
    for ax, col, ylab in zip(axes, ("ber", "fer"), ("BER", "FER")):
        ax.semilogy(sp.EsN0dB, sp[col].clip(lower=1e-7), "o-",
                    label="dense, phi form, bf16")
        ax.semilogy(fb.EsN0dB, fb[col].clip(lower=1e-7), "^-.",
                    label="single-kernel, tanh-F/B, bf16")
        ax.semilogy(f32.EsN0dB, f32[col].clip(lower=1e-7), "s--",
                    label="dense, phi form, float32")
        if hy is not None:
            ax.semilogy(hy.EsN0dB, hy[col].clip(lower=1e-7), "x:",
                        label="single-kernel, f32-totals hybrid (knee-neutral)")
        ax.set_xlabel("$E_s/N_0$ [dB]")
        ax.set_ylabel(ylab)
        ax.grid(True, which="both", alpha=0.3)
    axes[0].legend(fontsize=8)
    fig.suptitle(
        "Sum-product decode engines: softening reverse reconciliation, "
        "QC(3,6) N=64800 rate-1/2, maxiter=50", fontsize=10,
    )
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    print(f"wrote {out_png}")


if __name__ == "__main__":
    main(*sys.argv[1:6])
