"""Min-sum (alpha, beta) tuning grid at the DVB-S2 waterfall knee.

A density-evolution-style empirical
grid over the normalized/offset min-sum knobs, measured where it matters —
the knee points (3.5 / 3.75 dB) of the standard QC(3,6) N=64800 benchmark
code — journaled one JSON line per (alpha, beta) so an interrupted sweep
resumes for free.  Each config bakes its constants into the compiled round
(alpha/beta changes recompile), so the grid costs one compile
per config; both SNR points ride the same program.

Reference for the tuning surface: qamreconciliation/decoder.pyx:322-369
(the reference's check node is exact sum-product only; OMS/NMS is an
extension).

Usage:
    python scripts/run_oms_sweep.py --out oms_grid.jsonl
"""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="oms_grid.jsonl")
    ap.add_argument("--alphas", type=float, nargs="+",
                    default=[0.75, 13.0 / 16.0, 0.875, 1.0])
    ap.add_argument("--betas", type=float, nargs="+",
                    default=[0.0, 0.15, 0.3, 0.5])
    ap.add_argument("--snr", type=float, nargs=2, default=[3.5, 3.75])
    ap.add_argument("--simloops", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--maxiter", type=int, default=50)
    args = ap.parse_args()

    import numpy as np

    from qamreconciliation_jax.models.qc_decoder import (
        make_qc_ldpc, save_qc_csv,
    )
    from qamreconciliation_jax.sims import sim_reconciliation as sr

    z = 1800
    base, _, _ = make_qc_ldpc(36, z, dv=3, dc=6, seed=12345)
    code_csv = os.path.join(tempfile.gettempdir(), "qc36_64800.csv")
    save_qc_csv(code_csv, base, z)

    done = set()
    if os.path.exists(args.out):
        with open(args.out) as fh:
            for line in fh:
                r = json.loads(line)
                done.add((r["alpha"], r["beta"]))

    grid = [(a, b) for a in args.alphas for b in args.betas
            # alpha<1 with beta>0 double-penalizes; keep the classic axes
            # plus the pure-OMS column (alpha=1)
            if b == 0.0 or a == 1.0]
    for a, b in grid:
        if (round(a, 6), round(b, 6)) in done:
            print(f"skip alpha={a} beta={b} (journaled)", file=sys.stderr)
            continue
        out_csv = os.path.join(
            tempfile.gettempdir(), f"oms_{a:.4f}_{b:.4f}.csv"
        )
        argv = [code_csv, "--qc", "--out", out_csv,
                "--snr", str(args.snr[0]), str(args.snr[1]), "--nsnr", "2",
                "--simloops", str(args.simloops),
                "--batch", str(args.batch),
                "--maxiter", str(args.maxiter),
                "--check-rule", "minsum",
                "--minsum-alpha", str(a), "--minsum-beta", str(b),
                "--dtype", "bfloat16"]
        table = sr.main(argv)
        rec = {"alpha": round(a, 6), "beta": round(b, 6)}
        for row in table:
            tag = f"{row['EsN0dB']:g}dB"
            rec[f"fer@{tag}"] = float(row["fer"])
            rec[f"ber@{tag}"] = float(row["ber"])
            rec[f"iters@{tag}"] = float(row["iters"])
        with open(args.out, "a") as fh:
            fh.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), file=sys.stderr)


if __name__ == "__main__":
    main()
