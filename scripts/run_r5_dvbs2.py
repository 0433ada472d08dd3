"""DVB-S2 standard-construction code artifacts.

One process, three decoding-quality measurements on the models/dvbs2.py
codes (structure-exact synthetic Annex-B tables, see models/dvbs2.py):

  1. rate-1/2 waterfall (full-wrap z=360 QC base, tanh-F/B bf16, 1024
     frames/point) -> docs/img/wf_dvbs2_12.csv;
  2. full-wrap QC vs exact-H equivalence: the QC fast path adds ONE
     edge to check (0,0) of ~2e5 (models/dvbs2.to_qc_base); FER/BER at
     a waterfall point, same seeds, QC-full vs exact-H generic decode;
  3. rate-3/4 BSC sweep (the reference's display_bsc regime, reference:
     sims/display_bsc.py:20-22) -> docs/img/bsc_dvbs2_34.csv.

Usage: timeout 10800 python scripts/run_r5_dvbs2.py > dvbs2.jsonl 2> log
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--simloops", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--maxiter", type=int, default=50)
    ap.add_argument("--snr", type=float, nargs=2, default=[3.0, 4.25])
    ap.add_argument("--nsnr", type=int, default=6)
    ap.add_argument("--equiv-snr", type=float, default=3.75)
    ap.add_argument("--steps", default="wf,equiv,bsc")
    args = ap.parse_args()

    from qamreconciliation_jax.models.dvbs2 import (
        Z, expanded_edges, make_table, to_qc_base,
    )
    from qamreconciliation_jax.models.qc_decoder import save_qc_csv
    from qamreconciliation_jax.utils.edgefile import save_edge_csv
    from qamreconciliation_jax.sims import sim_bsc, sim_reconciliation

    steps = args.steps.split(",")
    tmp = tempfile.gettempdir()
    t12 = make_table("1/2", seed=0)
    qc12 = os.path.join(tmp, "dvbs2_12_qc.csv")
    save_qc_csv(qc12, to_qc_base(t12, wrap="full"), Z)

    if "wf" in steps:
        out_csv = os.path.join(REPO, "docs/img/wf_dvbs2_12.csv")
        t0 = time.perf_counter()
        sim_reconciliation.main([
            qc12, "--qc", "--out", out_csv,
            "--snr", str(args.snr[0]), str(args.snr[1]),
            "--nsnr", str(args.nsnr),
            "--simloops", str(args.simloops),
            "--batch", str(args.batch),
            "--maxiter", str(args.maxiter),
            "--ferr-count-min", "1000000000",
            "--dtype", "bfloat16", "--check-phi", "tanhfb",
        ])
        print(json.dumps({
            "step": "wf_dvbs2_12", "csv": out_csv,
            "wall_s": round(time.perf_counter() - t0, 1),
        }), flush=True)

    if "equiv" in steps:
        # same softening protocol, one SNR point, QC-full vs exact-H
        # (generic gather decoder); identical engine seeds
        res = {}
        for tag, argv_extra in (
            ("qc_full", [qc12, "--qc", "--dtype", "bfloat16",
                         "--check-phi", "tanhfb"]),
            ("exact_generic", [None, "--dtype", "bfloat16",
                               "--check-phi", "tanhfb"]),
        ):
            if tag == "exact_generic":
                vid, cid = expanded_edges(t12)
                p = os.path.join(tmp, "dvbs2_12_exact.csv")
                save_edge_csv(p, vid, cid)
                argv_extra[0] = p
            out_csv = os.path.join(tmp, f"dvbs2_equiv_{tag}.csv")
            t0 = time.perf_counter()
            row = sim_reconciliation.main(argv_extra + [
                "--out", out_csv,
                "--snr", str(args.equiv_snr), str(args.equiv_snr),
                "--nsnr", "1", "--simloops", str(args.simloops),
                "--batch", str(args.batch),
                "--maxiter", str(args.maxiter),
                "--ferr-count-min", "1000000000",
            ])[0]
            res[tag] = {"fer": float(row["fer"]), "ber": float(row["ber"]),
                        "iters": float(row["iters"]),
                        "wall_s": round(time.perf_counter() - t0, 1)}
        print(json.dumps({"step": "wrap_equivalence",
                          "snr_dB": args.equiv_snr, **res}), flush=True)

    if "bsc" in steps:
        t34 = make_table("3/4", seed=0)
        qc34 = os.path.join(tmp, "dvbs2_34_qc.csv")
        save_qc_csv(qc34, to_qc_base(t34, wrap="full"), Z)
        out_csv = os.path.join(REPO, "docs/img/bsc_dvbs2_34.csv")
        t0 = time.perf_counter()
        sim_bsc.main([
            qc34, "--qc", "--out", out_csv,
            "--rber", "0.010", "0.040", "--rpoints", "7",
            "--simloops", str(args.simloops),
            "--batch", str(args.batch), "--maxiter", str(args.maxiter),
            "--minerr", "1000000000",
            "--dtype", "bfloat16",
        ])
        print(json.dumps({
            "step": "bsc_dvbs2_34", "csv": out_csv,
            "wall_s": round(time.perf_counter() - t0, 1),
        }), flush=True)


if __name__ == "__main__":
    main()
