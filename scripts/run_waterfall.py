"""DVB-S2-scale waterfall/knee runner (one CLI sweep).

Generates the standard QC(3,6) N=64800 rate-1/2 benchmark code (same
construction/seed as bench.py) into a temp CSV,
then forwards every remaining flag to the sim_reconciliation CLI — the
waterfall CSVs in docs/img/wf_*.csv are produced this way so
knee-FER comparisons share code, seeds, and protocol exactly.

Usage:
    python scripts/run_waterfall.py OUT.CSV --snr 3.0 4.25 --nsnr 6 \
        --simloops 1024 --batch 128 --maxiter 50 \
        --check-phi tanhfb --dtype bfloat16
(--qc and --out are added automatically; --irregular swaps in the QC-IRA
mixed-degree code from make_qc_ira at the same N.)
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv):
    out = argv[0]
    rest = list(argv[1:])
    from qamreconciliation_jax.models.qc_decoder import (
        make_qc_ira, make_qc_ldpc, save_qc_csv,
    )

    nbv = 36
    if "--nbv" in rest:
        k = rest.index("--nbv")
        nbv = int(rest[k + 1])
        del rest[k:k + 2]
    z = 64800 // nbv
    if "--dvbs2" in rest:
        # the DVB-S2 standard-construction code (models/dvbs2.py:
        # Annex B/C machinery + structure-exact synthetic table), as the
        # full-wrap z=360 QC base — e.g. `--dvbs2 1/2` or `--dvbs2 3/4`
        k = rest.index("--dvbs2")
        rate = rest[k + 1]
        del rest[k:k + 2]
        from qamreconciliation_jax.models.dvbs2 import (
            Z, make_table, to_qc_base,
        )

        base = to_qc_base(make_table(rate, seed=0), wrap="full")
        z = Z
        name = f"dvbs2_{rate.replace('/', '')}_qc.csv"
        code_csv = os.path.join(tempfile.gettempdir(), name)
        save_qc_csv(code_csv, base, z)
        from qamreconciliation_jax.sims import sim_reconciliation as sr

        sr.main([code_csv, "--qc", "--out", out] + rest)
        return
    if "--rate34" in rest:
        rest.remove("--rate34")
        # rate-3/4 QC-IRA (dc ~ 12-17 accumulator rows — the reference's
        # BSC-experiment rate, reference: sims/display_bsc.py:20-22)
        base, _, _ = make_qc_ira(nb_info=3 * nbv // 4, nb_acc=nbv // 4,
                                 z=z, dv=3, seed=12345)
        name = f"qc_ira34_64800_z{z}.csv"
    elif "--irregular" in rest:
        rest.remove("--irregular")
        # rate-1/2 IRA-like mixed-degree base, same N=64800
        base, _, _ = make_qc_ira(nb_info=nbv // 2, nb_acc=nbv // 2, z=z,
                                 dv=3, seed=12345)
        name = f"qc_ira_64800_z{z}.csv"
    else:
        base, _, _ = make_qc_ldpc(nbv, z, dv=3, dc=6, seed=12345)
        name = f"qc{nbv}_64800.csv"
    code_csv = os.path.join(tempfile.gettempdir(), name)
    save_qc_csv(code_csv, base, z)

    from qamreconciliation_jax.sims import sim_reconciliation as sr

    sr.main([code_csv, "--qc", "--out", out] + rest)


if __name__ == "__main__":
    main(sys.argv[1:])
