"""Reconciliation BER/FER sweep CLI.

Flag surface and CSV schema of record mirror the reference CLI 1:1
(reference: sims/sim_reconciliation.py:27-46, 96-102; README.md:117-138):

    python -m qamreconciliation_jax.sims.sim_reconciliation EDGEFILE \
        [--out out.csv] [--maxiter 50] [--ferr-count-min 100] [--alpha 1.0]
        [--simloops 5000] [--snr 0 5] [--nsnr 11] [--bps 2]
        [--hard] [--direct] [--configuration-base]

plus the engine extensions (--batch/--dtype/--devices/--llr-exact/--seed/
--resume/--profile-dir).  Output CSV columns: ``EsN0dB,ber,fer,iters``
after a leading unnamed index column (the reference writes its CSV with
pandas' ``to_csv``, index included).

Where the reference forks one process per SNR point (parfor), the sweep here
runs points sequentially but each point processes a whole frame batch per
device step — the parallelism moved inside the point.
"""

import argparse

import numpy as np

from ..models.alphabet import PAMAlphabet
from ..models.matrix import Matrix
from ..sims.engine import ReconciliationEngine
from ..utils.checkpoint import SweepState
from .common import (
    add_engine_args, add_qc_arg, engine_kwargs, load_decoder,
    init_runtime as common_init_runtime, write_csv,
)


COLUMNS = ("EsN0dB", "ber", "fer", "iters")


def build_parser():
    parser = argparse.ArgumentParser(
        prog="decode",
        description="Evaluate BER for LDPC codes vs Raw BER",
    )
    parser.add_argument(
        "edgefile",
        help="CSV with a 'vid' and a 'cid' columns representing an edge per line",
    )
    add_qc_arg(parser)
    parser.add_argument("--out", default="out.csv")
    parser.add_argument("--maxiter", default=50, type=int,
                        help="Maximum number of iterations for the decoder")
    parser.add_argument("--ferr-count-min", default=100, type=int,
                        help="Minimum number of frame errors for early exit")
    parser.add_argument("--alpha", type=float, default=1.0,
                        help="Extra multiplicative coefficient for the LLR")
    parser.add_argument("--simloops", default=5000, type=int,
                        help="Number of frames per SNR point")
    parser.add_argument("--snr", type=float, nargs=2, default=[0, 5],
                        help="Initial and final SNR [dB] values of the range "
                        "to evaluate the BER at")
    parser.add_argument("--nsnr", type=int, default=11,
                        help="Number of equally spaced SNR [dB] points to "
                        "evaluate the BER at")
    parser.add_argument("--bps", type=int, default=2,
                        help="Bit Per Symbol (=log_2(PAM Order))")
    parser.add_argument("--hard", action="store_true",
                        help="Simulate hard reverse reconciliation")
    parser.add_argument("--direct", action="store_true",
                        help="Simulate the soft direct reconciliation, "
                        "overrides '--hard'")
    parser.add_argument("--configuration-base", action="store_true",
                        help="Instead of the Alternating configuration, use "
                        "the Base configuration")
    parser.add_argument("--graph-shard", action="store_true",
                        help="Partition the Tanner GRAPH over --devices "
                        "devices (for codes too large for one device); frames "
                        "stay whole.  Generic codes shard check nodes "
                        "(variable totals psum-reduced per BP iteration); "
                        "--qc/--lift-qc codes shard the circulant lane axis "
                        "(rolls become collective-permutes).  Composes "
                        "with --check-rule/--check-phi/--minsum-alpha/"
                        "--minsum-beta; mutually exclusive with frame-shard "
                        "DP and --point-batch")
    parser.add_argument("--point-batch", action="store_true",
                        help="Advance ALL SNR points per device dispatch "
                        "(vmapped over the grid; meant for small-N full "
                        "sweeps, where one point's batch leaves the device "
                        "idle). "
                        "The journal's frames_per_s then reports the "
                        "grid-AGGREGATE throughput, identical on every row "
                        "(points share each dispatch)")
    add_engine_args(parser)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    common_init_runtime()

    if args.graph_shard and args.point_batch:
        raise SystemExit(
            "--graph-shard is mutually exclusive with --point-batch"
        )
    if args.graph_shard and args.schedule != "flooding":
        raise SystemExit("--graph-shard supports only --schedule flooding")
    dec, vid, cid = load_decoder(args)
    if args.graph_shard:
        from ..models.qc_decoder import QCDecoder
        from ..parallel import make_mesh
        from ..parallel.graph_shard import ShardedDecoder, ShardedQCDecoder

        mesh = make_mesh(args.devices, axis_name="gs")
        ms_kw = dict(minsum_alpha=args.minsum_alpha,
                     minsum_beta=args.minsum_beta)
        if isinstance(dec, QCDecoder):
            # quasi-cyclic: shard the circulant lane axis
            dec = ShardedQCDecoder(
                dec.base_edges, dec.z, mesh, dtype=np.dtype(args.dtype),
                check_rule=args.check_rule, check_phi=args.check_phi,
                **ms_kw,
            )
        else:
            dec = ShardedDecoder(
                vid, cid, mesh, dtype=np.dtype(args.dtype),
                check_rule=args.check_rule, check_phi=args.check_phi,
                **ms_kw,
            )
    mat = Matrix(vid, cid)
    pa = PAMAlphabet(args.bps, 2)

    # mode selection: --direct overrides --hard (reference: 57-77)
    mode = "direct" if args.direct else ("hard" if args.hard else "softening")
    nmconfig = None
    if mode == "softening":
        nmconfig = np.zeros(pa.order, dtype=np.uint8)
        if not args.configuration_base:
            nmconfig[1::2] = 1  # Alternating configuration

    eng_kw = engine_kwargs(args)
    if args.graph_shard:
        # --devices carries the graph shards here, not frame-shard DP
        eng_kw.pop("mesh_axis", None)
    eng = ReconciliationEngine(dec, mat, pa, **eng_kw)
    state = SweepState(args.out, resume=args.resume)

    EsN0dB = np.linspace(args.snr[0], args.snr[1], args.nsnr)

    if args.point_batch:
        # honor the resume journal: only the pending points enter the batch
        done_rows = {}
        pending = []
        for snr in EsN0dB:
            prev = state.done(snr)
            if prev is not None:
                done_rows[float(snr)] = (
                    prev["point"], prev["ber"], prev["fer"], prev["iters"]
                )
            else:
                pending.append(float(snr))
        results = []
        if pending:
            results = eng.run_sweep_batched(
                mode, pending, args.maxiter, args.simloops,
                args.ferr_count_min, alpha=args.alpha, nmconfig=nmconfig,
                seed=args.seed,
            )
            for r in results:
                state.record(r.snr_dB, dict(ber=r.ber, fer=r.fer,
                                            iters=r.iters, frames=r.frames,
                                            frames_per_s=r.frames_per_s))
                done_rows[r.snr_dB] = (r.snr_dB, r.ber, r.fer, r.iters)
        rows = []
        for snr in EsN0dB:
            row = done_rows[float(snr)]
            print(
                f"[EsN0dB={row[0]:.3f}] ber={row[1]:.3e} "
                f"fer={row[2]:.3e} iters={row[3]:.2f}"
            )
            rows.append(row)
        table = write_csv(args.out, COLUMNS, rows)
        state.cleanup()
        if results:
            print(f"sweep throughput: {results[0].frames_per_s:.1f} frames/s")
        return table

    rows = []
    for i, snr in enumerate(EsN0dB):
        prev = state.done(snr)
        if prev is not None:
            rows.append((prev["point"], prev["ber"], prev["fer"], prev["iters"]))
            continue
        ctx = None
        if args.profile_dir and i == 0:
            import jax

            ctx = jax.profiler.trace(args.profile_dir)
            ctx.__enter__()
        r = eng.run_point(
            mode,
            float(snr),
            args.maxiter,
            args.simloops,
            args.ferr_count_min,
            alpha=args.alpha,
            nmconfig=nmconfig,
            seed=args.seed + 1000003 * i,
        )
        if ctx is not None:
            ctx.__exit__(None, None, None)
        print(
            f"[EsN0dB={snr:.3f}] frames={r.frames} ber={r.ber:.3e} "
            f"fer={r.fer:.3e} iters={r.iters:.2f} "
            f"({r.frames_per_s:.1f} frames/s, compile {r.compile_s:.1f} s)"
        )
        state.record(snr, dict(ber=r.ber, fer=r.fer, iters=r.iters,
                               frames=r.frames, frames_per_s=r.frames_per_s))
        rows.append((float(snr), r.ber, r.fer, r.iters))

    table = write_csv(args.out, COLUMNS, rows)
    state.cleanup()
    return table


if __name__ == "__main__":
    main()
