"""BSC hard-decision BP sanity sweep CLI.

Flags and CSV schema mirror the reference (reference: sims/sim_bsc.py:10-91):
columns ``f,ber,fer,iters``; constant-magnitude log-base-2 LLRs (quirk
preserved, see bitchannel.py).
"""

import argparse

import numpy as np

from ..models.matrix import Matrix
from ..utils.checkpoint import SweepState
from .bitchannel import BitChannelEngine
from .common import (
    add_engine_args, add_qc_arg, engine_kwargs, load_decoder,
    init_runtime as common_init_runtime, write_csv,
)


def build_parser():
    parser = argparse.ArgumentParser(
        prog="sim_bsc",
        description="Evaluate BER for LDPC codes vs Raw BER",
    )
    parser.add_argument("edgefile")
    parser.add_argument("--out", default="out.csv")
    parser.add_argument("--maxiter", default=30, type=int)
    parser.add_argument("--minerr", default=20, type=int)
    parser.add_argument(
        "--first_row", default=True, action="store_true",
        help="Flag: does the first line of the csv contain the number of edges",
    )
    parser.add_argument("--simloops", default=30, type=int)
    parser.add_argument("--rber", type=float, nargs=2, default=[0.01, 0.04])
    parser.add_argument("--rpoints", type=int, default=31)
    add_qc_arg(parser)
    add_engine_args(parser)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    common_init_runtime()
    dec, vid, cid = load_decoder(args)
    mat = Matrix(vid, cid)
    kw = engine_kwargs(args)
    kw.pop("llr_mode", None)
    kw.pop("fy_mode", None)
    eng = BitChannelEngine(dec, mat, **kw)
    state = SweepState(args.out, resume=args.resume)

    raw_ber = np.linspace(args.rber[0], args.rber[1], args.rpoints)
    rows = []
    for f in raw_ber:
        prev = state.done(f)
        if prev is not None:
            rows.append((prev["point"], prev["ber"], prev["fer"], prev["iters"]))
            continue
        r = eng.run_bsc_point(float(f), args.maxiter, args.simloops, args.minerr)
        print(
            f"[RawBER={f}] frames={r.frames}, ber={r.ber:.4e}, "
            f"fer={r.fer:.4e}, iters={r.iters:.2f}"
        )
        state.record(f, dict(ber=r.ber, fer=r.fer, iters=r.iters))
        rows.append((float(f), r.ber, r.fer, r.iters))

    cols = ("f", "ber", "fer", "iters")
    try:
        table = write_csv(args.out, cols, rows)
    except OSError:     # the reference falls back to ./out.csv
        table = write_csv("out.csv", cols, rows)
    state.cleanup()
    return table


if __name__ == "__main__":
    main()
