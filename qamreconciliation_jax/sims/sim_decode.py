"""BI-AWGN decode sweep CLI (syndrome decoding of BPSK over AWGN).

Flags and CSV schema mirror the reference (reference: sims/sim_decode.py):
columns ``EbN0dB,ber,fer,iters``; soft LLR ``2*alpha/v*r`` or hard
``LLR0*sign(r)`` with ``--hard``.
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
        prog="sim_decode",
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
    parser.add_argument("--snr", type=float, nargs=2, default=[0, 5])
    parser.add_argument("--nsnr", type=int, default=11)
    parser.add_argument("--alpha", type=float, default=1.0)
    parser.add_argument("--hard", action="store_true", default=False)
    add_qc_arg(parser)
    add_engine_args(parser)
    return parser


def run_sweep(args, snr_column: str):
    dec, vid, cid = load_decoder(args)
    mat = Matrix(vid, cid)
    kw = engine_kwargs(args)
    kw.pop("llr_mode", None)
    kw.pop("fy_mode", None)
    eng = BitChannelEngine(dec, mat, **kw)
    state = SweepState(args.out, resume=args.resume)

    grid = np.linspace(args.snr[0], args.snr[1], args.nsnr)
    rows = []
    for snr in grid:
        prev = state.done(snr)
        if prev is not None:
            rows.append((prev["point"], prev["ber"], prev["fer"], prev["iters"]))
            continue
        r = eng.run_biawgn_point(
            float(snr), args.maxiter, args.simloops, args.minerr,
            alpha=args.alpha, hard=args.hard,
        )
        print(
            f"[{snr_column}={snr:.3f}] frames={r.frames} ber={r.ber:.3e} "
            f"fer={r.fer:.3e} iters={r.iters:.2f}"
        )
        state.record(snr, dict(ber=r.ber, fer=r.fer, iters=r.iters))
        rows.append((float(snr), r.ber, r.fer, r.iters))

    table = write_csv(args.out, (snr_column, "ber", "fer", "iters"), rows)
    state.cleanup()
    return table


def main(argv=None):
    args = build_parser().parse_args(argv)
    common_init_runtime()
    return run_sweep(args, "EbN0dB")


if __name__ == "__main__":
    main()
