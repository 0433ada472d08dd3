"""Monte-Carlo mutual-information sweep CLI.

Mirrors the reference (reference: sims/sim_montecarlo_information.py):
columns ``EsN0dB,I(X;Xhat),I(X;Y),I(N,X;Xhat)``; optional gnuplot script /
matplotlib display.  Reference sign conventions preserved (see
models/mutual_information.py).
"""

import argparse

import numpy as np

from ..models.alphabet import PAMAlphabet
from ..models.mutual_information import P_xhat, montecarlo_information
from ..models.noisemapper import NoiseMapper
from ..utils.checkpoint import SweepState
from .common import init_runtime as common_init_runtime, write_csv


def build_parser():
    parser = argparse.ArgumentParser(
        prog="mutual_information_base_scheme",
        description="Evaluate mutual information vs SNR of the base scheme",
    )
    parser.add_argument("--out", default="out.csv")
    parser.add_argument("--snr", type=float, nargs=2, default=[-20, 20])
    parser.add_argument("--nsnr", type=int, default=401)
    parser.add_argument("--bps", type=int, default=2)
    parser.add_argument("--niters", type=int, default=1 << 8)
    parser.add_argument("--samples-per-iter", type=int, default=1 << 12)
    parser.add_argument("--display", action="store_true")
    parser.add_argument("--gnuplot", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--mc-ginv", choices=["poly", "interp"], default="poly",
        help="Candidate-inverse reconstruction inside the I(X,N;Xhat) "
        "estimator: 'poly' (gather-free Chebyshev inverse CDF, "
        "deviation ~3e-4 — far below MC noise) or "
        "'interp' (the reference's g_inv grid interpolation, mirrored "
        "exactly)",
    )
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "float64"])
    parser.add_argument("--resume", action="store_true")
    return parser


def main(argv=None):
    import jax

    args = build_parser().parse_args(argv)
    common_init_runtime()
    EsN0dB = np.linspace(args.snr[0], args.snr[1], args.nsnr)
    state = SweepState(args.out, resume=args.resume)

    # One alphabet for the whole sweep: it is a static (identity-hashed)
    # argument of the jitted MC estimator, so rebuilding it per point would
    # force a recompile per point.
    pa = PAMAlphabet(args.bps, 2)
    Es = pa.variance
    rows = []
    for i, esn0db in enumerate(EsN0dB):
        prev = state.done(esn0db)
        if prev is not None:
            rows.append((prev["point"], prev["ixxh"], prev["ixy"], prev["ixnxh"]))
            continue
        N0 = Es * (10 ** (-esn0db / 10)) / 2
        nm = NoiseMapper(pa, N0, dtype=np.dtype(args.dtype))
        if args.mc_ginv == "poly":
            nm._ensure_ginv_poly()   # before the pytree enters jit
        p_Xhat = P_xhat(nm)

        key = jax.random.key(args.seed + 7919 * i)
        # Fold iterations into fewer, larger estimator calls (identical
        # sample-mean estimator): each call pays a dispatch and a
        # readback, so niters x small calls would be dispatch-bound.  Cap the per-call sample count to bound memory of
        # the [N, M, M] intermediate.
        chunk_iters = max(1, min(args.niters, (1 << 21) // args.samples_per_iter))
        acc = np.zeros(3)
        done_iters = 0
        it = 0
        while done_iters < args.niters:
            take = min(chunk_iters, args.niters - done_iters)
            acc += take * np.asarray(
                montecarlo_information(
                    jax.random.fold_in(key, it), pa, nm, p_Xhat,
                    args.samples_per_iter * take,
                    ginv_mode=args.mc_ginv,
                )
            )
            done_iters += take
            it += 1
        acc /= args.niters
        state.record(esn0db, dict(ixxh=acc[0], ixy=acc[1], ixnxh=acc[2]))
        rows.append((float(esn0db), acc[0], acc[1], acc[2]))

    df = write_csv(
        args.out, ("EsN0dB", "I(X;Xhat)", "I(X;Y)", "I(N,X;Xhat)"), rows
    )
    state.cleanup()

    if args.gnuplot:
        # The script text is an output-artifact spec reproduced verbatim
        # (reference: sims/sim_montecarlo_information.py:80-94).
        gnuplot_script = f"""
        set datafile separator ","
        set xlabel "E_b/N_0 [dB]"
        set ylabel "I(X, N ; \\hat{{X}}) [bit/c.u.]"
        set grid

        plot '{args.out}' using 2:5 with lines title "I(X,N;Xhat)", \\
             '{args.out}' using 2:3 with lines title "I(X;Xhat)", \\
             '{args.out}' using 2:4 with lines title "I(X;Y)"

        """
        with open(f"{args.out}.gnuplot", "w") as f:
            f.write(gnuplot_script)

    if args.display:
        from matplotlib import pyplot as plt

        plt.plot(df["EsN0dB"], df["I(N,X;Xhat)"],
                 label=r"$I(\hat{X} \; ; \; X,\; N)$")
        plt.plot(df["EsN0dB"], df["I(X;Xhat)"], label=r"$I(X;\hat{X})$")
        plt.plot(df["EsN0dB"], df["I(X;Y)"], label="$I(X;Y)$")
        plt.xlabel("$E_b/N_0$ [dB]")
        plt.grid("both")
        plt.legend()
        plt.show()
    return df


if __name__ == "__main__":
    main()
