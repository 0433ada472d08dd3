"""Shared CLI plumbing for the sweep drivers."""

from __future__ import annotations

import argparse
import csv

import jax.numpy as jnp
import numpy as np


def init_runtime() -> bool:
    """Per-CLI runtime init: turn on the persistent compilation cache
    (utils/compile_cache.py) and join the multi-host distributed runtime
    when launched under one (coordinator address in the environment).
    Every sweep ``main()`` calls this before touching devices.  Returns
    True iff multi-host is active."""
    from ..parallel import mesh
    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    return mesh.maybe_distributed_init()


def write_csv(path, columns, rows):
    """Write a sweep CSV of record; return the rows as a numpy record array
    with one field per column.

    Same layout as the reference's ``DataFrame.to_csv`` (reference:
    sims/sim_reconciliation.py:96-102): a header whose first cell is empty,
    then one line per row led by its 0-based index, floats written in
    their shortest round-trip form.
    """
    rows = [tuple(float(v) for v in row) for row in rows]
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(("",) + tuple(columns))
        for i, row in enumerate(rows):
            w.writerow((i,) + tuple(repr(v) for v in row))
    return np.rec.array(
        np.array(rows, dtype=[(c, np.float64) for c in columns])
    )


def add_engine_args(parser: argparse.ArgumentParser):
    """Engine flags shared by all sweep CLIs (extensions over the
    reference's flag surface; the reference flags are added per-script)."""
    parser.add_argument(
        "--batch", type=int, default=128,
        help="Frames per round per device (the reference decodes 1 frame at a time)",
    )
    parser.add_argument(
        "--dtype", choices=["float32", "float64", "bfloat16"], default="float32",
        help="LLR/message dtype (the reference is float64-only)",
    )
    parser.add_argument(
        "--devices", type=int, default=1,
        help="Shard each round over this many devices (psum-reduced counters)",
    )
    parser.add_argument(
        "--llr-exact", action="store_true",
        help="Use the exact Newton g^-1 in LLR generation (the reference's "
        "g_inv_search contract) instead of the tabulated LLR map",
    )
    parser.add_argument(
        "--llr-mode", choices=["poly", "table", "interp", "search"],
        default=None,
        help="Softening LLR path: 'poly' (gather-free piecewise-Chebyshev "
        "fit of the LLR curves, default), 'table' "
        "(precomputed (n,j)->LLR map + gathers), 'interp' (per-sample grid "
        "inverse), 'search' (exact Newton inverse).  Overrides --llr-exact.",
    )
    parser.add_argument(
        "--fy-mode", choices=["erf", "erf_flat", "poly"], default="erf",
        help="Marginal-CDF implementation for the softening metric "
        "(map_noise): 'erf' (exact [.., M] mixture broadcast, default), "
        "'erf_flat' (the same M erfs unrolled lane-flat over static "
        "floats — no trailing M axis), 'poly' (probit-warped global "
        "Chebyshev fit: ~1 erf + one Clenshaw chain per sample; CDF fit "
        "error <~1e-4 at operating SNRs, see NoiseMapper._ensure_fy_poly)",
    )
    parser.add_argument(
        "--check-rule", choices=["sumproduct", "minsum"],
        default="sumproduct",
        help="Check-node update rule: 'sumproduct' (exact phi form, the "
        "reference's math) or 'minsum' (normalized min-sum, alpha=13/16 — "
        "transcendental-free check phase at ~0.1 dB waterfall cost)",
    )
    parser.add_argument(
        "--minsum-alpha", type=float, default=None,
        help="Min-sum normalization scale (default 13/16); "
        "mag = max(alpha*min - beta, 0)",
    )
    parser.add_argument(
        "--minsum-beta", type=float, default=0.0,
        help="Min-sum OFFSET correction (classic offset min-sum with "
        "--minsum-alpha 1); default 0 = normalized min-sum only",
    )
    parser.add_argument(
        "--check-phi", choices=["phi", "tanhfb"], default="phi",
        help="Sum-product magnitude implementation (QC decoders): 'phi' "
        "(the reference-comparable sign/phi form, default) or 'tanhfb' "
        "(tanh forward/backward products — the same exact box-plus "
        "reduction at half the transcendental count; extrinsic "
        "saturation ~16.6 vs ~69)",
    )
    parser.add_argument(
        "--rounds-per-dispatch", type=int, default=1,
        help="Run this many frame batches per device dispatch (lax.scan on "
        "device, counters summed on the device).  Amortizes the fixed "
        "per-dispatch host roundtrip; early exit coarsens to "
        "(batch * R)-frame granularity",
    )
    parser.add_argument("--seed", type=int, default=0, help="Sweep PRNG seed")
    parser.add_argument(
        "--resume", action="store_true",
        help="Resume a partially completed sweep from the .partial.jsonl journal",
    )
    parser.add_argument(
        "--profile-dir", default=None,
        help="Write a jax.profiler trace of the first SNR point here",
    )


def engine_kwargs(args):
    llr_mode = args.llr_mode or ("search" if args.llr_exact else "poly")
    kw = dict(
        batch=args.batch,
        dtype=jnp.dtype(args.dtype),
        llr_mode=llr_mode,
        rounds_per_dispatch=getattr(args, "rounds_per_dispatch", 1),
        fy_mode=getattr(args, "fy_mode", "erf"),
    )
    if args.devices > 1:
        from ..parallel import make_mesh

        kw["mesh_axis"] = (make_mesh(args.devices), "dp")
    return kw


def add_qc_arg(parser: argparse.ArgumentParser):
    """--qc flag shared by every decoder-driving sweep CLI (extension: the
    reference's CLIs only read expanded edge lists)."""
    parser.add_argument(
        "--qc", action="store_true",
        help="Treat EDGEFILE as a quasi-cyclic base-edge CSV "
        "(eid,cb,vb,shift with a (n_edges,z,nb_c) totals row) and decode "
        "with the circulant-roll QCDecoder",
    )
    parser.add_argument(
        "--schedule", choices=["flooding", "layered"], default="flooding",
        help="BP update schedule (QC decoders only): 'flooding' (the "
        "reference's schedule) or 'layered' (row-layered serial-C over "
        "check blocks — converges in roughly half the sweeps for the "
        "same quality)",
    )
    parser.add_argument(
        "--layered-chunk", type=int, default=4,
        help="Layered schedule only: sweeps per while-loop iteration "
        "(amortizes the per-sweep device sync; early exit coarsens to "
        "this granularity, iters/success stay sweep-exact)",
    )
    parser.add_argument(
        "--layered-groups", type=int, default=-1,
        help="Layered schedule only: process variable-disjoint check "
        "rows as one batched layer (bit-equivalent to a reordered "
        "serial sweep; cuts per-sweep serial depth from the row count "
        "to the color count).  -1 auto (on for codes with >= 32 check "
        "block-rows), 0 serial, 1 force grouped",
    )
    parser.add_argument(
        "--totals-dtype", choices=["storage", "float32"], default="storage",
        help="QC decoders: dtype of the running LLR totals. 'storage' "
        "keeps them in --dtype; 'float32' runs the f32-totals/"
        "storage-width-messages hybrid.  Measured at the DVB-S2 knee: "
        "quality-NEUTRAL at bf16 (FER 0.583 vs 0.581 at 3.5 dB — the bf16 "
        "knee cost lives in the c2v MESSAGE rounding, not the totals); "
        "use --dtype float32 when the ~0.05 dB matters",
    )
    parser.add_argument(
        "--sr-messages", action="store_true",
        help="QC dense flooding + bfloat16 only: STOCHASTICALLY round "
        "the bf16 c2v message stores (ops/boxplus."
        "stochastic_round_bf16) instead of round-to-nearest — the "
        "knee-quality experiment attacking the measured bf16 message-"
        "rounding FER cost",
    )
    parser.add_argument(
        "--lift-qc", action="store_true",
        help="Detect circulant (quasi-cyclic) structure in an EXPANDED "
        "edge-list CSV — the format real standards like DVB-S2/5G ship in — "
        "and lift it onto the roll QCDecoder; falls back to the generic "
        "decoder with a warning if no lifting exists",
    )


def load_decoder(args):
    """Build the decoder named by ``args.edgefile`` (+ ``--qc``).

    Returns ``(dec, vid, cid)`` with the expanded edge list either way, so
    callers can build a :class:`~qamreconciliation_jax.models.matrix.Matrix`
    and reuse the CSV first-row convention
    (reference: sims/sim_reconciliation.py:50, 60-61).
    """
    import numpy as np

    schedule = getattr(args, "schedule", "flooding")
    chunk = getattr(args, "layered_chunk", 4)
    lg = getattr(args, "layered_groups", -1)
    layered_groups = None if lg < 0 else bool(lg)
    check_phi = getattr(args, "check_phi", "phi")
    totals_dtype = getattr(args, "totals_dtype", "storage")
    ms_kw = dict(minsum_alpha=getattr(args, "minsum_alpha", None),
                 minsum_beta=getattr(args, "minsum_beta", 0.0),
                 sr_messages=getattr(args, "sr_messages", False))
    if getattr(args, "qc", False):
        from ..models.qc_decoder import QCDecoder, load_qc_csv

        base_edges, z = load_qc_csv(args.edgefile)
        dec = QCDecoder(base_edges, z, dtype=np.dtype(args.dtype),
                        check_rule=args.check_rule, schedule=schedule,
                        layered_chunk=chunk, layered_groups=layered_groups,
                        check_phi=check_phi, totals_dtype=totals_dtype,
                        **ms_kw)
        return dec, dec.graph.e_to_v, dec.graph.e_to_c
    from ..models.decoder import Decoder
    from ..utils.edgefile import load_edge_csv

    vid, cid = load_edge_csv(
        args.edgefile,
        num_data_first_row=getattr(args, "first_row", True),
    )
    if getattr(args, "lift_qc", False):
        from ..models.qc_decoder import QCDecoder, detect_qc

        lifted = detect_qc(vid, cid)
        if lifted is not None:
            base_edges, z = lifted
            try:
                dec = QCDecoder(base_edges, z, dtype=np.dtype(args.dtype),
                                check_rule=args.check_rule,
                                schedule=schedule, layered_chunk=chunk,
                                layered_groups=layered_groups,
                                check_phi=check_phi,
                                totals_dtype=totals_dtype, **ms_kw)
                print(f"[lift-qc] detected z={z} circulant lifting "
                      f"({len(base_edges)} base edges)")
                return dec, vid, cid
            except ValueError as e:   # e.g. non-uniform check-block degree
                import warnings

                warnings.warn(f"--lift-qc: lifting found but unusable "
                              f"({e}); using the generic decoder")
        else:
            import warnings

            warnings.warn("--lift-qc: no circulant structure detected; "
                          "using the generic decoder")
    if schedule != "flooding":
        raise SystemExit(
            "--schedule layered requires a quasi-cyclic decoder "
            "(--qc or a successful --lift-qc); the generic gather decoder "
            "is flooding-only"
        )
    if ms_kw.pop("sr_messages"):
        raise SystemExit(
            "--sr-messages requires a quasi-cyclic decoder (--qc or a "
            "successful --lift-qc): the stochastic message rounding "
            "lives in the QC dense check update"
        )
    dec = Decoder(vid, cid, dtype=np.dtype(args.dtype),
                  check_rule=args.check_rule, check_phi=check_phi, **ms_kw)
    return dec, vid, cid
