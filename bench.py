"""Headline benchmark: decoded frames/s, soft reverse reconciliation.

Workload: DVB-S2-scale rate-1/2 quasi-cyclic LDPC (N=64800, (3,6)-regular
base graph at the standard's z=360 lifting), 4-PAM (bps=2) softening
reverse reconciliation, max 50 decoder iterations — the reference's own
measurement protocol (reference: sims/sim_reconciliation.py:35-41,
maxiter=50).

Measured each run, on the device JAX finds (a GPU; the CPU only when
``JAX_PLATFORMS=cpu`` is set explicitly, as the tests do):
  1. decode-only ms/BP-iteration (every frame runs all iterations: random
     syndromes never converge), and the same for a rate-3/4 irregular
     QC-IRA code (check degrees up to ~16);
  2. the headline end-to-end round throughput at BENCH_SNR (default 3.5 dB,
     just below threshold for this code: every frame decodes the full 50
     iterations — the pure decode-throughput regime);
  3. a second point at BENCH_SNR2 (default 4.0 dB, the waterfall regime)
     through the SAME compiled round (SNR rides in as an argument);
  4. secondary rows: min-sum, dense tanh-F/B sum-product, the layered
     schedule, the fused streaming driver and the Monte-Carlo MI estimator;
  5. baseline: the native single-core scalar flooding decoder
     (qamreconciliation_jax/native/graphcore.cpp) on the same LLR/syndrome
     distribution, decode step only with per-frame early exit — a stand-in
     for the reference's single-core Cython decoder.  Timing decode-only
     understates the reference's per-frame cost, so vs_baseline is
     conservative.

Messages default to bfloat16 storage with f32 check-node math;
BENCH_DTYPE=float32 restores full width.

Knobs: BENCH_N, BENCH_NBV (variable blocks, z = N/nbv; default 180),
BENCH_BATCH, BENCH_SNR, BENCH_SNR2, BENCH_MAXITER, BENCH_ROUNDS,
BENCH_RPD (rounds per device dispatch), BENCH_DTYPE, BENCH_QC=0 (generic
gather decoder), BENCH_BPS, BENCH_MODE (softening|hard|direct),
BENCH_CHECK (sumproduct|minsum), BENCH_SCHEDULE (flooding|layered),
BENCH_TOTALS (storage|float32), BENCH_LLR (poly|table), BENCH_PROBE_ITERS,
BENCH_PROBE_REPS, BENCH_HEADLINE_REPS, BENCH_SKIP_DECODE=1,
BENCH_SKIP_WATERFALL=1, BENCH_RATE34=0, BENCH_CHECK2 (secondary rule,
"none" skips), BENCH_TANHFB=0, BENCH_SCHED2 (secondary schedule, "none"
skips), BENCH_STREAM=0, BENCH_STREAM_REPS, BENCH_MI=0, BENCH_MI_N,
BENCH_BASELINE_S.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
...extras}; progress goes to stderr.
"""

import json
import math
import os
import subprocess
import sys
import time

N_CODE = int(os.environ.get("BENCH_N", 64800))
NBV = int(os.environ.get("BENCH_NBV", 180))
BATCH = int(os.environ.get("BENCH_BATCH", 128))
USE_QC = os.environ.get("BENCH_QC", "1") == "1"
SNR_DB = float(os.environ.get("BENCH_SNR", 3.5))
SNR2_DB = float(os.environ.get("BENCH_SNR2", 4.0))
MAX_ITER = int(os.environ.get("BENCH_MAXITER", 50))
TIMED_ROUNDS = int(os.environ.get("BENCH_ROUNDS", 8))
RPD = int(os.environ.get("BENCH_RPD", 8))
CHECK_RULE = os.environ.get("BENCH_CHECK", "sumproduct")
SCHEDULE = os.environ.get("BENCH_SCHEDULE", "flooding")
DTYPE = os.environ.get("BENCH_DTYPE", "bfloat16")
BPS = int(os.environ.get("BENCH_BPS", 2))
MODE = os.environ.get("BENCH_MODE", "softening")
SKIP_DECODE = os.environ.get("BENCH_SKIP_DECODE", "0") == "1"
TOTALS = os.environ.get("BENCH_TOTALS", "storage")
SKIP_WATERFALL = os.environ.get("BENCH_SKIP_WATERFALL", "0") == "1"
LLR_MODE = os.environ.get("BENCH_LLR", "poly")
BASELINE_BUDGET_S = float(os.environ.get("BENCH_BASELINE_S", 30.0))
BASELINE_MIN_FRAMES = 3


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def device_record(jax):
    """Platform, kind and count as JAX reports them; on a GPU also the
    card's name and power limit as nvidia-smi reports them."""
    d = jax.devices()[0]
    rec = {"platform": d.platform, "kind": d.device_kind,
           "count": len(jax.devices())}
    if d.platform == "gpu":
        rec["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
    return rec


def main():
    import jax

    if (jax.devices()[0].platform != "gpu"
            and os.environ.get("JAX_PLATFORMS", "").strip() != "cpu"):
        raise SystemExit("bench.py measures a GPU and found none; set "
                         "JAX_PLATFORMS=cpu to run it on the CPU")

    import jax.numpy as jnp
    import numpy as np

    from qamreconciliation_jax.models.alphabet import PAMAlphabet
    from qamreconciliation_jax.models.decoder import Decoder
    from qamreconciliation_jax.models.matrix import Matrix
    from qamreconciliation_jax.models.noisemapper import NoiseMapper
    from qamreconciliation_jax.sims.engine import ReconciliationEngine
    from qamreconciliation_jax.utils.compile_cache import (
        enable_compile_cache,
    )
    from qamreconciliation_jax.utils.edgefile import make_regular_ldpc

    cache_dir = enable_compile_cache()
    device = device_record(jax)
    log(f"device={device} dtype={DTYPE} qc={USE_QC} bps={BPS} mode={MODE} "
        f"compile_cache={cache_dir}")
    dt = jnp.dtype(DTYPE)
    if USE_QC:
        from qamreconciliation_jax.models.qc_decoder import (
            QCDecoder, make_qc_ira, make_qc_ldpc,
        )

        if N_CODE % NBV or NBV % 2:
            raise SystemExit(
                f"BENCH_QC=1 needs BENCH_N divisible by even BENCH_NBV, "
                f"got N={N_CODE} nbv={NBV}"
            )
        z = N_CODE // NBV
        base, vid, cid = make_qc_ldpc(NBV, z, dv=3, dc=6, seed=12345)
        dec = QCDecoder(base, z, dtype=dt, check_rule=CHECK_RULE,
                        schedule=SCHEDULE, totals_dtype=TOTALS)
        code = f"qc(3,6) z={z} N={dec.vnum}"
    else:
        if SCHEDULE != "flooding":
            raise SystemExit("BENCH_SCHEDULE=layered requires BENCH_QC=1")
        vid, cid = make_regular_ldpc(N_CODE, dv=3, dc=6, seed=12345)
        dec = Decoder(vid, cid, dtype=dt, check_rule=CHECK_RULE)
        code = f"regular(3,6) N={dec.vnum}"
    mat = Matrix(vid, cid)
    pa = PAMAlphabet(BPS, 2.0)
    eng = ReconciliationEngine(dec, mat, pa, batch=BATCH, dtype=dt,
                               llr_mode=LLR_MODE, rounds_per_dispatch=RPD)

    extras = {"device": device, "code": code, "dtype": DTYPE, "bps": BPS,
              "mode": MODE, "batch": BATCH, "maxiter": MAX_ITER,
              "llr_mode": LLR_MODE, "rounds_per_dispatch": RPD,
              "check_rule": CHECK_RULE, "schedule": SCHEDULE}

    probe_iters = max(int(os.environ.get("BENCH_PROBE_ITERS", 250)),
                      MAX_ITER)
    probe_reps = int(os.environ.get("BENCH_PROBE_REPS", 4))

    def probe_ms_per_iter(d):
        """(compile+first s, min-over-reps ms per BP iteration) of one
        decode program on random syndromes (never converge: every frame
        runs all ``probe_iters`` iterations; maxiter is a traced argument,
        so one compilation serves both calls)."""
        rng = np.random.default_rng(0)
        lappr = jnp.asarray(rng.normal(0, 3.0, (d.vnum, BATCH)), dt)
        synd = jnp.asarray(rng.integers(0, 2, (d.cnum, BATCH)), jnp.int32)
        f = d._build_decode()
        t0 = time.perf_counter()
        jax.block_until_ready(f(lappr, synd, jnp.int32(MAX_ITER)))
        first = time.perf_counter() - t0
        ms = []
        for _ in range(probe_reps):
            t1 = time.perf_counter()
            jax.block_until_ready(f(lappr, synd, jnp.int32(probe_iters)))
            ms.append((time.perf_counter() - t1) * 1e3)
        return first, min(ms) / probe_iters

    # ---- 1. decode-only probes --------------------------------------------
    if not SKIP_DECODE:
        first, ms_iter = probe_ms_per_iter(dec)
        extras.update({
            "decode_compile_s": round(first, 2),
            "decode_ms_per_iter": round(ms_iter, 4),
            "decode_frames_per_s": round(
                BATCH / (ms_iter * MAX_ITER) * 1e3, 1
            ),
            "probe_iters": probe_iters,
        })
        log(f"decode-only: {ms_iter:.4f} ms/iter, "
            f"{extras['decode_frames_per_s']} fps (compile+first "
            f"{first:.1f}s)")

    # rate-3/4 QC-IRA code: the reference's BSC experiments run rate 3/4
    # (reference: sims/display_bsc.py:20-22); its accumulator rows grow
    # the check degrees to ~12-16, a wide-row shape for the dense loop
    if (USE_QC and not SKIP_DECODE and SCHEDULE == "flooding"
            and NBV % 4 == 0 and NBV >= 8
            and os.environ.get("BENCH_RATE34", "1") == "1"):
        r_base, _, _ = make_qc_ira(
            nb_info=3 * NBV // 4, nb_acc=NBV // 4, z=z, dv=3, seed=12345
        )
        rdec = QCDecoder(r_base, z, dtype=dt, check_rule=CHECK_RULE,
                         totals_dtype=TOTALS)
        _, r_ms = probe_ms_per_iter(rdec)
        r_dcs = sorted({len(r) for r in rdec._rows})
        extras["rate34_qc"] = {
            "code": f"qc-ira rate-3/4 dv=3 dc={r_dcs[0]}..{r_dcs[-1]} "
                    f"z={z} N={rdec.vnum}",
            "decode_ms_per_iter": round(r_ms, 4),
            "decode_frames_per_s": round(
                BATCH / (r_ms * MAX_ITER) * 1e3, 1
            ),
        }
        log(f"rate-3/4 irregular decode: {r_ms:.4f} ms/iter "
            f"(dc {r_dcs[0]}..{r_dcs[-1]})")
        del rdec

    # ---- 2. headline end-to-end round (decode-bound regime) ---------------
    nmcfg = np.zeros(pa.order, np.uint8)
    kw = dict(nmconfig=nmcfg) if MODE == "softening" else {}

    def run_row(e, snr, seed):
        r = e.run_point(MODE, snr, MAX_ITER, TIMED_ROUNDS * BATCH, 10 ** 9,
                        seed=seed, **kw)
        return r, {"snr_dB": snr, "ber": float(f"{r.ber:.3e}"),
                   "fer": round(r.fer, 4), "mean_iters": round(r.iters, 2),
                   "frames_per_s": round(r.frames_per_s, 1)}

    def warm(e, snr, label):
        t0 = time.perf_counter()
        e.run_point(MODE, snr, MAX_ITER, BATCH, 10 ** 9, seed=0, **kw)
        log(f"{label} round warmup (compile + 1 round): "
            f"{time.perf_counter() - t0:.1f}s")

    warm(eng, SNR_DB, "headline")
    h_reps = max(1, int(os.environ.get("BENCH_HEADLINE_REPS", 2)))
    h_fps = []
    for hr in range(h_reps):
        r, _ = run_row(eng, SNR_DB, 1 + 10 * hr)
        h_fps.append(r.frames_per_s)
        log(f"@ {SNR_DB} dB (rep {hr}): {r.frames} frames -> "
            f"{r.frames_per_s:.1f} frames/s (fer={r.fer:.3f} "
            f"iters={r.iters:.1f})")
    fps = max(h_fps)
    extras.update({"snr_dB": SNR_DB, "fer": round(r.fer, 4),
                   "mean_iters": round(r.iters, 2), "headline_reps": h_reps,
                   "rep_frames_per_s": [round(v, 1) for v in h_fps]})

    # ---- 3. waterfall-regime point (same compiled round, new SNR arg) -----
    if not SKIP_WATERFALL:
        _, extras["waterfall"] = run_row(eng, SNR2_DB, 2)
        log(f"@ {SNR2_DB} dB (waterfall): {extras['waterfall']}")

    # ---- 4. secondary rows -------------------------------------------------
    def secondary(d, label, snrs):
        e = ReconciliationEngine(d, mat, pa, batch=BATCH, dtype=dt,
                                 llr_mode=LLR_MODE, rounds_per_dispatch=RPD)
        warm(e, snrs[0], label)
        _, row = run_row(e, snrs[0], 1)
        log(f"{label} @ {snrs[0]} dB: {row}")
        if len(snrs) > 1:
            _, row["waterfall"] = run_row(e, snrs[1], 2)
            log(f"{label} @ {snrs[1]} dB: {row['waterfall']}")
        return row

    both = [SNR_DB] if SKIP_WATERFALL else [SNR_DB, SNR2_DB]
    check2 = os.environ.get("BENCH_CHECK2", "minsum")
    if check2 != "none" and check2 != CHECK_RULE and MODE == "softening":
        d2 = (QCDecoder(base, z, dtype=dt, check_rule=check2) if USE_QC
              else Decoder(vid, cid, dtype=dt, check_rule=check2))
        extras[check2] = secondary(d2, check2, both)

    if (os.environ.get("BENCH_TANHFB", "1") == "1" and USE_QC
            and MODE == "softening" and CHECK_RULE == "sumproduct"):
        extras["sumproduct_tanhfb_dense"] = secondary(
            QCDecoder(base, z, dtype=dt, check_phi="tanhfb"),
            "dense tanhfb", both,
        )

    sched2 = os.environ.get("BENCH_SCHED2", "layered")
    if (sched2 != "none" and sched2 != SCHEDULE and USE_QC
            and MODE == "softening" and not SKIP_WATERFALL):
        # the layered schedule's regime is the waterfall, where its
        # ~half-the-sweeps convergence shows
        row = secondary(QCDecoder(base, z, dtype=dt, check_rule="minsum",
                                  schedule=sched2),
                        f"{sched2} minsum", [SNR2_DB])
        extras[sched2] = {"check_rule": "minsum", **row}

    # fused one-program Bob->Alice stream driver (sims/streaming.
    # stream_fused): frame-misaligned 2.33-frame chunks, min-sum
    if (os.environ.get("BENCH_STREAM", "1") == "1" and USE_QC
            and MODE == "softening"):
        from qamreconciliation_jax.sims.streaming import StreamReconciler

        sb = min(BATCH, 64)
        sdec = QCDecoder(base, z, dtype=dt, check_rule="minsum")
        sN0 = pa.variance * (10.0 ** (-SNR2_DB / 10.0)) / 2.0
        snm = NoiseMapper(pa, sN0, dtype=dt)
        s_rng = np.random.default_rng(3)
        sx = s_rng.choice(pa.order, size=4 * sb * eng.N_symb,
                          p=np.asarray(pa.probabilities))
        sy = np.asarray(pa.constellation)[sx] \
            + math.sqrt(sN0) * s_rng.standard_normal(sx.size)
        sr = StreamReconciler(sdec, mat, pa, snm, batch=sb)
        t0 = time.perf_counter()
        sr.stream_fused(sy[: sb * eng.N_symb], sx[: sb * eng.N_symb],
                        MAX_ITER)
        log(f"stream_fused warmup: {time.perf_counter() - t0:.1f}s")
        chunk = int(2.33 * eng.N_symb)
        ycks = [sy[a:a + chunk] for a in range(0, sx.size, chunk)]
        xcks = [sx[a:a + chunk] for a in range(0, sx.size, chunk)]
        s_reps = max(1, int(os.environ.get("BENCH_STREAM_REPS", 3)))
        s_els = []
        for _ in range(s_reps):
            sr2 = StreamReconciler(sdec, mat, pa, snm, batch=sb)
            sr2._fused_jit = sr._fused_jit
            t0 = time.perf_counter()
            s_res = sr2.stream_fused(ycks, xcks, MAX_ITER)
            s_els.append(time.perf_counter() - t0)
        extras["streaming"] = {
            "driver": "stream_fused", "frames": s_res.frames, "batch": sb,
            "chunk_frames": 2.33, "snr_dB": SNR2_DB,
            "fer": round(s_res.fer, 4),
            "symbols_per_s": round(sx.size / min(s_els), 1),
            "reps": s_reps,
            "rep_symbols_per_s": [round(sx.size / e, 1) for e in s_els],
        }
        log(f"stream_fused: {extras['streaming']}")

    # Monte-Carlo mutual information (models/mutual_information.
    # montecarlo_information, reference: mutual_information.pyx:212-300)
    if os.environ.get("BENCH_MI", "1") == "1" and MODE == "softening":
        from qamreconciliation_jax.models.mutual_information import (
            P_xhat, montecarlo_information,
        )

        mi_n = int(os.environ.get("BENCH_MI_N", 1 << 21))
        mi_nm = NoiseMapper(
            pa, pa.variance * (10.0 ** (-8.0 / 10.0)) / 2.0,
            dtype=np.float32,
        )
        mi_nm._ensure_ginv_poly()
        mi_p = P_xhat(mi_nm)
        mi_key = jax.random.key(11)
        t0 = time.perf_counter()
        jax.block_until_ready(montecarlo_information(
            mi_key, pa, mi_nm, mi_p, mi_n, ginv_mode="poly"))
        log(f"MC-MI compile+first: {time.perf_counter() - t0:.1f}s")
        mi_ts = []
        for r in range(3):
            t1 = time.perf_counter()
            jax.block_until_ready(montecarlo_information(
                jax.random.fold_in(mi_key, r), pa, mi_nm, mi_p, mi_n,
                ginv_mode="poly"))
            mi_ts.append(time.perf_counter() - t1)
        extras["mc_mi"] = {
            "n": mi_n, "snr_dB": 8.0, "ginv": "poly",
            "samples_per_s": round(mi_n / min(mi_ts), 1),
        }
        log(f"MC-MI: {extras['mc_mi']['samples_per_s']:.0f} samples/s")

    # ---- 5. native single-core baseline -----------------------------------
    from qamreconciliation_jax._graphcore import ScalarDecoder
    from qamreconciliation_jax.utils.reference_np import softening_frames_np

    N0 = pa.variance * (10.0 ** (-SNR_DB / 10.0)) / 2.0
    n_base = min(BATCH, 32)
    lappr_h, word_h = softening_frames_np(
        NoiseMapper(pa, N0), pa, n_base, eng.N_symb, seed=999
    )
    sd = ScalarDecoder(vid, cid)
    synd_h = np.stack([sd.eval_syndrome(w) for w in word_h])
    done = 0
    t0 = time.perf_counter()
    for fi in range(n_base):
        sd.decode(lappr_h[fi], synd_h[fi], MAX_ITER)
        done += 1
        if (time.perf_counter() - t0 > BASELINE_BUDGET_S
                and done >= BASELINE_MIN_FRAMES):
            break
    el = time.perf_counter() - t0
    baseline_fps = done / el
    log(f"baseline (1-core scalar C++): {done} frames in {el:.2f}s "
        f"-> {baseline_fps:.3f} frames/s")

    print(json.dumps({
        "metric": f"{MODE}_decoded_frames_per_s",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / baseline_fps, 1),
        **extras,
    }))


if __name__ == "__main__":
    main()
