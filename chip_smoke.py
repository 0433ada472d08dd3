"""Bring-up check of the reconciliation system on NVIDIA GPUs.

Runs the main path end to end in this one process, through the entry points
a user calls, at the size users run: the DVB-S2 rate-1/2 code (N=64800,
z=360, 630 circulants) in a 4-PAM soft reverse-reconciliation sweep, batch
128, 50 BP iterations.  Phases, each printing one JSON line:

  device        the card JAX found (a GPU, or the script stops), its name
                and power limit from nvidia-smi, the compile-cache directory
  sweep         sim_reconciliation over 3.0-3.5 dB, 1024 frames per point;
                FER at 3.0 dB must agree with docs/img/wf_dvbs2_12.csv
                within a binomial 99% interval; plus decode ms/iteration
  decode_parity the sweep's QCDecoder in float32 against the C++ scalar
                oracle (_graphcore.ScalarDecoder, float64) on 8 frames
  llr_parity    the device poly-LLR chain against utils/reference_np.py
  check_phase   the fused check-phase kernel against the XLA check phase
                at z=360, B=128, dc 6 and 7, every rule, float32 and bf16;
                and the sweep's whole decode, ms/iteration, with either
  stream        StreamReconciler.stream_fused over a few batches
  mc_mi         one montecarlo_information call against analytic I(X;Y)

    python chip_smoke.py              # one GPU
    python chip_smoke.py --multichip  # four GPUs: the sharded paths and
                                      # what they are compared with, only

With --multichip the phases are: frame_shard (the 4-card shard_round
counters against the same four folded keys run one after another on one
card), graph_shard (ShardedQCDecoder over 4 cards against QCDecoder on
one), both on a z=360 code cut to N=12960, and the full DVB-S2 sweep with
--devices 4.

Any failed check stops the script with a non-zero exit code.  On success
the line before the last is nvidia-smi's name and power limit, and the last
line is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, ".smoke")          # generated codes and CSVs
REF_CSV = os.path.join(HERE, "docs", "img", "wf_dvbs2_12.csv")
Z99 = 2.5758      # two-sided 99% normal quantile


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok, what):
    if not ok:
        raise SystemExit(f"chip_smoke: check failed: {what}")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def nvidia_smi():
    """Name and power limit of every card, read by nvidia-smi (a child
    process that does not touch JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def fer_agrees(fer, frames, fer_ref, frames_ref):
    """Two binomial estimates agree at 99%: |difference| within Z99 of the
    difference's standard error (pooled proportion)."""
    p = (fer * frames + fer_ref * frames_ref) / (frames + frames_ref)
    half = Z99 * math.sqrt(max(p * (1 - p), 1e-12)
                           * (1 / frames + 1 / frames_ref))
    return abs(fer - fer_ref) <= half, half


def reference_fer(snr):
    """FER of the recorded rate-1/2 waterfall (1024 frames per point) at
    ``snr`` dB.  The CSV has the sweep CLI's layout: an unnamed leading
    index column, then EsN0dB,ber,fer,iters."""
    import csv

    with open(REF_CSV, newline="") as f:
        for row in csv.DictReader(f):
            if float(row["EsN0dB"]) == snr:
                return float(row["fer"])
    raise SystemExit(f"chip_smoke: no {snr} dB point in {REF_CSV}")


def dvbs2_code():
    """dvbs2_12_qc.csv from scripts/make_dvbs2_code.py, in .smoke/."""
    os.makedirs(WORK, exist_ok=True)
    path = os.path.join(WORK, "dvbs2_12_qc.csv")
    if not os.path.exists(path):
        subprocess.run(
            [sys.executable, os.path.join(HERE, "scripts", "make_dvbs2_code.py"),
             "--rate", "1/2", "--out-dir", WORK],
            check=True, env={**os.environ, "JAX_PLATFORMS": "cpu"},
            stdout=sys.stderr,
        )
    return path


def short_qc_code(nb_v=36, z=360):
    """A (3,6)-regular QC code at the DVB-S2 lifting z=360 with 36 block
    columns (N=12960): the sharded comparisons' code, cut in depth from
    N=64800 so that their four extra compilations fit the four-card run;
    the --devices 4 sweep keeps the full code.  Its waterfall sits near
    3.5 dB (Alternating sign configuration: about half the frames decode,
    so the frame-shard counters cover both outcomes) and every graph-shard
    frame converges at 4.0 dB."""
    from qamreconciliation_jax.models.qc_decoder import make_qc_ldpc, save_qc_csv

    os.makedirs(WORK, exist_ok=True)
    path = os.path.join(WORK, f"qc36_z{z}.csv")
    base, _, _ = make_qc_ldpc(nb_v, z, dv=3, dc=6, seed=12345)
    save_qc_csv(path, base, z)
    return path


def timed_ms(fn, *args, reps=20):
    """(min, median) wall ms of fn(*args) after one warm call."""
    import jax
    import numpy as np

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return min(ts), float(np.median(ts))


_POINT = re.compile(
    r"\[EsN0dB=(?P<snr>[-0-9.]+)\] frames=(?P<frames>\d+) ber=(?P<ber>\S+) "
    r"fer=(?P<fer>\S+) iters=(?P<iters>\S+) \((?P<fps>[0-9.]+) frames/s, "
    r"compile (?P<compile>[0-9.]+) s\)"
)


def phase_sweep(code, *, snr=(3.0, 3.5), nsnr=3, batch=128, simloops=1024,
                maxiter=50, devices=1, check_ref=True):
    """The sweep CLI in this process; returns the per-point rows."""
    import jax

    from qamreconciliation_jax.sims import sim_reconciliation

    out_csv = os.path.join(WORK, f"sweep_d{devices}.csv")
    argv = [code, "--qc", "--out", out_csv,
            "--snr", str(snr[0]), str(snr[1]), "--nsnr", str(nsnr),
            "--maxiter", str(maxiter), "--batch", str(batch),
            "--dtype", "bfloat16", "--simloops", str(simloops),
            "--ferr-count-min", "1000000000", "--devices", str(devices)]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        table = sim_reconciliation.main(argv)
    wall = time.perf_counter() - t0
    log(buf.getvalue())
    points = [m.groupdict() for m in _POINT.finditer(buf.getvalue())]
    check(len(points) == nsnr == len(table), f"{nsnr} sweep points printed")
    rows = []
    for p in points:
        row = {"snr_dB": float(p["snr"]), "frames": int(p["frames"]),
               "ber": float(p["ber"]), "fer": float(p["fer"]),
               "mean_iters": float(p["iters"]),
               "frames_per_s": float(p["fps"]),
               "compile_s": float(p["compile"])}
        check(row["frames"] >= simloops, f"{simloops} frames per point")
        check(0.0 <= row["ber"] <= row["fer"] <= 1.0, f"BER/FER range {row}")
        rows.append(row)
    check(rows[0]["fer"] >= rows[-1]["fer"], "FER falls with SNR")
    # None on the CPU rehearsal, which keeps no device memory statistics
    stats = jax.devices()[0].memory_stats() or {}
    out = {"points": rows, "wall_s": wall,
           "peak_bytes_in_use": stats.get("peak_bytes_in_use")}
    if check_ref:
        fer_ref = reference_fer(snr[0])
        ok, half = fer_agrees(rows[0]["fer"], rows[0]["frames"], fer_ref,
                              1024)
        out["fer_reference"] = {"snr_dB": snr[0], "fer": fer_ref,
                                "frames": 1024, "interval99": half}
        check(ok, f"FER {rows[0]['fer']} at {snr[0]} dB vs reference "
                  f"{fer_ref} (99% half-width {half:.4f})")
    return out


def decode_ms_per_iter(code, *, batch=128, iters=250, dtype="bfloat16",
                       fused=True):
    """(compile+first s, ms per BP iteration) of the sweep's decoder on
    random syndromes, which never converge: every frame runs all
    iterations (the bench.py probe).  ``fused=False`` keeps the XLA check
    phase, the one the graph-sharded decoder runs on a GPU."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from qamreconciliation_jax.models.qc_decoder import QCDecoder, load_qc_csv

    base, z = load_qc_csv(code)
    dec = QCDecoder(base, z, dtype=jnp.dtype(dtype))
    dec._fused_check_ok = fused
    f = dec._build_decode()
    rng = np.random.default_rng(0)
    lappr = jnp.asarray(rng.normal(0, 3.0, (dec.vnum, batch)), dtype)
    synd = jnp.asarray(rng.integers(0, 2, (dec.cnum, batch)), jnp.int32)
    t0 = time.perf_counter()
    jax.block_until_ready(f(lappr, synd, jnp.int32(50)))
    first = time.perf_counter() - t0
    ms, _ = timed_ms(f, lappr, synd, jnp.int32(iters), reps=3)
    return first, ms / iters


def phase_decode_parity(code, *, frames=8, snr=3.5, maxiter=50):
    """QCDecoder (float32, phi rule) on the card vs the C++ float64 scalar
    oracle on the same host-built frames.

    Success flags must be equal; on converged frames iterations and hard
    decisions must be equal.  Final LLRs of converged frames are compared
    where both magnitudes are below 20: at least 98% of them must agree
    within 0.05 + 1e-2 |LLR|.  The card sums in float32 and in another
    order, and the phi form computes each extrinsic magnitude as
    phi(S - phi_i): when one input dominates S, float32 loses S - phi_i to
    cancellation and the message saturates near 69 where the oracle's
    float64 box-plus gives 15-30.  Those messages move the few totals they
    reach by up to ~50 (on a small irregular QC code ~0.2% of the compared
    LLRs at 4-6 dB, on the CPU); beyond them only the decisions agree.
    """
    import jax.numpy as jnp
    import numpy as np

    from qamreconciliation_jax._graphcore import ScalarDecoder
    from qamreconciliation_jax.models.alphabet import PAMAlphabet
    from qamreconciliation_jax.models.noisemapper import NoiseMapper
    from qamreconciliation_jax.models.qc_decoder import QCDecoder, load_qc_csv
    from qamreconciliation_jax.utils.reference_np import softening_frames_np

    base, z = load_qc_csv(code)
    dec = QCDecoder(base, z, dtype=jnp.float32, check_phi="phi")
    pa = PAMAlphabet(2, 2.0)
    N0 = pa.variance * 10.0 ** (-snr / 10.0) / 2.0
    nmcfg = np.zeros(pa.order, np.uint8)
    nmcfg[1::2] = 1                  # the sweep's Alternating configuration
    lappr, word = softening_frames_np(NoiseMapper(pa, N0, nmcfg), pa, frames,
                                      dec.vnum // 2, seed=7)
    sd = ScalarDecoder(dec.graph.e_to_v, dec.graph.e_to_c)
    synd = np.stack([sd.eval_syndrome(w) for w in word])
    s_d, i_d, f_d = (np.asarray(a) for a in
                     dec.decode_batch(lappr, synd, maxiter))
    oracle = [sd.decode(lappr[f], synd[f], maxiter) for f in range(frames)]
    s_o = np.array([bool(o[0]) for o in oracle])
    i_o = np.array([int(o[1]) for o in oracle])
    f_o = np.stack([o[2] for o in oracle])
    check(np.array_equal(s_d, s_o), f"success {s_d} vs oracle {s_o}")
    conv = s_o
    check(np.array_equal(i_d[conv], i_o[conv]),
          f"iterations {i_d} vs oracle {i_o}")
    check(np.array_equal(f_d[conv] < 0, f_o[conv] < 0),
          "hard decisions of converged frames")
    f_d, f_o = f_d[conv].astype(np.float64), f_o[conv]
    m = np.maximum(np.abs(f_d), np.abs(f_o)) < 20.0
    diff = np.abs(f_d - f_o)[m]
    ok = diff <= (0.05 + 1e-2 * np.abs(f_o))[m]
    check(conv.any() and ok.mean() >= 0.98,
          f"final LLRs: {ok.mean():.4f} within 0.05 + 1e-2|x| (>= 0.98)")
    return {"frames": frames, "snr_dB": snr, "converged": int(conv.sum()),
            "iters": i_d.tolist(), "llr_within_tol_frac": float(ok.mean()),
            "llr_max_abs_diff_within_tol": float(diff[ok].max()),
            "llr_max_abs_diff": float(diff.max()),
            "llr_compared_frac": float(m.mean()),
            "llr_tolerance": "98% within 0.05 + 1e-2*|x| where both |x| < 20"}


def phase_llr_parity(*, frames=8, snr=3.5):
    """The device poly-LLR chain (hard decision, softening metric, LLRs) on
    one batch vs the float64 reference chain, base sign configuration.

    Words must be identical.  The fit holds |delta| <= 2e-3 on all but the
    boundary-layer tail of the softening metric, where it reaches ~6e-3
    (and the reference's own inverse-CDF interpolation kinks): the check
    is the 99.99th percentile <= 2e-3 and the maximum <= 1e-2.  A float32
    contraction run in TF32 breaks both.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from qamreconciliation_jax.models.alphabet import PAMAlphabet
    from qamreconciliation_jax.models.noisemapper import NoiseMapper
    from qamreconciliation_jax.utils.reference_np import softening_chain_np

    pa = PAMAlphabet(2, 2.0)
    N0 = pa.variance * 10.0 ** (-snr / 10.0) / 2.0
    cfg = np.zeros(pa.order, np.uint8)
    nm = NoiseMapper(pa, N0, cfg, dtype=jnp.float32)
    nm._ensure_llr_poly()
    rng = np.random.default_rng(1)
    S = 64800 // pa.bit_per_symbol
    x = rng.choice(pa.order, size=(frames, S), p=np.asarray(pa.probabilities))
    y = np.asarray(pa.constellation)[x] \
        + math.sqrt(N0) * rng.standard_normal((frames, S))
    ref, word_ref = softening_chain_np(NoiseMapper(pa, N0, cfg), pa, x, y)

    @jax.jit
    def chain(nm, x, y):
        x_hat = nm.hard_decide_index(y)
        n_hat = nm.map_noise(y, x_hat)
        return x_hat, jnp.stack(nm._poly_llr_bits(n_hat, x), axis=-1)

    x_hat, llr = chain(nm, jnp.asarray(x, jnp.int32),
                       jnp.asarray(y, jnp.float32))
    word = np.asarray(pa.s_to_b)[np.asarray(x_hat)].reshape(frames, -1)
    check(np.array_equal(word, word_ref), "hard-decision words")
    err = np.abs(np.asarray(llr, np.float64).reshape(frames, -1) - ref)
    p9999 = float(np.quantile(err, 0.9999))
    check(p9999 <= 2e-3 and err.max() <= 1e-2,
          f"LLR p99.99 {p9999:.3g} (<= 2e-3), max {err.max():.3g} (<= 1e-2)")
    return {"samples": int(err.size), "snr_dB": snr,
            "max_abs_diff": float(err.max()), "p9999_abs_diff": p9999,
            "tolerance": "p99.99 <= 2e-3, max <= 1e-2"}


# float32 and bf16 messages: the phi rule recovers each magnitude from a
# difference of two float32 sums, so another summation order moves it by
# a few ulps of the sum, amplified by phi's slope at small arguments;
# bf16 results differ by at most two ulps of the stored message
CHECK_TOL = {"float32": dict(rtol=1e-2, atol=1e-3),
             "bfloat16": dict(rtol=2 ** -6, atol=1e-6)}


def phase_check_phase(*, nb_c=90, z=360, B=128, dcs=(7, 6), reps=20):
    """Fused check-phase kernel vs the XLA check phase at the DVB-S2
    shape; parity and both timings, per rule, dtype and degree."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from qamreconciliation_jax.models.qc_decoder import check_phase_xla
    from qamreconciliation_jax.ops.pallas_kernels import (
        CHECK_RULES, bp_check_phase_qc,
    )

    rng = np.random.default_rng(0)
    rows = []
    for dc in dcs:
        shape = (nb_c, dc, z, B)
        for dtype in ("float32", "bfloat16"):
            t = jnp.asarray(rng.normal(0, 4, shape), dtype)
            c2v = jnp.asarray(rng.normal(0, 2, shape), dtype)
            synd = jnp.asarray(rng.integers(0, 2, (nb_c, z, B)), jnp.int32)
            for rule in CHECK_RULES:
                kern = jax.jit(lambda t, c, s, r=rule:
                               bp_check_phase_qc(t, c, s, rule=r))
                xla = jax.jit(lambda t, c, s, r=rule:
                              check_phase_xla(t, c, s, rule=r))
                conv_k, out_k = kern(t, c2v, synd)
                conv_x, out_x = xla(t, c2v, synd)
                a = np.asarray(out_k, np.float64)
                b = np.asarray(out_x, np.float64)
                tol = CHECK_TOL[dtype]
                excess = np.abs(a - b) - (tol["atol"] + tol["rtol"]
                                          * np.abs(b))
                row = {"dc": dc, "dtype": dtype, "rule": rule,
                       "max_abs_diff": float(np.abs(a - b).max()),
                       "tolerance": tol,
                       "kernel_ms": timed_ms(kern, t, c2v, synd, reps=reps),
                       "xla_ms": timed_ms(xla, t, c2v, synd, reps=reps)}
                rows.append(row)
                check(np.array_equal(np.asarray(conv_k), np.asarray(conv_x)),
                      f"convergence flags {row}")
                check(bool((excess <= 0).all()), f"messages {row}")
    return {"shape": [nb_c, "dc", z, B], "rows": rows,
            "timing": "(min, median) ms over 20 calls"}


def phase_stream(code, *, batch=64, batches=3, snr=3.5, maxiter=50):
    """One stream_fused pass over frame-misaligned chunks."""
    import jax.numpy as jnp
    import numpy as np

    from qamreconciliation_jax.models.alphabet import PAMAlphabet
    from qamreconciliation_jax.models.matrix import Matrix
    from qamreconciliation_jax.models.noisemapper import NoiseMapper
    from qamreconciliation_jax.models.qc_decoder import QCDecoder, load_qc_csv
    from qamreconciliation_jax.sims.streaming import StreamReconciler

    base, z = load_qc_csv(code)
    dec = QCDecoder(base, z, dtype=jnp.bfloat16)
    pa = PAMAlphabet(2, 2.0)
    N0 = pa.variance * 10.0 ** (-snr / 10.0) / 2.0
    sr = StreamReconciler(dec, Matrix(dec.graph.e_to_v, dec.graph.e_to_c),
                          pa, NoiseMapper(pa, N0, dtype=jnp.bfloat16),
                          batch=batch)
    rng = np.random.default_rng(3)
    F = batches * batch
    x = rng.choice(pa.order, size=F * sr.N_symb,
                   p=np.asarray(pa.probabilities))
    y = np.asarray(pa.constellation)[x] \
        + math.sqrt(N0) * rng.standard_normal(x.size)
    chunk = int(2.33 * sr.N_symb)
    t0 = time.perf_counter()
    res = sr.stream_fused([y[a:a + chunk] for a in range(0, x.size, chunk)],
                          [x[a:a + chunk] for a in range(0, x.size, chunk)],
                          maxiter)
    wall = time.perf_counter() - t0
    check(res.frames == F and len(res.success) == F, f"{F} frames streamed")
    check(0 < sum(res.success), "some frames reconcile")
    return {"frames": res.frames, "fer": res.fer,
            "bit_errors": int(res.bit_errors), "wall_s_with_compile": wall}


def phase_mc_mi(*, n=1 << 20, snr=8.0):
    """One montecarlo_information call at bps=2; I(X;Y) must match the
    analytic value within 0.02 bit (MC error at this n is ~1e-3).  The
    estimator keeps the reference's sign convention: its I(X;Xhat) and
    I(X;Y) come out negated (models/mutual_information.py)."""
    import jax
    import numpy as np

    from qamreconciliation_jax.models.alphabet import PAMAlphabet
    from qamreconciliation_jax.models.mutual_information import (
        P_xhat, montecarlo_information, mutual_information_X_Y,
    )
    from qamreconciliation_jax.models.noisemapper import NoiseMapper

    pa = PAMAlphabet(2, 2.0)
    nm = NoiseMapper(pa, pa.variance * 10.0 ** (-snr / 10.0) / 2.0,
                     dtype=np.float32)
    nm._ensure_ginv_poly()
    est = montecarlo_information(jax.random.key(11), pa, nm, P_xhat(nm), n,
                                 ginv_mode="poly")
    exact_xy = mutual_information_X_Y(nm)
    info = (-est[0], -est[1], est[2])
    check(all(math.isfinite(v) and 0.0 <= v <= 2.0 for v in info),
          f"finite estimates in [0, bps]: {info}")
    check(abs(info[1] - exact_xy) < 0.02, f"I(X;Y) {info[1]} vs {exact_xy}")
    return {"n": n, "snr_dB": snr, "I_X_Xhat": info[0], "I_X_Y": info[1],
            "I_XN_Xhat": info[2], "I_X_Y_analytic": exact_xy}


def phase_frame_shard(code, *, n_dev=4, batch=32, snr=3.5, maxiter=50):
    """shard_round over an n_dev-card mesh: its psum-reduced counters must
    equal, exactly, the sum of the same n_dev folded keys run one after
    another on one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from qamreconciliation_jax.models.alphabet import PAMAlphabet
    from qamreconciliation_jax.models.matrix import Matrix
    from qamreconciliation_jax.models.noisemapper import NoiseMapper
    from qamreconciliation_jax.models.qc_decoder import QCDecoder, load_qc_csv
    from qamreconciliation_jax.parallel import make_mesh
    from qamreconciliation_jax.parallel.sweep import shard_round
    from qamreconciliation_jax.sims.engine import ReconciliationEngine

    base, z = load_qc_csv(code)
    dec = QCDecoder(base, z, dtype=jnp.bfloat16)
    pa = PAMAlphabet(2, 2.0)
    eng = ReconciliationEngine(dec, Matrix(dec.graph.e_to_v,
                                           dec.graph.e_to_c),
                               pa, batch=batch, dtype=jnp.bfloat16)
    N0 = pa.variance * 10.0 ** (-snr / 10.0) / 2.0
    nmcfg = np.zeros(pa.order, np.uint8)
    nmcfg[1::2] = 1
    nm = NoiseMapper(pa, N0, nmcfg, dtype=jnp.bfloat16)
    nm._ensure_llr_poly()
    body = eng._build_round_body("softening")
    args = (jnp.int32(maxiter), nm, jnp.asarray(math.sqrt(N0), jnp.bfloat16),
            jnp.asarray(1.0, jnp.bfloat16))
    key = jax.random.key(5)
    sharded = shard_round(body, make_mesh(n_dev), "dp")
    got = np.asarray(sharded(key, *args))
    one = jax.jit(body)
    want = sum(np.asarray(one(jax.random.fold_in(key, d), *args))
               for d in range(n_dev))
    check(np.array_equal(got, want),
          f"sharded counters {got.tolist()} vs sequential {want.tolist()}")
    return {"devices": n_dev, "frames": n_dev * batch, "snr_dB": snr,
            "counters": dict(zip(("bit_errors", "frame_errors",
                                  "iters_of_successes", "successes"),
                                 got.tolist()))}


def phase_graph_shard(code, *, n_dev=4, frames=8, snr=4.0, maxiter=50):
    """ShardedQCDecoder (z over n_dev cards) vs QCDecoder on one card, on
    the same inputs, float32, tanh-F/B rule (the kernel and the XLA check
    phase compute it in the same order).  Success and iterations must be
    equal; totals within 1e-4 absolute + 1e-4 relative, since the cards
    may add the variable-node partial sums in another order."""
    import jax.numpy as jnp
    import numpy as np

    from qamreconciliation_jax.models.alphabet import PAMAlphabet
    from qamreconciliation_jax.models.noisemapper import NoiseMapper
    from qamreconciliation_jax.models.qc_decoder import QCDecoder, load_qc_csv
    from qamreconciliation_jax.parallel import make_mesh
    from qamreconciliation_jax.parallel.graph_shard import ShardedQCDecoder
    from qamreconciliation_jax.utils.reference_np import softening_frames_np

    base, z = load_qc_csv(code)
    kw = dict(dtype=jnp.float32, check_phi="tanhfb")
    one = QCDecoder(base, z, **kw)
    sharded = ShardedQCDecoder(base, z, make_mesh(n_dev, axis_name="gs"),
                               **kw)
    pa = PAMAlphabet(2, 2.0)
    N0 = pa.variance * 10.0 ** (-snr / 10.0) / 2.0
    lappr, word = softening_frames_np(NoiseMapper(pa, N0), pa, frames,
                                      one.vnum // 2, seed=9)
    synd = np.asarray(one.syndrome_from_bits(
        jnp.asarray(word.T, jnp.int32))).T
    s1, i1, f1 = (np.asarray(a) for a in one.decode_batch(lappr, synd,
                                                          maxiter))
    s2, i2, f2 = (np.asarray(a) for a in sharded.decode_batch(lappr, synd,
                                                              maxiter))
    check(np.array_equal(s1, s2), f"success {s1} vs {s2}")
    check(np.array_equal(i1, i2), f"iterations {i1} vs {i2}")
    diff = np.abs(f1 - f2)
    check(bool((diff <= 1e-4 + 1e-4 * np.abs(f1)).all()),
          f"totals: max |delta| {diff.max():.3g}")
    return {"devices": n_dev, "frames": frames, "snr_dB": snr,
            "converged": int(s1.sum()), "max_abs_diff": float(diff.max()),
            "tolerance": "1e-4 + 1e-4*|x|"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the four-card paths and what they are "
                    "compared with")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "qamreconciliation_jax")):
        log("chip_smoke.py: run it from a checkout of the repository")
        return 2
    sys.path.insert(0, HERE)

    import jax

    devices = jax.devices()
    dev = devices[0]
    n_dev = 4 if args.multichip else 1
    if dev.platform != "gpu":
        log(f"chip_smoke.py: no GPU (JAX found {dev.platform})")
        return 2
    if len(devices) < n_dev:
        log(f"chip_smoke.py: needs {n_dev} GPUs, found {len(devices)}")
        return 2

    from qamreconciliation_jax.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    smi = nvidia_smi()
    emit("device", platform=dev.platform, kind=dev.device_kind,
         count=len(devices), nvidia_smi=smi, compile_cache=cache)
    code = dvbs2_code()
    if args.multichip:
        short = short_qc_code()
        emit("frame_shard", code=os.path.basename(short),
             **phase_frame_shard(short, n_dev=n_dev))
        emit("graph_shard", code=os.path.basename(short),
             **phase_graph_shard(short, n_dev=n_dev))
        emit("sweep", devices=n_dev,
             **phase_sweep(code, devices=n_dev))
    else:
        sweep = phase_sweep(code)
        first, ms = decode_ms_per_iter(code)
        emit("sweep", devices=1, decode_ms_per_iter=ms,
             decode_compile_s=first, **sweep)
        emit("decode_parity", **phase_decode_parity(code))
        emit("llr_parity", **phase_llr_parity())
        # the whole decode with the XLA check phase instead of the kernel
        _, ms_xla = decode_ms_per_iter(code, iters=100, fused=False)
        emit("check_phase", decode_ms_per_iter={
            "kernel": ms, "xla": ms_xla, "rule": "sumproduct phi",
            "dtype": "bfloat16"}, **phase_check_phase())
        emit("stream", **phase_stream(code))
        emit("mc_mi", **phase_mc_mi())
    for line in smi:
        print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
