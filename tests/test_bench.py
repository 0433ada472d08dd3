"""bench.py smoke: the contract is ONE JSON line on stdout.

Runs the real bench script in a subprocess on the CPU backend (which it
takes only when JAX_PLATFORMS=cpu is set explicitly) with tiny shapes and
every measurement block enabled (decode probes, headline, waterfall,
secondary rows, native baseline) and validates the JSON schema.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_smoke_json_contract():
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "BENCH_N": "1152",          # divisible by 36 -> z=32 QC code
        "BENCH_NBV": "36",          # the default is 180 (z=360 DVB-S2
                                    # lifting); pin the z=32 smoke shape
        "BENCH_BATCH": "8",
        "BENCH_ROUNDS": "2",
        "BENCH_RPD": "1",
        "BENCH_BASELINE_S": "1",
        "BENCH_SNR": "4.0",
        "BENCH_SNR2": "5.0",
        "BENCH_MAXITER": "15",
        "BENCH_PROBE_ITERS": "30",
        "BENCH_MI_N": "65536",
    })
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py")],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [ln for ln in out.stdout.strip().splitlines() if ln.strip()]
    assert len(lines) == 1, f"expected ONE stdout line, got {lines}"
    j = json.loads(lines[0])
    for k in ("metric", "value", "unit", "vs_baseline"):
        assert k in j, k
    assert j["unit"] == "frames/s" and j["value"] > 0
    assert j["schedule"] == "flooding"
    # the device the numbers were taken on, as JAX reports it
    assert j["device"]["platform"] == "cpu" and j["device"]["count"] >= 1
    assert "kind" in j["device"]
    # decode probe + waterfall + both secondary blocks present
    assert j["decode_ms_per_iter"] > 0 and j["decode_compile_s"] > 0
    assert j["waterfall"]["frames_per_s"] > 0
    assert j["minsum"]["waterfall"]["mean_iters"] >= 0
    assert j["layered"]["check_rule"] == "minsum"
    assert j["layered"]["frames_per_s"] > 0
    # rate-3/4 irregular decode probe + min-over-reps streaming
    assert j["rate34_qc"]["decode_ms_per_iter"] > 0
    assert j["sumproduct_tanhfb_dense"]["waterfall"]["frames_per_s"] > 0
    assert j["streaming"]["symbols_per_s"] > 0
    assert len(j["streaming"]["rep_symbols_per_s"]) == j["streaming"]["reps"]
    assert j["mc_mi"]["samples_per_s"] > 0


def test_bench_refuses_cpu_without_explicit_platform():
    """Without JAX_PLATFORMS=cpu and without a GPU, bench.py stops before
    measuring anything and prints no result line."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["JAX_PLATFORMS"] = ""      # JAX picks its default: the CPU here
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py")],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO,
    )
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "found none" in out.stderr
