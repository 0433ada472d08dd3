"""chip_smoke.py without a card: it refuses to run, and its phases' logic
rehearses on the CPU at a tiny size (the sharded ones on the virtual
8-device mesh of conftest.py).  The full-size run needs a GPU:
``python chip_smoke.py`` and ``python chip_smoke.py --multichip``."""

import importlib.util
import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd, script, env_update):
    env = dict(os.environ)
    env.update(env_update)
    return subprocess.run([sys.executable, script], capture_output=True,
                          text=True, timeout=300, cwd=cwd, env=env)


def test_refuses_without_gpu():
    out = _run(REPO, os.path.join(REPO, "chip_smoke.py"),
               {"JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no GPU" in out.stderr


def test_refuses_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(str(tmp_path), str(tmp_path / "chip_smoke.py"),
               {"JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert out.stdout == ""


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """chip_smoke as a module, writing into a temporary directory, with a
    small irregular QC code (z=16) standing in for DVB-S2."""
    from qamreconciliation_jax.models.qc_decoder import make_qc_ira, save_qc_csv

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.WORK = str(tmp_path_factory.mktemp("smoke"))
    base, _, _ = make_qc_ira(nb_info=8, nb_acc=8, z=16, dv=3, seed=2)
    code = os.path.join(mod.WORK, "qc.csv")
    save_qc_csv(code, base, 16)
    return mod, code


def test_sweep_phase_tiny(smoke):
    mod, code = smoke
    out = mod.phase_sweep(code, snr=(4.0, 6.0), nsnr=2, batch=8,
                          simloops=16, maxiter=20, check_ref=False)
    assert [p["frames"] for p in out["points"]] == [16, 16]
    assert out["points"][0]["compile_s"] > 0
    assert out["points"][1]["compile_s"] == 0      # one program per sweep


def test_fer_agreement_interval():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ok, half = mod.fer_agrees(0.5781, 1024, 0.568359375, 1024)
    assert ok and 0.05 < half < 0.06
    assert not mod.fer_agrees(0.45, 1024, 0.568359375, 1024)[0]


def test_reference_fer_reads_recorded_waterfall():
    """The FER the sweep phase is held to: 3.0 dB of wf_dvbs2_12.csv,
    whose header starts with the unnamed index column."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.reference_fer(3.0) == 0.568359375
    with pytest.raises(SystemExit):
        mod.reference_fer(9.75)


def test_check_phase_phase_tiny(smoke, fused_check):
    """The check_phase phase's comparison and tolerances, with the kernel
    in the Pallas interpreter: z not a multiple of the tile, dc 7 and 6."""
    mod, _ = smoke
    fused_check()
    out = mod.phase_check_phase(nb_c=2, z=20, B=8, reps=1)
    assert len(out["rows"]) == 2 * 2 * 3
    for row in out["rows"]:
        assert row["max_abs_diff"] <= 1e-2 * 8 + 1e-3


def test_decode_ms_per_iter_kernel_and_xla_tiny(smoke, fused_check):
    """The decode timing the check_phase line reports, through the kernel
    (interpreted here) and through the XLA check phase."""
    mod, code = smoke
    fused_check()
    for fused in (True, False):
        first, ms = mod.decode_ms_per_iter(code, batch=4, iters=3,
                                           dtype="float32", fused=fused)
        assert first > 0 and ms > 0


def test_decode_parity_phase_tiny(smoke):
    mod, code = smoke
    out = mod.phase_decode_parity(code, frames=4, snr=6.0, maxiter=30)
    assert out["converged"] > 0


def test_llr_parity_phase_tiny(smoke):
    mod, _ = smoke
    out = mod.phase_llr_parity(frames=1)
    assert out["p9999_abs_diff"] <= 2e-3


def test_stream_and_mc_mi_phases_tiny(smoke):
    mod, code = smoke
    out = mod.phase_stream(code, batch=4, batches=2, snr=6.0, maxiter=20)
    assert out["frames"] == 8
    with jax.enable_x64(False):      # as on the card: float32 estimator
        mi = mod.phase_mc_mi(n=1 << 14)
    assert abs(mi["I_X_Y"] - mi["I_X_Y_analytic"]) < 0.02


def test_multichip_phases_on_virtual_devices(smoke):
    """The four-card comparisons on four virtual CPU devices."""
    mod, code = smoke
    fs = mod.phase_frame_shard(code, n_dev=4, batch=4, snr=6.0, maxiter=20)
    assert fs["frames"] == 16
    gs = mod.phase_graph_shard(code, n_dev=4, frames=4, snr=6.0, maxiter=20)
    assert gs["converged"] > 0
    sw = mod.phase_sweep(code, snr=(4.0, 6.0), nsnr=2, batch=4, simloops=16,
                         maxiter=20, devices=4, check_ref=False)
    assert [p["frames"] for p in sw["points"]] == [16, 16]
