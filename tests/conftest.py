"""Test configuration: force CPU with 8 virtual devices, enable x64.

Multi-device tests follow SURVEY.md §4's prescription: shard-invariance is
validated on a virtual CPU mesh.  x64 is enabled so float64 parity tests
against the (float64) reference semantics are meaningful; the library
itself is dtype-explicit and defaults to float32.

Tests marked ``gpu`` need an NVIDIA GPU; they skip here and run on a card
through ``python chip_smoke.py``.
"""

import functools
import os

import pytest

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def fused_check(monkeypatch):
    """Returns ``enable()``: from that call on, QCDecoder's dense flooding
    loop takes the fused check-phase kernel — the path it takes on a GPU —
    run in the Pallas interpreter.  Decoders built before the call keep
    the XLA check phase, so one test can compare both."""
    from qamreconciliation_jax.models import qc_decoder
    from qamreconciliation_jax.ops import pallas_kernels

    def enable():
        monkeypatch.setattr(qc_decoder, "fused_check_phase", lambda p: True)
        monkeypatch.setattr(
            pallas_kernels, "bp_check_phase_qc",
            functools.partial(pallas_kernels.bp_check_phase_qc,
                              interpret=True),
        )

    return enable


@pytest.fixture
def gpu():
    """The first JAX device, which must be an NVIDIA GPU; skips otherwise.
    Decided here, at run time, never while modules are imported."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX runs on {dev.platform}); "
                    "chip_smoke.py runs these checks on a card")
    return dev
