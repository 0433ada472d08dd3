"""Multi-device tests on the 8-way virtual CPU mesh (SURVEY.md §4)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qamreconciliation_jax import Decoder, Matrix, PAMAlphabet
from qamreconciliation_jax.parallel import make_mesh, shard_round
from qamreconciliation_jax.sims import ReconciliationEngine
from qamreconciliation_jax.utils import make_regular_ldpc


@pytest.fixture(scope="module")
def setup():
    vid, cid = make_regular_ldpc(120, 3, 6, seed=2)
    dec = Decoder(vid, cid, dtype=jnp.float64)
    mat = Matrix(vid, cid)
    pa = PAMAlphabet(2, 2.0)
    return dec, mat, pa


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_round_equals_manual_per_device_sum(setup):
    """Shard-invariance: the psum-reduced counters of an 8-device round must
    equal the sum of 8 single-device rounds run with the same folded keys."""
    dec, mat, pa = setup
    mesh = make_mesh(8)

    eng_sharded = ReconciliationEngine(
        dec, mat, pa, batch=16, dtype=jnp.float64, mesh_axis=(mesh, "dp")
    )
    eng_local = ReconciliationEngine(dec, mat, pa, batch=16, dtype=jnp.float64)

    snr = 5.0
    cfg = np.zeros(4, np.uint8)
    import math

    Es = pa.variance
    N0 = Es * 10 ** (-snr / 10) / 2
    sigma = math.sqrt(N0)
    from qamreconciliation_jax.models.noisemapper import NoiseMapper

    nm = NoiseMapper(pa, N0, cfg, dtype=jnp.float64)
    nm._ensure_llr_poly()  # default poly-mode consumer: build before jit

    shard_fn = eng_sharded._build_round("softening")
    local_fn = eng_local._build_round("softening")
    sigma_dev = jnp.asarray(sigma, jnp.float64)
    alpha_dev = jnp.asarray(1.0, jnp.float64)

    key = jax.random.key(42)
    got = [
        int(x)
        for x in shard_fn(key, jnp.int32(20), nm, sigma_dev, alpha_dev)
    ]

    expect = [0, 0, 0, 0]
    for d in range(8):
        res = local_fn(
            jax.random.fold_in(key, d), jnp.int32(20), nm, sigma_dev,
            alpha_dev,
        )
        expect = [a + int(b) for a, b in zip(expect, res)]

    assert got == expect


def test_sharded_sweep_runs(setup):
    dec, mat, pa = setup
    mesh = make_mesh(8)
    eng = ReconciliationEngine(
        dec, mat, pa, batch=8, dtype=jnp.float64, mesh_axis=(mesh, "dp")
    )
    assert eng.frames_per_round == 64
    r = eng.run_point("direct", 7.0, 20, 128, 10**9, seed=0)
    assert r.frames == 128
    assert 0.0 <= r.ber <= 1.0


class TestMaybeDistributedInit:
    """CLI multi-host wiring (SURVEY §2 collective-backend row)."""

    def test_noop_without_coordinator(self, monkeypatch):
        from qamreconciliation_jax.parallel import mesh

        monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
        monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
        monkeypatch.setitem(mesh._dist_state, "initialized", False)
        assert mesh.maybe_distributed_init() is False

    def test_failure_warns_not_silent(self, monkeypatch):
        """A failed multi-host init must be loud (single-host fallback would
        silently mis-attribute sweep statistics)."""
        import warnings

        import jax

        from qamreconciliation_jax.parallel import mesh

        monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "203.0.113.1:1234")
        monkeypatch.setitem(mesh._dist_state, "initialized", False)

        def boom(*a, **k):
            raise RuntimeError("no coordinator reachable")

        monkeypatch.setattr(jax.distributed, "initialize", boom)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            assert mesh.maybe_distributed_init() is False
        assert any("FALLING BACK" in str(w.message) for w in rec)

    def test_cli_reaches_init(self, monkeypatch, tmp_path):
        """Every sweep CLI calls maybe_distributed_init before device use."""
        from qamreconciliation_jax.parallel import mesh
        from qamreconciliation_jax.sims import sim_bsc
        from qamreconciliation_jax.utils import make_regular_ldpc, save_edge_csv

        calls = []
        monkeypatch.setattr(
            mesh, "maybe_distributed_init", lambda *a, **k: calls.append(1)
        )
        path = str(tmp_path / "code.csv")
        vid, cid = make_regular_ldpc(120, 3, 6, seed=9)
        save_edge_csv(path, vid, cid)
        sim_bsc.main([
            path, "--out", str(tmp_path / "o.csv"), "--maxiter", "5",
            "--simloops", "32", "--rber", "0.01", "0.01", "--rpoints", "1",
            "--batch", "32", "--dtype", "float64",
        ])
        assert calls
