"""The fused QC check-phase kernel (ops/pallas_kernels.py).

On the CPU the kernel runs in the Pallas interpreter and is compared with
the XLA check phase it replaces on a GPU (models/qc_decoder.
check_phase_xla); the choice between the two is tested as a function of
the platform.  The ``gpu``-marked test compares the compiled kernel on a
card and skips elsewhere (chip_smoke.py runs the same comparison).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qamreconciliation_jax.models.matrix import Matrix
from qamreconciliation_jax.models.qc_decoder import (
    QCDecoder, check_phase_xla, fused_check_phase, make_qc_ira, make_qc_ldpc,
)
from qamreconciliation_jax.ops.pallas_kernels import (
    CHECK_RULES, bp_check_phase_qc, check_phase_tiles, check_phase_warps,
)

BIG = 1e30   # the dense loop's neutral sentinel for padded slots


def _inputs(shape, dtype, seed=0, pad_rows=()):
    """t, c2v, synd in the dense loop's layout; rows listed in
    ``pad_rows`` get their last slot padded with the +BIG sentinel the way
    gather_totals pads short rows of irregular codes."""
    nb_c, dc, z, B = shape
    rng = np.random.default_rng(seed)
    t = rng.normal(0, 4, shape)
    for r in pad_rows:
        t[r, -1] = BIG
    c2v = rng.normal(0, 2, shape)
    for r in pad_rows:
        c2v[r, -1] = 0.0
    synd = rng.integers(0, 2, (nb_c, z, B))
    return (jnp.asarray(t, dtype), jnp.asarray(c2v, dtype),
            jnp.asarray(synd, jnp.int32))


# (nb_c, dc, z, B), padded rows: aligned z; z that is not a multiple of
# the z tile (masked rows); frame count that is not a power of two
# (masked frames); the DVB-S2 lifting z=360 with dc 7 and a padded row
SHAPES = [
    ((3, 6, 16, 8), ()),
    ((2, 7, 20, 12), ()),
    ((2, 6, 37, 5), (1,)),
    ((2, 7, 360, 8), (0,)),
]


@pytest.mark.parametrize("shape,pad_rows", SHAPES,
                         ids=["aligned", "z_masked", "b_masked", "z360"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("rule", CHECK_RULES)
def test_bp_check_phase_qc_parity(rule, dtype, shape, pad_rows):
    """Interpret-mode kernel == XLA check phase: convergence flags equal,
    messages equal to f32 summation order (the kernel folds the slot sum
    left to right, XLA's reduce picks its own order); bf16 messages are
    compared at one bf16 ulp of their magnitude."""
    t, c2v, synd = _inputs(shape, dtype, pad_rows=pad_rows)
    conv_k, out_k = bp_check_phase_qc(t, c2v, synd, rule=rule,
                                      interpret=True)
    conv_x, out_x = check_phase_xla(t, c2v, synd, rule=rule)
    assert out_k.dtype == c2v.dtype and out_k.shape == c2v.shape
    np.testing.assert_array_equal(np.asarray(conv_k), np.asarray(conv_x))
    a = np.asarray(out_k, np.float32)
    b = np.asarray(out_x, np.float32)
    real = np.ones(shape, bool)
    for r in pad_rows:
        real[r, -1] = False      # padded slots are never scattered
    assert np.isfinite(a[real]).all()
    rtol = 2 ** -7 if dtype == jnp.bfloat16 else 1e-5
    np.testing.assert_allclose(a[real], b[real], rtol=rtol, atol=1e-6)


def test_check_phase_kernel_convergence_counts():
    """A consistent tile converges and an inconsistent one does not,
    frame by frame, across several z tiles and two frame tiles, the
    second of them masked (B=160 -> tiles of 4 x 128: 10 z tiles)."""
    nb_c, dc, z, B = 2, 6, 40, 160
    assert check_phase_tiles(z, B) == (4, 128)
    t, c2v, _ = _inputs((nb_c, dc, z, B), jnp.float32, seed=2)
    parity = np.asarray(jnp.sum((t < 0).astype(jnp.int32), axis=1) & 1)
    synd = parity.copy()
    synd[1, 33, 2] ^= 1          # frame 2 breaks one check in a late tile
    synd[0, 5, 131] ^= 1         # frame 131, in the masked frame tile
    conv, _ = bp_check_phase_qc(t, c2v, jnp.asarray(synd), interpret=True)
    want = np.ones(B, bool)
    want[[2, 131]] = False
    np.testing.assert_array_equal(np.asarray(conv), want)


def test_pallas_extreme_llrs_no_nan():
    """Saturated and zero LLRs stay finite for every rule."""
    vals = np.array([0.0, 1e9, -1e9, 1e-30, -0.0, 3.0, -2.0, 1e4])
    t = jnp.asarray(np.broadcast_to(vals, (1, 6, 8, 8)).copy(), jnp.float32)
    c2v = jnp.zeros_like(t)
    synd = jnp.zeros((1, 8, 8), jnp.int32)
    for rule in CHECK_RULES:
        _, out = bp_check_phase_qc(t, c2v, synd, rule=rule, interpret=True)
        assert np.isfinite(np.asarray(out)).all(), rule


def test_check_phase_tiles_and_validation():
    """Tiles are powers of two of at most 512 elements per slot, frames
    along the minor axis, one warp per 64 elements; unknown rules are
    refused."""
    assert check_phase_tiles(360, 128) == (4, 128)
    assert check_phase_tiles(360, 8) == (64, 8)
    assert check_phase_tiles(16, 8) == (16, 8)
    assert check_phase_tiles(20, 12) == (32, 16)
    assert check_phase_warps(4, 128) == 8 and check_phase_warps(4, 8) == 1
    for z, B in ((360, 128), (7, 3), (1800, 256), (13, 1)):
        zt, bt = check_phase_tiles(z, B)
        assert zt & (zt - 1) == 0 and bt & (bt - 1) == 0
        assert zt * bt <= 512
        assert 1 <= check_phase_warps(zt, bt) <= 8
    t, c2v, synd = _inputs((1, 6, 16, 8), jnp.float32)
    with pytest.raises(ValueError, match="unknown rule"):
        bp_check_phase_qc(t, c2v, synd, rule="bogus", interpret=True)


def _jaxpr_has_kernel(dec, B=4):
    f = dec._build_decode()
    jaxpr = jax.make_jaxpr(f)(
        jnp.zeros((dec.vnum, B), dec.dtype),
        jnp.zeros((dec.cnum, B), jnp.int32), jnp.int32(3),
    )
    return "pallas_call" in str(jaxpr)


@pytest.mark.parametrize("platform,kw,want", [
    ("gpu", {}, True),
    ("cpu", {}, False),
    ("gpu", {"sr_messages": True, "dtype": jnp.bfloat16}, False),
    ("gpu", {"schedule": "layered"}, False),
], ids=["gpu", "cpu", "gpu_sr_messages", "gpu_layered"])
def test_check_phase_choice_by_platform(monkeypatch, platform, kw, want):
    """The dense flooding loop takes the kernel exactly on a GPU; the
    stochastic-rounding experiment and the layered schedule stay on XLA
    ops.  Tracing only: nothing is compiled for the platform."""
    assert fused_check_phase("gpu") and not fused_check_phase("cpu")
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    base, _, _ = make_qc_ldpc(6, 8, dv=3, dc=6, seed=1)
    assert _jaxpr_has_kernel(QCDecoder(base, 8, **kw)) is want


def test_sharded_qc_decoder_never_takes_kernel(monkeypatch):
    """GSPMD cannot partition the kernel: the z-sharded decoder keeps the
    XLA check phase even on a GPU."""
    from qamreconciliation_jax.parallel import make_mesh
    from qamreconciliation_jax.parallel.graph_shard import ShardedQCDecoder

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    base, _, _ = make_qc_ldpc(6, 8, dv=3, dc=6, seed=1)
    dec = ShardedQCDecoder(base, 8, make_mesh(2, axis_name="gz"))
    assert not _jaxpr_has_kernel(dec)


def _frames(vid, cid, V, B, seed, noise=1.6):
    rng = np.random.default_rng(seed)
    word = rng.integers(0, 2, (B, V))
    synd = np.asarray(Matrix(vid, cid).eval_syndrome(word))
    llr = (1 - 2 * word) * 2.5 + rng.normal(0, noise, word.shape)
    return llr, synd


@pytest.mark.parametrize("rule,phi", [("sumproduct", "phi"),
                                      ("sumproduct", "tanhfb"),
                                      ("minsum", "phi")])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_decoders_pallas_path_match_xla(fused_check, rule, phi, dtype):
    """Whole decodes through the kernel (the GPU path, interpreted) ==
    the XLA path: same (success, iters), finals equal on the CPU, where
    both sum in the same precision."""
    base, vid, cid = make_qc_ira(4, 4, 16, dv=3, seed=2)
    kw = dict(dtype=dtype, check_rule=rule, check_phi=phi)
    xla = QCDecoder(base, 16, **kw)
    llr, synd = _frames(vid, cid, xla.vnum, B=6, seed=3)
    s0, i0, f0 = xla.decode_batch(llr, synd, 20)
    fused_check()
    s1, i1, f1 = QCDecoder(base, 16, **kw).decode_batch(llr, synd, 20)
    np.testing.assert_array_equal(np.asarray(s0), np.asarray(s1))
    np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))
    np.testing.assert_allclose(np.asarray(f0, np.float32),
                               np.asarray(f1, np.float32),
                               rtol=1e-5, atol=1e-5)
    assert int(np.asarray(s0).sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("rule", CHECK_RULES)
def test_check_phase_compiled_matches_xla(gpu, rule):
    """On a card: the Triton-compiled kernel == the XLA check phase at the
    DVB-S2 shape (z=360, B=128, dc 7), bf16 messages within two ulps (the
    tolerance chip_smoke.py states)."""
    t, c2v, synd = _inputs((90, 7, 360, 128), jnp.bfloat16)
    conv_k, out_k = bp_check_phase_qc(t, c2v, synd, rule=rule)
    conv_x, out_x = check_phase_xla(t, c2v, synd, rule=rule)
    np.testing.assert_array_equal(np.asarray(conv_k), np.asarray(conv_x))
    np.testing.assert_allclose(np.asarray(out_k, np.float32),
                               np.asarray(out_x, np.float32),
                               rtol=2 ** -6, atol=1e-6)
