"""Stochastic message rounding (ops/boxplus.stochastic_round_bf16 +
QCDecoder(sr_messages=True)) — a knee-quality lever (decoding-quality
runs put the bf16 FER cost in c2v message round-to-nearest bias)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qamreconciliation_jax.ops.boxplus import stochastic_round_bf16
from qamreconciliation_jax.models.qc_decoder import QCDecoder, make_qc_ldpc


def test_sr_neighbours_and_unbiasedness():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(0, 5, 4096), jnp.float32)
    key = jax.random.PRNGKey(7)
    # truncation neighbour (round-toward-zero in the pattern)
    lo_bits = jax.lax.bitcast_convert_type(x, jnp.uint32) \
        & jnp.uint32(0xFFFF0000)
    lo = np.asarray(
        jax.lax.bitcast_convert_type(lo_bits, jnp.float32), np.float64
    )
    hi_bits = (jax.lax.bitcast_convert_type(x, jnp.uint32)
               + jnp.uint32(0xFFFF)) & jnp.uint32(0xFFFF0000)
    hi = np.asarray(
        jax.lax.bitcast_convert_type(hi_bits, jnp.float32), np.float64
    )
    R = 64
    acc = np.zeros(x.shape, np.float64)
    for i in range(R):
        bits = jax.random.bits(jax.random.fold_in(key, i), x.shape,
                               jnp.uint32)
        y = np.asarray(stochastic_round_bf16(x, bits), np.float64)
        # every draw is one of the two enclosing bf16 neighbours
        assert np.all((y == lo) | (y == hi))
        acc += y
    # unbiased: the empirical mean approaches x well inside one bf16 ulp
    err = np.abs(acc / R - np.asarray(x, np.float64))
    ulp = np.abs(np.asarray(x, np.float64)) * 2 ** -8 + 1e-12
    assert float(np.max(err / ulp)) < 0.5


def test_sr_decode_matches_statistics():
    """sr_messages decodes the same easy frames as round-to-nearest (the
    rounding perturbation is sub-ulp noise, not a semantic change)."""
    base, _, _ = make_qc_ldpc(12, 32, dv=3, dc=6, seed=3)
    rng = np.random.default_rng(0)
    word = rng.integers(0, 2, (8, 384))
    lappr = (1.0 - 2.0 * word) * 2.0 + rng.standard_normal(word.shape)
    res = {}
    for sr in (False, True):
        dec = QCDecoder(base, 32, dtype=jnp.bfloat16, sr_messages=sr)
        synd = dec.syndrome_from_bits(jnp.asarray(word.T))
        ok, iters, _ = dec.decode_batch(
            jnp.asarray(lappr, jnp.bfloat16), jnp.asarray(synd).T, 50
        )
        res[sr] = np.asarray(ok)
    assert res[False].all() and res[True].all()


def test_sr_config_validation():
    base, _, _ = make_qc_ldpc(12, 32, dv=3, dc=6, seed=3)
    with pytest.raises(ValueError, match="bfloat16"):
        QCDecoder(base, 32, dtype=jnp.float32, sr_messages=True)
    for kw in (dict(compressed=True, check_rule="minsum"),
               dict(schedule="layered")):
        with pytest.raises(ValueError, match="dense flooding"):
            QCDecoder(base, 32, dtype=jnp.bfloat16, sr_messages=True, **kw)
