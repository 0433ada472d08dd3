"""checkify debug tier: NaN guards fire on bad pipelines, pass on good ones."""

import numpy as np
import jax.numpy as jnp
import pytest
from jax.experimental import checkify

from qamreconciliation_jax.utils.debug import with_numeric_checks


def test_clean_function_passes():
    f = with_numeric_checks(lambda x: jnp.log1p(jnp.exp(-jnp.abs(x))).sum())
    out = f(jnp.linspace(-5, 5, 64))
    assert np.isfinite(float(out))


def test_nan_production_raises():
    f = with_numeric_checks(lambda x: jnp.log(x).sum())  # log of negatives
    with pytest.raises(checkify.JaxRuntimeError):
        f(jnp.array([-1.0, 2.0]))


def test_decoder_round_checks_clean():
    """The BP decode pipeline is NaN-free under float checks."""
    from qamreconciliation_jax import Decoder, Matrix
    from qamreconciliation_jax.utils import make_regular_ldpc

    vid, cid = make_regular_ldpc(96, 3, 6, seed=2)
    dec = Decoder(vid, cid, dtype=jnp.float32)
    mat = Matrix(vid, cid)
    rng = np.random.default_rng(0)
    word = rng.integers(0, 2, (4, dec.vnum))
    synd = np.asarray(mat.eval_syndrome(word))
    llr = jnp.asarray((1 - 2 * word) * 2.0 + rng.normal(0, 1.5, word.shape),
                      jnp.float32)

    if dec._decode_jit is None:
        dec._decode_jit = dec._build_decode()

    step = with_numeric_checks(
        lambda l, s: dec._decode_jit(l.T, s.T, jnp.int32(10))[2],
        errors=checkify.float_checks,
    )
    out = step(llr, jnp.asarray(synd))
    assert np.isfinite(np.asarray(out)).all()
