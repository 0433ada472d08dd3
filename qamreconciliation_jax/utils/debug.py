"""Debug-tier numeric guards.

The reference *disables* safety in its hot paths (``boundscheck(False)``,
reference: qamreconciliation/decoder.pyx:181,240,289,332,399).  Per SURVEY.md
§5 this framework inverts that: shapes/dtypes are checked at trace time by
construction, and this module adds an opt-in ``checkify`` wrapper that turns
NaN/Inf production and out-of-bounds gathers inside any jittable pipeline
function into eager Python errors — for debugging LLR pipelines, not for the
production path.
"""

from __future__ import annotations

import functools

import jax
from jax.experimental import checkify

__all__ = ["with_numeric_checks"]


def with_numeric_checks(fn, errors=None):
    """Wrap a jittable function with checkify NaN/OOB guards.

    Example::

        step = with_numeric_checks(lambda key: engine_round(key, ...))
        step(key)   # raises checkify.JaxRuntimeError on the first NaN

    ``errors`` defaults to float + index checks.
    """
    if errors is None:
        errors = checkify.float_checks | checkify.index_checks
    checked = checkify.checkify(fn, errors=errors)
    jitted = jax.jit(checked)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        err, out = jitted(*args, **kwargs)
        err.throw()
        return out

    return wrapper
