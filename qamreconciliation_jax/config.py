"""Global numeric configuration.

The reference implementation is float64 throughout (Cython ``double``).  On
an accelerator the natural compute dtype is float32; float64 remains available on CPU for
parity validation.  Everything in this package takes an explicit ``dtype``
argument defaulting to :data:`DEFAULT_DTYPE`.
"""

import numpy as np
import jax.numpy as jnp

# Default compute dtype for LLR/message arrays.
DEFAULT_DTYPE = jnp.float32

# Integer dtype for node/edge indices.  int32 is enough for any code we care
# about (DVB-S2 N=64800, E~300k) and is the fast integer width on accelerators.
INDEX_DTYPE = jnp.int32


def finite_llr_max(dtype) -> float:
    """A large-but-safe LLR magnitude for the given dtype.

    The reference uses a sentinel of 1e300 for "certain" bits
    (reference: qamreconciliation/noisemapper.pyx:218).  In float32 that would
    overflow to inf and poison sums, so we clamp to a quarter of the dtype max.
    """
    # jnp.finfo understands ml_dtypes (bfloat16 etc.) where np.finfo does not
    fi = jnp.finfo(jnp.dtype(dtype))
    return min(1e300, float(fi.max) / 4)
