"""Channel-observation LLR builders (Bob-side, direct reconciliation).

Batched log-domain equivalent of the reference's Gray max-log-free exact LLR
(reference: sims/reconciliation.pyx:25-89): for each sample y and bit k,

    LLR_k = log sum_{i: gray_k(i)=0} e^{-(y-a_i)^2 / 2v}
          - log sum_{i: gray_k(i)=1} e^{-(y-a_i)^2 / 2v}

computed with logsumexp for float32 stability.
"""

import numpy as np

import jax.numpy as jnp
from jax.scipy.special import logsumexp

from ..models.bicm import gray_bit_masks
from ..config import DEFAULT_DTYPE

__all__ = ["y_to_lappr_gray", "y_to_lappr_gray_bits"]


def y_to_lappr_gray(y, constellation, two_variance, dtype=DEFAULT_DTYPE):
    """y: [..., S] samples -> LLRs [..., S*bps] (per-symbol blocks contiguous).

    ``two_variance`` is 2*noise_var, matching the reference's argument
    (reference: sims/reconciliation.pyx:75-89).
    """
    y = jnp.asarray(y, dtype)
    c = jnp.asarray(constellation, dtype)
    M = c.shape[0]
    bps = M.bit_length() - 1
    mask1 = jnp.asarray(gray_bit_masks(bps), dtype) > 0      # [M, bps]

    log_w = -((y[..., None] - c) ** 2) / jnp.asarray(two_variance, dtype)
    lw = log_w[..., None]                                    # [..., S, M, 1]
    neg_inf = jnp.array(-jnp.inf, dtype)
    num = logsumexp(jnp.where(mask1, neg_inf, lw), axis=-2)
    den = logsumexp(jnp.where(mask1, lw, neg_inf), axis=-2)
    llr = num - den                                          # [..., S, bps]
    return llr.reshape(*llr.shape[:-2], -1)


def y_to_lappr_gray_bits(y_sb, constellation, two_variance,
                         dtype=DEFAULT_DTYPE):
    """Lane-flat direct-mode LLRs: y [S, B] -> [bps, S, B] per-bit curves.

    Same math as :func:`y_to_lappr_gray` (reference:
    sims/reconciliation.pyx:25-89) reorganized for a dense layout:
    the M-candidate axis is an UNROLLED host loop over
    static constellation floats — every live array stays ``[S, B]`` with
    the batch on the lane dim, no trailing M axis, no mid-shape reductions
    (a small trailing axis leaves the minor dimension mostly empty, see
    models/noisemapper.hard_decide_index).  Stability is a
    SHARED-max logsumexp: one global running max over the M distance
    slabs, M exps, ``2*bps`` logs.

    Deviation from the per-group logsumexp: when every exponential of one
    Gray group underflows against the shared max (a >~88-sigma'd tail
    sample at very high SNR in f32), the group sum is floored at the
    dtype's smallest normal, saturating that LLR at ~|log(tiny)| ~= 88-175
    instead of the exact larger tail value — far beyond BP decision
    levels, and finite (never +/-inf/NaN), where a 0-sum would produce
    inf.  Per-group maxes would be exact but cost ``bps*M`` exps instead
    of M.

    ``two_variance`` may be a traced scalar (sigma rides into jitted sweep
    rounds as an argument — one compiled program per sweep).
    """
    y = jnp.asarray(y_sb, dtype)
    cs = [float(v) for v in np.asarray(constellation)]       # static floats
    M = len(cs)
    bps = M.bit_length() - 1
    masks = np.asarray(gray_bit_masks(bps)) > 0              # [M, bps] host
    inv2v = (1.0 / jnp.asarray(two_variance, dtype)).astype(dtype)

    lw = [-jnp.square(y - c_m) * inv2v for c_m in cs]        # M x [S, B]
    gmax = lw[0]
    for m in range(1, M):
        gmax = jnp.maximum(gmax, lw[m])
    e = [jnp.exp(lw[m] - gmax) for m in range(M)]            # M x [S, B]

    # smallest normal of the COMPUTE dtype: bf16/f16 inputs are summed in
    # their own dtype, so floor against that dtype's underflow threshold
    tiny = float(jnp.finfo(jnp.dtype(dtype)).tiny)
    out = []
    for b in range(bps):
        num = den = None
        for m in range(M):
            if masks[m, b]:
                den = e[m] if den is None else den + e[m]
            else:
                num = e[m] if num is None else num + e[m]
        out.append(
            jnp.log(jnp.maximum(num, tiny)) - jnp.log(jnp.maximum(den, tiny))
        )
    return jnp.stack(out)                                    # [bps, S, B]
