"""Belief-propagation message math, batched.

The reference computes the exact sum-product check-node update with jagged
per-node forward/backward box-plus prefix scans over ``long**`` tables
(reference: qamreconciliation/decoder.pyx:41-45, 322-369).  Here we use the
numerically-equal sign/phi decomposition, which turns the all-but-one
reduction into *one dense segment sum minus self* — a perfect fit for the
padded dual-layout graph representation (see models/decoder.py):

    box-plus over a set S, excluding element e
      magnitude:  phi( sum_{s in S} phi(|m_s|) - phi(|m_e|) )
      sign:       (-1)^(parity(S) - neg_e)

where ``phi(x) = -log(tanh(x/2))`` is a self-inverse involution.  Equality
with the reference's box-plus (``sgn*min + log1p(exp(-|a+b|)) -
log1p(exp(-|a-b|))``) and with the tanh form ``2*artanh(prod tanh(m/2))`` is
asserted in tests to the same tolerance the reference uses for its own
check-node tests (reference: test/test_decoder.py:189-220).
"""

import jax.numpy as jnp

__all__ = [
    "box_plus",
    "phi_llr",
    "stochastic_round_bf16",
    "check_node_update",
    "check_node_update_sm",
    "minsum_extrinsic_mag",
    "tanhfb_extrinsic_mag",
    "tanhfb_extrinsic_list",
    "minsum_extrinsic_list",
    "check_node_minsum",
    "check_node_minsum_sm",
    "check_node_tanhfb_sm",
    "fb_allbutone_list",
    "var_node_update",
    "MINSUM_ALPHA",
    "minsum_mag",
]

# Normalized min-sum scale (13/16) — the standard hardware-decoder choice;
# exactly representable in bfloat16/float32.
MINSUM_ALPHA = 0.8125


def minsum_mag(m, alpha: float, beta: float):
    """Normalized/offset min-sum magnitude: ``max(alpha*m - beta, 0)``.

    alpha=13/16, beta=0 is the repo's normalized default; alpha=1 with
    beta>0 is classic offset min-sum (both standard hardware-decoder
    corrections of min-sum's magnitude over-estimate; the offset form is
    the basis of the neural-OMS line of work).  beta=0 lowers to a bare
    multiply, so the default costs nothing extra.
    """
    scaled = alpha * m
    if beta:
        return jnp.maximum(scaled - beta, 0.0)
    return scaled


def box_plus(a, b):
    """Exact pairwise box-plus (elementwise, any shape).

    Same formulation as reference: qamreconciliation/decoder.pyx:41-45;
    provided for tests and small host-side use.  The decode hot loop uses the
    phi form instead.
    """
    return (
        jnp.sign(a) * jnp.sign(b) * jnp.minimum(jnp.abs(a), jnp.abs(b))
        + jnp.log1p(jnp.exp(-jnp.abs(a + b)))
        - jnp.log1p(jnp.exp(-jnp.abs(a - b)))
    )


def phi_llr(x, tiny: float = 1e-30):
    """phi(x) = -log(tanh(x/2)) for x > 0, numerically stable, self-inverse.

    Computed as ``log1p(e^-x) - log1p(-e^-x)``.  Inputs are clamped to
    ``[tiny, inf)``; the clamp bounds output magnitudes at ``phi(tiny)``
    (~69 for tiny=1e-30), which also acts as the LLR saturation level of the
    decoder — far beyond any magnitude that affects BP decisions.
    """
    x = jnp.maximum(x, tiny)
    # Two regimes for full relative accuracy across the range:
    #  x < 10:  -log(tanh(x/2)) is well-conditioned (tanh far from 1).
    #  x >= 10: log1p(e^-x) - log1p(-e^-x); both log1p args are tiny, so no
    #           cancellation (log(-expm1(-x)) would round 1 - e^-x to 1 here
    #           and lose exactly a factor 2 -> ln 2 error after inversion).
    ex = jnp.exp(-jnp.maximum(x, 10.0))
    big = jnp.log1p(ex) - jnp.log1p(-ex)
    small = -jnp.log(jnp.tanh(jnp.minimum(x, 10.0) / 2.0))
    return jnp.where(x < 10.0, small, big)


def check_node_update(v2c_c, synd, c_mask, tiny: float = 1e-30):
    """Batched check-node (horizontal) update in check-major layout.

    Args:
      v2c_c:  [C, dc_max, B] variable->check messages (padded slots arbitrary)
      synd:   [C, B] syndrome bits (0/1)
      c_mask: [C, dc_max] 1.0 on real slots, 0.0 on padding
      tiny:   phi clamp

    Returns c2v_c [C, dc_max, B]: extrinsic check->variable messages with the
    syndrome prefactor ``(-1)^synd`` applied
    (semantics of reference: qamreconciliation/decoder.pyx:322-369).

    bfloat16 messages are upcast to float32 for the phi math (exp/log in
    bf16's 8-bit mantissa distorts small-LLR magnitudes) and the result is
    stored back in bf16 — messages ride HBM at half width, arithmetic stays
    f32-accurate in registers.
    """
    out_dtype = v2c_c.dtype
    if out_dtype == jnp.bfloat16:
        v2c_c = v2c_c.astype(jnp.float32)
        c_mask = c_mask.astype(jnp.float32)
    mask = c_mask[:, :, None]
    absm = jnp.abs(v2c_c)
    phim = phi_llr(absm, tiny) * mask
    s_phi = jnp.sum(phim, axis=1, keepdims=True)
    mag = phi_llr(s_phi - phim, tiny)

    neg = jnp.logical_and(v2c_c < 0, mask > 0)
    parity = jnp.sum(neg.astype(jnp.int32), axis=1, keepdims=True) & 1
    ext_neg = jnp.bitwise_xor(parity, neg.astype(jnp.int32))
    sign = (1 - 2 * ext_neg).astype(v2c_c.dtype)

    pref = (1 - 2 * synd.astype(jnp.int32)).astype(v2c_c.dtype)[:, None, :]
    return (sign * pref * mag * mask).astype(out_dtype)


def check_node_update_sm(v2c_d, synd, c_mask_T, tiny: float = 1e-30):
    """Slot-major check-node update: the degree axis LEADS.

    Same math as :func:`check_node_update` with layout [dc_max, C, B]
    (mask [dc_max, C]) — the decode hot loop's native layout, chosen so the
    two minormost dims are (checks, frames) with no slot
    padding (see models/decoder.py TannerGraph).  Semantics per
    reference: qamreconciliation/decoder.pyx:322-369.
    """
    out_dtype = v2c_d.dtype
    if out_dtype == jnp.bfloat16:
        v2c_d = v2c_d.astype(jnp.float32)
        c_mask_T = c_mask_T.astype(jnp.float32)
    mask = c_mask_T[:, :, None]
    phim = phi_llr(jnp.abs(v2c_d), tiny) * mask
    s_phi = jnp.sum(phim, axis=0, keepdims=True)
    mag = phi_llr(s_phi - phim, tiny)

    neg = jnp.logical_and(v2c_d < 0, mask > 0)
    parity = jnp.sum(neg.astype(jnp.int32), axis=0, keepdims=True) & 1
    sign = (1 - 2 * jnp.bitwise_xor(parity, neg.astype(jnp.int32))).astype(
        v2c_d.dtype
    )
    pref = (1 - 2 * synd.astype(jnp.int32)).astype(v2c_d.dtype)[None, :, :]
    return (sign * pref * mag * mask).astype(out_dtype)


def minsum_extrinsic_mag(absm, axis: int):
    """Per-slot min over the OTHER slots of ``axis`` (exact, tie-correct).

    min-sum's all-but-one magnitude via the min1/min2 decomposition: the
    unique argmin slot sees the second-smallest value, every other slot
    (including every slot of a tied minimum) sees the minimum.  Pure
    min/compare/select code — no transcendentals.

    Masked callers pre-set padded slots to a large sentinel; those slots
    never win the min and their outputs are re-masked by the caller.
    """
    big = jnp.asarray(1e30, absm.dtype)
    min1 = jnp.min(absm, axis=axis, keepdims=True)
    is_min = absm == min1
    cnt = jnp.sum(is_min.astype(jnp.int32), axis=axis, keepdims=True)
    min2 = jnp.min(jnp.where(is_min, big, absm), axis=axis, keepdims=True)
    return jnp.where(jnp.logical_and(is_min, cnt == 1), min2, min1)


def minsum_extrinsic_list(absm):
    """:func:`minsum_extrinsic_mag` over a list of same-shape slot tiles
    (the form a kernel holding one tile per slot uses); min and select are
    exact, so both forms give identical values."""
    big = jnp.asarray(1e30, absm[0].dtype)
    min1 = absm[0]
    for a in absm[1:]:
        min1 = jnp.minimum(min1, a)
    is_min = [a == min1 for a in absm]
    cnt = is_min[0].astype(jnp.int32)
    for m in is_min[1:]:
        cnt = cnt + m.astype(jnp.int32)
    min2 = jnp.where(is_min[0], big, absm[0])
    for a, m in zip(absm[1:], is_min[1:]):
        min2 = jnp.minimum(min2, jnp.where(m, big, a))
    return [jnp.where(m & (cnt == 1), min2, min1) for m in is_min]


def check_node_minsum(v2c_c, synd, c_mask, alpha: float = MINSUM_ALPHA,
                      beta: float = 0.0):
    """Check-major NORMALIZED MIN-SUM update: layout [C, dc_max, B].

    Same contract as :func:`check_node_update` with the min-sum magnitude
    rule (see :func:`check_node_minsum_sm`)."""
    out_dtype = v2c_c.dtype
    if out_dtype == jnp.bfloat16:
        v2c_c = v2c_c.astype(jnp.float32)
        c_mask = c_mask.astype(jnp.float32)
    mask = c_mask[:, :, None]
    big = jnp.asarray(1e30, v2c_c.dtype)
    absm = jnp.where(mask > 0, jnp.abs(v2c_c), big)
    mag = minsum_mag(minsum_extrinsic_mag(absm, axis=1), alpha, beta)

    neg = jnp.logical_and(v2c_c < 0, mask > 0)
    parity = jnp.sum(neg.astype(jnp.int32), axis=1, keepdims=True) & 1
    sign = (1 - 2 * jnp.bitwise_xor(parity, neg.astype(jnp.int32))).astype(
        v2c_c.dtype
    )
    pref = (1 - 2 * synd.astype(jnp.int32)).astype(v2c_c.dtype)[:, None, :]
    return (sign * pref * mag * mask).astype(out_dtype)


def check_node_minsum_sm(v2c_d, synd, c_mask_T,
                         alpha: float = MINSUM_ALPHA, beta: float = 0.0):
    """Slot-major NORMALIZED MIN-SUM check update: layout [dc_max, C, B].

    Extension over the reference (opt-in via ``Decoder(check_rule="minsum")``): the
    reference implements exact sum-product only
    (qamreconciliation/decoder.pyx:322-369); normalized min-sum
    (magnitude = alpha * min over others, identical sign rule) is the
    standard hardware-decoder approximation, trading ~0.1 dB of waterfall
    SNR for a transcendental-free check phase.  Sign semantics and the
    syndrome prefactor match :func:`check_node_update_sm` exactly.
    """
    out_dtype = v2c_d.dtype
    if out_dtype == jnp.bfloat16:
        v2c_d = v2c_d.astype(jnp.float32)
        c_mask_T = c_mask_T.astype(jnp.float32)
    mask = c_mask_T[:, :, None]
    big = jnp.asarray(1e30, v2c_d.dtype)
    absm = jnp.where(mask > 0, jnp.abs(v2c_d), big)
    mag = minsum_mag(minsum_extrinsic_mag(absm, axis=0), alpha, beta)

    neg = jnp.logical_and(v2c_d < 0, mask > 0)
    parity = jnp.sum(neg.astype(jnp.int32), axis=0, keepdims=True) & 1
    sign = (1 - 2 * jnp.bitwise_xor(parity, neg.astype(jnp.int32))).astype(
        v2c_d.dtype
    )
    pref = (1 - 2 * synd.astype(jnp.int32)).astype(v2c_d.dtype)[None, :, :]
    return (sign * pref * mag * mask).astype(out_dtype)


def check_node_tanhfb_sm(v2c_d, synd, c_mask_T):
    """Slot-major sum-product check update via tanh-F/B products.

    Same contract as :func:`check_node_update_sm`; the magnitude comes
    from :func:`tanhfb_extrinsic_mag` (padded slots ride the large
    sentinel so tanh -> 1 is the exact neutral element).  The same exact
    box-plus reduction as the phi form at half the transcendental count;
    f32 rounding differs and magnitudes saturate at ~16.6 (see
    tanhfb_extrinsic_mag).
    """
    out_dtype = v2c_d.dtype
    if out_dtype == jnp.bfloat16:
        v2c_d = v2c_d.astype(jnp.float32)
        c_mask_T = c_mask_T.astype(jnp.float32)
    mask = c_mask_T[:, :, None]
    big = jnp.asarray(1e30, v2c_d.dtype)
    absm = jnp.where(mask > 0, jnp.abs(v2c_d), big)
    mag = tanhfb_extrinsic_mag(absm, 0)

    neg = jnp.logical_and(v2c_d < 0, mask > 0)
    parity = jnp.sum(neg.astype(jnp.int32), axis=0, keepdims=True) & 1
    sign = (1 - 2 * jnp.bitwise_xor(parity, neg.astype(jnp.int32))).astype(
        v2c_d.dtype
    )
    pref = (1 - 2 * synd.astype(jnp.int32)).astype(v2c_d.dtype)[None, :, :]
    return (sign * pref * mag * mask).astype(out_dtype)


def var_node_update(prior, c2v_v, v_mask):
    """Batched variable-node (vertical) update in var-major layout.

    Args:
      prior: [V, B] channel LLRs
      c2v_v: [V, dv_max, B] check->variable messages (padding slots MUST be 0)
      v_mask: [V, dv_max]

    Returns (total [V, B], v2c_v [V, dv_max, B]):
      total = prior + sum of incoming; v2c = total - incoming (extrinsic),
    matching reference: qamreconciliation/decoder.pyx:285-298.
    """
    c2v_v = c2v_v * v_mask[:, :, None]
    total = prior + jnp.sum(c2v_v, axis=1)
    v2c_v = total[:, None, :] - c2v_v
    return total, v2c_v


def tanhfb_extrinsic_mag(absm, axis: int):
    """Exact sum-product all-but-one magnitude via tanh forward/backward
    products: ``mag_i = 2 artanh(prod_{j!=i} tanh(absm_j / 2))``.

    The same box-plus reduction as the phi form (and the formulation the
    reference validates its check update against, reference:
    test/test_decoder.py:189-220) at HALF the transcendental count — one
    ``exp`` plus one ``log`` per edge instead of two full phi
    evaluations.  f32 rounding differs from the phi form and
    the output saturates at ``-log(6e-8) ~= 16.6`` instead of phi(tiny)
    ~= 69 — both far beyond BP decision levels (BER-equivalence tested).

    Padded slots follow the min-sum sentinel convention: set them large
    (e.g. 1e30) so ``tanh(x/2) -> 1`` is the exact neutral element.
    """
    x = jnp.moveaxis(absm, axis, 0)
    mag = tanhfb_extrinsic_list([x[d] for d in range(x.shape[0])])
    return jnp.moveaxis(jnp.stack(mag), 0, axis)


def tanhfb_extrinsic_list(absm):
    """:func:`tanhfb_extrinsic_mag` over a list of same-shape slot tiles
    (the form a kernel holding one tile per slot uses)."""
    if len(absm) == 1:
        # empty all-but-one product: the neutral element u = 1, i.e. the
        # saturated magnitude — matching the phi form's phi(0) clamp
        sat = jnp.log1p(1.0 - 6e-8) - jnp.log1p(-(1.0 - 6e-8))
        return [jnp.full_like(absm[0], sat)]
    # P/Q factorization: with e_j = exp(-x_j), tanh(x_j/2) = (1-e_j)/
    # (1+e_j), so u_i = P_i/Q_i for P_i = prod_{j!=i}(1-e_j), Q_i =
    # prod_{j!=i}(1+e_j), and 2 artanh(u_i) = log((Q_i+P_i)/(Q_i-P_i)).
    # ONE exp and ONE log per edge — no per-edge division or log1p pair
    # (the direct r-product form costs exp + div + 2 log1p).  Q <= 2^dc
    # and P <= 1 keep the ratio in f32 range; the (Q-P) floor clamps the
    # saturation at ~log(2/6e-8) ~= 17.2 like the u-clip it replaces.
    e = [jnp.exp(-x) for x in absm]
    P = fb_allbutone_list([1.0 - ej for ej in e])[0]
    Q = fb_allbutone_list([1.0 + ej for ej in e])[0]
    return [jnp.log((q + p) / jnp.maximum(q - p, 6e-8 * q))
            for p, q in zip(P, Q)]


def fb_allbutone_list(terms):
    """All-but-one products of a list of same-shape arrays via forward/
    backward prefix chains — the single source of truth for the P/Q
    product order, shared by the XLA and kernel check updates so the
    tanh-F/B paths cannot silently diverge.

    Returns ``(allbutone, full)``: ``allbutone[i] = prod_{j != i}
    terms[j]`` (length-1 input gives the neutral ``[ones]``) and
    ``full = prod_j terms[j]``.
    """
    n = len(terms)
    if n == 1:
        return [jnp.ones_like(terms[0])], terms[0]
    F = [terms[0]]
    for d in range(1, n):
        F.append(F[-1] * terms[d])
    Bk = [terms[n - 1]]
    for d in range(n - 2, -1, -1):
        Bk.append(Bk[-1] * terms[d])
    Bk = Bk[::-1]
    out = [Bk[1]] + [F[d - 1] * Bk[d + 1] for d in range(1, n - 1)] \
        + [F[n - 2]]
    return out, F[n - 1]


def stochastic_round_bf16(x_f32, rbits_u32):
    """Stochastically round float32 values to bfloat16.

    bfloat16 is the top 16 bits of the float32 pattern, so adding a
    uniform random 16-bit integer to the pattern and truncating the low
    half rounds x to one of its two bf16 neighbours with probability
    proportional to proximity — unbiased in expectation (within an
    exponent window the float value is affine in the bit pattern; the
    carry across a window boundary lands on the correct neighbour).

    The knee-quality lever: earlier decoding-quality runs attributed the
    bf16 knee-FER cost (0.58 vs f32's 0.42
    at 3.5 dB) to accumulated c2v MESSAGE rounding BIAS — round-to-
    nearest is deterministic per edge, so the same edges round the same
    way every iteration; stochastic rounding decorrelates the per-
    iteration rounding errors (the standard mitigation in reduced-
    precision iterative algorithms).

    Args:
      x_f32: float32 array (finite; callers clamp).
      rbits_u32: uint32 random bits, same shape.

    Returns the stochastically rounded values as bfloat16.
    """
    import jax

    b = jax.lax.bitcast_convert_type(x_f32, jnp.uint32)
    y = (b + (rbits_u32 & jnp.uint32(0xFFFF))) & jnp.uint32(0xFFFF0000)
    return jax.lax.bitcast_convert_type(y, jnp.float32).astype(jnp.bfloat16)
