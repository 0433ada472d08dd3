"""Mutual-information estimators (analytic + Monte-Carlo).

Capability parity with reference: qamreconciliation/mutual_information.pyx.

Design split (SURVEY.md §7.9):

* the analytic estimators (``scipy.integrate.quad`` over scalar integrands)
  stay on the host in float64 — they are tiny M x M computations and exactness
  matters more than throughput;
* ``montecarlo_information`` becomes a fully batched device reduction: the
  per-sample M x M loops (reference: mutual_information.pyx:251-292) are
  tensor dimensions.

Sign conventions are reproduced VERBATIM from the reference (SURVEY.md §2):
the MC accumulators for I(X;Xhat) and I(X;Y) sum ``log2(p_Xhat/p_cond)`` and
``log2(sum p_k LR)`` — the *negatives* of the pointwise information — while
I(X,N;Xhat) accumulates with ``-=`` and comes out positive
(reference: mutual_information.pyx:259, 269, 292).
"""

from __future__ import annotations

import functools

import numpy as np
from scipy.integrate import quad
from scipy.special import logsumexp as np_logsumexp

import jax
import jax.numpy as jnp
from jax.scipy.special import logsumexp

from .alphabet import PAMAlphabet
from .noisemapper import NoiseMapper

__all__ = [
    "P_xhat",
    "mutual_information_base_scheme_arg",
    "mutual_information_base_scheme",
    "mutual_information_X_Xhat",
    "mutual_information_X_Y_int_arg",
    "mutual_information_X_Y",
    "montecarlo_information",
    "montecarlo_information_batched",
]


def P_xhat(nm: NoiseMapper) -> np.ndarray:
    """Marginal of Bob's decisions: P{Xhat=a_i} = sum_j p_j fwd[j, i]
    (reference: mutual_information.pyx:29-39)."""
    t = nm.np_tables
    return t["probabilities"] @ t["fwrd_transition_probability"]


def _host_g_inv(nm: NoiseMapper, n: float, i: int) -> float:
    """Host float64 grid-interpolated inverse softening (base sign_config)."""
    t = nm.np_tables
    F_thr, dF = t["F_Y_thresholds"], t["delta_F_Y"]
    if nm.sign_config[i]:
        target = F_thr[i + 1] - n * dF[i]
    else:
        target = n * dF[i] + F_thr[i]
    return float(np.interp(target, t["F_Y"], t["y_range"]))


def mutual_information_base_scheme_arg(n: float, nm: NoiseMapper, p_Xhat) -> float:
    """Integrand of I(X,N;Xhat) over n in [0,1]
    (reference: mutual_information.pyx:43-119)."""
    t = nm.np_tables
    c, p, dF = t["constellation"], t["probabilities"], t["delta_F_Y"]
    M = nm.order
    two_var = 2.0 * nm.noise_var

    y_hat = np.array([_host_g_inv(nm, n, i) for i in range(M)])    # [M]
    # denom[i, j] = sum_k p_k exp(-(2 y_i - c_j - c_k)(c_j - c_k)/2v),
    # computed in the log domain: the raw exp overflows for far-apart
    # (y_hat, c_j) pairs (the reference's form emits RuntimeWarnings and
    # relies on inf/NaN propagation, reference: mutual_information.pyx:43-119);
    # logsumexp gives the same dF/denom values warning-free (overflowed denom
    # -> f == 0 -> dropped by the q > 0 mask below, exactly as before).
    expo = -(
        (2.0 * y_hat[:, None, None] - c[None, :, None] - c[None, None, :])
        * (c[None, :, None] - c[None, None, :])
    ) / two_var
    with np.errstate(divide="ignore"):                 # log(p_k = 0) -> -inf
        log_denom = np_logsumexp(expo + np.log(p)[None, None, :], axis=2)
        f_N_Xhat_cond_X = np.exp(np.log(dF)[:, None] - log_denom)  # [i, j]
    f_N_cond_X = f_N_Xhat_cond_X.sum(axis=0)                       # [j]

    res = 0.0
    for j in range(M):
        q = f_N_Xhat_cond_X[:, j] * p[j]
        pos = q > 0.0
        res += np.sum(q[pos] * np.log2(q[pos] / np.asarray(p_Xhat)[pos]))
        tj = p[j] * f_N_cond_X[j]
        if tj > 0.0:
            res -= tj * np.log2(tj)
    return float(res)


def mutual_information_base_scheme(nm: NoiseMapper, p_Xhat) -> float:
    """quad of the integrand over [0, 1]
    (reference: mutual_information.pyx:123-148)."""
    I, _ = quad(mutual_information_base_scheme_arg, 0.0, 1.0, args=(nm, p_Xhat))
    return I


def mutual_information_X_Xhat(nm: NoiseMapper, p_Xhat) -> float:
    """Discrete-channel MI (reference: mutual_information.pyx:152-172)."""
    t = nm.np_tables
    fwd, p = t["fwrd_transition_probability"], t["probabilities"]
    p_Xhat = np.asarray(p_Xhat)
    res = 0.0
    for j in range(nm.order):
        tmp = np.zeros(nm.order)
        pos = fwd[j] > 0.0
        tmp[pos] += np.log2(fwd[j][pos])
        posx = p_Xhat > 0.0
        tmp[posx] -= np.log2(p_Xhat[posx])
        res += p[j] * np.sum(tmp * fwd[j])
    return float(res)


def mutual_information_X_Y_int_arg(y: float, nm: NoiseMapper) -> float:
    """Continuous-channel MI integrand
    (reference: mutual_information.pyx:175-199)."""
    t = nm.np_tables
    c, p = t["constellation"], t["probabilities"]
    two_var = 2.0 * nm.noise_var
    res = 0.0
    for j in range(nm.order):
        # log-domain inner sum: the reference's raw exp overflows far from
        # the constellation (log2(inf) * exp(-big) -> NaN, silently dropped
        # at mutual_information.pyx:202-208).  Here log_tmp stays finite and
        # the Gaussian weight underflows to exactly 0, so the term vanishes
        # — the same contribution, warning-free.  The explicit NaN guard is
        # kept to preserve the reference's drop semantics for any residual
        # non-finite term.
        expo = (2.0 * y - c - c[j]) * (c - c[j]) / two_var
        with np.errstate(divide="ignore"):             # log(p_k = 0) -> -inf
            log_tmp = float(np_logsumexp(expo + np.log(p)))
        tmp2 = (
            p[j] * np.exp(-((y - c[j]) ** 2) / two_var)
            * (log_tmp / np.log(2.0))
        )
        if not np.isnan(tmp2):
            res -= tmp2
    return res / (np.sqrt(2.0 * np.pi) * nm.noise_sigma)


def mutual_information_X_Y(nm: NoiseMapper) -> float:
    I, _ = quad(mutual_information_X_Y_int_arg, -np.inf, np.inf, args=(nm,))
    return I


# --------------------------------------------------------------------- #

def _mc_info_impl(key, pa, nm, p_Xhat_dev, N, which, ginv_mode="interp"):
    """MC estimator core (unjitted; see ``_mc_info`` and
    ``montecarlo_information_batched``); nm rides in as a pytree argument, so one compile
    serves every SNR point of a sweep (the alphabet is static via its hash —
    identity-based, alphabets are built once per sweep).

    ginv_mode selects how the I(X,N;Xhat) estimator reconstructs the
    candidate inverses y_hat[s, k != xhat]: "interp" (the reference's
    g_inv grid interpolation, mirrored exactly) or "poly" (gather-free
    probit-warped Chebyshev fit of the SAME inverse table, which replaces
    the per-(sample, candidate) gathers with elementwise math; fit
    residual ~1e-5 of the constellation scale, far below MC noise).  The k == xhat slot always
    uses the exact Newton ``g_inv_search`` (the reference's contract).
    """
    dtype = nm.dtype
    kx, kn = jax.random.split(jnp.asarray(key))
    x_ind = pa.random_symbols(kx, N)
    y = pa.index_to_value(x_ind, dtype) + nm._sigma_dev * jax.random.normal(
        kn, (N,), dtype
    )
    xhat_ind = nm.hard_decide_index(y)
    n = nm.map_noise(y, xhat_ind)

    c = nm._c
    p = nm._p
    x_val = c[x_ind]
    two_var = 2.0 * nm._noise_var_dev
    fwd = nm._fwd
    dF = nm._delta_F_Y
    log2e = 1.0 / np.log(2.0)

    zero = jnp.asarray(0.0, dtype)
    I_X_Xhat = I_X_Y = I_XN_Xhat = zero

    if which[0]:
        I_X_Xhat = jnp.mean(
            jnp.log2(p_Xhat_dev[xhat_ind] / fwd[x_ind, xhat_ind])
        )

    if which[1]:
        expo = (2.0 * y[:, None] - c - x_val[:, None]) * (c - x_val[:, None]) / two_var
        I_X_Y = jnp.mean(logsumexp(expo + nm._log_p, axis=1)) * log2e

    if which[2]:
        # y_hat for every candidate decision k: grid interp for k != xhat
        # (reference uses g_inv there) and exact bisection at k == xhat
        # (reference uses g_inv_search), mirrored exactly.
        y_hat_all = nm._y_hat_all_candidates(n, ginv_mode)         # [N, M]
        y_hat_hat = nm.g_inv_search(n, xhat_ind)                   # [N]
        karange = jnp.arange(nm.order)
        is_hat = karange[None, :] == xhat_ind[:, None]
        y_hat_all = jnp.where(is_hat, y_hat_hat[:, None], y_hat_all)

        expo = (
            (2.0 * y_hat_all[:, :, None] - x_val[:, None, None] - c[None, None, :])
            * (c[None, None, :] - x_val[:, None, None])
            / two_var
        )
        denom = jnp.sum(p * jnp.exp(expo), axis=2)                 # [N, M]
        terms = jnp.where(is_hat, 0.0, dF / denom)
        tmp_sum = jnp.sum(terms, axis=1)                           # [N]
        denom_hat = jnp.take_along_axis(denom, xhat_ind[:, None], 1)[:, 0]
        dF_hat = dF[xhat_ind]
        val = (tmp_sum * denom_hat / dF_hat + 1.0) * p_Xhat_dev[xhat_ind]
        I_XN_Xhat = -jnp.mean(jnp.log2(val))

    return I_X_Xhat, I_X_Y, I_XN_Xhat


_mc_info = functools.partial(
    jax.jit, static_argnames=("pa", "N", "which", "ginv_mode")
)(_mc_info_impl)

_MC_BATCH_CACHE: dict = {}


def montecarlo_information_batched(keys, pa, nms, p_Xhats, N, which,
                                   ginv_mode="interp"):
    """Batched MC estimators over a list of NoiseMappers (e.g. one per sign
    configuration) sharing one alphabet and one noise variance.

    Args:
      keys: [P] PRNG keys (one stream per mapper).
      nms: list of P NoiseMappers with identical table shapes.
      p_Xhats: [P, M] decision marginals (one per mapper).
      N: samples per mapper per call.  which: static 3-bool mask.

    Returns a [P, 3] numpy array of (I_X_Xhat, I_X_Y, I_XN_Xhat) rows.

    Leaves that are identical BY REFERENCE across all P mappers — every
    sign-independent table of a ``NoiseMapper.with_sign_config`` clone —
    ride once with ``vmap in_axes=None`` instead of being stacked P-fold.
    At bps=4 with 4096-config chunks that turns a ~570 MB stacked pytree
    (dominated by the [K*2] inverse-CDF table, re-uploaded per dispatch
    for host-leaf mappers) into ~200 KB: one [P, M] sign-config stack plus
    one shared copy of the tables.  Mappers built by separate constructor
    calls share nothing by reference and keep the fully-stacked behavior.
    """
    flats = [jax.tree_util.tree_flatten(nm) for nm in nms]
    leaves0, treedef = flats[0]
    # every mapper is rebuilt with flats[0]'s treedef (static config rides
    # in the aux data), so a structure mismatch must fail LOUDLY here —
    # positional leaf alignment would otherwise silently decode mapper
    # k>0 with mapper 0's thresholds/static tables
    for k, (_, td) in enumerate(flats[1:], 1):
        if td != treedef:
            raise ValueError(
                f"montecarlo_information_batched: NoiseMapper {k}'s pytree "
                f"structure differs from mapper 0's (different alphabet / "
                f"dtype / static config?); batch only same-config mappers"
            )
    nleaf = len(leaves0)
    shared_mask = tuple(
        len(nms) > 1 and all(f[0][i] is leaves0[i] for f in flats)
        for i in range(nleaf)
    )
    stacked = tuple(
        jnp.stack([jnp.asarray(f[0][i]) for f in flats])
        for i in range(nleaf) if not shared_mask[i]
    )
    shared_vals = tuple(
        jnp.asarray(leaves0[i]) for i in range(nleaf) if shared_mask[i]
    )
    p_stack = jnp.asarray(np.asarray(p_Xhats), nms[0].dtype)
    cache_key = (treedef, shared_mask, pa, int(N), tuple(which), ginv_mode)
    fn = _MC_BATCH_CACHE.get(cache_key)
    if fn is None:
        def one(k, st, sh, p):
            it_s, it_h = iter(st), iter(sh)
            leaves = [
                next(it_h) if m else next(it_s) for m in shared_mask
            ]
            nm = jax.tree_util.tree_unflatten(treedef, leaves)
            return _mc_info_impl(k, pa, nm, p, N, tuple(which), ginv_mode)
        fn = jax.jit(jax.vmap(one, in_axes=(0, 0, None, 0)))
        _MC_BATCH_CACHE[cache_key] = fn
    out = fn(keys, stacked, shared_vals, p_stack)
    return np.stack([np.asarray(o) for o in out], axis=1)


def montecarlo_information(
    key,
    pa: PAMAlphabet,
    nm: NoiseMapper,
    p_Xhat,
    N: int,
    which=(True, True, True),
    ginv_mode: str = "interp",
):
    """Monte-Carlo estimators of (I_X_Xhat, I_X_Y, I_XN_Xhat), batched.

    Batched re-design of reference: mutual_information.pyx:212-300 — the
    O(N*M^2) per-sample loops become one ``[N, M, M]`` tensor contraction —
    with the reference's sign conventions (see module docstring).  ``which``
    is a static 3-tuple of bools selecting the estimators (reference's uint8
    mask argument); unselected entries return 0.0.

    Takes an explicit PRNG ``key`` (the reference uses global np.random).
    The whole estimator is ONE jitted program; the NoiseMapper is a pytree
    argument, so repeated calls across iterations and SNR points reuse a
    single compilation.
    """
    p_Xhat_dev = jnp.asarray(np.asarray(p_Xhat), nm.dtype)
    a, b, c = _mc_info(key, pa, nm, p_Xhat_dev, int(N), tuple(which),
                       ginv_mode)
    return float(a), float(b), float(c)
