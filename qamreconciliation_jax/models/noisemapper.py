"""Softening / noise-mapping layer (the paper's central object), batched in JAX.

Capability parity with reference: qamreconciliation/noisemapper.pyx:102-816,
re-designed batched-first:

* Table construction (§3.3 of SURVEY.md) runs once per (alphabet, noise_var)
  on the host in float64 — exact — and ships a pytree of device arrays.
* Every per-sample scalar method of the reference (``g``, ``g_inv``,
  ``g_inv_search``, ``hard_decide_index``, ``map_noise``, ``demap_lappr*``)
  becomes a batched op over arbitrary sample shapes; the M-candidate /
  M-symbol loops of the LLR builders become tensor dimensions ``[S, M, M]``.
* ``g_inv_search``'s bracket-doubling + bisection
  (reference: noisemapper.pyx:310-345) becomes a fixed-trip-count vectorised
  bisection (80 steps over a fixed bracket — tighter than the reference's
  1e-9 exit criterion).
* LLR builders are computed in the log domain (logsumexp) so they are stable
  in float32 where the reference relies on float64 headroom.

Deliberate deviations from reference quirks (SURVEY.md §2 "quirks"):

(a) The inverse-CDF interpolation grid ``_F_Y`` is probability-weighted
    (correct for shaped alphabets); the reference weights it uniformly
    (reference: noisemapper.pyx:274) while using probability weights
    elsewhere.  For the default uniform alphabet the two coincide.
    ``ref_compat_fy_grid=True`` restores the reference grid.
(b) ``demap_lappr`` in the reference omits the ``/2sigma^2`` in the k<j
    exponent (reference: noisemapper.pyx:503-507).  We default to the correct
    math; ``ref_compat=True`` reproduces the reference formula.
(c) ``demap_lappr_sofisticated`` in the reference evaluates
    ``y_hat[i] = g_inv(n, j)`` (index j for all i, reference:
    noisemapper.pyx:655).  We default to ``g_inv(n, i)``; ``ref_compat=True``
    reproduces the reference.
(d) The MC mutual-information CLIs default their candidate-inverse
    reconstruction to ``g_inv_poly`` (the gather-free global-Chebyshev
    inverse CDF, gather-free) instead of the reference's grid
    interpolation (reference: noisemapper.pyx:295-307): the fit residual
    shifts I(X,N;Xhat) by ~3e-4 relative — an order below the estimators'
    own MC standard error at the default sample budgets.  ``--mc-ginv
    interp`` restores the reference-mirroring path exactly.
"""

from __future__ import annotations

import copy
import functools

import numpy as np
from scipy.special import erf as np_erf

import jax
import jax.numpy as jnp
from jax.scipy.special import erf as jerf, logsumexp

from .alphabet import PAMAlphabet
from .bicm import generate_table_s_to_b
from ..config import DEFAULT_DTYPE, INDEX_DTYPE, finite_llr_max

__all__ = [
    "NoiseMapper",
    "NoiseDemapper",
    "NoiseMapperFlipSign",
    "NoiseMapperAntiFlipSign",
]


def _np_F_Z(z, mu, sigma):
    """Gaussian CDF (host float64), reference: noisemapper.pyx:66-67."""
    return 0.5 * (1.0 + np_erf((z - mu) / (np.sqrt(2.0) * sigma)))


# Piecewise-Chebyshev softening-LLR evaluation ("poly" llr_mode): segment
# count / degree / boundary-layer warp width.  The LLR curves have log-type
# boundary layers at n -> 0/1 (validated numerically across sign configs);
# fitting in the warped coordinate w = log(n+d) - log(1-n+d) resolves them
# (base sign configuration, bps=2 at 3-3.5 dB: error <= 2e-3 absolute on
# 99.99% of samples, ~6e-3 at worst in the boundary-layer tail; flipped
# configurations see larger tail errors, see _ensure_llr_poly).
_POLY_NSEG = 8
_POLY_DEG = 10
_POLY_D = 1e-4
# gather-free g^-1: ONE global Chebyshev fit of the inverse marginal CDF
# y(u) in the probit coordinate t = ndtri(u) (exactly linear for a single
# Gaussian; smooth for realistic mixture overlap).  Global (segment-free)
# on purpose: a per-element segment one-hot materializes a [.., nseg]
# tensor that explodes under config-vmapped estimators (a 17 GB
# intermediate), while Clenshaw over a [deg+1]
# coefficient leaf via lax.scan is pure elementwise FMA flow.
_GINV_DEG = 96
# gather-free F_Y ("poly" fy_mode): ONE global Chebyshev fit of the probit-
# warped marginal CDF h(y) = ndtri(F_Y(y)) — exactly linear for a single
# Gaussian, smooth for the heavily-overlapped mixtures of real operating
# SNRs (bps=4 waterfall: sigma > step).  Replaces the M-component erf
# mixture of the softening preamble with one Clenshaw chain + one erf per
# sample.
_FY_DEG = 64


class NoiseMapper:
    """Precomputed softening tables + batched mapping/demapping ops.

    Constructor signature mirrors the reference
    (reference: qamreconciliation/noisemapper.pyx:103-107).
    """

    def __init__(
        self,
        pa: PAMAlphabet,
        noise_var: float,
        sign_config=None,
        trunkation_threshold: float = 1e-21,
        n_intervals_per_step: int = 1000,
        dtype=DEFAULT_DTYPE,
        ref_compat_fy_grid: bool = False,
        device: bool = True,
        fy_mode: str = "erf",
    ):
        if noise_var <= 0:
            raise ValueError(
                f"noise variance must be strictly positive, got {noise_var}"
            )
        if fy_mode not in ("erf", "erf_flat", "poly"):
            raise ValueError(f"unknown fy_mode {fy_mode!r}")
        # marginal-CDF implementation used by g/map_noise (the softening
        # preamble's hot op): "erf" = the exact [.., M] mixture broadcast,
        # "erf_flat" = the same M erfs unrolled over STATIC host floats
        # (lane-flat [S, B] slabs, no trailing M axis), "poly" = the
        # probit-warped global Chebyshev fit (_ensure_fy_poly; ~1 erf +
        # one Clenshaw chain per sample)
        self.fy_mode = fy_mode
        M = pa.order
        if sign_config is None:
            self.sign_config = np.zeros(M, dtype=np.uint8)
        else:
            self.sign_config = np.asarray(sign_config, dtype=np.uint8).reshape(-1)
            if self.sign_config.size < M:
                raise ValueError(
                    "Not enough data for a monotonicity sign configuration"
                )
            # Own the array: np.asarray may return a view into caller memory
            # (e.g. a row of a config enumeration), and the host analytic
            # paths read self.sign_config lazily — a later caller-side
            # mutation must not desync them from the device _sign_cfg copy.
            self.sign_config = self.sign_config[:M].copy()

        self.dtype = jnp.dtype(dtype)
        self.alphabet = pa
        self.order = M
        self.half_order = M >> 1
        self.bit_per_symbol = pa.bit_per_symbol
        self.variance = pa.variance
        self.noise_var = float(noise_var)
        self._sigma = float(np.sqrt(noise_var))
        self.noise_sigma = self._sigma

        c = pa.constellation          # [M] float64
        thr = pa.thresholds           # [M+1] float64
        p = pa.probabilities          # [M] float64
        sq2s = np.sqrt(2.0) * self._sigma

        # --- y grid + marginal CDF for inverse interpolation -------------- #
        # (reference: noisemapper.pyx:135-144)
        if trunkation_threshold > 1.0:
            y_low, y_high = c[0] * 10.0, c[-1] * 10.0
        else:
            tmp = np.sqrt(-2.0 * np.log(trunkation_threshold)) * self._sigma
            y_low, y_high = c[0] - tmp, c[-1] + tmp
        n_points = int(np.ceil((y_high - y_low) * n_intervals_per_step / pa.step)) + 1
        y_range = np.linspace(y_low, y_high, n_points)
        grid_w = (np.full(M, 1.0 / M) if ref_compat_fy_grid else p)
        F_Y_grid = np.zeros(n_points)
        for i in range(M):
            F_Y_grid += grid_w[i] * _np_F_Z(y_range, c[i], self._sigma)

        # --- threshold CDF values + interval masses ----------------------- #
        # (reference: noisemapper.pyx:149-162; always probability-weighted)
        F_thr = np.empty(M + 1)
        F_thr[0], F_thr[M] = 0.0, 1.0
        for i in range(1, M):
            F_thr[i] = np.sum(p * _np_F_Z(thr[i], c, self._sigma))
        delta_F_Y = np.diff(F_thr)

        # --- symbol transition matrices ----------------------------------- #
        # fwd[j, i] = P{Xhat = a_i | X = a_j} via erf differences with exact
        # +-1 at the outer decision intervals (reference: noisemapper.pyx:167-182)
        erf_grid = np.empty((M + 1, M))          # erf((thr_i - c_j)/(sqrt2 s))
        erf_grid[0, :] = -1.0
        erf_grid[M, :] = 1.0
        for i in range(1, M):
            erf_grid[i, :] = np_erf((thr[i] - c) / sq2s)
        fwd = 0.5 * (erf_grid[1:, :] - erf_grid[:-1, :]).T   # [j, i]

        marg = p @ fwd                                        # P{Xhat = a_i}
        back = (p[:, None] * fwd) / marg[None, :]             # [j, i] -> transpose
        back = back.T                                         # back[i, j]

        # --- hard-decision bare-LLR table --------------------------------- #
        # (reference: noisemapper.pyx:198-220); Gray bit of received symbol i
        bits = generate_table_s_to_b(pa.bit_per_symbol).astype(np.float64)  # [M, bps]
        Nsum = fwd @ (1.0 - bits)      # [j, k]
        Dsum = fwd @ bits
        with np.errstate(divide="ignore"):
            bare = np.where(Dsum == 0.0, 1e300, np.log(np.maximum(Nsum, 0.0)) - np.log(Dsum))
        llr_cap = finite_llr_max(self.dtype)
        bare = np.clip(bare, -llr_cap, llr_cap)

        # inf_erf_table[i, j] = erf((inf(D_i) - a_j)/(sqrt2 sigma)), row 0 = -1
        # (reference: noisemapper.pyx:223-236)
        inf_erf = erf_grid[:M, :].copy()

        # --- host float64 copies (analytic MI + oracles) ------------------ #
        self.np_tables = dict(
            y_range=y_range,
            F_Y=F_Y_grid,
            F_Y_thresholds=F_thr,
            delta_F_Y=delta_F_Y,
            fwrd_transition_probability=fwd,
            back_transition_probability=back,
            bare_llr_table=bare,
            inf_erf_table=inf_erf,
            constellation=c,
            thresholds=thr,
            probabilities=p,
        )

        # --- device copies ------------------------------------------------ #
        # Every device table below has an SNR-independent shape (fixed by the
        # alphabet / the fixed-size inverse grid), so a NoiseMapper can be
        # passed as a jitted-function ARGUMENT (see pytree registration at the
        # bottom of this file) and one compiled round function serves a whole
        # SNR sweep without retracing.
        dt = self.dtype
        # ``device=False`` keeps the leaves as HOST numpy arrays: every
        # eager jnp.asarray is a host->device transfer, so
        # mass enumeration (the 32,896-config sign study) constructs mappers
        # host-only and pays ONE transfer when the stacked chunk pytree
        # enters the jitted estimator.  Numpy leaves are valid jit arguments;
        # keep the default True for sweep engines, where resident device
        # leaves avoid a re-upload per dispatch.
        A = jnp.asarray if device else np.asarray
        self._F_thr = A(F_thr, dt)
        self._delta_F_Y = A(delta_F_Y, dt)
        self._fwd = A(fwd, dt)
        self._back = A(back, dt)
        self._bare_llr = A(bare, dt)
        self._inf_erf = A(inf_erf, dt)
        self._c = A(c, dt)
        self._thr_interior = A(thr[1:M], dt)
        self._p = A(p, dt)
        self._log_p = A(np.log(p), dt)
        self._sign_cfg = A(self.sign_config.astype(np.bool_))
        # Uniform-in-CDF inverse of the marginal CDF grid, for O(1) g_inv.
        self._inv_K = 1 << 14
        y_of_u = np.interp(
            np.linspace(0.0, 1.0, self._inv_K), F_Y_grid, y_range
        )
        self._y_of_u = A(y_of_u, dt)
        self._bits_mask = A(bits, dt)               # [M, bps]
        # SNR-dependent scalars as device leaves (not trace-time constants).
        self._sigma_dev = A(self._sigma, dt)
        self._noise_var_dev = A(self.noise_var, dt)
        # Alphabet decision thresholds as a hashable host tuple
        # (SNR-independent -> safe as jit static data).
        self._thr_tuple = tuple(float(t) for t in thr[1:-1])
        # Constellation/priors as static host tuples for the lane-flat F_Y
        # unroll: per-component DEVICE-leaf reads in an unrolled loop are a
        # measured compile pathology on this backend, but static Python
        # floats bake as constants (the hard_decide_index _thr_tuple trick).
        self._c_tuple = tuple(float(v) for v in c)
        self._p_tuple = tuple(float(v) for v in p)

        # --- tabulated softening LLRs (lazy) ------------------------------- #
        # For fixed tables the Formulation-2 LLR is a smooth function of ONLY
        # (n, j): tabulate it once on the host in float64 over a uniform
        # n-grid and batched demapping collapses to two gathers + a lerp per
        # bit — no per-sample exp/log and no xM candidate expansion.  This is
        # the batched counterpart of the reference's per-sample scalar
        # loops (reference: noisemapper.pyx:450-559); the residual
        # interpolation error (~(1/K)^2 x curvature) sits far below
        # Monte-Carlo noise and the "interp"/"search" per-sample modes remain
        # available as exactness references.  Built on first use (pytree
        # flatten or table-mode demap): many mappers (analytic MI, bare-LLR
        # paths) never demap.
        self._llr_K = 1 << 13
        self._llr_tab = None
        self._llr_tab_inputs = (F_thr, delta_F_Y, y_of_u, c, p, bits, llr_cap)
        # gather-free piecewise-Chebyshev LLR coefficients (lazy, see
        # _ensure_llr_poly)
        self._llr_poly = None
        # gather-free inverse-CDF coefficients (lazy, sign-INDEPENDENT —
        # with_sign_config clones share them; see _ensure_ginv_poly)
        self._ginv_poly = None
        # gather-free marginal-CDF fit (lazy, sign-independent, see
        # _ensure_fy_poly; _fy_dom = [y_lo, y_hi] device scalars — the fit
        # domain is SNR-dependent, so it must ride as a LEAF, never aux)
        self._fy_poly = None
        self._fy_dom = None

    def with_sign_config(self, sign_config) -> "NoiseMapper":
        """Cheap variant of this mapper with a different sign configuration.

        ``sign_config`` only parameterizes the monotonicity *direction* of
        g/g_inv at read time (reference: noisemapper.pyx:289-307); none of
        the constructor tables (CDF grids, transition matrices, bare-LLR /
        inverse-CDF tables) depend on it.  Mass enumerations — the sign
        study's 32,896 configurations at bps=4 (reference:
        sims/sim_mutual_information_compare_signs.py:67-95) — therefore
        build ONE mapper per SNR point and clone per configuration: every
        table leaf is shared by reference, only ``sign_config``/``_sign_cfg``
        is replaced.  The lazy LLR caches (``_llr_tab``/``_llr_poly``) DO
        bake in the sign directions, so they reset to unbuilt in the clone;
        the gather-free inverse-CDF coefficients (``_ginv_poly``) do NOT
        (signs transform the CDF target, not the inverse curve) and stay
        shared by reference.

        Host-leaf mappers (``device=False``) produce host-leaf clones.
        """
        M = self.order
        cfg = np.asarray(sign_config, dtype=np.uint8).reshape(-1)
        if cfg.size < M:
            raise ValueError(
                "Not enough data for a monotonicity sign configuration"
            )
        # Own the array (see __init__): host paths read clone.sign_config
        # lazily, so it must not alias caller memory.
        cfg = cfg[:M].copy()
        clone = copy.copy(self)
        clone.sign_config = cfg
        A = np.asarray if isinstance(self._sign_cfg, np.ndarray) else jnp.asarray
        clone._sign_cfg = A(cfg.astype(np.bool_))
        clone._llr_tab = None
        clone._llr_poly = None
        return clone

    def _llr_eval_f64(self, n_full):
        """Exact float64 softening LLRs on an arbitrary n-grid.

        Host-only: the Formulation-2 per-(n, j) LLR in the log domain,
        clipped to the dtype's finite LLR cap.  Shared by the tabulated
        (uniform n-grid + lerp) and polynomial (Chebyshev nodes) device
        formulations.  Semantics per the reference's per-sample demapper
        (reference: qamreconciliation/noisemapper.pyx:450-559).

        Returns [len(n_full), M, bps] float64.
        """
        F_thr, delta_F_Y, y_of_u, c, p, bits, llr_cap = self._llr_tab_inputs
        n_full = np.asarray(n_full, np.float64)
        # effective monotonicity directions: subclasses (FlipSign/...)
        # override _g_signs(), and the table must match the g_inv the
        # "interp" formulation uses
        signs_b = np.asarray(self._g_signs()).astype(bool)
        b1 = bits.astype(bool)                                 # [M_i, bps]

        def lse(x, axis):
            mm = x.max(axis=axis, keepdims=True)
            return np.squeeze(mm, axis) + np.log(
                np.sum(np.exp(x - mm), axis=axis)
            )

        # chunk the n-grid so the [chunk, M, M, M] temporaries stay small
        # (a monolithic K x M^3 float64 build costs minutes + hundreds of MB
        # at M >= 16)
        chunk = max(1, (1 << 22) // max(1, self.order ** 3))
        out = np.empty((n_full.size, self.order, bits.shape[1]))
        for lo in range(0, n_full.size, chunk):
            n_grid = n_full[lo:lo + chunk]
            tgt = np.where(
                signs_b[None, :],
                F_thr[1:][None, :] - n_grid[:, None] * delta_F_Y[None, :],
                n_grid[:, None] * delta_F_Y[None, :] + F_thr[:-1][None, :],
            )                                                  # [k, M_i]
            y_hat_g = np.interp(np.clip(tgt, 0.0, 1.0),
                                np.linspace(0.0, 1.0, self._inv_K), y_of_u)
            # expo[k, M_i, M_j, M_k]
            expo = (
                (2.0 * y_hat_g[:, :, None, None] - c[None, None, None, :]
                 - c[None, None, :, None])
                * (c[None, None, None, :] - c[None, None, :, None])
            ) / (2.0 * self.noise_var)
            m = expo.max(axis=-1, keepdims=True)
            denom = np.squeeze(m, -1) + np.log(
                np.sum(np.exp(expo - m) * p[None, None, None, :], axis=-1)
            )                                                  # [k, M_i, M_j]
            log_w = np.log(delta_F_Y)[None, :, None] - denom
            num = lse(np.where(b1[None, :, None, :], -np.inf,
                               log_w[..., None]), axis=1)      # [k, M_j, bps]
            den = lse(np.where(b1[None, :, None, :], log_w[..., None],
                               -np.inf), axis=1)
            out[lo:lo + chunk] = num - den
        return np.clip(out, -llr_cap, llr_cap)

    def _ensure_llr_tab(self):
        if self._llr_tab is not None and self._llr_tab.size:
            return
        self._llr_tab = jnp.asarray(
            self._llr_eval_f64(np.linspace(0.0, 1.0, self._llr_K)),
            self.dtype,
        )

    def _table_llr_bits(self, n, j):
        """Per-bit tabulated LLRs: list of ``bps`` arrays shaped like ``n``.

        The single source of the table indexing math (clip/floor/lerp over
        the flattened [K*M, bps] table) — used by both demap_lappr_array's
        "table" branch and the engines' layout-native rounds.
        """
        if self._llr_tab is None or not self._llr_tab.size:
            if not hasattr(self, "_llr_tab_inputs"):
                raise RuntimeError(
                    "tabulated LLR path reached a traced NoiseMapper whose "
                    "table was never built — call nm._ensure_llr_tab() on "
                    "the original object before passing it through jit"
                )
            self._ensure_llr_tab()
        K, M = self._llr_K, self.order
        t = jnp.clip(jnp.asarray(n, self.dtype), 0.0, 1.0) * (K - 1)
        i0 = jnp.clip(jnp.floor(t).astype(INDEX_DTYPE), 0, K - 2)
        frac = t - i0.astype(self.dtype)
        tab = self._llr_tab.reshape(-1, self.bit_per_symbol)
        base = i0 * M + j
        out = []
        for b in range(self.bit_per_symbol):
            lo = tab[:, b][base]
            hi = tab[:, b][base + M]
            out.append(lo + (hi - lo) * frac)
        return out

    def _ensure_llr_poly(self):
        """Host build of the piecewise-Chebyshev LLR coefficients.

        Fits degree-``_POLY_DEG`` Chebyshev series per (segment, symbol j,
        bit) to the exact float64 LLR (``_llr_eval_f64``) sampled at
        oversampled Chebyshev nodes in the warped coordinate.  Stores a
        device array ``[nseg * M, (deg + 1) * bps]`` (float32, or float64
        for float64 mappers) — shape SNR-independent, so it rides the
        pytree like every other table.  The max fit residual is kept in
        ``_llr_poly_fit_err`` and a warning is emitted if it exceeds 1.0.
        Typical residuals are <= 1e-2; flipped sign configurations reach
        ~0.3 concentrated on the ~1e-4 tail fraction of samples whose
        softening metric n falls inside the warp's boundary layer — there
        the "exact" reference is itself the kinked y_of_u inverse-CDF lerp
        (the tabulated path shares the artifact) and |LLR| ~ the cap, so
        the sign and scale BP consumes are unaffected (BER equivalence is
        tested in tests/test_poly_llr.py).
        """
        if self._llr_poly is not None and self._llr_poly.size:
            return
        nseg, deg, d = _POLY_NSEG, _POLY_DEG, _POLY_D
        M, bps = self.order, self.bit_per_symbol
        wlo = np.log(d) - np.log1p(d)
        whi = -wlo
        nn = 4 * (deg + 1)  # 4x oversampled least-squares fit
        xs = np.cos(np.pi * np.arange(nn) / (nn - 1))[::-1]    # [-1, 1]
        C = np.empty((nseg * M, (deg + 1) * bps))
        fit_err = 0.0
        for s in range(nseg):
            wn = (s + (xs + 1.0) / 2.0) / nseg
            ew = np.exp(wlo + wn * (whi - wlo))
            n_nodes = np.clip((ew * (1.0 + d) - d) / (1.0 + ew), 0.0, 1.0)
            vals = self._llr_eval_f64(n_nodes)                 # [nn, M, bps]
            for j in range(M):
                for b in range(bps):
                    c = np.polynomial.chebyshev.chebfit(xs, vals[:, j, b], deg)
                    fit = np.polynomial.chebyshev.chebval(xs, c)
                    fit_err = max(fit_err, np.abs(fit - vals[:, j, b]).max())
                    C[s * M + j, np.arange(deg + 1) * bps + b] = c
        self._llr_poly_fit_err = fit_err
        if fit_err > 1.0:
            import warnings

            warnings.warn(
                f"piecewise-Chebyshev LLR fit residual {fit_err:.3g} is "
                "unusually large for this (alphabet, SNR, sign-config); "
                "prefer llr_mode='table'",
                stacklevel=2,
            )
        pdt = jnp.float64 if self.dtype == jnp.float64 else jnp.float32
        self._llr_poly = jnp.asarray(C, pdt)

    def _poly_llr_bits(self, n, j):
        """Gather-free per-bit softening LLRs: list of ``bps`` arrays.

        Same contract as :func:`_table_llr_bits` but with ZERO random
        gathers (the table path pays 2 per bit): the (segment, j)
        coefficient select is a one-hot [.., nseg*M] contraction and the
        series is summed by Clenshaw recurrence.  Deviation from the exact
        f64 LLR <= 2e-3 on all but the boundary-layer tail of n (see
        _ensure_llr_poly), below bf16 LLR quantisation at typical scales.
        """
        if self._llr_poly is None or not self._llr_poly.size:
            if not hasattr(self, "_llr_tab_inputs"):
                raise RuntimeError(
                    "poly LLR path reached a traced NoiseMapper whose "
                    "coefficients were never built — call "
                    "nm._ensure_llr_poly() on the original object before "
                    "passing it through jit"
                )
            self._ensure_llr_poly()
        nseg, deg, d = _POLY_NSEG, _POLY_DEG, _POLY_D
        M, bps = self.order, self.bit_per_symbol
        compute = jnp.float64 if self.dtype == jnp.float64 else jnp.float32
        wlo = float(np.log(d) - np.log1p(d))
        inv_range = float(1.0 / (-2.0 * wlo))

        nf = jnp.clip(jnp.asarray(n).astype(compute), 0.0, 1.0)
        w = jnp.log(nf + d) - jnp.log((1.0 + d) - nf)
        t = jnp.clip((w - wlo) * (inv_range * nseg), 0.0,
                     nseg * (1.0 - 1e-7))
        sidx = jnp.floor(t)
        x = 2.0 * (t - sidx) - 1.0
        combo = sidx.astype(INDEX_DTYPE) * M + jnp.asarray(j, INDEX_DTYPE)
        oh = (combo[..., None]
              == jnp.arange(nseg * M, dtype=INDEX_DTYPE)).astype(compute)
        Cd = self._llr_poly.astype(compute)        # [nseg*M, (deg+1)*bps]
        # HIGHEST: a GPU may otherwise run a float32 contraction in TF32,
        # whose 10-bit mantissa breaks both the exact one-hot select and
        # the fit's 2e-3 accuracy
        cf = jnp.einsum("...q,qd->...d", oh, Cd,
                        preferred_element_type=compute,
                        precision=jax.lax.Precision.HIGHEST)
        cf = cf.reshape(*combo.shape, deg + 1, bps)
        xx = x[..., None]
        b1 = jnp.zeros_like(cf[..., 0, :])
        b2 = b1
        for k in range(deg, 0, -1):
            b1, b2 = 2.0 * xx * b1 - b2 + cf[..., k, :], b1
        vals = (xx * b1 - b2 + cf[..., 0, :]).astype(self.dtype)
        return [vals[..., b] for b in range(bps)]

    # ------------------------------------------------------------------ #
    # Properties (API parity, reference: noisemapper.pyx:254-261 + .pxd)

    @property
    def y_range(self):
        return np.asarray(self.np_tables["y_range"])

    @property
    def F_Y_values(self):
        return np.asarray(self.np_tables["F_Y"])

    @property
    def F_Y_thresholds(self):
        return np.asarray(self.np_tables["F_Y_thresholds"])

    @property
    def delta_F_Y(self):
        return np.asarray(self.np_tables["delta_F_Y"])

    @property
    def fwrd_transition_probability(self):
        return np.asarray(self.np_tables["fwrd_transition_probability"])

    @property
    def back_transition_probability(self):
        return np.asarray(self.np_tables["back_transition_probability"])

    @property
    def bare_llr_table(self):
        return np.asarray(self.np_tables["bare_llr_table"])

    @property
    def inf_erf_table(self):
        return np.asarray(self.np_tables["inf_erf_table"])

    @property
    def constellation(self):
        return np.asarray(self.np_tables["constellation"])

    @property
    def thresholds(self):
        return np.asarray(self.np_tables["thresholds"])

    @property
    def probabilities(self):
        return np.asarray(self.np_tables["probabilities"])

    # ------------------------------------------------------------------ #
    # Effective monotonicity direction used by g / g_inv.  The base class
    # reads sign_config; subclasses hardcode their pattern
    # (reference: noisemapper.pyx:289-307, 775-816).  NOTE: g_inv_search
    # always reads sign_config, even in subclasses — mirrored quirk.

    def _g_signs(self):
        return self._sign_cfg

    # ------------------------------------------------------------------ #
    # CDF evaluations (batched)

    def F_Y(self, y):
        """Marginal CDF of Y, probability-weighted (batched, any shape).

        Deviation (a): the reference's public ``F_Y`` weighs components
        uniformly (reference: noisemapper.pyx:264-275); for shaped alphabets
        that is inconsistent with ``_single_F_Y``.  Here both agree.

        Dispatches on the constructor's ``fy_mode``: "erf" (exact
        trailing-axis mixture broadcast, default), "erf_flat" (the same M
        erfs unrolled over static host floats — no trailing M axis; an
        earlier unroll that read per-component values from DEVICE leaves
        was a measured compile pathology, 66-122s), "poly" (probit-warped
        global Chebyshev fit, see :meth:`F_Y_poly`).
        """
        if self.fy_mode == "poly":
            return self.F_Y_poly(y)
        if self.fy_mode == "erf_flat":
            return self.F_Y_flat(y)
        y = jnp.asarray(y, self.dtype)
        z = (y[..., None] - self._c) / (np.sqrt(2.0) * self._sigma_dev)
        return jnp.sum(self._p * 0.5 * (1.0 + jerf(z)), axis=-1)

    single_F_Y = F_Y  # probability-weighted scalar CDF, same math

    def F_Y_flat(self, y):
        """Exact marginal CDF, lane-flat: the M-component mixture unrolled
        over STATIC host floats (``_c_tuple``/``_p_tuple`` aux) so every
        live array keeps the sample shape — no trailing M axis (which pads
        M up to the 128-lane tile: 8x waste at M=16), no device-leaf
        indexing inside the unroll.  Same math as :meth:`F_Y` to float
        round-off (summation order differs)."""
        y = jnp.asarray(y, self.dtype)
        inv = (1.0 / (np.sqrt(2.0) * self._sigma_dev)).astype(self.dtype)
        acc = None
        for ck, pk in zip(self._c_tuple, self._p_tuple):
            t = (0.5 * pk) * (1.0 + jerf((y - ck) * inv))
            acc = t if acc is None else acc + t
        return acc.astype(self.dtype)

    def _ensure_fy_poly(self):
        """Host build of the gather-free marginal-CDF fit.

        Fits ONE global degree-``_FY_DEG`` Chebyshev series to the
        probit-warped CDF ``h(y) = ndtri(F_Y(y))`` over
        ``y in [c_0 - 6.5 sigma, c_{M-1} + 6.5 sigma]`` — h is exactly
        linear for a single Gaussian and stays smooth while the mixture
        components overlap (the regime softening actually operates in:
        at the bps=4 waterfall sigma exceeds the constellation step).
        Evaluation is one Clenshaw chain + one erf per sample instead of
        the M-erf mixture (the measured bps=4 softening-preamble
        residual).  The fit error ON THE CDF SCALE is kept in
        ``_fy_poly_fit_err``; a warning points back to fy_mode="erf"
        when it exceeds 5e-4 (well-separated high-SNR plateaus).

        Sign-independent (like ``_ginv_poly``): with_sign_config clones
        share the coefficients by reference.
        """
        if self._fy_poly is not None and self._fy_poly.size:
            return
        if not hasattr(self, "np_tables"):
            raise RuntimeError(
                "fy_mode='poly' reached a traced NoiseMapper whose "
                "coefficients were never built — call nm._ensure_fy_poly() "
                "on the original object before passing it through jit"
            )
        from scipy.special import ndtr, ndtri

        deg = _FY_DEG
        c = self.np_tables["constellation"]
        p = self.np_tables["probabilities"]
        s = self.noise_sigma
        # 6.5-sigma domain + 1e-10 clip: wide enough that beyond-domain
        # samples carry ~1e-10 of probability mass, narrow enough that the
        # ndtri clip flattens h only in a thin sliver at the extreme edge
        # nodes (a wide clip-induced flat segment rings the Chebyshev
        # fit — measured non-monotonic error vs degree with an
        # 8.5-sigma/1e-16 window; this pairing measured <1e-4 CDF error
        # across bps 1-4 at operating SNRs)
        y_lo = float(c[0] - 6.5 * s)
        y_hi = float(c[-1] + 6.5 * s)
        nn = 4 * (deg + 1)
        xs = np.cos(np.pi * np.arange(nn) / (nn - 1))[::-1]     # [-1, 1]
        yn = y_lo + (xs + 1.0) / 2.0 * (y_hi - y_lo)
        F = np.zeros_like(yn)
        for ck, pk in zip(c, p):
            F += pk * _np_F_Z(yn, ck, s)
        h = ndtri(np.clip(F, 1e-10, 1.0 - 1e-10))
        C = np.polynomial.chebyshev.chebfit(xs, h, deg)
        fit_err = float(
            np.abs(ndtr(np.polynomial.chebyshev.chebval(xs, C)) - F).max()
        )
        self._fy_poly_fit_err = fit_err
        if fit_err > 5e-4:
            import warnings

            warnings.warn(
                f"gather-free F_Y fit residual {fit_err:.3g} on the CDF "
                "scale is large for this (alphabet, N0) — well-separated "
                "mixture components at high SNR; prefer fy_mode='erf'",
                stacklevel=2,
            )
        pdt = jnp.float64 if self.dtype == jnp.float64 else jnp.float32
        A = jnp.asarray if isinstance(
            self._sigma_dev, jax.Array
        ) else np.asarray
        self._fy_poly = A(C, pdt)
        self._fy_dom = A(np.asarray([y_lo, y_hi]), pdt)

    def F_Y_poly(self, y):
        """Approximate marginal CDF via the probit-warped global Chebyshev
        fit (see :meth:`_ensure_fy_poly`): Clenshaw over the coefficient
        leaf via ``lax.scan`` + one erf, all lane-flat."""
        if self._fy_poly is None or not self._fy_poly.size:
            self._ensure_fy_poly()
        deg = _FY_DEG
        compute = jnp.float64 if self.dtype == jnp.float64 else jnp.float32
        y = jnp.asarray(y, compute)
        lo = self._fy_dom[0].astype(compute)
        hi = self._fy_dom[1].astype(compute)
        x = jnp.clip(2.0 * (y - lo) / (hi - lo) - 1.0, -1.0, 1.0)
        c_rev = jnp.flip(self._fy_poly.astype(compute))

        def step(carry, ck):
            b1, b2 = carry
            return (2.0 * x * b1 - b2 + ck, b1), None

        zero = jnp.zeros_like(x)
        (b1, b2), _ = jax.lax.scan(step, (zero, zero), c_rev[:deg])
        h = x * b1 - b2 + c_rev[deg]
        F = 0.5 * (1.0 + jerf(h * np.float64(1.0 / np.sqrt(2.0))))
        return F.astype(self.dtype)

    # ------------------------------------------------------------------ #

    def hard_decide_index(self, y_samples):
        """Decision-interval index of each sample (batched).

        Equivalent to the reference's per-sample binary search over the
        sentinel-padded threshold array
        (reference: noisemapper.pyx:349-359): index = #{interior thresholds
        <= y}, clamped to [0, M-1].
        """
        y = jnp.asarray(y_samples, self.dtype)
        # index = #{interior thresholds <= y}, accumulated one scalar
        # threshold at a time.  Exactly searchsorted(side="right"), but pure
        # elementwise code: M-1 unrolled compare-adds fuse into one pass
        # over y, with no search and no compare-reduce over a small
        # trailing axis.
        idx = jnp.zeros(y.shape, self.dtype)
        for t in self._thr_tuple:
            idx += (y >= jnp.asarray(t, self.dtype)).astype(self.dtype)
        return idx.astype(INDEX_DTYPE)

    def index_to_val(self, index):
        return self._c[jnp.asarray(index)]

    def g(self, y, i):
        """Softening metric n = g(y, decided interval i), batched."""
        y = jnp.asarray(y, self.dtype)
        i = jnp.asarray(i)
        F = self.F_Y(y)
        lo, hi = self._F_thr[i], self._F_thr[i + 1]
        d = self._delta_F_Y[i]
        flip = self._g_signs()[i]
        return jnp.where(flip, (hi - F) / d, (F - lo) / d)

    def map_noise(self, y_samples, index):
        """n = g(y, index) elementwise (reference: noisemapper.pyx:373-388)."""
        return self.g(y_samples, index)

    def _g_target(self, n_hat, i, signs):
        lo, hi = self._F_thr[i], self._F_thr[i + 1]
        d = self._delta_F_Y[i]
        return jnp.where(signs[i], hi - jnp.asarray(n_hat, self.dtype) * d,
                         jnp.asarray(n_hat, self.dtype) * d + lo)

    def g_inv(self, n_hat, i):
        """Inverse softening by monotone grid interpolation (batched).

        Returns y_hat, not z_hat (reference: noisemapper.pyx:295-307).
        Deviation: clamps (rather than extrapolates) below the grid start.
        """
        target = self._g_target(n_hat, jnp.asarray(i), self._g_signs())
        # Gather-interpolate on the uniform-in-CDF inverse table (built on the
        # host in __init__) instead of jnp.interp over the non-uniform forward
        # grid: identical math, but one gather + FMA instead of a search
        # per sample.
        K = self._inv_K
        t = jnp.clip(target, 0.0, 1.0) * (K - 1)
        i0 = jnp.clip(jnp.floor(t).astype(INDEX_DTYPE), 0, K - 2)
        frac = t - i0.astype(self.dtype)
        y0 = self._y_of_u[i0]
        y1 = self._y_of_u[i0 + 1]
        return y0 + (y1 - y0) * frac

    def _ensure_ginv_poly(self):
        """Host build of the gather-free inverse-CDF coefficients.

        Fits ONE global degree-``_GINV_DEG`` Chebyshev series to the SAME
        uniform-in-CDF inverse table ``g_inv`` interpolates (so "poly" is a
        drop-in for "interp" up to the fit residual), in the probit
        coordinate ``t = ndtri(u)`` over ``u in [0.5/K, 1 - 0.5/K]`` —
        y(t) is exactly linear for a single Gaussian and stays smooth for
        the overlapping mixture components of realistic SNRs (measured
        residuals <= 2e-5 of the constellation step for bps=2/4 across
        3.5-14 dB; at very high SNR the plateaus between components
        steepen the curve — the max residual is kept in
        ``_ginv_poly_fit_err`` and a warning points back to "interp" when
        it exceeds 1e-2 of the step).

        The coefficients depend only on the (alphabet, N0) tables — NOT on
        the sign configuration (signs transform the CDF target, not the
        inverse curve) — so ``with_sign_config`` clones share them by
        reference and mass enumerations fit once.
        """
        if self._ginv_poly is not None and self._ginv_poly.size:
            return
        if not hasattr(self, "np_tables"):
            raise RuntimeError(
                "gather-free g_inv reached a traced NoiseMapper whose "
                "coefficients were never built — call "
                "nm._ensure_ginv_poly() on the original object before "
                "passing it through jit"
            )
        from scipy.special import ndtr, ndtri

        deg = _GINV_DEG
        K = self._inv_K
        u_eps = 0.5 / K
        t_lo, t_hi = float(ndtri(u_eps)), float(ndtri(1.0 - u_eps))
        F_grid = self.np_tables["F_Y"]
        y_grid = self.np_tables["y_range"]
        nn = 4 * (deg + 1)
        xs = np.cos(np.pi * np.arange(nn) / (nn - 1))[::-1]     # [-1, 1]
        tn = t_lo + (xs + 1.0) / 2.0 * (t_hi - t_lo)
        yn = np.interp(ndtr(tn), F_grid, y_grid)
        C = np.polynomial.chebyshev.chebfit(xs, yn, deg)
        fit = np.polynomial.chebyshev.chebval(xs, C)
        fit_err = float(np.abs(fit - yn).max())
        self._ginv_poly_fit_err = fit_err
        if fit_err > 1e-2 * float(self.alphabet.step):
            import warnings

            warnings.warn(
                f"gather-free g_inv fit residual {fit_err:.3g} is large "
                "for this (alphabet, N0) — well-separated mixture "
                "components at high SNR; prefer ginv mode 'interp'",
                stacklevel=2,
            )
        pdt = jnp.float64 if self.dtype == jnp.float64 else jnp.float32
        self._ginv_poly = jnp.asarray(C, pdt)

    def g_inv_poly(self, n_hat, i):
        """Gather-free inverse softening (batched): same contract as
        :meth:`g_inv` but ZERO random table gathers — Clenshaw recurrence
        over the global coefficient leaf via ``lax.scan`` (coefficients
        enter as scan slices: no one-hot tensors, no per-component leaf
        reads), where :meth:`g_inv` pays per-(sample, candidate) gathers."""
        if self._ginv_poly is None or not self._ginv_poly.size:
            self._ensure_ginv_poly()
        deg = _GINV_DEG
        compute = jnp.float64 if self.dtype == jnp.float64 else jnp.float32
        K = self._inv_K
        u_eps = 0.5 / K
        from scipy.special import ndtri as _h_ndtri

        t_lo = float(_h_ndtri(u_eps))
        t_hi = float(_h_ndtri(1.0 - u_eps))
        target = self._g_target(n_hat, jnp.asarray(i), self._g_signs())
        u = jnp.clip(target.astype(compute), u_eps, 1.0 - u_eps)
        t = jax.scipy.special.ndtri(u)
        x = jnp.clip(2.0 * (t - t_lo) / (t_hi - t_lo) - 1.0, -1.0, 1.0)
        Cd = self._ginv_poly.astype(compute)                   # [deg+1]
        # Clenshaw: k = deg..1 as scan slices c_deg..c_1, then c_0
        c_rev = jnp.flip(Cd)

        def step(carry, ck):
            b1, b2 = carry
            return (2.0 * x * b1 - b2 + ck, b1), None

        zero = jnp.zeros_like(x)
        (b1, b2), _ = jax.lax.scan(step, (zero, zero), c_rev[:deg])
        return (x * b1 - b2 + c_rev[deg]).astype(self.dtype)

    def _f_Y_pdf(self, y):
        """Mixture pdf of Y (batched), for the Newton inverse."""
        y = jnp.asarray(y, self.dtype)
        inv_s = 1.0 / self._sigma_dev
        z = (y[..., None] - self._c) * inv_s
        norm = inv_s / np.sqrt(2.0 * np.pi)
        return jnp.sum(self._p * norm * jnp.exp(-0.5 * z * z), axis=-1)

    def g_inv_search(self, n_hat, i, y_accuracy: float = 1e-9, iters: int = 12):
        """Inverse softening on the exact CDF: interp init + safeguarded Newton.

        Same result contract as the reference's bracket-doubling + bisection
        to ``y_accuracy=1e-9`` (reference: noisemapper.pyx:310-345) — always
        uses ``sign_config``, mirroring that the reference subclasses do not
        override it — but instead of ~80 bisection steps (each an exact-CDF
        evaluation) it starts from the grid-interpolated inverse (~1e-3
        accurate) and runs ``iters`` Newton steps on the LOG of the nearer
        CDF tail (log F for targets below 1/2, log(1-F) above): quadratic
        convergence near the bulk AND geometric tail progress (plain Newton
        on F stalls in flat tails where pdf -> 0).  6 exact-CDF evaluations
        replace ~80; verified against 100-step bisection ground truth.
        """
        del y_accuracy
        i = jnp.asarray(i)
        target = self._g_target(n_hat, i, self._sign_cfg)
        # interp-inverse initial guess (same target math as g_inv)
        K = self._inv_K
        t = jnp.clip(target, 0.0, 1.0) * (K - 1)
        i0 = jnp.clip(jnp.floor(t).astype(INDEX_DTYPE), 0, K - 2)
        frac = t - i0.astype(self.dtype)
        y0 = self._y_of_u[i0]
        y = y0 + (self._y_of_u[i0 + 1] - y0) * frac

        is64 = jnp.dtype(self.dtype) == jnp.dtype(jnp.float64)
        f_floor = jnp.asarray(1e-300 if is64 else 1e-38, self.dtype)
        max_step = jnp.asarray(20.0, self.dtype)
        lower = target <= 0.5
        log_t_lo = jnp.log(jnp.maximum(target, f_floor))
        log_t_hi = jnp.log(jnp.maximum(1.0 - target, f_floor))
        inv_sq2s = 1.0 / (np.sqrt(2.0) * self._sigma_dev)

        def body(_, y):
            # erfc-based tail CDFs: plain F_Y rounds to exactly 0/1 beyond
            # |z| ~ 6, which stalls the log-Newton; erfc keeps full relative
            # precision in the tail the target lives in.
            z = (y[..., None] - self._c) * inv_sq2s
            F_lo = jnp.sum(self._p * 0.5 * jax.scipy.special.erfc(-z), axis=-1)
            F_hi = jnp.sum(self._p * 0.5 * jax.scipy.special.erfc(z), axis=-1)
            pdf = jnp.maximum(self._f_Y_pdf(y), f_floor)
            F_lo = jnp.maximum(F_lo, f_floor)
            F_hi = jnp.maximum(F_hi, f_floor)
            # log-Newton far out (geometric tail progress), plain Newton once
            # within a decade of the target (quadratic close-in).
            ld_lo = jnp.log(F_lo) - log_t_lo
            ld_hi = jnp.log(F_hi) - log_t_hi
            step_lo = jnp.where(
                jnp.abs(ld_lo) < 1.0,
                (F_lo - target) / pdf,
                ld_lo * (F_lo / pdf),
            )
            step_hi = jnp.where(
                jnp.abs(ld_hi) < 1.0,
                ((1.0 - target) - F_hi) / pdf,
                -ld_hi * (F_hi / pdf),
            )
            step = jnp.where(lower, step_lo, step_hi)
            return y - jnp.clip(step, -max_step, max_step)

        return jax.lax.fori_loop(0, iters, body, y)

    def demap_noise(self, n_hat, symb):
        """y_hat = g_inv(n, symb) elementwise (reference: noisemapper.pyx:391-403)."""
        return self.g_inv(jnp.asarray(n_hat), jnp.asarray(symb))

    def demap_noise_search(self, n_hat, symb, y_accuracy: float = 1e-9):
        return self.g_inv_search(jnp.asarray(n_hat), jnp.asarray(symb), y_accuracy)

    # ------------------------------------------------------------------ #
    # LLR builders.  All accept n, j of shape [...], return [..., S*bps]
    # flat bit LLRs (per-symbol blocks contiguous), matching the reference's
    # flat layout.

    def bare_llr(self, symb):
        """Hard-decision LLRs from the precomputed table
        (reference: noisemapper.pyx:423-432)."""
        llr = self._bare_llr[jnp.asarray(symb)]        # [..., S, bps]
        return llr.reshape(*llr.shape[:-2], -1)

    def _y_hat_all_candidates(self, n, mode: str):
        """y_hat[s, i] = g^-1(n_s, i) for every candidate received symbol i."""
        n = jnp.asarray(n, self.dtype)
        S = n.shape[-1]
        ii = jnp.broadcast_to(jnp.arange(self.order), (*n.shape, self.order))
        nn = n[..., None]
        if mode == "search":
            return self.g_inv_search(jnp.broadcast_to(nn, ii.shape), ii)
        if mode == "poly":
            return self.g_inv_poly(jnp.broadcast_to(nn, ii.shape), ii)
        return self.g_inv(jnp.broadcast_to(nn, ii.shape), ii)

    def _gray_group_llr(self, log_w):
        """log_w [..., M] -> LLR [..., bps]: LSE over Gray-bit groups."""
        neg_inf = jnp.array(-jnp.inf, self.dtype)
        lw = log_w[..., None]                          # [..., M, 1]
        mask1 = self._bits_mask > 0                    # [M, bps]
        num = logsumexp(jnp.where(mask1, neg_inf, lw), axis=-2)
        den = logsumexp(jnp.where(mask1, lw, neg_inf), axis=-2)
        return num - den

    def demap_lappr_array(self, n, j, mode: str = "search", ref_compat: bool = False):
        """Softening LLRs, "Formulation 2/4" — the sims' default path.

        Batched log-domain equivalent of reference: noisemapper.pyx:450-559.
        For each sample s (softening metric n_s, Alice symbol j_s) and each
        candidate Bob decision i: reconstruct y_hat = g^-1(n_s, i), weight the
        decision interval mass ``delta_F_Y[i]`` by the probability-weighted
        exponential sum over true-symbol hypotheses k, then group by Gray bit.

        mode: "poly" (gather-free piecewise-Chebyshev fit, the default,
        see _poly_llr_bits), "table" (host-precomputed [K, M, bps]
        LLR table, two gathers + lerp per bit), "interp" (per-sample
        grid-interpolated inverse) or "search" (exact Newton inverse, the
        reference's ``g_inv_search`` contract).
        ref_compat: reproduce quirk (b) (missing /2sigma^2 on k<j terms;
        forces the per-sample path).
        """
        n = jnp.atleast_1d(jnp.asarray(n, self.dtype))
        j = jnp.atleast_1d(jnp.asarray(j))
        M = self.order
        S = n.shape[-1]
        lead = n.shape[:-1]

        if mode in ("table", "poly") and not ref_compat:
            fn = (self._table_llr_bits if mode == "table"
                  else self._poly_llr_bits)
            bits = fn(n, j)                                    # bps x [..., S]
            llr = jnp.stack(bits, axis=-1)                     # [..., S, bps]
            return llr.reshape(*lead, S * self.bit_per_symbol)
        if mode in ("table", "poly"):
            mode = "interp"  # ref_compat needs the per-sample exponent quirk

        # Lane-flat layout: the M candidate decisions are flattened INTO the
        # sample (lane) dimension via repeat/tile — pure reshapes, no
        # transposes, no small trailing axes.  The true-symbol sum over k is
        # unrolled as an overflow-safe two-pass logsumexp accumulation.
        # (A small trailing [..., M] candidate axis leaves the minor
        # dimension mostly empty; the flat form keeps every array dense.)
        nf = n.reshape(-1)                              # [T]
        jf = j.reshape(-1)
        T = nf.shape[0]
        nn = jnp.repeat(nf, M)                          # [T*M]
        ii = jnp.tile(jnp.arange(M), T)                 # [T*M]
        if mode == "search":
            y_hat = self.g_inv_search(nn, ii)
        else:
            y_hat = self.g_inv(nn, ii)

        c_j = jnp.repeat(self._c[jf], M)                # [T*M]
        j_rep = jnp.repeat(jf, M) if ref_compat else None

        def expo_k(k):
            base = (2.0 * y_hat - self._c[k] - c_j) * (self._c[k] - c_j)
            e = base / (2.0 * self._noise_var_dev)
            if ref_compat:
                # quirk (b): k<j terms keep the raw (un-normalized) exponent
                e = jnp.where(j_rep > k, base, e)
            return e + self._log_p[k]

        expos = [expo_k(k) for k in range(M)]           # each [T*M]
        m = expos[0]
        for e in expos[1:]:
            m = jnp.maximum(m, e)
        acc = jnp.zeros_like(m)
        for e in expos:
            acc = acc + jnp.exp(e - m)
        log_sums = jnp.log(acc) + m                     # [T*M]
        log_w = jnp.tile(jnp.log(self._delta_F_Y), T) - log_sums

        # Gray-bit grouping: [T, 1, M] against [1, bps, M] masks; the only
        # small-trailing-axis op left is this float logsumexp pair.
        lw = log_w.reshape(T, 1, M)
        mask1 = (self._bits_mask > 0).T[None]           # [1, bps, M]
        neg_inf = jnp.array(-jnp.inf, self.dtype)
        num = logsumexp(jnp.where(mask1, neg_inf, lw), axis=-1)   # [T, bps]
        den = logsumexp(jnp.where(mask1, lw, neg_inf), axis=-1)
        return (num - den).reshape(*lead, S * self.bit_per_symbol)

    def demap_lappr(self, n, j, mode: str = "search", ref_compat: bool = False):
        """Single-sample wrapper (reference: noisemapper.pyx:450-540)."""
        return self.demap_lappr_array(
            jnp.asarray([n], self.dtype), jnp.asarray([j]), mode, ref_compat
        )

    def demap_lappr_simplified_array(self, n, j):
        """"Formulation 1" (reference: noisemapper.pyx:563-601):
        plain Gaussian kernels at the interpolated y_hat candidates."""
        n = jnp.atleast_1d(jnp.asarray(n, self.dtype))
        j = jnp.atleast_1d(jnp.asarray(j))
        y_hat = self._y_hat_all_candidates(n, "interp")            # [..., M]
        a_j = self._c[j][..., None]
        log_w = -((y_hat - a_j) ** 2) / (2.0 * self._noise_var_dev)
        llr = self._gray_group_llr(log_w)
        return llr.reshape(*llr.shape[:-2], -1)

    def demap_lappr_simplified(self, n, j):
        return self.demap_lappr_simplified_array(
            jnp.asarray([n], self.dtype), jnp.asarray([j])
        )

    def demap_lappr_sofisticated_array(self, n, j, ref_compat: bool = False):
        """"Formulation 3" (reference: noisemapper.pyx:624-747).

        beta/delta-F_Z coefficient construction; kept in the linear domain
        because the A coefficients are signed (negative sums produce NaN
        LLRs exactly as in the reference).
        ref_compat: reproduce quirk (c) (y_hat built from index j for all i).
        """
        n = jnp.atleast_1d(jnp.asarray(n, self.dtype))
        j = jnp.atleast_1d(jnp.asarray(j))
        M = self.order
        if ref_compat:
            y_hat = jnp.broadcast_to(
                self.g_inv(n, j)[..., None], (*n.shape, M)
            )
        else:
            y_hat = self._y_hat_all_candidates(n, "interp")

        c_j = self._c[j][..., None, None]
        c_m = self._c[None, :]
        expo = (2.0 * y_hat[..., None] - c_m - c_j) * (c_m - c_j) / (
            2.0 * self._noise_var_dev
        )
        e_coeff = jnp.sum(self._p * jnp.exp(expo), axis=-1)        # [..., M]
        beta = self._delta_F_Y / e_coeff
        B = jnp.sum(beta, axis=-1, keepdims=True)

        a_j = self._c[j][..., None]
        sq2s = jnp.sqrt(2.0 * self._noise_var_dev)
        # _inf_erf is [i, j]; per sample we need the column j_s over all i.
        inf_erf_cols = self._inf_erf.T[j]                          # [..., M]
        dFZ = 0.5 * (jerf((y_hat - a_j) / sq2s) - inf_erf_cols)
        Sz = jnp.sum(dFZ, axis=-1, keepdims=True)

        A = beta * Sz - dFZ * B                                    # [..., M]
        bits1 = self._bits_mask                                     # [M, bps]
        hi = jax.lax.Precision.HIGHEST       # no TF32 on a GPU
        Nk = jnp.einsum("...m,mk->...k", A, 1.0 - bits1, precision=hi)
        Dk = jnp.einsum("...m,mk->...k", A, bits1, precision=hi)
        llr = jnp.log(Nk) - jnp.log(Dk)
        return llr.reshape(*llr.shape[:-2], -1)

    def demap_lappr_sofisticated(self, n, j, ref_compat: bool = False):
        return self.demap_lappr_sofisticated_array(
            jnp.asarray([n], self.dtype), jnp.asarray([j]), ref_compat
        )


class NoiseDemapper(NoiseMapper):
    """Kept-for-compat alias (reference: qamreconciliation/noisemapper.pxd:89-92)."""


class NoiseMapperFlipSign(NoiseMapper):
    """g decreasing on the lower half of the constellation
    (reference: noisemapper.pyx:775-795)."""

    def _g_signs(self):
        return jnp.arange(self.order) < self.half_order


class NoiseMapperAntiFlipSign(NoiseMapper):
    """Complement of FlipSign (reference: noisemapper.pyx:798-816)."""

    def _g_signs(self):
        return jnp.arange(self.order) >= self.half_order


# --------------------------------------------------------------------- #
# Pytree registration: a NoiseMapper can be passed as an argument to a
# jitted function.  Leaves are the device tables/scalars (all with
# SNR-independent shapes); aux data is the SNR-independent static config,
# so different-SNR mappers hit the SAME compiled function — one compile
# serves an entire SNR sweep.  Reconstructed (traced) instances carry only
# the leaves + aux; host-side attributes (np_tables, alphabet, ...) exist
# only on originals and are init/analysis-time state.

_NM_LEAVES = (
    "_F_thr", "_delta_F_Y", "_fwd", "_back", "_bare_llr", "_inf_erf",
    "_c", "_thr_interior", "_p", "_log_p", "_sign_cfg", "_bits_mask",
    "_y_of_u", "_sigma_dev", "_noise_var_dev", "_llr_tab", "_llr_poly",
    "_ginv_poly", "_fy_poly", "_fy_dom",
)
_NM_AUX = (
    "order", "half_order", "bit_per_symbol", "_inv_K", "_llr_K",
    "_thr_tuple", "dtype", "fy_mode", "_c_tuple", "_p_tuple",
)


def _nm_flatten(nm):
    # An unbuilt lazy LLR table flattens as a size-0 placeholder leaf (same
    # treedef, different shape): paths that never demap — hard mode, MC-MI,
    # interp/search engines — must not pay the O(K*M^3) host build just for
    # being passed through jit.  Table-mode consumers ensure the build
    # eagerly before tracing (engine.run_point / demap_lappr_array).
    leaves = []
    for k in _NM_LEAVES:
        v = getattr(nm, k)
        if k in (
            "_llr_tab", "_llr_poly", "_ginv_poly", "_fy_poly", "_fy_dom"
        ) and v is None:
            v = jnp.zeros((0,), nm.dtype)
        leaves.append(v)
    return tuple(leaves), tuple(getattr(nm, k) for k in _NM_AUX)


def _nm_unflatten(cls, aux, leaves):
    obj = object.__new__(cls)
    for k, v in zip(_NM_AUX, aux):
        object.__setattr__(obj, k, v)
    for k, v in zip(_NM_LEAVES, leaves):
        object.__setattr__(obj, k, v)
    return obj


for _cls in (
    NoiseMapper, NoiseDemapper, NoiseMapperFlipSign, NoiseMapperAntiFlipSign
):
    jax.tree_util.register_pytree_node(
        _cls, _nm_flatten, functools.partial(_nm_unflatten, _cls)
    )
del _cls
