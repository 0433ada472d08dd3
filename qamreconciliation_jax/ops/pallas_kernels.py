"""Fused QC check phase for NVIDIA GPUs, on the Pallas Triton route.

Every flooding BP iteration of the quasi-cyclic decoder
(models/qc_decoder._build_dense) runs a check phase over the gathered
variable totals ``t`` and the previous check->variable messages ``c2v``,
both ``[nb_c, dc, z, B]``:

  1. the convergence test: parity of the hard decisions of ``t`` against
     the syndrome, per frame (reference: qamreconciliation/decoder.pyx:
     251-257);
  2. ``v2c = t - c2v`` and the extrinsic check update with the syndrome
     prefactor (reference: qamreconciliation/decoder.pyx:322-369).

XLA splits this into a reduction over the ``dc`` axis and elementwise
fusions that read ``t`` and ``c2v`` again.  Here one program owns one
(check block, z tile, frame tile): it loads each of the ``dc`` slot tiles
of ``t`` and ``c2v`` once, keeps them in registers through a static loop
over the slots (``dc`` is never padded to a power of two), and writes the
new messages once.  Its per-frame violation count goes to a small
``[nb_c, n_z_tiles, B]`` array that is summed outside.

Tiles are powers of two; loads and stores are masked, so any ``z`` and
``B`` work (z=360 for DVB-S2).  Interpret mode (``interpret=True``) runs the
same kernel on the CPU for the tests.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .boxplus import (
    MINSUM_ALPHA, minsum_extrinsic_list, minsum_mag, phi_llr,
    tanhfb_extrinsic_list,
)

__all__ = ["bp_check_phase_qc", "check_phase_tiles", "check_phase_warps",
           "CHECK_RULES"]

# check-update rules of the fused phase: exact sum-product in the phi form,
# exact sum-product in the tanh forward/backward form, normalized min-sum
CHECK_RULES = ("sumproduct", "tanhfb", "minsum")


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def check_phase_tiles(z: int, B: int) -> tuple[int, int]:
    """(z tile, frame tile) of one program: powers of two, at most 512
    elements per slot tile, frames along the contiguous minor axis.

    512 elements hold two elements of each of the ``2 dc`` live slot tiles
    per thread at 8 warps: at z=360, B=128, dc 7 on an H100 the phi rule
    ran fastest there, and 1024-element tiles at 4 warps ran ~1.6x slower
    (register pressure)."""
    bt = min(128, _next_pow2(B))
    zt = max(1, min(512 // bt, _next_pow2(z)))
    return zt, bt


def check_phase_warps(zt: int, bt: int) -> int:
    """Warps per program: one per 64 tile elements, 1 to 8."""
    return max(1, min(8, zt * bt // 64))


def _extrinsic_mags(absv, rule, tiny, ms_alpha, ms_beta):
    """Per-slot all-but-one magnitudes from the list of |v2c| slot tiles."""
    if rule == "minsum":
        return [minsum_mag(m, ms_alpha, ms_beta)
                for m in minsum_extrinsic_list(absv)]
    if rule == "tanhfb":
        return tanhfb_extrinsic_list(absv)
    phim = [phi_llr(a, tiny) for a in absv]
    s_phi = phim[0]
    for p in phim[1:]:
        s_phi = s_phi + p
    return [phi_llr(s_phi - p, tiny) for p in phim]


def _check_phase_kernel(t_ref, c2v_ref, synd_ref, out_ref, viol_ref, *,
                        zt, bt, rule, tiny, ms_alpha, ms_beta):
    cb, zi, bi = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    _, dc, z, B = t_ref.shape
    rows = zi * zt + jnp.arange(zt)
    cols = bi * bt + jnp.arange(bt)
    col_ok = cols < B
    mask = (rows < z)[:, None] & col_ok[None, :]
    zs, bs = pl.ds(zi * zt, zt), pl.ds(bi * bt, bt)
    wide = jnp.float64 in (t_ref.dtype, out_ref.dtype)
    compute = jnp.float64 if wide else jnp.float32

    slots = [jnp.int32(d) for d in range(dc)]   # index dtypes must match
    synd = plgpu.load(synd_ref.at[cb, zs, bs], mask=mask, other=0)
    t = [plgpu.load(t_ref.at[cb, d, zs, bs], mask=mask, other=0)
         .astype(compute) for d in slots]
    v2c = [t[d] - plgpu.load(c2v_ref.at[cb, slots[d], zs, bs], mask=mask,
                             other=0).astype(compute) for d in range(dc)]

    # 1. convergence: parity of the hard decisions of t vs the syndrome
    # (masked-off cells load t=0, synd=0 and so never count)
    par_t = (t[0] < 0).astype(jnp.int32)
    for d in range(1, dc):
        par_t = par_t ^ (t[d] < 0).astype(jnp.int32)
    count = jnp.sum((par_t != synd).astype(jnp.int32), axis=0)
    plgpu.store(viol_ref.at[cb, zi, bs], count.astype(viol_ref.dtype),
                mask=col_ok)

    # 2. extrinsic check update, sign rule with the syndrome prefactor
    mag = _extrinsic_mags([jnp.abs(v) for v in v2c], rule, tiny,
                          ms_alpha, ms_beta)
    neg = [(v < 0).astype(jnp.int32) for v in v2c]
    par = neg[0]
    for n in neg[1:]:
        par = par ^ n
    par = par ^ synd
    for d in range(dc):
        sign = (1 - 2 * (par ^ neg[d])).astype(compute)
        plgpu.store(out_ref.at[cb, slots[d], zs, bs],
                    (sign * mag[d]).astype(out_ref.dtype), mask=mask)


@functools.partial(
    jax.jit,
    static_argnames=("rule", "ms_alpha", "ms_beta", "tiny", "interpret"),
)
def bp_check_phase_qc(t, c2v, synd, *, rule: str = "sumproduct",
                      ms_alpha: float = MINSUM_ALPHA, ms_beta: float = 0.0,
                      tiny: float = 1e-30, interpret: bool = False):
    """Fused check phase in the QC decoder's native layout.

    Args:
      t:    [nb_c, dc, z, B] gathered variable totals (padded slots of
            irregular rows carry the decoder's +BIG neutral sentinel).
      c2v:  [nb_c, dc, z, B] previous check->variable messages; the new
            messages are returned at this (storage) dtype.
      synd: [nb_c, z, B] syndrome bits (0/1).
      rule: one of :data:`CHECK_RULES`.
      interpret: run the kernel in the Pallas interpreter (CPU tests).

    Tiles come from :func:`check_phase_tiles`, warps from
    :func:`check_phase_warps`; one pipeline stage, since every tile is
    loaded once and there is nothing to pipeline.

    Returns ``(converged [B] bool, c2v_new [nb_c, dc, z, B])`` with the
    semantics of models/qc_decoder's XLA ``consistent`` + ``qc_check_update``.
    Arithmetic runs in float32 (float64 for float64 operands).
    """
    if rule not in CHECK_RULES:
        raise ValueError(f"unknown rule {rule!r}")
    nb_c, dc, z, B = t.shape
    zt, bt = check_phase_tiles(z, B)
    grid = (nb_c, pl.cdiv(z, zt), pl.cdiv(B, bt))
    out, viol = pl.pallas_call(
        functools.partial(
            _check_phase_kernel, zt=zt, bt=bt, rule=rule, tiny=tiny,
            ms_alpha=ms_alpha, ms_beta=ms_beta,
        ),
        out_shape=(
            jax.ShapeDtypeStruct(c2v.shape, c2v.dtype),
            jax.ShapeDtypeStruct((nb_c, grid[1], B), jnp.int32),
        ),
        grid=grid,
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=check_phase_warps(zt, bt), num_stages=1,
        ),
        interpret=interpret,
        name="qc_check_phase",
    )(t, c2v, synd.astype(jnp.int32))
    return jnp.sum(viol, axis=(0, 1)) == 0, out
