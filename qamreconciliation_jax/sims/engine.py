"""Monte-Carlo reconciliation sweep engine, batched.

Capability parity with the reference's compiled per-SNR frame loops
(reference: sims/reconciliation.pyx:93-329), re-designed for an accelerator:

* the reference decodes ONE frame at a time in C loops; here every step —
  symbol sampling, AWGN, hard decision, softening, syndrome, LLR build,
  BP decode, error counting — runs over a frame batch ``B`` in one jitted
  round function,
* the per-frame early-exit heuristic
  (reference: sims/reconciliation.pyx:159-161) becomes batch-round granular:
  after each round of ``B`` frames the host checks
  ``frame_errors >= ferr_count_min and frames > simloops/20`` — a
  statistically equivalent stopping rule (documented deviation),
* randomness is counter-based (``jax.random``): each round folds its index
  into the sweep key, so results are reproducible and shardable.

The three modes mirror the reference entry points:

* softening  — reverse reconciliation with the softening metric
  (reference: reconciliation.pyx:93-168)
* direct     — Bob-side Gray LLRs from y (reference: reconciliation.pyx:173-249)
* hard       — reverse with Alice's bare-LLR table
  (reference: reconciliation.pyx:253-329)
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from ..config import DEFAULT_DTYPE
from ..models.alphabet import PAMAlphabet
from ..models.decoder import Decoder
from ..models.matrix import Matrix
from ..models.noisemapper import NoiseMapper
from ..ops.llr import y_to_lappr_gray_bits
from ..utils.scalar import count_errors_from_lappr

__all__ = [
    "ReconciliationEngine",
    "simulate_softening_snr_dB",
    "simulate_direct_snr_dB",
    "simulate_hard_reverse_snr_dB",
]


@dataclass
class PointResult:
    """Per-SNR-point result tuple, matching the reference's CSV schema
    (reference: sims/sim_reconciliation.py:96-102)."""

    snr_dB: float
    ber: float
    fer: float
    iters: float
    frames: int = 0
    frames_per_s: float = 0.0
    compile_s: float = 0.0      # compile time paid before this point ran

    def as_tuple(self):
        return (self.snr_dB, self.ber, self.fer, self.iters)


def scan_rounds(body, rounds_per_dispatch: int, counter_shape=()):
    """Wrap a counters-returning round body in a device-side ``lax.scan``
    over ``rounds_per_dispatch`` sub-rounds (decorrelated by an inner
    ``fold_in``), summing the [..., 4] int32 counters on-chip.

    One dispatch then advances R frame batches, so the fixed per-dispatch
    host roundtrip is paid once per R rounds.
    """
    R = int(rounds_per_dispatch)
    if R <= 1:
        return body

    def multi(key, max_iterations, *args):
        def step(acc, r):
            out = body(jax.random.fold_in(key, r), max_iterations, *args)
            # x64 mode promotes some counters to int64; the carry stays
            # int32 (values bounded < 2^31 by the engine ctor guards)
            return acc + out.astype(acc.dtype), None

        tot, _ = jax.lax.scan(
            step, jnp.zeros((*counter_shape, 4), jnp.int32), jnp.arange(R)
        )
        return tot

    return multi


class ReconciliationEngine:
    """Batched Monte-Carlo engine bound to (code, alphabet).

    Args:
      dec, mat, pa: decoder / parity matrix / alphabet (shared graph metadata).
      batch: frames per round per device.
      dtype: LLR/message dtype.
      llr_mode: "poly" (default; gather-free piecewise-Chebyshev fit of
        the (n, j)->LLR curves), "table" (host-precomputed LLR map, two
        random gathers + lerp per bit), "interp" (per-sample grid-interpolated g^-1) or
        "search" (exact Newton inverse, the reference's g_inv_search
        contract — slowest).
      mesh_axis: optional ``(mesh, axis_name)`` to shard rounds over devices
        (see parallel/sweep.py helpers).
      rounds_per_dispatch: run this many frame batches inside ONE jitted
        call (``lax.scan`` over the round body, counters summed on
        device), so the fixed per-dispatch host roundtrip is paid once
        per R rounds.  Early exit coarsens from batch-granular to
        (R*batch)-granular — an extension of the documented deviation from
        the reference's per-frame exit (reference:
        sims/reconciliation.pyx:159-161).
    """

    def __init__(
        self,
        dec: Decoder,
        mat: Matrix,
        pa: PAMAlphabet,
        batch: int = 128,
        dtype=DEFAULT_DTYPE,
        llr_mode: str = "poly",
        mesh_axis=None,
        rounds_per_dispatch: int = 1,
        fy_mode: str = "erf",
    ):
        if mat.vnum % pa.bit_per_symbol != 0:
            raise ValueError(
                f"code length {mat.vnum} not divisible by bits/symbol "
                f"{pa.bit_per_symbol}"
            )
        self.dec = dec
        self.mat = mat
        self.pa = pa
        self.batch = int(batch)
        self.dtype = jnp.dtype(dtype)
        self.llr_mode = llr_mode
        # marginal-CDF implementation for the softening preamble's
        # map_noise (see NoiseMapper fy_mode): "erf" exact mixture
        # broadcast, "erf_flat" lane-flat static-float unroll, "poly"
        # probit-warped Chebyshev fit (cheaper than the M=16 erf mixture
        # at bps=4)
        self.fy_mode = fy_mode
        self.mesh_axis = mesh_axis
        self.rounds_per_dispatch = int(rounds_per_dispatch)
        self.N = mat.vnum
        self.K = mat.vnum - mat.cnum
        self.N_symb = mat.vnum // pa.bit_per_symbol
        # counters are int32 on-device (x64 only on CPU tests):
        # the worst-case bit-error sum per dispatch must fit
        if self.rounds_per_dispatch * self.batch * self.K >= 2 ** 31:
            raise ValueError(
                "rounds_per_dispatch * batch * K must stay below 2^31 "
                "(int32 on-device counters)"
            )
        self._round_cache = {}
        # frames produced per dispatch: batch x scan depth x mesh width
        self.frames_per_round = self.batch * self.rounds_per_dispatch * (
            mesh_axis[0].devices.size if mesh_axis is not None else 1
        )

    # ------------------------------------------------------------------ #
    # Round builders: each returns a jitted key -> counters function.

    def _decode_and_count(self, lappr, word, max_iterations):
        """Common tail: decode [B, N] LLRs against word's syndrome and
        reduce the reference's four counters.

        Returned STACKED as one [4] int32 array: every device->host read
        is a roundtrip, so four separate scalar counters would cost four
        per round; one array costs one.
        """
        synd = self.mat.eval_syndrome(word)
        success, iters, final = _decode_inline(
            self.dec, lappr, synd, max_iterations
        )
        errors = count_errors_from_lappr(
            final[:, : self.K], word[:, : self.K]
        )
        return jnp.stack([
            jnp.sum(errors),
            jnp.sum(errors > 0),
            jnp.sum(jnp.where(success, iters, 0)),
            jnp.sum(success),
        ])

    # -- layout-native helpers: samples live as [S, B], bits/LLRs as [N, B]
    # (the decoder's internal layout), so the round has NO minor-axis
    # transposes.

    def _bits_nb(self, table_col_fn, idx_sb):
        """Per-bit gathers + leading-axis interleave: [S, B] -> [N, B]."""
        cols = [table_col_fn(b, idx_sb) for b in range(self.pa.bit_per_symbol)]
        return jnp.stack(cols, axis=1).reshape(self.N, -1)

    def _decode_and_count_nb(self, lappr_nb, word_nb, max_iterations):
        """[N, B] decode + counters ([4] int32, see _decode_and_count) with
        leading-axis (cheap) reductions.  Prefers the decoder's own
        structure-aware syndrome (QC circulant rolls) over the generic
        [dc, C, B] gather."""
        synd_fn = getattr(
            self.dec, "syndrome_from_bits", None
        ) or self.dec.graph.syndrome_from_bits
        synd = synd_fn(word_nb.astype(jnp.int32))
        if self.dec._decode_jit is None:
            self.dec._decode_jit = self.dec._build_decode()
        success, iters, final = self.dec._decode_jit(
            lappr_nb, synd, max_iterations
        )
        K = self.K
        # exact int32 XOR count (never sum error indicators in the LLR dtype:
        # bfloat16 sums silently round above ~256, corrupting BER counters)
        errb = (final[:K] < 0).astype(jnp.int32) ^ word_nb[:K].astype(jnp.int32)
        errors = jnp.sum(errb, axis=0)
        return jnp.stack([
            jnp.sum(errors),
            jnp.sum(errors > 0),
            jnp.sum(jnp.where(success, iters, 0)),
            jnp.sum(success),
        ])

    def _build_round_body(self, mode: str):
        """The raw (unjitted) round function for MODE — SNR enters through
        traced arguments.

        The NoiseMapper rides in as a pytree argument (its device tables all
        have SNR-independent shapes, see models/noisemapper.py) and
        sigma/alpha as device scalars, so a single compilation serves every
        point of an SNR sweep (a DVB-S2-size round compiles for tens of
        seconds).

        The softening/table, hard, and direct modes run layout-native
        ([S, B] samples, [N, B] bits — no transposes); interp/search
        softening keeps the [B, N] formulation (their per-sample LLR
        builders speak the reference's sample-major layout).
        """
        pa, B = self.pa, self.batch
        dtype = self.dtype
        bps = pa.bit_per_symbol
        M = pa.order
        s2b = pa.s_to_b.astype(np.int32)

        def sample_sb(key, sigma):
            kx, kn = jax.random.split(key)
            x = pa.random_symbols(kx, (self.N_symb, B))
            y = pa.index_to_value(x, dtype) + sigma.astype(
                dtype
            ) * jax.random.normal(kn, (self.N_symb, B), dtype)
            return x, y

        if mode == "softening" and self.llr_mode in ("table", "poly"):
            poly = self.llr_mode == "poly"

            def round_fn(key, max_iterations, nm, sigma, alpha):
                x, y = sample_sb(key, sigma)
                x_hat = nm.hard_decide_index(y)
                n_hat = nm.map_noise(y, x_hat)
                s2b_dev = jnp.asarray(s2b)
                word = self._bits_nb(
                    lambda b, idx: s2b_dev[:, b][idx], x_hat
                )
                llr_fn = nm._poly_llr_bits if poly else nm._table_llr_bits
                llr_bits = llr_fn(n_hat, x)                    # bps x [S, B]
                lappr = alpha.astype(dtype) * self._bits_nb(
                    lambda b, _: llr_bits[b], x_hat
                )
                return self._decode_and_count_nb(lappr, word, max_iterations)

            return round_fn

        if mode == "hard":

            def round_fn(key, max_iterations, nm, sigma, alpha):
                x, y = sample_sb(key, sigma)
                x_hat = nm.hard_decide_index(y)
                s2b_dev = jnp.asarray(s2b)
                word = self._bits_nb(
                    lambda b, idx: s2b_dev[:, b][idx], x_hat
                )
                lappr = self._bits_nb(
                    lambda b, _: nm._bare_llr[:, b][x], x_hat
                )
                return self._decode_and_count_nb(lappr, word, max_iterations)

            return round_fn

        if mode == "direct":
            # layout-native [S, B] direct reconciliation: per-bit Gray
            # LLRs + the [N, B] round the other fast modes use (no
            # transposing [B, N] formulation)
            def round_fn(key, max_iterations, nm, sigma, alpha):
                x, y = sample_sb(key, sigma)
                s2b_dev = jnp.asarray(s2b)
                word = self._bits_nb(
                    lambda b, idx: s2b_dev[:, b][idx], x
                )
                two_var = 2.0 * sigma.astype(dtype) ** 2
                llr_bits = y_to_lappr_gray_bits(
                    y, pa.constellation, two_var, dtype
                )
                lappr = self._bits_nb(lambda b, _: llr_bits[b], x)
                return self._decode_and_count_nb(lappr, word, max_iterations)

            return round_fn

        def round_fn(key, max_iterations, nm, sigma, alpha):
            kx, kn = jax.random.split(key)
            x = pa.random_symbols(kx, (B, self.N_symb))
            y = pa.index_to_value(x, dtype) + sigma.astype(
                dtype
            ) * jax.random.normal(kn, (B, self.N_symb), dtype)
            if mode == "softening":
                x_hat = nm.hard_decide_index(y)
                n_hat = nm.map_noise(y, x_hat)
                word = pa.demap_symbols_to_bits(x_hat)
                lappr = alpha.astype(dtype) * nm.demap_lappr_array(
                    n_hat, x, mode=self.llr_mode
                )
            else:
                raise ValueError(mode)
            return self._decode_and_count(lappr, word, max_iterations)

        return round_fn

    def _build_round(self, mode: str):
        """Jitted (and, with a mesh, shard_mapped) round for MODE."""
        round_fn = scan_rounds(
            self._build_round_body(mode), self.rounds_per_dispatch
        )
        if self.mesh_axis is not None:
            from ..parallel.sweep import shard_round

            return shard_round(round_fn, *self.mesh_axis)
        return jax.jit(round_fn)

    # ------------------------------------------------------------------ #

    def run_point(
        self,
        mode: str,
        snr_dB: float,
        decoder_iterations: int,
        simulation_loops: int,
        ferr_count_min: int,
        alpha: float = 1.0,
        nmconfig=None,
        seed: int = 0,
        timer=None,
    ) -> PointResult:
        """Run one SNR point until the frame budget or the early-exit rule.

        SNR convention matches the reference: Es/N0 with
        ``N0 = Es * 10^(-snr/10) / 2`` (reference: reconciliation.pyx:110).
        """
        Es = self.pa.variance
        N0 = Es * (10.0 ** (-snr_dB / 10.0)) / 2.0
        sigma = math.sqrt(N0)

        nm = None
        if mode in ("softening", "hard"):
            cfg = nmconfig if mode == "softening" else None
            nm = NoiseMapper(self.pa, N0, cfg, dtype=self.dtype,
                             fy_mode=self.fy_mode)
            if mode == "softening" and self.llr_mode == "table":
                nm._ensure_llr_tab()   # before flatten: table-mode consumer
            elif mode == "softening" and self.llr_mode == "poly":
                nm._ensure_llr_poly()
            if mode == "softening" and self.fy_mode == "poly":
                nm._ensure_fy_poly()   # before flatten (lazy leaf)

        sigma_dev = jnp.asarray(sigma, self.dtype)
        alpha_dev = jnp.asarray(alpha, self.dtype)
        key = jax.random.key(seed)

        import time

        compile_s = 0.0
        round_fn = self._round_cache.get(mode)
        if round_fn is None:
            round_fn = self._build_round(mode)
            self._round_cache[mode] = round_fn
            # compile before the clock starts (the jit cache keeps the
            # result): frames_per_s is the steady rate, compile_s its own
            t_c = time.perf_counter()
            round_fn.lower(
                key, jnp.int32(decoder_iterations), nm, sigma_dev, alpha_dev,
            ).compile()
            compile_s = time.perf_counter() - t_c
        err_count = 0
        frame_error_count = 0
        decoding_iterations = 0
        successful_decoding = 0
        frames = 0
        n_rounds = max(1, math.ceil(simulation_loops / self.frames_per_round))

        # Double-buffered rounds: dispatch round r+1 before blocking on
        # round r's counters, overlapping host sync / dispatch latency with
        # device compute.  The early-exit decision therefore lags one round
        # — the batch-granular stopping rule is already a documented
        # statistical deviation from the reference's per-frame exit
        # (reference: sims/reconciliation.pyx:159-161).
        def accumulate(out):
            nonlocal err_count, frame_error_count
            nonlocal decoding_iterations, successful_decoding, frames
            # ONE device->host transfer for all four counters
            errs, ferrs, iters, succ = np.asarray(out)
            err_count += int(errs)
            frame_error_count += int(ferrs)
            decoding_iterations += int(iters)
            successful_decoding += int(succ)
            frames += self.frames_per_round

        t0 = time.perf_counter()
        pending = None
        for r in range(n_rounds):
            out = round_fn(
                jax.random.fold_in(key, r), jnp.int32(decoder_iterations),
                nm, sigma_dev, alpha_dev,
            )
            if pending is not None:
                accumulate(pending)
                if (
                    frame_error_count >= ferr_count_min
                    and frames > simulation_loops / 20
                ):
                    pending = out
                    break
            pending = out
        if pending is not None:
            accumulate(pending)
        elapsed = time.perf_counter() - t0
        if timer is not None:
            timer.append(elapsed)

        return PointResult(
            snr_dB=snr_dB,
            ber=err_count / (frames * self.K),
            fer=frame_error_count / frames,
            iters=(
                0.0
                if successful_decoding == 0
                else decoding_iterations / successful_decoding
            ),
            frames=frames,
            frames_per_s=frames / elapsed if elapsed > 0 else 0.0,
            compile_s=compile_s,
        )

    # ------------------------------------------------------------------ #
    # SNR-point-batched sweep: all points advance in ONE device dispatch.

    def run_sweep_batched(
        self,
        mode: str,
        snr_points,
        decoder_iterations: int,
        simulation_loops: int,
        ferr_count_min: int,
        alpha: float = 1.0,
        nmconfig=None,
        seed: int = 0,
    ) -> list[PointResult]:
        """Run ALL SNR points together, vmapped over the point axis.

        The NoiseMapper's device tables have SNR-independent shapes, so the
        per-point mappers stack into one pytree with a leading point axis and
        the whole sweep becomes ``vmap(round)`` — realizing SURVEY.md §2's
        "SNR-point x frame-shard DP": every dispatch advances every
        unfinished point by one frame batch, amortizing the per-dispatch
        overhead across the grid.

        Early exit is per point: finished points keep computing inside the
        lockstep vmap (bounded waste) but stop accumulating counters.
        Results match ``run_point`` semantics per point (same counters, same
        stopping rule) with decorrelated per-point RNG streams.

        ``frames_per_s`` semantic: every returned PointResult carries the
        *grid-aggregate* throughput (total frames across all points / wall
        time) — the points share every dispatch, so a per-point wall time
        does not exist.  Sequential sweeps report true per-point throughput.
        """
        snr_points = [float(s) for s in snr_points]
        P = len(snr_points)
        Es = self.pa.variance
        N0s = [Es * (10.0 ** (-s / 10.0)) / 2.0 for s in snr_points]

        if mode in ("softening", "hard"):
            cfg = nmconfig if mode == "softening" else None
            nms = [
                NoiseMapper(self.pa, n0, cfg, dtype=self.dtype,
                            fy_mode=self.fy_mode) for n0 in N0s
            ]
            if mode == "softening" and self.llr_mode == "table":
                for m in nms:
                    m._ensure_llr_tab()
            elif mode == "softening" and self.llr_mode == "poly":
                for m in nms:
                    m._ensure_llr_poly()
            if mode == "softening" and self.fy_mode == "poly":
                for m in nms:
                    m._ensure_fy_poly()   # before stacking (lazy leaf)
            nm_stack = jax.tree_util.tree_map(
                lambda *xs: jnp.stack(xs), *nms
            )
        else:
            nm_stack = None
        sigma_vec = jnp.asarray(np.sqrt(N0s), self.dtype)
        alpha_vec = jnp.full(P, alpha, self.dtype)

        cache_key = ("vmap", mode, P)
        vround = self._round_cache.get(cache_key)
        if vround is None:
            base = self._build_round_body(mode)
            vbody = jax.vmap(base, in_axes=(0, None, 0, 0, 0))
            if self.rounds_per_dispatch > 1:
                # scan over sub-rounds OUTSIDE the vmap: per-point keys are
                # re-folded per sub-round inside the scan step
                inner_v = vbody

                def vbody(keys, max_iter, nm_s, sig, alp):
                    def step(acc, r):
                        ks = jax.vmap(
                            lambda k: jax.random.fold_in(k, r)
                        )(keys)
                        out = inner_v(ks, max_iter, nm_s, sig, alp)
                        return acc + out.astype(acc.dtype), None

                    tot, _ = jax.lax.scan(
                        step, jnp.zeros((P, 4), jnp.int32),
                        jnp.arange(self.rounds_per_dispatch),
                    )
                    return tot
            if self.mesh_axis is not None:
                # compose with frame-shard DP: every device runs all P
                # points on decorrelated keys; counters psum over the mesh
                # (so frames_per_round per point stays batch * n_devices).
                mesh, axis = self.mesh_axis
                from jax.sharding import PartitionSpec as _P

                def inner(keys, max_iter, nm_s, sig, alp):
                    keys = jax.vmap(
                        lambda k: jax.random.fold_in(
                            k, jax.lax.axis_index(axis)
                        )
                    )(keys)
                    counters = vbody(keys, max_iter, nm_s, sig, alp)
                    return jax.lax.psum(counters, axis)    # [P, 4]

                vround = jax.jit(jax.shard_map(
                    inner, mesh=mesh, in_specs=_P(), out_specs=_P(),
                    check_vma=False,
                ))
            else:
                vround = jax.jit(vbody)
            self._round_cache[cache_key] = vround

        key = jax.random.key(seed)
        point_keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(
            jnp.arange(P)
        )

        counters = np.zeros((P, 4), np.int64)
        frames = np.zeros(P, np.int64)
        active = np.ones(P, bool)
        n_rounds = max(1, math.ceil(simulation_loops / self.frames_per_round))

        import time

        def accumulate(out):
            nonlocal active
            out_np = np.asarray(out)        # [P, 4], one host transfer
            counters[active] += out_np[active]
            frames[active] += self.frames_per_round
            active = active & ~(
                (counters[:, 1] >= ferr_count_min)
                & (frames > simulation_loops / 20)
            )

        t0 = time.perf_counter()
        # double-buffered rounds (see run_point): dispatch r+1 before
        # blocking on r's counters; per-point early exit lags one round.
        pending = None
        for r in range(n_rounds):
            keys_r = jax.vmap(
                lambda k: jax.random.fold_in(k, r)
            )(point_keys)
            out = vround(
                keys_r, jnp.int32(decoder_iterations), nm_stack, sigma_vec,
                alpha_vec,
            )
            if pending is not None:
                accumulate(pending)
                if not active.any():
                    pending = out
                    break
            pending = out
        if pending is not None:
            accumulate(pending)
        elapsed = time.perf_counter() - t0

        total_fps = (
            float(frames.sum()) / elapsed if elapsed > 0 else 0.0
        )  # aggregate over the whole grid (points share every dispatch)
        results = []
        for p, snr in enumerate(snr_points):
            err, ferr, its, succ = (int(v) for v in counters[p])
            f = int(frames[p])
            results.append(PointResult(
                snr_dB=snr,
                ber=err / (f * self.K),
                fer=ferr / f,
                iters=0.0 if succ == 0 else its / succ,
                frames=f,
                frames_per_s=total_fps,
            ))
        return results


def _decode_inline(dec: Decoder, lappr, synd, max_iterations):
    """Decode [B, N] against [B, C] syndromes inside an outer jit."""
    if dec._decode_jit is None:
        dec._decode_jit = dec._build_decode()
    success, iters, total = dec._decode_jit(
        jnp.asarray(lappr, dec.dtype).T, jnp.asarray(synd).T, max_iterations
    )
    return success, iters, total.T


# --------------------------------------------------------------------- #
# Free-function API mirroring the reference engine signatures
# (reference: sims/reconciliation.pyx:93, 173, 253).

def _mk_engine(dec, mat, pa, **kw):
    return ReconciliationEngine(dec, mat, pa, **kw)


def simulate_softening_snr_dB(
    snr_dB,
    dec,
    mat,
    pa,
    nmconfig,
    decoder_iterations,
    simulation_loops,
    ferr_count_min,
    alpha: float = 1.0,
    **engine_kw,
):
    eng = _mk_engine(dec, mat, pa, **engine_kw)
    return eng.run_point(
        "softening",
        snr_dB,
        decoder_iterations,
        simulation_loops,
        ferr_count_min,
        alpha=alpha,
        nmconfig=nmconfig,
    ).as_tuple()


def simulate_direct_snr_dB(
    snr_dB,
    dec,
    mat,
    pa,
    decoder_iterations,
    simulation_loops,
    ferr_count_min,
    **engine_kw,
):
    eng = _mk_engine(dec, mat, pa, **engine_kw)
    return eng.run_point(
        "direct", snr_dB, decoder_iterations, simulation_loops, ferr_count_min
    ).as_tuple()


def simulate_hard_reverse_snr_dB(
    snr_dB,
    dec,
    mat,
    pa,
    decoder_iterations,
    simulation_loops,
    ferr_count_min,
    **engine_kw,
):
    eng = _mk_engine(dec, mat, pa, **engine_kw)
    return eng.run_point(
        "hard", snr_dB, decoder_iterations, simulation_loops, ferr_count_min
    ).as_tuple()
