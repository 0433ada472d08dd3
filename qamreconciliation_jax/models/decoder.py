"""Syndrome belief-propagation LDPC decoder, batched in JAX.

Re-designs the reference's scalar flooding decoder
(reference: qamreconciliation/decoder.pyx:92-455) as a batched dual-layout
message-passing engine:

* The Tanner graph's jagged ``long**`` adjacency tables
  (reference: qamreconciliation/decoder.pyx:60-89) become **static padded
  dense layouts**: variable-major ``[V, dv_max]`` and check-major
  ``[C, dc_max]`` slot grids plus two flat permutation maps between them.
* Messages are stored as ``[slots, B]`` arrays with the frame batch ``B`` in
  the trailing (contiguous) dimension, so each of the two gathers per BP
  iteration moves whole frame rows — there are **no scatters** in the hot
  loop.
* The check-node update uses the sign/phi sum-product form
  (see ops/boxplus.py), turning the reference's per-node forward/backward
  box-plus scans into one dense masked reduction.
* Iteration control is a ``lax.while_loop`` with a per-frame done mask,
  reproducing the reference's convergence semantics
  (reference: qamreconciliation/decoder.pyx:391-436): ``iters == 0`` and LLR
  passthrough for an already-consistent input, ``success=0`` with
  ``iters == max_iterations`` on failure, final LLRs always produced.
"""

from __future__ import annotations


import numpy as np
import jax
import jax.numpy as jnp

from ..config import DEFAULT_DTYPE, INDEX_DTYPE
from ..ops.boxplus import (
    box_plus, check_node_minsum_sm, check_node_tanhfb_sm,
    check_node_update_sm,
)

__all__ = ["TannerGraph", "Decoder"]


def _slot_positions(ids: np.ndarray) -> np.ndarray:
    """Position of each element within its id-group, in original order.

    For ids = [0,0,1,0,1] returns [0,1,0,2,1].  Matches the reference's
    adjacency construction order: edges appear in each node's table in
    increasing edge-id order (reference: qamreconciliation/decoder.pyx:69-87).
    """
    order = np.argsort(ids, kind="stable")
    sorted_ids = ids[order]
    first_idx = np.concatenate(
        [[0], np.flatnonzero(sorted_ids[1:] != sorted_ids[:-1]) + 1]
    )
    group_first = np.repeat(
        first_idx, np.diff(np.concatenate([first_idx, [sorted_ids.size]]))
    )
    pos_sorted = np.arange(sorted_ids.size) - group_first
    pos = np.empty_like(pos_sorted)
    pos[order] = pos_sorted
    return pos


class TannerGraph:
    """Static dual-layout metadata for one LDPC code.

    Built once per code on the host (numpy); the index arrays are embedded as
    constants into every jitted decode/syndrome function.

    Attributes:
      vnum, cnum, ednum: node/edge counts (``max(id)+1`` inference, matching
        reference: qamreconciliation/matrix.pyx:31-32).
      dv_max, dc_max: maximum node degrees (padding widths).
      c_from_v [C*dc_max]: for each check-major slot, the var-major flat slot
        holding the same edge (padding -> 0, masked).
      v_from_c [V*dv_max]: inverse map (padding -> 0, masked).
      v_mask [V, dv_max], c_mask [C, dc_max]: 1.0 real / 0.0 pad.
      c_vids [C, dc_max]: variable index per check slot (padding -> 0, masked).
      var_slot_of_edge, chk_slot_of_edge [E]: edge-array <-> layout bridges,
        used by the API-parity helpers that speak the reference's
        edge-indexed message format.
    """

    def __init__(self, e_to_v, e_to_c):
        vid = np.asarray(e_to_v, dtype=np.int64).reshape(-1)
        cid = np.asarray(e_to_c, dtype=np.int64).reshape(-1)
        if vid.size != cid.size:
            raise ValueError("Sizes don't match")

        self.ednum = int(vid.size)
        self.vnum = int(vid.max()) + 1
        self.cnum = int(cid.max()) + 1

        v_pos = _slot_positions(vid)
        c_pos = _slot_positions(cid)
        self.dv = np.bincount(vid, minlength=self.vnum)
        self.dc = np.bincount(cid, minlength=self.cnum)
        self.dv_max = int(self.dv.max())
        self.dc_max = int(self.dc.max())

        var_slot = vid * self.dv_max + v_pos   # flat var-major slot per edge
        chk_slot = cid * self.dc_max + c_pos   # flat check-major slot per edge

        c_from_v = np.zeros(self.cnum * self.dc_max, dtype=np.int64)
        c_from_v[chk_slot] = var_slot
        v_from_c = np.zeros(self.vnum * self.dv_max, dtype=np.int64)
        v_from_c[var_slot] = chk_slot

        v_mask = np.zeros(self.vnum * self.dv_max, dtype=np.float64)
        v_mask[var_slot] = 1.0
        c_mask = np.zeros(self.cnum * self.dc_max, dtype=np.float64)
        c_mask[chk_slot] = 1.0

        c_vids = np.zeros(self.cnum * self.dc_max, dtype=np.int64)
        c_vids[chk_slot] = vid

        self.e_to_v = vid
        self.e_to_c = cid
        self.var_slot_of_edge = var_slot
        self.chk_slot_of_edge = chk_slot
        self._c_from_v = jnp.asarray(c_from_v, INDEX_DTYPE)
        self._v_from_c = jnp.asarray(v_from_c, INDEX_DTYPE)
        self._c_vids = jnp.asarray(c_vids, INDEX_DTYPE)
        self._v_mask_np = v_mask.reshape(self.vnum, self.dv_max)
        self._c_mask_np = c_mask.reshape(self.cnum, self.dc_max)

        # Slot-major ("transposed") layouts: [dc_max, C] / [dv_max, V].
        # Keeping the node axis and the frame batch minor — [dc, C, B] —
        # gives every gather a contiguous [B] row per slot; the decode hot
        # loop (see Decoder._build_decode) runs entirely in this layout.
        self._c_vids_T = jnp.asarray(
            np.ascontiguousarray(c_vids.reshape(self.cnum, self.dc_max).T),
            INDEX_DTYPE,
        )
        # flat check-major slot c*dc_max + d  ->  slot-major flat d*C + c
        v_from_c_T = (
            (v_from_c % self.dc_max) * self.cnum + v_from_c // self.dc_max
        )
        self._v_from_c_T = jnp.asarray(
            np.ascontiguousarray(
                v_from_c_T.reshape(self.vnum, self.dv_max).T
            ),
            INDEX_DTYPE,
        )
        self._c_mask_T_np = np.ascontiguousarray(
            c_mask.reshape(self.cnum, self.dc_max).T
        )
        self._v_mask_T_np = np.ascontiguousarray(
            v_mask.reshape(self.vnum, self.dv_max).T
        )

    def _masks(self, dtype_name: str):
        """Device mask pair for a dtype.

        Intentionally NOT cached: under a jit trace ``jnp.asarray`` yields
        trace-local constants, and caching one across traces leaks tracers.
        XLA deduplicates repeated constants, so rebuilding is free.
        """
        dtype = jnp.dtype(dtype_name)
        return (
            jnp.asarray(self._v_mask_np, dtype),
            jnp.asarray(self._c_mask_np, dtype),
        )

    # ------------------------------------------------------------------ #
    # Layout conversions

    def permute_v_to_c(self, flat_v):
        """[V*dv_max, B] var-major -> [C, dc_max, B] check-major."""
        return flat_v[self._c_from_v].reshape(self.cnum, self.dc_max, -1)

    def permute_c_to_v(self, flat_c):
        """[C*dc_max, B] check-major -> [V, dv_max, B] var-major."""
        return flat_c[self._v_from_c].reshape(self.vnum, self.dv_max, -1)

    # ------------------------------------------------------------------ #

    def syndrome_from_bits(self, bits):
        """Syndrome of hard bits: parity over each check's neighborhood.

        bits: [V, B] int32 (0/1) -> [C, B] int32.  Gather + masked popcount
        replaces the reference's XOR scatter over edges
        (reference: qamreconciliation/matrix.pyx:55-60).  Slot-major
        [dc_max, C, B] gather: (C, B) stay the minormost dims.
        """
        mask = jnp.asarray(self._c_mask_T_np, jnp.int32)[:, :, None]
        gathered = bits[self._c_vids_T] * mask        # [dc_max, C, B]
        return gathered.sum(axis=0) & 1

    def lappr_consistent(self, total, synd):
        """Per-frame syndrome test of hard decisions from LLRs.

        bit = 1 iff lappr < 0 (reference: qamreconciliation/decoder.pyx:235-248).
        total: [V, B]; synd: [C, B] -> ok: [B] bool.
        """
        bits = (total < 0).astype(jnp.int32)
        return jnp.all(self.syndrome_from_bits(bits) == synd.astype(jnp.int32), axis=0)


class Decoder:
    """Flooding sum-product syndrome decoder over a :class:`TannerGraph`.

    Constructor signature mirrors the reference
    (``Decoder(e_to_v, e_to_c)``, reference: qamreconciliation/decoder.pyx:93).
    """

    def __init__(self, e_to_v, e_to_c, dtype=DEFAULT_DTYPE,
                 check_rule: str = "sumproduct",
                 check_phi: str = "phi",
                 minsum_alpha: float | None = None,
                 minsum_beta: float = 0.0):
        self.graph = TannerGraph(e_to_v, e_to_c)
        self.dtype = jnp.dtype(dtype)
        # "sumproduct" (exact phi form — the reference's math,
        # qamreconciliation/decoder.pyx:322-369) or "minsum" (normalized
        # min-sum, alpha=13/16 — opt-in extension: transcendental-free
        # check phase at ~0.1 dB waterfall cost)
        if check_rule not in ("sumproduct", "minsum"):
            raise ValueError(f"unknown check_rule {check_rule!r}")
        self.check_rule = check_rule
        # sum-product magnitude implementation: "phi" (reference-
        # comparable, default) or "tanhfb" (tanh-F/B products — same
        # exact box-plus reduction at half the transcendental count;
        # saturation ~16.6 vs ~69; see ops/boxplus.py)
        if check_phi not in ("phi", "tanhfb"):
            raise ValueError(f"unknown check_phi {check_phi!r}")
        self.check_phi = check_phi
        # min-sum magnitude correction (see ops/boxplus.minsum_mag):
        # mag = max(alpha*min - beta, 0); normalized default, offset opt-in
        from ..ops.boxplus import MINSUM_ALPHA as _MSA

        self.minsum_alpha = float(
            _MSA if minsum_alpha is None else minsum_alpha
        )
        self.minsum_beta = float(minsum_beta)
        if self.minsum_beta < 0:
            raise ValueError("minsum_beta must be >= 0")
        self._decode_jit = None

    # Properties: reference qamreconciliation/decoder.pyx:157-172
    @property
    def cnum(self):
        return self.graph.cnum

    @property
    def vnum(self):
        return self.graph.vnum

    @property
    def ednum(self):
        return self.graph.ednum

    # ------------------------------------------------------------------ #
    # Core batched decode

    def _build_decode(self):
        g = self.graph
        dtype = self.dtype
        rule = self.check_rule
        if rule == "sumproduct" and self.check_phi == "tanhfb":
            rule = "tanhfb"

        def decode_batched(prior_vb, synd_cb, max_iterations):
            """prior [V, B], synd [C, B] -> (success [B], iters [B], final [V, B]).

            Two gathers per iteration instead of three: the variable->check
            messages are reconstructed in check-major layout directly as
            ``total[c_vids] - c2v_c`` (numerically identical to permuting the
            var-major extrinsics, since total - c2v is formed from the same
            float pairs), and the syndrome convergence test reuses the same
            gathered totals instead of re-gathering hard bits.

            All message arrays are SLOT-MAJOR — [dc, C, B] / [dv, V, B] —
            so the two minormost dims are always (nodes, frames).
            """
            # created per trace (never cached): safe under nested jit
            v_mask_T = jnp.asarray(g._v_mask_T_np, dtype)      # [dv, V]
            c_mask_T = jnp.asarray(g._c_mask_T_np, dtype)      # [dc, C]
            c_mask_T_i = jnp.asarray(g._c_mask_T_np, jnp.int32)
            synd_cb = synd_cb.astype(jnp.int32)
            B = prior_vb.shape[1]
            prior_vb = prior_vb.astype(dtype)

            def consistent_from_gather(t_d):
                """Per-frame syndrome test from gathered totals t_d [dc, C, B]."""
                bits = (t_d < 0).astype(jnp.int32) * c_mask_T_i[:, :, None]
                parity = jnp.sum(bits, axis=0) & 1
                return jnp.all(parity == synd_cb, axis=0)

            def gather_totals(total):
                return total[g._c_vids_T]                # [dc, C, B]

            def check_phase(t_d, c2v_d):
                """(conv [B], c2v_new)."""
                conv = consistent_from_gather(t_d)
                if rule == "minsum":
                    c2v_new = check_node_minsum_sm(
                        t_d - c2v_d, synd_cb, c_mask_T,
                        alpha=self.minsum_alpha, beta=self.minsum_beta,
                    )
                else:
                    update = ({"tanhfb": check_node_tanhfb_sm}
                              .get(rule, check_node_update_sm))
                    c2v_new = update(t_d - c2v_d, synd_cb, c_mask_T)
                return conv, c2v_new

            def cond(state):
                it, _, _, _, done, _ = state
                return jnp.logical_and(it < max_iterations, ~jnp.all(done))

            def body(state):
                it, c2v_d, total, final, done, iters = state
                t_d = gather_totals(total)                     # gather 1
                # convergence of the CURRENT totals (after iteration `it`):
                # at it=0 this is the reference's pre-check of the priors
                # (reference: qamreconciliation/decoder.pyx:402-405).
                conv, c2v_new = check_phase(t_d, c2v_d)
                newly = jnp.logical_and(conv, ~done)
                iters_new = jnp.where(newly, it, iters)
                done_new = jnp.logical_or(done, conv)
                # Capture-at-convergence instead of freezing the loop state:
                # converged frames keep iterating (lockstep batch — the work
                # is spent either way) but their result is snapshotted HERE,
                # so the reference's stop-at-convergence final LLRs are
                # preserved (reference: qamreconciliation/decoder.pyx:404,
                # 412) without the 3x [C*dc, B] freeze-mask traffic the
                # previous where()-based freeze paid every iteration.  The
                # cond skips the [V, B] snapshot whenever no frame newly
                # converged (the common case below the decoding threshold).
                final_new = jax.lax.cond(
                    jnp.any(newly),
                    lambda f: jnp.where(newly[None, :], total, f),
                    lambda f: f,
                    final,
                )

                # gather 2: slot-major check flat [dc*C, B] -> [dv, V, B].
                # Accumulate in f32 and round ONCE to the storage dtype
                # (bf16 left-fold sums round every add; upcast-sum-round-
                # once is strictly more accurate at identical memory traffic).
                sum_dtype = (
                    jnp.float64 if dtype == jnp.float64 else jnp.float32
                )
                c2v_v = c2v_new.reshape(-1, B)[g._v_from_c_T].astype(
                    sum_dtype
                )
                total_new = (
                    prior_vb.astype(sum_dtype) + jnp.sum(
                        c2v_v * v_mask_T.astype(sum_dtype)[:, :, None],
                        axis=0,
                    )
                ).astype(dtype)
                return (
                    it + 1, c2v_new, total_new, final_new, done_new, iters_new
                )

            init = (
                jnp.int32(0),
                jnp.zeros((g.dc_max, g.cnum, B), dtype),
                prior_vb,
                prior_vb,
                jnp.zeros(B, bool),
                jnp.zeros(B, jnp.int32),
            )
            it, _, total, final, done, iters = jax.lax.while_loop(
                cond, body, init
            )
            # frames that converged exactly at the final allowed iteration
            # exit the loop untested — one final syndrome test covers them.
            conv = consistent_from_gather(gather_totals(total))
            newly = jnp.logical_and(conv, ~done)
            iters = jnp.where(newly, jnp.minimum(it, max_iterations), iters)
            final = jnp.where(newly[None, :], total, final)
            done = jnp.logical_or(done, conv)
            iters = jnp.where(done, iters, max_iterations)
            # failures: final LLRs = the totals at max_iterations
            # (reference: decoder.pyx:436 — final always written)
            final = jnp.where(done[None, :], final, total)
            return done, iters, final

        return jax.jit(decode_batched)

    def decode_batch(self, lappr, synd, max_iterations: int):
        """Decode a batch: lappr [B, V], synd [B, C] -> (success [B], iters [B], final [B, V])."""
        if self._decode_jit is None:
            self._decode_jit = self._build_decode()
        lappr = jnp.asarray(lappr, self.dtype)
        synd = jnp.asarray(synd)
        success, iters, total = self._decode_jit(
            lappr.T, synd.T, jnp.int32(max_iterations)
        )
        return success, iters, total.T

    def decode(self, lappr_data, synd, max_iterations: int):
        """Single-frame API-parity wrapper.

        Returns ``(success, iters, final_lappr)`` exactly as the reference
        (reference: qamreconciliation/decoder.pyx:441-455).
        """
        lappr = jnp.asarray(lappr_data, self.dtype)[None, :]
        synd = jnp.asarray(synd)[None, :]
        success, iters, final = self.decode_batch(lappr, synd, max_iterations)
        return bool(success[0]), int(iters[0]), np.asarray(final[0])

    # ------------------------------------------------------------------ #
    # API-parity check / single-node helpers (test tier; functional style)

    def check_synd_node(self, check_node_index, word, synd) -> bool:
        """Parity test of one check node (reference: decoder.pyx:177-209)."""
        g = self.graph
        word = np.asarray(word).astype(np.int64)
        if word.size != g.vnum:
            raise ValueError("Size of word does not match number of vnodes")
        synd = np.asarray(synd).astype(np.int64)
        if synd.size != g.cnum:
            raise ValueError("Size of synd does not match number of cnodes")
        members = g.e_to_v[g.e_to_c == check_node_index]
        return bool((word[members].sum() + synd[check_node_index]) % 2 == 0)

    def check_word(self, word, synd) -> bool:
        """All-checks parity test (reference: decoder.pyx:212-232)."""
        word = jnp.asarray(np.asarray(word).astype(np.int64))[:, None]
        synd_hat = self.graph.syndrome_from_bits(word.astype(jnp.int32))
        return bool(
            jnp.all(synd_hat[:, 0] == jnp.asarray(np.asarray(synd).astype(np.int32)))
        )

    def check_lappr(self, lappr, synd) -> bool:
        """Syndrome test of LLR hard decisions (reference: decoder.pyx:260-281)."""
        lappr = np.asarray(lappr, dtype=np.float64)
        if lappr.size != self.graph.vnum:
            raise ValueError("Size of lappr does not match number of vnodes")
        synd = np.asarray(synd).astype(np.int64)
        if synd.size != self.graph.cnum:
            raise ValueError("Size of synd does not match number of cnodes")
        total = jnp.asarray(lappr)[:, None]
        return bool(
            self.graph.lappr_consistent(total, jnp.asarray(synd)[:, None])[0]
        )

    def process_var_node(self, node_index, lappr_data, check_to_var, var_to_check, updated_lappr):
        """Single variable-node update in the reference's edge-indexed format.

        Functional twist on reference: qamreconciliation/decoder.pyx:285-298 —
        returns updated copies of (var_to_check, updated_lappr) instead of
        mutating.
        """
        g = self.graph
        check_to_var = np.asarray(check_to_var, np.float64)
        var_to_check = np.array(var_to_check, np.float64, copy=True)
        updated_lappr = np.array(updated_lappr, np.float64, copy=True)
        edges = np.flatnonzero(g.e_to_v == node_index)
        total = float(np.asarray(lappr_data)[node_index]) + check_to_var[edges].sum()
        updated_lappr[node_index] = total
        var_to_check[edges] = total - check_to_var[edges]
        return var_to_check, updated_lappr

    def process_check_node(self, node_index, synd, check_to_var, var_to_check):
        """Single check-node update in the reference's edge-indexed format.

        Functional version of reference: qamreconciliation/decoder.pyx:322-369
        (exact box-plus prefix logic, applied pairwise).
        """
        g = self.graph
        check_to_var = np.array(check_to_var, np.float64, copy=True)
        var_to_check = np.asarray(var_to_check, np.float64)
        synd = np.asarray(synd).astype(np.int64)
        edges = np.flatnonzero(g.e_to_c == node_index)
        msgs = var_to_check[edges]
        pref = -1.0 if synd[node_index] else 1.0
        for pos, e in enumerate(edges):
            others = np.delete(msgs, pos)
            acc = others[0]
            for m in others[1:]:
                acc = float(box_plus(jnp.float64(acc), jnp.float64(m)))
            check_to_var[e] = pref * acc
        return check_to_var
