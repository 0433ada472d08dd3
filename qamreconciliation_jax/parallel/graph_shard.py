"""Graph-sharded BP decoding: the Tanner graph partitioned across a mesh.

SURVEY.md §2's "graph sharding" plan: for codes too large for one device, the
graph itself is split over devices while frames stay whole.  Two shardings:

* :class:`ShardedDecoder` — generic edge-list codes: CHECK nodes are
  partitioned into contiguous blocks, one per device.  Variable totals stay
  replicated; each device runs the check-node update for its block and
  contributes its block's check->variable partial sums, reduced with one
  ``psum`` across the mesh per iteration (no point-to-point halo needed
  because totals are replicated).  Per-device message arrays are
  SLOT-MAJOR ``[dc, Cd, B]`` — the layout of models/decoder.py.

* :class:`ShardedQCDecoder` — quasi-cyclic codes: the CIRCULANT LANE axis z
  is sharded over the mesh (GSPMD: ``with_sharding_constraint`` on the
  dense roll decoder's state), so every circulant ``jnp.roll`` becomes a
  static slice pair whose shard-boundary halos XLA moves with
  collective-permutes between devices — rolls, not gathers, exactly like the
  single-chip QC path (models/qc_decoder._build_dense).

The arithmetic is the same flooding schedule as the single-device decoders
(reference semantics: qamreconciliation/decoder.pyx:391-436); only the
summation order of the variable update differs (per-device partial sums),
so results agree with the single-device decoder to float rounding — and
exactly when per-device sub-sums see the same operand order (asserted in
tests/test_graph_shard.py).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import DEFAULT_DTYPE, INDEX_DTYPE
from ..models.decoder import TannerGraph
from ..models.qc_decoder import QCDecoder
from ..ops.boxplus import (
    check_node_minsum_sm, check_node_tanhfb_sm, check_node_update_sm,
)

__all__ = ["ShardedDecoder", "ShardedQCDecoder"]


class ShardedDecoder:
    """Check-sharded flooding decoder over a 1-D mesh (slot-major blocks).

    Args:
      e_to_v, e_to_c: edge lists (same contract as Decoder).
      mesh: 1-D ``jax.sharding.Mesh`` whose single axis carries the shards.
      dtype: message dtype.
      check_rule: "sumproduct" (reference math) | "minsum" (normalized/
        offset min-sum — full ``minsum_alpha``/``minsum_beta`` tuning
        surface, same as the single-device decoders).
      check_phi: sum-product magnitude implementation, "phi" | "tanhfb".
    """

    def __init__(self, e_to_v, e_to_c, mesh: Mesh, dtype=DEFAULT_DTYPE,
                 check_rule: str = "sumproduct", check_phi: str = "phi",
                 minsum_alpha: float | None = None,
                 minsum_beta: float = 0.0):
        if len(mesh.axis_names) != 1:
            raise ValueError("ShardedDecoder expects a 1-D mesh")
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.n_dev = mesh.devices.size
        self.dtype = jnp.dtype(dtype)
        if check_rule not in ("sumproduct", "minsum"):
            raise ValueError(f"unknown check_rule {check_rule!r}")
        self.check_rule = check_rule
        if check_phi not in ("phi", "tanhfb"):
            raise ValueError(f"unknown check_phi {check_phi!r}")
        self.check_phi = check_phi
        from ..ops.boxplus import MINSUM_ALPHA as _MSA

        self.minsum_alpha = float(
            _MSA if minsum_alpha is None else minsum_alpha
        )
        self.minsum_beta = float(minsum_beta)
        if self.minsum_beta < 0:
            raise ValueError("minsum_beta must be >= 0")

        g = TannerGraph(e_to_v, e_to_c)
        self.graph = g
        self.vnum, self.cnum, self.ednum = g.vnum, g.cnum, g.ednum

        D = self.n_dev
        C_pad = ((g.cnum + D - 1) // D) * D
        self.c_per_dev = Cd = C_pad // D
        dc, dv = g.dc_max, g.dv_max

        # Per-device SLOT-MAJOR check metadata [D, dc, Cd] (shard_map slices
        # the leading axis, so these ship as [D*dc, Cd]).
        c_vids = np.zeros((C_pad, dc), np.int64)
        c_mask = np.zeros((C_pad, dc), np.float64)
        c_vids[: g.cnum] = np.asarray(g._c_vids).reshape(g.cnum, dc)
        c_mask[: g.cnum] = g._c_mask_np
        self._c_vids_T_sh = np.ascontiguousarray(
            c_vids.reshape(D, Cd, dc).transpose(0, 2, 1)
        ).reshape(D * dc, Cd)
        self._c_mask_T_sh = np.ascontiguousarray(
            c_mask.reshape(D, Cd, dc).transpose(0, 2, 1)
        ).reshape(D * dc, Cd)

        # Per-device var-major -> LOCAL slot-major map: variable slot
        # (v, dv_slot) -> d*Cd + c_local of the same edge on that device,
        # or the local dummy slot (dc*Cd, always masked) — slot-major twin
        # of TannerGraph._v_from_c_T.
        chk_slot = g.chk_slot_of_edge          # global check-flat slot c*dc+d
        var_slot = g.var_slot_of_edge
        c_of_edge = chk_slot // dc
        d_of_edge = chk_slot % dc
        dev_of_edge = c_of_edge // Cd
        local_sm = d_of_edge * Cd + (c_of_edge - dev_of_edge * Cd)
        dummy = dc * Cd
        v_from_c = np.full((D, g.vnum * dv), dummy, np.int64)
        v_valid = np.zeros((D, g.vnum * dv), np.float64)
        v_from_c[dev_of_edge, var_slot] = local_sm
        v_valid[dev_of_edge, var_slot] = 1.0
        # [D, V, dv] -> slot-major [D, dv, V], shipped as [D*dv, V]
        self._v_from_c_T_sh = np.ascontiguousarray(
            v_from_c.reshape(D, g.vnum, dv).transpose(0, 2, 1)
        ).reshape(D * dv, g.vnum)
        self._v_valid_T_sh = np.ascontiguousarray(
            v_valid.reshape(D, g.vnum, dv).transpose(0, 2, 1)
        ).reshape(D * dv, g.vnum)

        self._decode_jit = None

    # ------------------------------------------------------------------ #

    def _build_decode(self):
        """Engine duck-type contract (same as Decoder._build_decode /
        QCDecoder._build_decode): returns the jitted
        ``(prior [V, B], synd [C, B], max_iter) -> (success, iters, total)``
        function, so a ShardedDecoder drops into ReconciliationEngine and
        sharded *sweeps* run end-to-end (the reference's flagship loop,
        reference: sims/reconciliation.pyx:93-168, under graph sharding)."""
        return self._build()

    def _build(self):
        g = self.graph
        dtype = self.dtype
        D, dc, dv = self.n_dev, g.dc_max, g.dv_max
        Cd = self.c_per_dev
        axis = self.axis
        rule = self.check_rule
        if rule == "sumproduct" and self.check_phi == "tanhfb":
            rule = "tanhfb"

        c_vids_sh = jnp.asarray(self._c_vids_T_sh, INDEX_DTYPE)
        c_mask_sh = jnp.asarray(self._c_mask_T_sh, dtype)
        c_mask_i_sh = jnp.asarray(self._c_mask_T_sh != 0, jnp.int32)
        v_from_c_sh = jnp.asarray(self._v_from_c_T_sh, INDEX_DTYPE)
        v_valid_sh = jnp.asarray(self._v_valid_T_sh, dtype)

        def check_update(v2c_d, synd, c_mask_T):
            if rule == "minsum":
                return check_node_minsum_sm(
                    v2c_d, synd, c_mask_T,
                    alpha=self.minsum_alpha, beta=self.minsum_beta,
                )
            if rule == "tanhfb":
                return check_node_tanhfb_sm(v2c_d, synd, c_mask_T)
            return check_node_update_sm(v2c_d, synd, c_mask_T)

        def local_decode(c_vids_T, c_mask_T, c_mask_T_i, v_from_c_T,
                         v_valid_T, prior, synd, max_iterations):
            """Runs on ONE device inside shard_map.

            c_vids_T/c_mask_T [dc, Cd]; v_from_c_T/v_valid_T [dv, V];
            prior [V, B] replicated; synd [Cd, B] this device's syndrome
            block; returns (success [B], iters [B], total [V, B]).
            """
            B = prior.shape[1]
            synd = synd.astype(jnp.int32)

            def consistent(t_d):
                bits = (t_d < 0).astype(jnp.int32) * c_mask_T_i[:, :, None]
                parity = jnp.sum(bits, axis=0) & 1
                viol = jnp.sum((parity != synd).astype(jnp.int32), axis=0)
                return jax.lax.psum(viol, axis) == 0          # [B] bool

            def gather_totals(total):
                return total[c_vids_T]                        # [dc, Cd, B]

            sum_dtype = (
                jnp.float64 if dtype == jnp.float64 else jnp.float32
            )

            def var_partial(c2v_d):
                """This device's contribution to the total sums [V, B]
                (sum_dtype: f32-accumulate, round once after the psum —
                mirrors models/decoder.py's variable update)."""
                padded = jnp.concatenate(
                    [c2v_d.reshape(-1, B), jnp.zeros((1, B), dtype)], axis=0
                ).astype(sum_dtype)
                c2v_v = padded[v_from_c_T]                    # [dv, V, B]
                return jnp.sum(
                    c2v_v * v_valid_T.astype(sum_dtype)[:, :, None], axis=0
                )

            def cond(state):
                it, _, _, _, done, _ = state
                return jnp.logical_and(it < max_iterations, ~jnp.all(done))

            def body(state):
                it, c2v_d, total, final, done, iters = state
                t_d = gather_totals(total)
                conv = consistent(t_d)
                newly = jnp.logical_and(conv, ~done)
                iters_new = jnp.where(newly, it, iters)
                done_new = jnp.logical_or(done, conv)
                # capture-at-convergence (see models/decoder.py): snapshot
                # instead of freezing; skips the [V, B] copy when nothing
                # newly converged.
                final_new = jax.lax.cond(
                    jnp.any(newly),
                    lambda f: jnp.where(newly[None, :], total, f),
                    lambda f: f,
                    final,
                )

                c2v_new = check_update(t_d - c2v_d, synd, c_mask_T)
                total_new = (
                    prior.astype(sum_dtype)
                    + jax.lax.psum(var_partial(c2v_new), axis)
                ).astype(dtype)
                return (
                    it + 1, c2v_new, total_new, final_new, done_new, iters_new
                )

            init = (
                jnp.int32(0),
                jnp.zeros((dc, Cd, B), dtype),
                prior.astype(dtype),
                prior.astype(dtype),
                jnp.zeros(B, bool),
                jnp.zeros(B, jnp.int32),
            )
            it, _, total, final, done, iters = jax.lax.while_loop(
                cond, body, init
            )
            conv = consistent(gather_totals(total))
            newly = jnp.logical_and(conv, ~done)
            iters = jnp.where(newly, jnp.minimum(it, max_iterations), iters)
            final = jnp.where(newly[None, :], total, final)
            done = jnp.logical_or(done, conv)
            iters = jnp.where(done, iters, max_iterations)
            final = jnp.where(done[None, :], final, total)
            return done, iters, final

        mapped = jax.shard_map(
            local_decode,
            mesh=self.mesh,
            in_specs=(
                P(axis), P(axis), P(axis), P(axis), P(axis),
                P(), P(axis), P(),
            ),
            out_specs=P(),
            check_vma=False,
        )

        def decode_batched(prior_vb, synd_cb, max_iterations):
            # pad the syndrome to the sharded check count
            pad = D * Cd - g.cnum
            synd_p = jnp.concatenate(
                [synd_cb.astype(jnp.int32),
                 jnp.zeros((pad, synd_cb.shape[1]), jnp.int32)], axis=0
            )
            return mapped(
                c_vids_sh, c_mask_sh, c_mask_i_sh, v_from_c_sh, v_valid_sh,
                prior_vb, synd_p, max_iterations,
            )

        return jax.jit(decode_batched)

    def decode_batch(self, lappr, synd, max_iterations: int):
        """lappr [B, V], synd [B, C] -> (success [B], iters [B], final [B, V])."""
        if self._decode_jit is None:
            self._decode_jit = self._build()
        lappr = jnp.asarray(lappr, self.dtype)
        synd = jnp.asarray(synd)
        success, iters, total = self._decode_jit(
            lappr.T, synd.T, jnp.int32(max_iterations)
        )
        return success, iters, total.T


class ShardedQCDecoder(QCDecoder):
    """Quasi-cyclic graph sharding: the circulant lane axis z over the mesh.

    The single-chip QC decoder's whole advantage is that its "gathers" are
    circulant rolls — static slice pairs (models/qc_decoder._build_dense).
    Sharding the z axis keeps that: each device holds ``z / n_dev`` lanes
    of EVERY block's totals/messages, the per-block arithmetic is purely
    local, and each roll's shard-boundary halo is a collective-permute XLA
    inserts from the ``with_sharding_constraint`` annotations (GSPMD) —
    rolls become neighbour exchanges instead of degrading to gathers.  Frames stay whole;
    counters/finals come back replicated.

    Dense flooding only (layered's serial .at updates don't shard).  Decode results
    match the single-device QCDecoder BIT-EXACTLY: sharding annotations
    change data placement, not arithmetic or reduction order.
    """

    def __init__(self, base_edges, z: int, mesh: Mesh, **kw):
        if len(mesh.axis_names) != 1:
            raise ValueError("ShardedQCDecoder expects a 1-D mesh")
        D = mesh.devices.size
        if z % D:
            raise ValueError(f"z={z} must be divisible by the mesh size {D}")
        if kw.get("schedule", "flooding") != "flooding":
            raise ValueError("ShardedQCDecoder supports only the flooding "
                             "schedule")
        if kw.get("compressed"):
            raise ValueError("ShardedQCDecoder is incompatible with "
                             "compressed=True")
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        super().__init__(base_edges, z, **kw)

    # GSPMD cannot partition the fused check-phase kernel: the XLA check
    # phase is the sharded path
    _fused_check_ok = False

    # sharding hooks consumed by QCDecoder._build_dense
    def _constrain_vz(self, x):      # [nb_v, z, B]
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(self.mesh, P(None, self.axis, None))
        )

    def _constrain_cz(self, x):      # [nb_c, z, B]
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(self.mesh, P(None, self.axis, None))
        )

    def _constrain_msg(self, x):     # [nb_c, dc, z, B]
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(self.mesh, P(None, None, self.axis, None))
        )
