"""Quasi-cyclic LDPC decoder: circulant structure instead of gathers.

Practical LDPC standards (DVB-S2, 5G NR, 802.11) are quasi-cyclic: the
parity-check matrix is a grid of z x z circulant permutations.  The generic
:class:`~qamreconciliation_jax.models.decoder.Decoder` treats any Tanner
graph as unstructured gather metadata; for QC codes the two per-iteration
[E, B]-row gathers (the decode bottleneck at DVB-S2
scale) collapse into per-base-edge ``jnp.roll`` ops on contiguous
[z, B] slabs — pure sliced copies that move at memory bandwidth.

Same flooding sum-product schedule and (success, iters, final) semantics as
the generic decoder (reference: qamreconciliation/decoder.pyx:391-436);
message values are identical up to float summation order.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..config import DEFAULT_DTYPE
from ..ops.boxplus import (
    MINSUM_ALPHA, minsum_extrinsic_mag, minsum_mag, phi_llr,
    stochastic_round_bf16, tanhfb_extrinsic_mag,
)

__all__ = ["QCDecoder", "detect_qc", "make_qc_ldpc", "make_qc_ira",
           "save_qc_csv", "load_qc_csv", "check_phase_xla", "fused_check_phase",
           "qc_check_update", "qc_consistent"]


def make_qc_ldpc(nb_v: int, z: int, dv: int = 3, dc: int = 6, seed: int = 0):
    """Random (dv, dc)-regular quasi-cyclic LDPC code.

    The base graph is a (dv, dc)-regular bipartite configuration model on
    ``nb_v`` variable blocks and ``nb_v * dv / dc`` check blocks; every base
    edge carries a uniform circulant shift in [0, z).  N = nb_v * z.

    Returns ``(base_edges, vid, cid)``: the base-edge list
    ``[(check_block, var_block, shift), ...]`` for :class:`QCDecoder` and the
    expanded edge list for the generic Decoder/Matrix (edge between variable
    ``vb*z + k`` and check ``cb*z + ((k + shift) % z)`` for every k).
    """
    if (nb_v * dv) % dc != 0:
        raise ValueError("nb_v*dv must be divisible by dc")
    nb_c = nb_v * dv // dc
    rng = np.random.default_rng(seed)
    # configuration model on the base graph, repaired to avoid duplicate
    # (check_block, var_block, shift) triples (parallel circulants with the
    # same shift would cancel)
    vb = np.repeat(np.arange(nb_v), dv)
    cb = np.repeat(np.arange(nb_c), dc)
    vb = vb[rng.permutation(vb.size)]
    shifts = rng.integers(0, z, vb.size)
    for _ in range(1000):
        key = (cb.astype(np.int64) * nb_v + vb) * z + shifts
        _, first = np.unique(key, return_index=True)
        dup = np.ones(key.size, bool)
        dup[first] = False
        if not dup.any():
            break
        shifts[dup] = rng.integers(0, z, int(dup.sum()))
    else:
        raise RuntimeError(
            "could not avoid duplicate circulants (parallel base edges with "
            "equal shifts cancel mod 2); increase z or reduce dv/dc"
        )
    base_edges = [(int(c), int(v), int(s)) for c, v, s in zip(cb, vb, shifts)]

    k = np.arange(z)
    vid = np.concatenate([v * z + k for (_, v, _) in base_edges])
    cid = np.concatenate([c * z + (k + s) % z for (c, _, s) in base_edges])
    return base_edges, vid, cid


def make_qc_ira(nb_info: int, nb_acc: int, z: int, dv: int = 3,
                seed: int = 0):
    """Irregular QC-IRA code: config-model information part + circulant
    accumulator — the structure class of the reference's flagship codes
    (IRA-style DVB-S2 LDPC, reference: sims/display_biawgn.py:30-35; the
    reference's jagged-table decoder consumes them without special cases,
    qamreconciliation/decoder.pyx:60-89).

    Layout: ``nb_info`` information variable blocks each of degree ``dv``
    (uniform-shift circulants onto random check blocks, duplicate-repaired
    like :func:`make_qc_ldpc`) + ``nb_acc`` parity variable blocks in a
    circulant staircase: check block i carries ``I + P^1`` on parity block
    i (two base edges in one cell, shifts {0, 1}) and ``I`` on parity
    block i-1.  Check-block degrees are therefore IRREGULAR — roughly
    ``nb_info*dv/nb_acc + 3`` with the config-model spread and a lighter
    first row.  N = (nb_info + nb_acc) * z, rate = nb_info / (nb_info +
    nb_acc).

    Returns ``(base_edges, vid, cid)`` in :func:`make_qc_ldpc`'s
    convention.
    """
    if nb_acc < 2:
        raise ValueError("need nb_acc >= 2 for a staircase accumulator")
    rng = np.random.default_rng(seed)
    vb = np.repeat(np.arange(nb_info), dv)
    vb = vb[rng.permutation(vb.size)]
    cb = rng.integers(0, nb_acc, vb.size)
    shifts = rng.integers(0, z, vb.size)
    for _ in range(1000):
        key = (cb.astype(np.int64) * nb_info + vb) * z + shifts
        _, first = np.unique(key, return_index=True)
        dup = np.ones(key.size, bool)
        dup[first] = False
        if not dup.any():
            break
        shifts[dup] = rng.integers(0, z, int(dup.sum()))
        cb[dup] = rng.integers(0, nb_acc, int(dup.sum()))
    else:
        raise RuntimeError("could not avoid duplicate circulants")
    base_edges = [(int(c), int(v), int(s)) for c, v, s in zip(cb, vb, shifts)]
    # circulant staircase accumulator on parity blocks nb_info..nb_info+nb_acc
    for i in range(nb_acc):
        p = nb_info + i
        base_edges.append((i, p, 0))
        base_edges.append((i, p, 1))          # I + P^1 cell
        if i > 0:
            base_edges.append((i, nb_info + i - 1, 0))
    base_edges.sort()

    k = np.arange(z)
    vid = np.concatenate([v * z + k for (_, v, _) in base_edges])
    cid = np.concatenate([c * z + (k + s) % z for (c, _, s) in base_edges])
    return base_edges, vid, cid


def color_disjoint_rows(rows):
    """Greedy first-fit coloring of check-block rows: rows sharing a
    VARIABLE block get different colors, so all rows of one color touch
    pairwise-disjoint variable blocks.

    Disjoint rows' layered updates commute EXACTLY — row A's totals
    writes never feed row B's gather — so processing a color as one
    batched layer is bit-identical to processing its rows serially (in
    any order), and a grouped sweep equals a serial sweep under the
    group-major row order.  Used by the layered schedule to cut the
    per-sweep serial depth from nb_c to the color count (~dv*dc_max at
    configuration-model densities; 90 -> ~15 on the z=360 DVB-S2-shape
    code).

    Returns a list of colors, each a list of row indices (ascending).
    """
    colors = []          # [(touched_vb_set, [row_idx, ...]), ...]
    for cb, row in enumerate(rows):
        vbs = {v for (v, _) in row}
        for used, members in colors:
            if not (used & vbs):
                used |= vbs
                members.append(cb)
                break
        else:
            colors.append((set(vbs), [cb]))
    return [members for _, members in colors]


def layered_plan(rows):
    """(degree, [row_idx...]) batches for the grouped layered sweep:
    :func:`color_disjoint_rows` colors split by row degree so every
    batch stacks rectangularly.  The concatenation of the batches IS the
    equivalent serial row order (grouped == serial under it, exactly —
    see color_disjoint_rows)."""
    plan = []
    for members in color_disjoint_rows(rows):
        by_deg = {}
        for cb in members:
            by_deg.setdefault(len(rows[cb]), []).append(cb)
        for dcr, cbs in sorted(by_deg.items()):
            plan.append((dcr, cbs))
    return plan


def fused_check_phase(platform: str) -> bool:
    """Whether the dense flooding loop runs the fused check-phase kernel
    (ops/pallas_kernels.bp_check_phase_qc) on ``platform``.  The kernel is
    compiled for NVIDIA GPUs through Triton; every other platform runs the
    XLA check phase (:func:`check_phase_xla`)."""
    return platform == "gpu"


def qc_consistent(t, synd):
    """Per-frame syndrome test on gathered totals: t [nb_c, dc, z, B],
    synd [nb_c, z, B] -> [B] bool (reference: decoder.pyx:251-257).  The
    +BIG sentinel of padded slots is positive, so it never flips parity."""
    parity = jnp.sum((t < 0).astype(jnp.int32), axis=1) & 1
    return jnp.all((parity == synd).reshape(-1, t.shape[-1]), axis=0)


def qc_check_update(v2c, synd, rule: str = "sumproduct",
                    ms_alpha: float = MINSUM_ALPHA, ms_beta: float = 0.0,
                    tiny: float = 1e-30):
    """Check update in the native [nb_c, dc, z, B] layout (padded slots of
    irregular rows carry the +BIG neutral sentinel) with the syndrome
    prefactor, reducing over the slot axis: ``rule`` "sumproduct" (sign/phi
    form, same math as ops.boxplus.check_node_update), "tanhfb" (tanh
    forward/backward form) or "minsum" (normalized/offset min-sum).
    Reference semantics: qamreconciliation/decoder.pyx:322-369.
    """
    if rule == "minsum":
        mag = minsum_mag(minsum_extrinsic_mag(jnp.abs(v2c), 1),
                         ms_alpha, ms_beta)
    elif rule == "tanhfb":
        mag = tanhfb_extrinsic_mag(jnp.abs(v2c), 1)
    else:
        phim = phi_llr(jnp.abs(v2c), tiny)
        s_phi = jnp.sum(phim, axis=1, keepdims=True)
        mag = phi_llr(s_phi - phim, tiny)
    neg = (v2c < 0).astype(jnp.int32)
    parity = jnp.sum(neg, axis=1, keepdims=True) & 1
    sign = (1 - 2 * jnp.bitwise_xor(parity, neg)).astype(v2c.dtype)
    pref = (1 - 2 * synd.astype(jnp.int32)).astype(v2c.dtype)[:, None]
    return sign * pref * mag


def check_phase_xla(t, c2v, synd, rule: str = "sumproduct",
                    ms_alpha: float = MINSUM_ALPHA, ms_beta: float = 0.0,
                    rbits=None):
    """The dense flooding check phase in plain XLA ops.

    t [nb_c, dc, z, B] gathered totals, c2v the previous messages (their
    dtype is the message storage dtype), synd [nb_c, z, B].  Returns
    ``(converged [B], c2v_new)``.  ``v2c = t - c2v`` and the magnitude math
    run in float32 (float64 for float64 operands); with ``rbits`` the bf16
    message store is stochastically rounded (the sr_messages experiment).
    The fused kernel ops/pallas_kernels.bp_check_phase_qc has the same
    contract.
    """
    compute = (jnp.float64 if jnp.float64 in (t.dtype, c2v.dtype)
               else jnp.float32)
    out = qc_check_update(
        t.astype(compute) - c2v.astype(compute), synd, rule=rule,
        ms_alpha=ms_alpha, ms_beta=ms_beta,
    )
    if rbits is not None:
        out = stochastic_round_bf16(out.astype(jnp.float32), rbits)
    return qc_consistent(t, synd), out.astype(c2v.dtype)


class QCDecoder:
    """Flooding sum-product syndrome decoder over a quasi-cyclic graph.

    Args:
      base_edges: ``[(check_block, var_block, shift), ...]``.  Check-block
        degrees may DIFFER (irregular codes — the regime of real standards
        like the IRA-style DVB-S2 family; the reference's jagged decoder
        is irregular by construction, reference:
        qamreconciliation/decoder.pyx:60-89): short rows pad to the max
        degree with a neutral sentinel in the dense path and unroll at
        their own degree in the layered path.  Parallel
        circulants (two base edges in the same (cb, vb) cell with
        different shifts — e.g. the I + P accumulator cells of QC-IRA
        codes) are supported.
      z: circulant size.
      dtype: message dtype.

    Variable/check ids follow the expansion of :func:`make_qc_ldpc`:
    variable ``vb*z + k`` ↔ check ``cb*z + ((k + shift) % z)``.
    """

    def __init__(self, base_edges, z: int, dtype=DEFAULT_DTYPE,
                 check_rule: str = "sumproduct",
                 compressed: bool | None = None,
                 schedule: str = "flooding",
                 layered_chunk: int = 4,
                 layered_groups: bool | None = None,
                 totals_dtype: str = "storage",
                 check_phi: str = "phi",
                 minsum_alpha: float | None = None,
                 minsum_beta: float = 0.0,
                 sr_messages: bool = False):
        self.z = int(z)
        self.dtype = jnp.dtype(dtype)
        # "sumproduct" (reference math) | "minsum" (normalized min-sum,
        # opt-in extension — see models/decoder.py)
        if check_rule not in ("sumproduct", "minsum"):
            raise ValueError(f"unknown check_rule {check_rule!r}")
        self.check_rule = check_rule
        # compressed-state min-sum loop (see _build_compressed): opt-in
        # (None/False = dense).  Bit-identical to the dense min-sum path;
        # it trades ~2x less state traffic for ~3x the elementwise work of
        # reconstructing and repacking messages (see DESIGN.md).  Its speed
        # on the GPU is not measured.
        self.compressed = compressed
        # "flooding" (the reference's schedule, decoder.pyx:424-433) |
        # "layered" (row-layered / serial-C over check blocks — an
        # extension: converges in roughly half the sweeps for the same
        # quality, see _build_layered)
        if schedule not in ("flooding", "layered"):
            raise ValueError(f"unknown schedule {schedule!r}")
        if schedule == "layered" and compressed:
            raise ValueError("compressed=True supports only the flooding "
                             "schedule")
        self.schedule = schedule
        # sweeps per while-loop iteration in the layered schedule (each
        # data-dependent while cond is a device sync; K sweeps per
        # iteration amortize it K-fold at the price of up to K-1 lockstep
        # overrun sweeps per frame)
        if int(layered_chunk) < 1:
            raise ValueError("layered_chunk must be >= 1")
        self.layered_chunk = int(layered_chunk)
        # layered schedule only: process VARIABLE-DISJOINT check rows as
        # one batched layer (color_disjoint_rows) — bit-equivalent to a
        # reordered serial sweep, at color-count serial depth instead of
        # nb_c.  None = auto: on when nb_c >= 32 (the z=360 many-row
        # regime, where a serial sweep is a long chain of small ops);
        # few-row codes stay serial.
        self.layered_groups = layered_groups
        # running-totals dtype: "storage" (totals at the message dtype) or
        # "float32" (the knee-quality hybrid: totals and their
        # accumulation in f32 while messages are stored at the storage
        # width).  The
        # layered schedule always uses f32 totals (incremental updates).
        if totals_dtype not in ("storage", "float32"):
            raise ValueError(f"unknown totals_dtype {totals_dtype!r}")
        self.totals_dtype = totals_dtype
        # sum-product magnitude implementation of the check update: "phi"
        # (the reference-
        # comparable form, default — the scalar-oracle bit-exactness tier
        # holds on it) or "tanhfb" (tanh-F/B factorization — same exact
        # box-plus reduction at half the transcendental count; extrinsic
        # saturation ~16.6 vs ~69, f32 rounding differs; opt in for bf16
        # throughput runs).  Ignored by check_rule="minsum".
        if check_phi not in ("phi", "tanhfb"):
            raise ValueError(f"unknown check_phi {check_phi!r}")
        self.check_phi = check_phi
        # min-sum magnitude correction mag = max(alpha*min - beta, 0):
        # alpha=13/16, beta=0 is the normalized default; alpha=1 with
        # beta>0 is classic OFFSET min-sum (ops/boxplus.minsum_mag —
        # both standard corrections of min-sum's over-estimate)
        self.minsum_alpha = float(
            MINSUM_ALPHA if minsum_alpha is None else minsum_alpha
        )
        self.minsum_beta = float(minsum_beta)
        if self.minsum_beta < 0:
            raise ValueError("minsum_beta must be >= 0")
        # stochastically round the bf16 c2v message stores instead of
        # round-to-nearest (ops/boxplus.stochastic_round_bf16) — the
        # knee-quality experiment attacking the measured bf16 message-
        # rounding FER cost.  Dense flooding XLA path only (forces the
        # unfused check phase); requires bfloat16 message storage.
        self.sr_messages = bool(sr_messages)
        if self.sr_messages:
            if self.dtype != jnp.bfloat16:
                raise ValueError("sr_messages=True requires bfloat16 "
                                 "message storage")
            if compressed or schedule != "flooding":
                raise ValueError("sr_messages=True supports only the "
                                 "dense flooding path")
        self.base_edges = [(int(c), int(v), int(s)) for c, v, s in base_edges]
        self.nb_c = max(c for c, _, _ in self.base_edges) + 1
        self.nb_v = max(v for _, v, _ in self.base_edges) + 1
        self.vnum = self.nb_v * self.z
        self.cnum = self.nb_c * self.z
        self.ednum = len(self.base_edges) * self.z

        # group base edges by check block; degrees may DIFFER per block
        # (irregular codes — the regime of real standards, e.g. IRA-style
        # DVB-S2; the reference's jagged decoder is irregular by
        # construction, reference: qamreconciliation/decoder.pyx:60-89)
        self._rows = [[] for _ in range(self.nb_c)]
        for e_idx, (c, v, s) in enumerate(self.base_edges):
            self._rows[c].append((v, s))
        self.row_degrees = [len(r) for r in self._rows]
        if min(self.row_degrees) < 1:
            raise ValueError("empty check block (gap in check-block ids)")
        # dc = the max check-block degree (the padded slot count of the
        # dense path; for regular codes the row weight, unchanged meaning)
        self.dc = max(self.row_degrees)
        self.is_regular = min(self.row_degrees) == self.dc
        if self.check_rule == "minsum" and min(self.row_degrees) < 2:
            # a degree-1 check's all-but-one min is over an empty set: the
            # sentinel would leak as a ~1e30 message.  phi/tanhfb saturate
            # finitely; use those (or the generic Decoder) for such codes.
            raise ValueError(
                "check_rule='minsum' requires check-block degree >= 2 "
                "(degree-1 checks have no finite min-sum extrinsic)"
            )
        if compressed and self.dc > 26:
            raise ValueError(
                "compressed=True packs per-slot signs into an int32 meta "
                "word: check degree must be <= 26"
            )
        self._decode_jit = None

        # Expanded-graph metadata so the engines can use a QCDecoder as a
        # drop-in for Decoder (syndrome evaluation, layout bridges).
        from .decoder import TannerGraph

        k = np.arange(self.z)
        vid = np.concatenate([v * self.z + k for (_, v, _) in self.base_edges])
        cid = np.concatenate(
            [c * self.z + (k + s) % self.z for (c, _, s) in self.base_edges]
        )
        self.graph = TannerGraph(vid, cid)

    # the dense flooding loop may use the fused check-phase kernel
    # (cleared by parallel.graph_shard.ShardedQCDecoder: GSPMD cannot
    # partition a kernel)
    _fused_check_ok = True

    # GSPMD sharding hooks (overridden by parallel.graph_shard.
    # ShardedQCDecoder to z-shard the dense flooding state over a mesh;
    # identity on the single-device decoder).
    def _constrain_vz(self, x):      # [nb_v, z, B]
        return x

    def _constrain_cz(self, x):      # [nb_c, z, B]
        return x

    def _constrain_msg(self, x):     # [nb_c, dc, z, B]
        return x

    def syndrome_from_bits(self, bits):
        """Syndrome via circulant rolls: [V, B] int (0/1) -> [C, B] int32.

        Check ``cb*z + j`` touches variable ``vb*z + ((j - s) % z)``
        (same convention as the decode loop's gather_totals), so each base
        edge contributes ``roll(word_block[vb], s, axis=0)``.  Replaces the
        generic expanded-graph [dc, C, B] gather
        (TannerGraph.syndrome_from_bits) — same XOR-parity semantics as
        reference qamreconciliation/matrix.pyx:55-60, but pure rolls.
        """
        z = self.z
        B = bits.shape[-1]
        w = jnp.asarray(bits, jnp.int32).reshape(self.nb_v, z, B)
        out = []
        for row in self._rows:
            acc = None
            for (v, s) in row:
                slab = jnp.roll(w[v], s, axis=0)
                acc = slab if acc is None else acc + slab
            out.append(acc & 1)
        return jnp.stack(out).reshape(self.cnum, B)

    def _build_decode(self):
        """Duck-type alias matching Decoder's engine-facing API."""
        return self._build()

    # ------------------------------------------------------------------ #

    def _build(self):
        if self.compressed:
            if self.check_rule != "minsum":
                raise ValueError(
                    "compressed=True requires check_rule='minsum' (exact "
                    "sum-product magnitudes are not selection-compressible)"
                )
            return self._build_compressed()
        if self.schedule == "layered":
            return self._build_layered()
        return self._build_dense()

    def _build_compressed(self):
        """Compressed-state normalized min-sum flooding loop.

        Min-sum's check->variable messages are *selections*: every slot of a
        check sees ``alpha*min1`` except the unique argmin slot, which sees
        ``alpha*min2`` (ops/boxplus.py:minsum_extrinsic_mag).  So the dense
        ``c2v [nb_c, dc, z, B]`` loop state collapses to three per-check
        arrays — ``m1``/``m2`` (bf16 magnitudes, alpha pre-applied) and a
        packed int32 ``meta`` (bits 0-2: argmin slot, 7 = tie/none; bit 3+d:
        sign of slot d's message) — and the gathered-totals array ``t`` is
        never materialized in HBM: each check block reconstructs its old
        messages and consumes its rolled total slabs in one fused pass.
        Per-iteration HBM traffic drops from ~5E+4V to ~E+2C_state+3V
        message-widths (~2x at (3,6)).

        Message values, iteration schedule, and (success, iters, final)
        semantics are bit-identical to the dense min-sum path (f32
        subtract of bf16-stored operands; asserted in
        tests/test_qc_compressed.py).  Same convergence
        semantics as reference: qamreconciliation/decoder.pyx:391-436;
        min-sum itself is the opt-in extension documented in
        ops/boxplus.py:check_node_minsum_sm.
        """
        from ..ops.boxplus import minsum_mag

        z, dc = self.z, self.dc
        nb_c, nb_v = self.nb_c, self.nb_v
        rows = self._rows
        dtype = self.dtype
        alpha, beta = self.minsum_alpha, self.minsum_beta

        def decode_batched(prior_vb, synd_cb, max_iterations):
            """prior [V, B], synd [C, B] -> (success, iters, final [V, B])."""
            B = prior_vb.shape[1]
            prior = prior_vb.astype(dtype).reshape(nb_v, z, B)
            synd = synd_cb.astype(jnp.int32).reshape(nb_c, z, B)
            big = jnp.asarray(1e30, jnp.float32)

            def check_pass(total, m1, m2, meta):
                """One fused gather+reconstruct+update+scatter sweep.

                Returns (conv [B], m1', m2', meta', partial_sums [nb_v,z,B]).
                """
                acc = [None] * nb_v
                viol = jnp.zeros((B,), jnp.int32)
                m1n, m2n, metan = [], [], []
                for cb, row in enumerate(rows):
                    meta_cb = meta[cb]                       # [z, B] int32
                    m1f = m1[cb].astype(jnp.float32)
                    m2f = m2[cb].astype(jnp.float32)
                    idx = meta_cb & 31
                    t_rows, v2c_rows = [], []
                    for d, (v, s) in enumerate(row):
                        t_d = jnp.roll(total[v], s, axis=0).astype(
                            jnp.float32
                        )
                        sgn_bit = (meta_cb >> (5 + d)) & 1
                        c2v_old = jnp.where(
                            idx == d, m2f, m1f
                        ) * (1 - 2 * sgn_bit).astype(jnp.float32)
                        t_rows.append(t_d)
                        v2c_rows.append(t_d - c2v_old)
                    # convergence test on the pre-update totals (parity of
                    # hard decisions vs syndrome — decoder.pyx:251-257)
                    par_t = (t_rows[0] < 0).astype(jnp.int32)
                    for t_d in t_rows[1:]:
                        par_t = par_t ^ (t_d < 0).astype(jnp.int32)
                    viol = viol + jnp.sum(
                        (par_t != synd[cb]).astype(jnp.int32), axis=0
                    )
                    # min1/min2/argmin over the dc slots (tie-correct:
                    # minsum_extrinsic_mag semantics, ops/boxplus.py)
                    absm = [jnp.abs(x) for x in v2c_rows]
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
                    idx_new = jnp.zeros_like(meta_cb)
                    for d, m in enumerate(is_min):
                        idx_new = idx_new + d * m.astype(jnp.int32)
                    idx_new = jnp.where(cnt == 1, idx_new, 31)
                    negs = [(x < 0).astype(jnp.int32) for x in v2c_rows]
                    par = negs[0]
                    for n in negs[1:]:
                        par = par ^ n
                    m1_cb = minsum_mag(min1, alpha, beta).astype(dtype)
                    m2_cb = minsum_mag(min2, alpha, beta).astype(dtype)
                    meta_new = idx_new
                    m1_f32 = m1_cb.astype(jnp.float32)
                    m2_f32 = m2_cb.astype(jnp.float32)
                    for d, (v, s) in enumerate(row):
                        sgn = par ^ negs[d] ^ synd[cb]       # 1 = negative
                        meta_new = meta_new | (sgn << (5 + d))
                        c2v_new = (
                            jnp.where(idx_new == d, m2_f32, m1_f32)
                            * (1 - 2 * sgn).astype(jnp.float32)
                        ).astype(dtype)
                        # f32 accumulation, one rounding at the total store
                        # (mirrors the dense path's scatter_partials)
                        slab = jnp.roll(c2v_new, -s, axis=0).astype(
                            jnp.float32
                        )
                        acc[v] = slab if acc[v] is None else acc[v] + slab
                    m1n.append(m1_cb)
                    m2n.append(m2_cb)
                    metan.append(meta_new)
                for vb in range(nb_v):
                    if acc[vb] is None:
                        acc[vb] = jnp.zeros((z, B), jnp.float32)
                return (
                    viol == 0,
                    jnp.stack(m1n),
                    jnp.stack(m2n),
                    jnp.stack(metan),
                    jnp.stack(acc),
                )

            def consistent(total):
                ok = jnp.zeros((B,), jnp.int32)
                for cb, row in enumerate(rows):
                    par_t = None
                    for (v, s) in row:
                        bit = (
                            jnp.roll(total[v], s, axis=0) < 0
                        ).astype(jnp.int32)
                        par_t = bit if par_t is None else par_t ^ bit
                    ok = ok + jnp.sum(
                        (par_t != synd[cb]).astype(jnp.int32), axis=0
                    )
                return ok == 0

            def cond(state):
                it, _, _, _, _, _, done, _ = state
                return jnp.logical_and(it < max_iterations, ~jnp.all(done))

            def body(state):
                it, m1, m2, meta, total, final, done, iters = state
                conv, m1n, m2n, metan, sums = check_pass(total, m1, m2, meta)
                newly = jnp.logical_and(conv, ~done)
                iters_new = jnp.where(newly, it, iters)
                done_new = jnp.logical_or(done, conv)
                final_new = jax.lax.cond(
                    jnp.any(newly),
                    lambda f: jnp.where(newly[None, None, :], total, f),
                    lambda f: f,
                    final,
                )
                total_new = (
                    prior.astype(jnp.float32) + sums
                ).astype(dtype)
                return (
                    it + 1, m1n, m2n, metan, total_new, final_new,
                    done_new, iters_new,
                )

            init = (
                jnp.int32(0),
                jnp.zeros((nb_c, z, B), dtype),
                jnp.zeros((nb_c, z, B), dtype),
                jnp.full((nb_c, z, B), 31, jnp.int32),
                prior,
                prior,
                jnp.zeros(B, bool),
                jnp.zeros(B, jnp.int32),
            )
            it, _, _, _, total, final, done, iters = jax.lax.while_loop(
                cond, body, init
            )
            conv = consistent(total)
            newly = jnp.logical_and(conv, ~done)
            iters = jnp.where(newly, jnp.minimum(it, max_iterations), iters)
            final = jnp.where(newly[None, None, :], total, final)
            done = jnp.logical_or(done, conv)
            iters = jnp.where(done, iters, max_iterations)
            final = jnp.where(done[None, None, :], final, total)
            return done, iters, final.reshape(nb_v * z, B)

        return jax.jit(decode_batched)

    def _build_layered(self):
        """Row-layered (serial-C) schedule over the check blocks.

        Extension over the reference's flooding schedule
        (qamreconciliation/decoder.pyx:424-433): check blocks are processed
        sequentially within one sweep, and each block's extrinsic update is
        folded into the variable totals *immediately*, so later blocks in
        the same sweep already see it.  Layered BP needs roughly half the
        sweeps of flooding for the same target quality (the standard
        hardware-decoder schedule); one "iteration" in the returned
        ``iters`` counts one full sweep, and the (success, iters==0
        passthrough, final) contract is otherwise identical to the
        flooding decoder.

        The loop runs ``layered_chunk`` sweeps per ``while_loop`` iteration
        (default 4), testing the syndrome after EVERY sweep inside the
        chunk, so (success, iters, final) stay sweep-exact while the
        while-loop's data-dependent-cond synchronization is amortized
        K-fold.  Early exit coarsens to K-sweep granularity (converged
        frames sweep up to K-1 extra times in lockstep; detection,
        ``iters`` and the captured ``final`` are still per-sweep exact,
        and failed frames' finals snapshot exactly at ``max_iterations``).

        Numerics: ``c2v`` messages are stored at ``self.dtype`` (bf16 is
        stored at half width); the running totals stay float32 and are updated
        with deltas of the *stored* (rounded) messages, so
        ``total == prior + sum(stored c2v)`` holds to f32 addition rounding
        across arbitrarily many sweeps — no bf16 accumulation drift.
        """
        from ..ops.boxplus import (
            check_node_minsum_sm, check_node_tanhfb_sm, check_node_update_sm,
        )

        z, dc = self.z, self.dc
        nb_c, nb_v = self.nb_c, self.nb_v
        rows = self._rows
        dtype = self.dtype
        rule = self.check_rule
        # totals accumulate incrementally: keep them at >= f32 (f64 parity
        # runs keep f64 end to end)
        acc_dtype = jnp.float64 if dtype == jnp.float64 else jnp.float32
        # one all-ones mask per distinct check-block degree (irregular
        # rows update at their OWN degree — no padding in the layer loop)
        ones_masks = {
            d: np.ones((d, z), np.float32) for d in set(self.row_degrees)
        }

        phi_impl = self.check_phi
        use_groups = (
            self.layered_groups if self.layered_groups is not None
            else nb_c >= 32
        )
        if use_groups:
            # (color, degree)-batched layer plan: rows within a batch are
            # variable-disjoint (updates commute exactly — see
            # color_disjoint_rows) and same-degree (rectangular stack)
            layer_plan = layered_plan(rows)

        def layer_update_group(v2c, synd_g):
            """Batched check update over a variable-disjoint layer.

            v2c [R, dcr, z, B] (acc_dtype) -> new c2v, same shape.  The
            same math as :func:`layer_update` with the slot axis at 1 —
            axis-NATIVE reductions (minsum/phi take an axis; tanh-F/B's
            moveaxis touches leading dims only), so no minor-axis
            relayout: an earlier super-layer form lost to exactly
            those concat/transpose costs (docstring above).
            """
            from ..ops.boxplus import (
                minsum_extrinsic_mag, minsum_mag, phi_llr,
                tanhfb_extrinsic_mag,
            )

            absm = jnp.abs(v2c)
            if rule == "minsum":
                mag = minsum_mag(
                    minsum_extrinsic_mag(absm, 1),
                    self.minsum_alpha, self.minsum_beta,
                )
            elif phi_impl == "tanhfb":
                mag = tanhfb_extrinsic_mag(absm, 1)
            else:
                phim = phi_llr(absm)
                s_phi = jnp.sum(phim, axis=1, keepdims=True)
                mag = phi_llr(s_phi - phim)
            neg = (v2c < 0).astype(jnp.int32)
            par = jnp.sum(neg, axis=1, keepdims=True) & 1
            sign = (1 - 2 * jnp.bitwise_xor(par, neg)).astype(v2c.dtype)
            pref = (1 - 2 * synd_g.astype(jnp.int32)).astype(
                v2c.dtype
            )[:, None]
            return sign * pref * mag

        def layer_update(v2c, synd_cb):
            """v2c [dcr, z, B] -> new c2v [dcr, z, B] (acc_dtype in/out).

            Reuses the slot-major check rules with an all-ones mask: the
            layer layout [dcr, z, B] is the slot-major [dc_max, C, B] with
            C = z (full rows, no padding).
            """
            ones_mask = ones_masks[v2c.shape[0]]
            if rule == "minsum":
                return check_node_minsum_sm(
                    v2c, synd_cb, ones_mask,
                    alpha=self.minsum_alpha, beta=self.minsum_beta,
                )
            if phi_impl == "tanhfb":
                return check_node_tanhfb_sm(v2c, synd_cb, ones_mask)
            return check_node_update_sm(v2c, synd_cb, ones_mask)

        def decode_batched(prior_vb, synd_cb, max_iterations):
            """prior [V, B], synd [C, B] -> (success, iters, final [V, B])."""
            B = prior_vb.shape[1]
            prior = prior_vb.astype(acc_dtype).reshape(nb_v, z, B)
            synd = synd_cb.astype(jnp.int32).reshape(nb_c, z, B)

            def consistent(total):
                """Hard-decision syndrome test on [nb_v, z, B] totals.

                One int8 sign pass + per-edge int8 rolls."""
                bits = (total < 0).astype(jnp.int8)
                ok = jnp.zeros((B,), jnp.int32)
                for cb, row in enumerate(rows):
                    par = None
                    for (v, s) in row:
                        slab = jnp.roll(bits[v], s, axis=0)
                        par = slab if par is None else par ^ slab
                    ok = ok + jnp.sum(
                        (par.astype(jnp.int32) != synd[cb]).astype(jnp.int32),
                        axis=0,
                    )
                return ok == 0

            def sweep_serial(total, c2v):
                """One serial pass over all check blocks."""
                for cb, row in enumerate(rows):
                    dcr = len(row)
                    t = jnp.stack(
                        [jnp.roll(total[v], s, axis=0) for (v, s) in row]
                    )                                      # [dcr, z, B] acc
                    old = c2v[cb, :dcr].astype(acc_dtype)
                    new = layer_update(t - old, synd[cb])
                    stored = new.astype(dtype)
                    # delta of the STORED values keeps total consistent
                    # with the bf16 state (bf16 is exact in f32)
                    delta = stored.astype(acc_dtype) - old
                    for d, (v, s) in enumerate(row):
                        total = total.at[v].add(
                            jnp.roll(delta[d], -s, axis=0)
                        )
                    c2v = c2v.at[cb, :dcr].set(stored)
                return total, c2v

            def sweep_grouped(total, c2v):
                """One pass in (color, degree)-batched layers.

                Bit-identical to :func:`sweep_serial` under the layer-
                plan's row order (rows within a batch are variable-
                disjoint, so their updates commute exactly); the serial
                depth drops from nb_c to len(layer_plan).  The totals
                scatter stays PER-EDGE ``.at[v].add`` with static
                indices (cheap dynamic-update-slice) rather than one
                vector-index scatter per layer."""
                for dcr, cbs in layer_plan:
                    t = jnp.stack([
                        jnp.stack([
                            jnp.roll(total[v], s, axis=0)
                            for (v, s) in rows[cb]
                        ])
                        for cb in cbs
                    ])                                  # [R, dcr, z, B]
                    idx = np.asarray(cbs)
                    old = c2v[idx, :dcr].astype(acc_dtype)
                    stored = layer_update_group(
                        t - old, synd[idx]
                    ).astype(dtype)
                    delta = stored.astype(acc_dtype) - old
                    for i, cb in enumerate(cbs):
                        for d, (v, s) in enumerate(rows[cb]):
                            total = total.at[v].add(
                                jnp.roll(delta[i, d], -s, axis=0)
                            )
                    c2v = c2v.at[idx, :dcr].set(stored)
                return total, c2v

            sweep = sweep_grouped if use_groups else sweep_serial

            K = self.layered_chunk

            def cond(state):
                it, _, _, _, done, _ = state
                return jnp.logical_and(it < max_iterations, ~jnp.all(done))

            def body(state):
                it, c2v, total, final, done, iters = state
                for k in range(K):
                    total, c2v = sweep(total, c2v)
                    swp = it + (k + 1)
                    conv = consistent(total)
                    # sweeps past max_iterations (chunk overrun) never
                    # count as success
                    newly = conv & ~done & (swp <= max_iterations)
                    iters = jnp.where(newly, swp, iters)
                    done = jnp.logical_or(done, newly)
                    # failed frames' final LLRs are the max_iterations-
                    # sweep totals (reference decoder.pyx:436 returns the
                    # current lappr at maxiter), not chunk-end totals
                    snap = (~done) & (swp == max_iterations)
                    cap = newly | snap
                    final = jax.lax.cond(
                        jnp.any(cap),
                        lambda f, c, t: jnp.where(c[None, None, :], t, f),
                        lambda f, c, t: f,
                        final, cap, total,
                    )
                return it + K, c2v, total, final, done, iters

            # iters==0 passthrough for already-consistent inputs
            # (reference: decoder.pyx:402-405)
            conv0 = consistent(prior)
            init = (
                jnp.int32(0),
                jnp.zeros((nb_c, dc, z, B), dtype),
                prior,
                prior,
                conv0,
                jnp.zeros(B, jnp.int32),
            )
            it, _, total, final, done, iters = jax.lax.while_loop(
                cond, body, init
            )
            iters = jnp.where(done, iters, max_iterations)
            # final is already correct for every frame: converged frames
            # captured at their convergence sweep, failed frames
            # snapshotted at the max_iterations sweep inside the chunk
            # (the loop cannot exit with stragglers before reaching it),
            # and a max_iterations==0 call passes the prior through (init).
            return done, iters, final.reshape(nb_v * z, B)

        return jax.jit(decode_batched)

    def _build_dense(self):
        z, dc = self.z, self.dc
        nb_c, nb_v = self.nb_c, self.nb_v
        rows = self._rows
        dtype = self.dtype
        # running-totals dtype (see ctor totals_dtype): accumulation and
        # the gathered t ride acc_dtype; messages stay at storage width
        acc_dtype = (
            jnp.float32
            if self.totals_dtype == "float32" and dtype != jnp.float64
            else dtype
        )
        # irregular rows: short check blocks pad to dc with a +BIG
        # sentinel slab — positive (no parity/sign contribution) and the
        # exact neutral element of every magnitude rule (phi(BIG)=0,
        # tanh(BIG/2)=1, never wins a min); padded c2v slots are never
        # scattered, so the sentinel never reaches the totals.
        BIG = 1e30

        def gather_totals(total):
            """total [nb_v, z, B] -> t [nb_c, dc, z, B] via rolls.

            Check ``cb*z + j`` touches variable ``vb*z + ((j - s) % z)``, so
            the slab seen by check block cb through a base edge of shift s is
            ``roll(total[vb], -s?)``: t[cb, d, j] = total[vb, (j - s) % z]
            = roll(total[vb], s, axis=0)[j].
            """
            B = total.shape[-1]
            pad = jnp.full((z, B), BIG, total.dtype)
            slabs = [
                jnp.stack(
                    [jnp.roll(total[v], s, axis=0) for (v, s) in row]
                    + [pad] * (dc - len(row))
                )
                for row in rows
            ]
            return jnp.stack(slabs)                       # [nb_c, dc, z, B]

        # variable-update accumulation dtype: ALWAYS at least f32, with one
        # rounding at the store (bf16 left-fold sums round at every add;
        # upcast-sum-round-once is strictly more accurate at identical
        # memory traffic).
        sum_dtype = jnp.float64 if dtype == jnp.float64 else jnp.float32

        def scatter_partials(c2v):
            """c2v [nb_c, dc, z, B] -> per-variable sums [nb_v, z, B]
            (sum_dtype; padded slots of irregular rows are skipped)."""
            acc = [None] * nb_v
            for cb, row in enumerate(rows):
                for d, (v, s) in enumerate(row):
                    slab = jnp.roll(c2v[cb, d], -s, axis=0).astype(sum_dtype)
                    acc[v] = slab if acc[v] is None else acc[v] + slab
            B = c2v.shape[-1]
            for vb in range(nb_v):
                if acc[vb] is None:     # isolated block (e.g. loaded file
                    acc[vb] = jnp.zeros((z, B), sum_dtype)   # with a gap)
            return jnp.stack(acc)                         # [nb_v, z, B]

        rule = self.check_rule
        if rule == "sumproduct" and self.check_phi == "tanhfb":
            rule = "tanhfb"
        ms = dict(ms_alpha=self.minsum_alpha, ms_beta=self.minsum_beta)
        # the stochastic message rounding lives only in the XLA check
        # update, and GSPMD cannot partition a kernel (_fused_check_ok)
        fused = (
            fused_check_phase(jax.default_backend())
            and self._fused_check_ok and not self.sr_messages
        )

        def decode_batched(prior_vb, synd_cb, max_iterations):
            """prior [V, B], synd [C, B] -> (success, iters, final [V, B])."""
            B = prior_vb.shape[1]
            # per-iteration counter-derived random bits for the stochastic
            # message rounding; 'rbg' (XLA RngBitGenerator) is the cheap
            # hardware generator — decode stays deterministic given inputs
            # (fixed key), bits decorrelate across iterations via fold_in
            sr_key = (
                jax.random.key(0x5eed, impl="rbg")
                if self.sr_messages else None
            )
            prior = self._constrain_vz(
                prior_vb.astype(dtype).astype(acc_dtype).reshape(nb_v, z, B)
            )
            synd = self._constrain_cz(
                synd_cb.astype(jnp.int32).reshape(nb_c, z, B)
            )

            def check_phase(t, c2v, rbits=None):
                """(conv [B], c2v_new) — fused kernel or XLA ops."""
                if fused:
                    from ..ops.pallas_kernels import bp_check_phase_qc

                    return bp_check_phase_qc(t, c2v, synd, rule=rule, **ms)
                return check_phase_xla(t, c2v, synd, rule=rule, rbits=rbits,
                                       **ms)

            def cond(state):
                it, _, _, _, done, _ = state
                return jnp.logical_and(it < max_iterations, ~jnp.all(done))

            def body(state):
                it, c2v, total, final, done, iters = state
                t = gather_totals(total)                  # [nb_c, dc, z, B]
                rbits = (
                    jax.random.bits(jax.random.fold_in(sr_key, it),
                                    (nb_c, dc, z, B), jnp.uint32)
                    if sr_key is not None else None
                )
                conv, c2v_new = check_phase(t, c2v, rbits)
                newly = jnp.logical_and(conv, ~done)
                iters_new = jnp.where(newly, it, iters)
                done_new = jnp.logical_or(done, conv)
                # capture-at-convergence (see models/decoder.py): snapshot
                # newly-converged frames' totals instead of freezing the
                # whole loop state — saves the 3x [nb_c, dc, z, B] freeze
                # traffic per iteration; cond skips the snapshot entirely
                # when no frame newly converged.
                final_new = jax.lax.cond(
                    jnp.any(newly),
                    lambda f: jnp.where(newly[None, None, :], total, f),
                    lambda f: f,
                    final,
                )

                total_new = (
                    prior.astype(sum_dtype) + scatter_partials(c2v_new)
                ).astype(acc_dtype)
                return (
                    it + 1, c2v_new, total_new, final_new, done_new, iters_new
                )

            init = (
                jnp.int32(0),
                self._constrain_msg(jnp.zeros((nb_c, dc, z, B), dtype)),
                prior,
                prior,
                jnp.zeros(B, bool),
                jnp.zeros(B, jnp.int32),
            )
            it, _, total, final, done, iters = jax.lax.while_loop(
                cond, body, init
            )
            conv = qc_consistent(gather_totals(total), synd)
            newly = jnp.logical_and(conv, ~done)
            iters = jnp.where(newly, jnp.minimum(it, max_iterations), iters)
            final = jnp.where(newly[None, None, :], total, final)
            done = jnp.logical_or(done, conv)
            iters = jnp.where(done, iters, max_iterations)
            final = jnp.where(done[None, None, :], final, total)
            return done, iters, final.reshape(nb_v * z, B)

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


def save_qc_csv(path: str, base_edges, z: int):
    """Write a QC base-edge CSV: header ``eid,cb,vb,shift``, first data row
    carries the totals ``(n_base_edges, z, nb_c, 0)`` — mirroring the expanded
    edge-list format's first-row convention."""
    nb_c = max(c for c, _, _ in base_edges) + 1
    lines = ["eid,cb,vb,shift", f"{len(base_edges)},{z},{nb_c},0"]
    lines.extend(
        f"{i},{c},{v},{s}" for i, (c, v, s) in enumerate(base_edges)
    )
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def load_qc_csv(path: str):
    """Load a QC base-edge CSV -> ``(base_edges, z)``."""
    data = np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.int64, ndmin=2)
    declared_e, z = int(data[0, 0]), int(data[0, 1])
    rows = data[1:]
    if rows.shape[0] != declared_e:
        raise ValueError(
            f"QC file declares {declared_e} base edges but contains "
            f"{rows.shape[0]}"
        )
    base_edges = [(int(c), int(v), int(s)) for _, c, v, s in rows]
    return base_edges, z


def detect_qc(vid, cid, z: int | None = None):
    """Detect quasi-cyclic structure in an expanded edge list.

    Real LDPC standards (DVB-S2, 5G NR, 802.11) are quasi-cyclic, but they
    ship — and the reference consumes (reference: sims/sim_reconciliation.py:
    50, 60-61) — *expanded* ``(vid, cid)`` edge lists.  This recovers the
    circulant lifting so such codes can ride the ~2x-faster roll decoder:
    an edge (v, c) belongs to base cell ``(cb, vb) = (c // z, v // z)`` with
    shift ``s = (c % z - v % z) % z``; the list is QC at lifting size ``z``
    iff every populated ``(cb, vb, s)`` cell contains exactly ``z`` edges
    (one per lane ``k = v % z``).

    Args:
      vid, cid: expanded edge list.
      z: try only this lifting size; default tries every common divisor of
        (vnum, cnum) from largest to smallest and returns the first hit
        (the maximal lifting).

    Returns ``(base_edges, z)`` in :class:`QCDecoder`'s convention, or
    ``None`` if no non-trivial lifting (z >= 2) exists.
    """
    vid = np.asarray(vid, np.int64).reshape(-1)
    cid = np.asarray(cid, np.int64).reshape(-1)
    V = int(vid.max()) + 1
    C = int(cid.max()) + 1
    E = vid.size
    if z is not None:
        cands = [int(z)]
    else:
        cands = [d for d in range(min(V, C), 1, -1)
                 if V % d == 0 and C % d == 0 and E % d == 0]
    for zc in cands:
        vb = vid // zc
        cb = cid // zc
        s = (cid % zc - vid % zc) % zc
        key = (cb * (V // zc) + vb) * zc + s
        uniq, counts = np.unique(key, return_counts=True)
        if not (counts == zc).all():
            continue
        # one edge per lane k within each cell (duplicate edges would slip
        # through the count check otherwise)
        lane_key = key * zc + vid % zc
        if np.unique(lane_key).size != E:
            continue
        base = [(int(k // zc) // (V // zc), int(k // zc) % (V // zc),
                 int(k % zc)) for k in uniq]
        return base, zc
    return None
