"""Block-streamed reconciliation over unbounded symbol streams.

The reference processes one whole frame at a time inside its C loops
(SURVEY.md §5 "long-context": frame length up to N=64800, symbol streams
N_symb = N/bps).  This module adds a streaming capability:
arbitrarily long correlated (x, y) symbol streams are chunked
into code frames with carry-over boundary handling — symbols that arrive
mid-frame are held in a carry buffer until their frame completes (the
overlap-save analogue for frame-aligned block processing) — and complete
frames are decoded in fixed-size batches through one reused jitted program.

Bob-side and Alice-side steps are split exactly as the protocol splits them:
``bob_process`` consumes y and emits (hard words, syndromes, softening
metrics); ``alice_process`` consumes (softening metrics, Alice's x) plus
Bob's syndromes and emits corrected hard words.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import jax
import jax.numpy as jnp

from ..models.decoder import Decoder
from ..models.matrix import Matrix
from ..models.alphabet import PAMAlphabet
from ..models.noisemapper import NoiseMapper

__all__ = ["StreamReconciler", "StreamResult", "DeviceHandoff"]


@dataclass
class DeviceHandoff:
    """Device-resident Bob->Alice batch handoff (see
    :meth:`StreamReconciler.bob_step`).

    Holds one entry per dispatched batch: ``(words_dev [B, N],
    synd_dev [B, C], n_hat_dev [B, N_symb], take)`` — all jax device
    arrays, padded to the reconciler's fixed batch with ``take`` real
    frames.  The arrays pin device memory until :meth:`alice_step`
    consumes them; in a real deployment Bob and Alice are distinct hosts
    and the split ``bob_process``/``alice_process`` API is the faithful
    boundary — this handle is the co-located-simulation fast path that
    skips its structural device->host->device bounce (~20 MB per
    DVB-S2 batch, what binds the split API)."""

    batches: list = field(default_factory=list)
    frames: int = 0


def _make_pack_bits(N: int):
    """[B, N] 0/1 int -> [B, ceil(N/8)] uint8 packer (little bitorder,
    ``np.unpackbits(..., bitorder='little')``-compatible) — the
    packed-word download trick of the fused/handoff paths (8x less
    device->host traffic than uint8-per-bit words)."""
    npad = (-N) % 8
    w_pack = jnp.asarray(np.asarray([1, 2, 4, 8, 16, 32, 64, 128], np.int32))

    def pack_bits(bits_bn):
        if npad:
            bits_bn = jnp.concatenate(
                [bits_bn,
                 jnp.zeros((bits_bn.shape[0], npad), bits_bn.dtype)],
                axis=1,
            )
        g = bits_bn.reshape(bits_bn.shape[0], -1, 8).astype(jnp.int32)
        return jnp.sum(g * w_pack, axis=-1).astype(jnp.uint8)

    return pack_bits


@dataclass
class StreamResult:
    """Aggregated streaming statistics + decoded payload."""

    frames: int = 0
    decoded_words: list = field(default_factory=list)   # [N]-bit arrays
    success: list = field(default_factory=list)          # per-frame bool
    iterations: list = field(default_factory=list)       # per-frame int
    bit_errors: int = 0                                  # vs Bob's words

    @property
    def fer(self) -> float:
        return (
            0.0 if not self.success
            else 1.0 - sum(self.success) / len(self.success)
        )


class StreamReconciler:
    """Frame-aligned block streaming over a (code, alphabet, noise) triple.

    Args:
      dec, mat, pa, nm: decoder / parity matrix / alphabet / noise mapper.
      batch: frames processed per device round on BOTH sides (the streaming
        block size is ``batch * N_symb`` symbols; partial tail blocks are
        padded up to ``batch`` so every call reuses one compiled program).
      llr_mode: "poly" (default; gather-free piecewise-Chebyshev LLR
        curves), "table" (precomputed (n, j)->LLR map), "interp"
        (per-sample grid inverse) or "search" (exact Newton inverse) — see
        NoiseMapper.demap_lappr_array.
      defer: hold completed frames until a FULL batch accumulates instead
        of padding every partial block — the throughput mode for streams
        fed in chunks smaller than ``batch * N_symb`` symbols (a padded
        partial block costs the whole batch's device work: measured 27x
        waste at 2.3-frame chunks into a 64-frame batch).  Outputs are
        delayed until batches fill PLUS one batch of dispatch pipelining
        (each side keeps its newest batch in flight and harvests it on
        the next call, overlapping Bob's upload/compute with Alice's
        decode); drain tails with ``bob_flush()`` /
        ``alice_flush()``.  Default False (emit-immediately semantics).
    """

    def __init__(
        self,
        dec: Decoder,
        mat: Matrix,
        pa: PAMAlphabet,
        nm: NoiseMapper,
        batch: int = 32,
        llr_mode: str = "poly",
        defer: bool = False,
        mesh_axis=None,
    ):
        if mat.vnum % pa.bit_per_symbol != 0:
            raise ValueError("code length not divisible by bits/symbol")
        # optional (mesh, axis_name): the FUSED driver shards each batch's
        # frames over the mesh (pure frame-shard DP — every stage of the
        # protocol is frame-parallel, so there are no collectives; outputs
        # come back batch-sharded and concatenate transparently).  The
        # split bob/alice API stays single-device (its contract is the
        # host protocol boundary).
        if mesh_axis is not None and batch % mesh_axis[0].devices.size:
            raise ValueError(
                f"batch {batch} must divide over the {mesh_axis[0]} mesh"
            )
        self.mesh_axis = mesh_axis
        self.dec = dec
        self.mat = mat
        self.pa = pa
        self.nm = nm
        self.batch = int(batch)
        self.llr_mode = llr_mode
        self.N = mat.vnum
        self.N_symb = mat.vnum // pa.bit_per_symbol
        self._carry_y = np.empty(0, np.float64)
        self._carry_x = np.empty(0, np.int64)
        self._alice_jit = None
        self._bob_jit = None
        # defer=True: hold completed frames until a FULL batch accumulates
        # and only then dispatch, instead of padding every partial block.
        # Without it, a stream fed in chunks much smaller than
        # batch*N_symb symbols pays the full batch's device work per
        # chunk (measured: 2.3-frame chunks into a 64-frame batch ran 27x
        # the needed decode work).  Outputs are delayed until the batch
        # fills; call bob_flush()/alice_flush() to drain the tails
        # (padded, once) at end of stream.
        self.defer = bool(defer)
        self._bob_q = np.empty((0, self.N_symb), np.float64)
        self._aq_x = np.empty((0, self.N_symb), np.int64)
        self._aq_nhat = np.empty((0, self.N_symb), np.float64)
        self._aq_synd = np.empty((0, mat.cnum), np.uint8)
        self._aq_words = None  # lazily [Q, N] when bob_words accounting is on
        # accounting mode latches on the FIRST deferred enqueue: rows
        # queued without words cannot be retro-aligned to words that
        # arrive later (the queue front would desync from _aq_words)
        self._aq_words_mode = None
        self.decode_dispatches = 0  # device decode calls (waste accounting)
        # Cross-call dispatch pipeline (defer mode only): the LAST batch of
        # each _run call stays in flight — (device outputs, accounting) —
        # and is harvested by the NEXT call (or the flush), so Bob's
        # upload/compute for batch r+1 overlaps Alice's decode of batch r.
        # In defer mode every call carries exactly one
        # batch, so a within-call double buffer alone never forms a
        # pipeline.  Outputs shift one batch later —
        # consistent with defer's documented delayed-output contract;
        # emit-immediately mode (defer=False) keeps its synchronous
        # return and only double-buffers within a call.
        self._bob_pending = None
        self._alice_pending = None
        if llr_mode == "table":
            # build before any jit flattens the mapper: the lazy LLR table
            # changes the pytree structure when materialized
            nm._ensure_llr_tab()
        elif llr_mode == "poly":
            nm._ensure_llr_poly()

    # ---------------------------------------------------------------- Bob

    def bob_process(self, y_block):
        """Consume a block of Bob's samples; emit completed frames.

        Returns ``(words [F, N] uint8, synd [F, C] uint8, n_hat [F, N_symb])``
        for however many frames completed (F may be 0); incomplete-tail
        symbols are carried into the next call.

        Frames are processed in fixed ``batch``-sized blocks with tail
        padding (mirroring the Alice side), so any stream chunking reuses
        ONE compiled program — a DVB-S2-size decode compiles for tens of
        seconds per shape.
        """
        if not self.defer and self._bob_q.shape[0]:
            # frames queued by bob_step would be silently skipped (and
            # later dispatched out of stream order) by the immediate path
            raise ValueError(
                "bob_process(defer=False) after bob_step left queued "
                "frames; drain them with bob_step_flush() first (or stay "
                "on one API per reconciler)"
            )
        y = np.concatenate([self._carry_y, np.asarray(y_block, np.float64).ravel()])
        F = y.size // self.N_symb
        self._carry_y = y[F * self.N_symb:]
        yf = y[: F * self.N_symb].reshape(F, self.N_symb)
        if self.defer:
            if F:
                self._bob_q = np.concatenate([self._bob_q, yf], axis=0)
            P = (self._bob_q.shape[0] // self.batch) * self.batch
            yf = self._bob_q[:P]
            self._bob_q = self._bob_q[P:]
        if yf.shape[0] == 0 and self._bob_pending is None:
            return (
                np.empty((0, self.N), np.uint8),
                np.empty((0, self.mat.cnum), np.uint8),
                np.empty((0, self.N_symb)),
            )
        return self._bob_run(yf, leave_pending=self.defer)

    def bob_flush(self):
        """Drain Bob's deferred frame queue (padded tail batch, once) and
        any in-flight pipelined batch.

        Returns the same triple as :meth:`bob_process`.  No-op (empty
        arrays) when nothing is queued or in flight."""
        yf = self._bob_q
        self._bob_q = np.empty((0, self.N_symb), np.float64)
        if yf.shape[0] == 0 and self._bob_pending is None:
            return (
                np.empty((0, self.N), np.uint8),
                np.empty((0, self.mat.cnum), np.uint8),
                np.empty((0, self.N_symb)),
            )
        return self._bob_run(yf, leave_pending=False)

    def _ensure_bob_jit(self):
        if self._bob_jit is None:

            def bob_round(nm, yf):
                x_hat = nm.hard_decide_index(yf)
                n_hat = nm.map_noise(yf, x_hat)
                words = self.pa.demap_symbols_to_bits(x_hat)
                synd = self.mat.eval_syndrome(words)
                return words, synd, n_hat

            self._bob_jit = jax.jit(bob_round)
        return self._bob_jit

    def _bob_run(self, yf, leave_pending=False):
        """Batch-blocked device processing of complete frames [F, N_symb]."""
        F = yf.shape[0]
        self._ensure_bob_jit()

        words_l, synd_l, nhat_l = [], [], []

        def harvest(pend):
            (w, s, nh), take = pend
            # device->host reads: the only sync points in the pipeline
            words_l.append(np.asarray(w, np.uint8)[:take])
            synd_l.append(np.asarray(s, np.uint8)[:take])
            nhat_l.append(np.asarray(nh)[:take])

        # double-buffered: dispatch block r+1 BEFORE reading block r's
        # outputs, so upload/compute overlap the previous readback (the
        # engine's own trick, sims/engine.py:392-409 — jax dispatch is
        # async; only np.asarray blocks).  The pending slot persists ACROSS calls in defer
        # mode (leave_pending=True; see __init__).
        for lo in range(0, F, self.batch):
            hi = min(lo + self.batch, F)
            take = hi - lo
            blk = yf[lo:hi]
            pad = self.batch - take
            if pad:
                blk = np.concatenate([blk, np.repeat(blk[-1:], pad, 0)])
            out = self._bob_jit(
                self.nm, jnp.asarray(blk, self.nm.dtype)
            )
            if self._bob_pending is not None:
                harvest(self._bob_pending)
            self._bob_pending = (out, take)
        if not leave_pending and self._bob_pending is not None:
            harvest(self._bob_pending)
            self._bob_pending = None
        if not words_l:
            return (
                np.empty((0, self.N), np.uint8),
                np.empty((0, self.mat.cnum), np.uint8),
                np.empty((0, self.N_symb)),
            )
        return (
            np.concatenate(words_l, axis=0),
            np.concatenate(synd_l, axis=0),
            np.concatenate(nhat_l, axis=0),
        )

    # -------------------------------------------------------------- Alice

    def alice_process(self, n_hat, x_block, synd, max_iterations: int = 50,
                      bob_words=None):
        """Alice's side: LLRs from (softening metric, own symbols) + decode.

        ``x_block`` streams like Bob's y (carry-over boundary handling);
        ``n_hat``/``synd`` must cover the same frames that complete here.
        ``bob_words`` (optional, [F, N]) enables ``bit_errors`` accounting of
        the decoded words against Bob's.  Returns a StreamResult for the
        completed frames.
        """
        x = np.concatenate([self._carry_x, np.asarray(x_block, np.int64).ravel()])
        F = x.size // self.N_symb
        self._carry_x = x[F * self.N_symb:]
        xf = x[: F * self.N_symb].reshape(F, self.N_symb)
        if self.defer:
            # queue x-completed frames and Bob's (n_hat, synd[, words])
            # rows independently (they may arrive at different rates) and
            # decode only full batches from the aligned fronts
            if F:
                self._aq_x = np.concatenate([self._aq_x, xf], axis=0)
            n_hat = np.asarray(n_hat)
            if n_hat.shape[0]:
                self._aq_nhat = np.concatenate(
                    [self._aq_nhat, n_hat], axis=0
                )
                self._aq_synd = np.concatenate(
                    [self._aq_synd, np.asarray(synd, np.uint8)], axis=0
                )
                has_words = bob_words is not None
                if self._aq_words_mode is None:
                    self._aq_words_mode = has_words
                elif self._aq_words_mode != has_words:
                    # both directions are desyncs: starting accounting
                    # mid-stream would align later words to earlier queue
                    # rows, stopping it would starve the aligned front
                    raise ValueError(
                        "bob_words accounting must be passed on every "
                        "deferred alice_process call or never"
                    )
                if has_words:
                    bw = np.asarray(bob_words, np.uint8)
                    self._aq_words = (
                        bw if self._aq_words is None
                        else np.concatenate([self._aq_words, bw], axis=0)
                    )
            avail = min(self._aq_x.shape[0], self._aq_nhat.shape[0],
                        self._aq_synd.shape[0])
            P = (avail // self.batch) * self.batch
            if P == 0:
                return StreamResult()
            xf = self._aq_x[:P]
            n_hat = self._aq_nhat[:P]
            synd = self._aq_synd[:P]
            bob_words = (
                self._aq_words[:P] if self._aq_words is not None else None
            )
            self._aq_x = self._aq_x[P:]
            self._aq_nhat = self._aq_nhat[P:]
            self._aq_synd = self._aq_synd[P:]
            if self._aq_words is not None:
                self._aq_words = self._aq_words[P:]
            return self._alice_run(n_hat, xf, synd, max_iterations,
                                   bob_words, leave_pending=True)
        if F == 0:
            return StreamResult()
        n_hat = np.asarray(n_hat)[:F]
        synd = np.asarray(synd)[:F]
        return self._alice_run(n_hat, xf, synd, max_iterations, bob_words)

    def alice_flush(self, max_iterations: int = 50):
        """Drain Alice's deferred queues (padded tail batch, once) and any
        in-flight pipelined batch.

        Decodes whatever aligned frames remain queued; returns a
        StreamResult.  No-op when nothing is queued or in flight."""
        avail = min(self._aq_x.shape[0], self._aq_nhat.shape[0],
                    self._aq_synd.shape[0])
        if avail == 0 and self._alice_pending is None:
            return StreamResult()
        xf = self._aq_x[:avail]
        n_hat = self._aq_nhat[:avail]
        synd = self._aq_synd[:avail]
        bob_words = (
            self._aq_words[:avail] if self._aq_words is not None else None
        )
        self._aq_x = self._aq_x[avail:]
        self._aq_nhat = self._aq_nhat[avail:]
        self._aq_synd = self._aq_synd[avail:]
        if self._aq_words is not None:
            self._aq_words = self._aq_words[avail:]
        return self._alice_run(n_hat, xf, synd, max_iterations, bob_words)

    def _alice_run(self, n_hat, xf, synd, max_iterations, bob_words,
                   leave_pending=False):
        """Batch-blocked LLR+decode of aligned frames [F, ...]."""
        F = xf.shape[0]
        res = StreamResult()
        if self._alice_jit is None:
            llr_mode = self.llr_mode
            if llr_mode == "table":
                self.nm._ensure_llr_tab()   # before flatten
            elif llr_mode == "poly":
                self.nm._ensure_llr_poly()

            def alice_round(nm, n_hat, x, synd, max_iter):
                lappr = nm.demap_lappr_array(n_hat, x, mode=llr_mode)
                if self.dec._decode_jit is None:
                    self.dec._decode_jit = self.dec._build_decode()
                return self.dec._decode_jit(lappr.T, synd.T, max_iter)

            self._alice_jit = jax.jit(alice_round)

        def harvest(pend):
            (success, iters, total), words_slice, take = pend
            # device->host reads: the only sync points in the pipeline
            words = (np.asarray(total).T < 0).astype(np.uint8)[:take]
            if words_slice is not None:
                res.bit_errors += int(np.sum(words != words_slice))
            res.frames += take
            res.decoded_words.extend(list(words))
            res.success.extend(bool(s) for s in np.asarray(success)[:take])
            res.iterations.extend(int(i) for i in np.asarray(iters)[:take])

        # double-buffered like _bob_run: dispatch block r+1 before reading
        # block r, overlapping the uint8/bf16 uploads and the decode with
        # the previous block's readback.  The pending slot
        # persists ACROSS calls in defer mode (leave_pending=True) — each
        # deferred call carries exactly one batch, so only a cross-call
        # pipeline overlaps Bob's batch r+1 with Alice's batch r.  The
        # pending tuple is self-contained (snapshots its bob_words slice);
        # its frames are reported in whichever call harvests them.
        for lo in range(0, F, self.batch):
            hi = min(lo + self.batch, F)
            take = hi - lo
            nh, xs, sd = n_hat[lo:hi], xf[lo:hi], synd[lo:hi]
            pad = self.batch - take
            if pad:
                # pad the tail block to the fixed batch shape (single jit
                # program for every block); padded lanes are trimmed below
                nh = np.concatenate([nh, np.repeat(nh[-1:], pad, 0)])
                xs = np.concatenate([xs, np.repeat(xs[-1:], pad, 0)])
                sd = np.concatenate([sd, np.repeat(sd[-1:], pad, 0)])
            self.decode_dispatches += 1
            # host->device bandwidth binds this path: ship
            # symbol indices at the smallest sufficient width (uint8 for
            # any real alphabet) instead of int64 — 8x less upload
            idx_dt = np.uint8 if self.pa.order <= 256 else np.int32
            out = self._alice_jit(
                self.nm,
                jnp.asarray(nh, self.nm.dtype),
                jnp.asarray(xs.astype(idx_dt)),
                jnp.asarray(sd),
                jnp.int32(max_iterations),
            )
            ws = (
                np.asarray(bob_words, np.uint8)[lo:hi]
                if bob_words is not None else None
            )
            if self._alice_pending is not None:
                harvest(self._alice_pending)
            self._alice_pending = (out, ws, take)
        if not leave_pending and self._alice_pending is not None:
            harvest(self._alice_pending)
            self._alice_pending = None
        return res

    # -------------------------------------------- device-handoff step pair

    def bob_step(self, y_block) -> DeviceHandoff:
        """Bob's side with DEVICE-RESIDENT outputs: consume a block of
        Bob's samples, return a :class:`DeviceHandoff` covering the
        FULL batches that accumulated (may be empty).

        Protocol-equivalent to :meth:`bob_process` — the same jitted
        program computes the same (words, syndromes, softening metrics),
        and the y carry buffer is shared — but nothing is read back to
        the host: the outputs stay on device for :meth:`alice_step`,
        skipping the split API's structural device->host->device bounce
        (~20 MB per DVB-S2 batch — its measured binder; the fused driver
        that avoids it holds 4.87M symbols/s vs the split API's 1.29M).
        Completed frames queue until a full ``batch`` accumulates (the
        stream_fused discipline: a padded partial batch costs the whole
        batch's device work — the measured 27x defer-mode waste);
        :meth:`bob_step_flush` drains the padded tail once at end of
        stream.  Use the split ``bob_process``/``alice_process`` pair
        when the two sides genuinely run on different hosts.  Not
        available in defer mode (the deferred host queues would desync
        from the handle's batches).
        """
        if self.defer:
            raise ValueError(
                "bob_step/alice_step require defer=False (bob_step "
                "already queues to full batches; the deferred host "
                "queues would desync from the handle's batches)"
            )
        y = np.concatenate(
            [self._carry_y, np.asarray(y_block, np.float64).ravel()]
        )
        F = y.size // self.N_symb
        self._carry_y = y[F * self.N_symb:]
        if F:
            self._bob_q = np.concatenate(
                [self._bob_q, y[: F * self.N_symb].reshape(F, self.N_symb)],
                axis=0,
            )
        P = (self._bob_q.shape[0] // self.batch) * self.batch
        yf = self._bob_q[:P]
        self._bob_q = self._bob_q[P:]
        return self._bob_step_run(yf)

    def bob_step_flush(self) -> DeviceHandoff:
        """Drain Bob's queued frames into a final (padded) handoff batch.
        No-op (empty handle) when nothing is queued."""
        yf = self._bob_q
        self._bob_q = np.empty((0, self.N_symb), np.float64)
        return self._bob_step_run(yf)

    def _bob_step_run(self, yf) -> DeviceHandoff:
        bob = self._ensure_bob_jit()
        hand = DeviceHandoff()
        F = yf.shape[0]
        for lo in range(0, F, self.batch):
            hi = min(lo + self.batch, F)
            take = hi - lo
            blk = yf[lo:hi]
            pad = self.batch - take
            if pad:
                blk = np.concatenate([blk, np.repeat(blk[-1:], pad, 0)])
            w, s, nh = bob(self.nm, jnp.asarray(blk, self.nm.dtype))
            hand.batches.append((w, s, nh, take))
            hand.frames += take
        return hand

    def _ensure_alice_handoff_jit(self):
        if getattr(self, "_alice_handoff_jit", None) is not None:
            return self._alice_handoff_jit
        llr_mode = self.llr_mode
        if llr_mode == "table":
            self.nm._ensure_llr_tab()   # before flatten
        elif llr_mode == "poly":
            self.nm._ensure_llr_poly()
        pack_bits = _make_pack_bits(self.N)

        def alice_handoff_round(nm, n_hat, x, synd, words, max_iter):
            lappr = nm.demap_lappr_array(n_hat, x, mode=llr_mode)
            if self.dec._decode_jit is None:
                self.dec._decode_jit = self.dec._build_decode()
            success, iters, total = self.dec._decode_jit(
                lappr.T, synd.T, max_iter
            )
            alice_bits = (total.T < 0).astype(jnp.int32)
            errs = jnp.sum(
                jnp.bitwise_xor(alice_bits, words.astype(jnp.int32)),
                axis=1,
            )
            return success, iters, errs, pack_bits(alice_bits)

        self._alice_handoff_jit = jax.jit(alice_handoff_round)
        return self._alice_handoff_jit

    def alice_step(self, handoff: DeviceHandoff, x_block,
                   max_iterations: int = 50) -> StreamResult:
        """Alice's side consuming a :class:`DeviceHandoff`: LLR + decode
        with Bob's (n_hat, synd, words) staying on device end to end.

        ``x_block`` streams like :meth:`alice_process`'s (shared x carry
        buffer) and must complete at least the handoff's frames; excess
        symbols carry over.  Bit errors are counted ON DEVICE against
        Bob's words and decoded words come back bit-packed (the
        stream_fused download contract), so per batch only Alice's x
        goes up and ~0.5 MB of packed words/counters comes down.
        Batches are popped from the handle at dispatch, so peak device
        pinning stays ~one batch plus the in-flight outputs rather than
        the whole handle.  Returns a StreamResult.
        """
        x = np.concatenate(
            [self._carry_x, np.asarray(x_block, np.int64).ravel()]
        )
        Fh = handoff.frames
        if x.size < Fh * self.N_symb:
            # absorb x_block into the carry BEFORE raising so the error
            # is recoverable: a retry with the missing tail symbols
            # resumes the aligned stream instead of silently desyncing
            self._carry_x = x
            raise ValueError(
                f"x stream completes {x.size // self.N_symb} frames but "
                f"the handoff carries {Fh}"
            )
        self._carry_x = x[Fh * self.N_symb:]
        xf = x[: Fh * self.N_symb].reshape(Fh, self.N_symb)
        jit = self._ensure_alice_handoff_jit()
        idx_dt = np.uint8 if self.pa.order <= 256 else np.int32
        res = StreamResult()
        pending = None

        def harvest(p):
            (succ, iters, errs, packed), take = p
            res.frames += take
            res.success.extend(bool(v) for v in np.asarray(succ)[:take])
            res.iterations.extend(
                int(v) for v in np.asarray(iters)[:take]
            )
            res.bit_errors += int(np.asarray(errs)[:take].sum())
            words = np.unpackbits(
                np.asarray(packed)[:take], axis=1, bitorder="little"
            )[:, : self.N]
            res.decoded_words.extend(list(words))

        lo = 0
        while handoff.batches:
            # pop at dispatch so each batch's device arrays are released
            # as soon as its program is in flight (peak pinning stays
            # ~one batch + the pipelined pending outputs, not the handle)
            w, s, nh, take = handoff.batches.pop(0)
            handoff.frames -= take
            xs = xf[lo:lo + take]
            lo += take
            pad = self.batch - take
            if pad:
                xs = np.concatenate([xs, np.repeat(xs[-1:], pad, 0)])
            self.decode_dispatches += 1
            out = jit(
                self.nm, nh, jnp.asarray(xs.astype(idx_dt)), s, w,
                jnp.int32(max_iterations),
            )
            if pending is not None:
                harvest(pending)
            pending = (out, take)
        if pending is not None:
            harvest(pending)
        return res

    # ------------------------------------------------- fused protocol path

    def _ensure_fused_jit(self):
        """One jitted program for the WHOLE per-batch protocol: Bob
        (hard-decide + softening metric + word + syndrome) feeding Alice
        (LLR + decode) without the device->host->device bounce of the
        split API, plus device-side bit-error accounting and bit-PACKED
        word downloads.  Per 64-frame DVB-S2 batch this shrinks the
        host<->device traffic from ~20 MB (split API: Bob's words/synd/n_hat
        down, then n_hat/synd back up, then bf16 totals down) to the y/x
        uploads + ~0.5 MB of packed words and counters."""
        if getattr(self, "_fused_jit", None) is not None:
            return self._fused_jit
        llr_mode = self.llr_mode
        if llr_mode == "table":
            self.nm._ensure_llr_tab()
        elif llr_mode == "poly":
            self.nm._ensure_llr_poly()
        pack_bits = _make_pack_bits(self.N)

        def fused_round(nm, y, x, max_iter):
            x_hat = nm.hard_decide_index(y)
            n_hat = nm.map_noise(y, x_hat)
            words = self.pa.demap_symbols_to_bits(x_hat)      # [B, N]
            synd = self.mat.eval_syndrome(words)
            lappr = nm.demap_lappr_array(n_hat, x, mode=llr_mode)
            if self.dec._decode_jit is None:
                self.dec._decode_jit = self.dec._build_decode()
            success, iters, total = self.dec._decode_jit(
                lappr.T, synd.T, max_iter
            )
            alice_bits = (total.T < 0).astype(jnp.int32)      # [B, N]
            errs = jnp.sum(
                jnp.bitwise_xor(alice_bits, words.astype(jnp.int32)),
                axis=1,
            )                                                  # [B] int32
            return success, iters, errs, pack_bits(alice_bits)

        if self.mesh_axis is not None:
            from jax.sharding import PartitionSpec as P

            mesh, ax = self.mesh_axis
            self._fused_jit = jax.jit(jax.shard_map(
                fused_round, mesh=mesh,
                in_specs=(P(), P(ax), P(ax), P()),
                out_specs=P(ax), check_vma=False,
            ))
        else:
            self._fused_jit = jax.jit(fused_round)
        return self._fused_jit

    def stream_fused(self, y_stream, x_stream, max_iterations: int = 50):
        """Run the full Bob->Alice reconciliation over chunked streams in
        ONE device program per batch (see :meth:`_ensure_fused_jit`).

        The split ``bob_process``/``alice_process`` API is the
        protocol-faithful host boundary (Bob's outputs cross a classical
        channel); this is the throughput path for simulation/evaluation,
        where both streams are visible to one host.  Chunks may be any
        sizes (carry-over boundary handling both sides); frames complete
        when BOTH streams cover them.  One batch stays in flight
        (double-buffered); the tail is padded once.  Returns a
        StreamResult with exact per-frame success/iterations, decoded
        words, and bit_errors vs Bob's words (counted on device).
        """
        if isinstance(y_stream, np.ndarray):
            y_stream = [y_stream]
        if isinstance(x_stream, np.ndarray):
            x_stream = [x_stream]
        y_it, x_it = iter(y_stream), iter(x_stream)
        S, B, N = self.N_symb, self.batch, self.N
        need = B * S
        idx_dt = np.uint8 if self.pa.order <= 256 else np.int32
        ycar = np.empty(0, np.float64)
        xcar = np.empty(0, np.int64)
        res = StreamResult()
        jit = self._ensure_fused_jit()
        pending = None

        def harvest(p):
            (succ, iters, errs, packed), take = p
            res.frames += take
            res.success.extend(bool(v) for v in np.asarray(succ)[:take])
            res.iterations.extend(int(v) for v in np.asarray(iters)[:take])
            res.bit_errors += int(np.asarray(errs)[:take].sum())
            words = np.unpackbits(
                np.asarray(packed)[:take], axis=1, bitorder="little"
            )[:, :N]
            res.decoded_words.extend(list(words))

        def dispatch(yb, xb, take):
            nonlocal pending
            self.decode_dispatches += 1
            out = jit(
                self.nm,
                jnp.asarray(yb, self.nm.dtype),
                jnp.asarray(xb.astype(idx_dt)),
                jnp.int32(max_iterations),
            )
            if pending is not None:
                harvest(pending)
            pending = (out, take)

        y_done = x_done = False
        while True:
            # top up: each side ends this block either exhausted or with
            # >= one full batch of symbols
            while ycar.size < need and not y_done:
                try:
                    ycar = np.concatenate(
                        [ycar, np.asarray(next(y_it), np.float64).ravel()]
                    )
                except StopIteration:
                    y_done = True
            while xcar.size < need and not x_done:
                try:
                    xcar = np.concatenate(
                        [xcar, np.asarray(next(x_it), np.int64).ravel()]
                    )
                except StopIteration:
                    x_done = True
            avail = min(ycar.size, xcar.size) // S
            if avail >= B:
                yb = ycar[:need].reshape(B, S)
                xb = xcar[:need].reshape(B, S)
                ycar, xcar = ycar[need:], xcar[need:]
                dispatch(yb, xb, B)
                continue
            if avail:     # padded tail, once (symbols past the shorter
                yb = ycar[: avail * S].reshape(avail, S)   # stream's last
                xb = xcar[: avail * S].reshape(avail, S)   # frame cannot
                pad = B - avail                            # decode)
                yb = np.concatenate([yb, np.repeat(yb[-1:], pad, 0)])
                xb = np.concatenate([xb, np.repeat(xb[-1:], pad, 0)])
                dispatch(yb, xb, avail)
            break
        if pending is not None:
            harvest(pending)
        return res
