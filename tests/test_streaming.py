"""Streaming reconciliation: boundary carry-over + end-to-end decode."""

import numpy as np
import jax.numpy as jnp
import pytest

from qamreconciliation_jax import Decoder, Matrix, PAMAlphabet
from qamreconciliation_jax.models.noisemapper import NoiseMapper
from qamreconciliation_jax.sims.streaming import StreamReconciler
from qamreconciliation_jax.utils import make_regular_ldpc


@pytest.fixture(scope="module")
def chain():
    vid, cid = make_regular_ldpc(240, 3, 6, seed=9)
    dec = Decoder(vid, cid, dtype=jnp.float64)
    mat = Matrix(vid, cid)
    pa = PAMAlphabet(2, 2.0)
    snr = 9.0
    N0 = pa.variance * 10 ** (-snr / 10) / 2
    nm = NoiseMapper(pa, N0, dtype=jnp.float64)
    return dec, mat, pa, nm, np.sqrt(N0)


def _run_stream(chain, chunk_sizes, n_frames=7, batch=3, seed=0):
    dec, mat, pa, nm, sigma = chain
    sr = StreamReconciler(dec, mat, pa, nm, batch=batch)
    rng = np.random.default_rng(seed)
    S = sr.N_symb
    x = rng.integers(0, pa.order, n_frames * S)
    y = pa.constellation[x] + sigma * rng.standard_normal(x.size)

    words, synds, nhats = [], [], []
    pos = 0
    for sz in chunk_sizes(x.size):
        w, s, nh = sr.bob_process(y[pos:pos + sz])
        if w.shape[0]:
            words.append(w)
            synds.append(s)
            nhats.append(nh)
        pos += sz
    words = np.concatenate(words)
    synds = np.concatenate(synds)
    nhats = np.concatenate(nhats)
    assert words.shape[0] == n_frames

    res = StreamReconciler.alice_process(
        sr, nhats, x, synds, max_iterations=30
    )
    return sr, words, res


def irregular_chunks(total):
    """Chunk sizes deliberately misaligned with the frame length."""
    sizes = []
    left = total
    k = 17
    while left > 0:
        sz = min(left, k)
        sizes.append(sz)
        left -= sz
        k = (k * 7) % 97 + 11
    return sizes


def test_stream_misaligned_chunks_decode(chain):
    sr, bob_words, res = _run_stream(chain, irregular_chunks)
    assert res.frames == bob_words.shape[0]
    # high SNR: every frame decodes to Bob's word
    assert all(res.success)
    for got, expect in zip(res.decoded_words, bob_words):
        np.testing.assert_array_equal(got, expect)


def test_stream_matches_single_shot(chain):
    """Streamed processing == one-shot processing of the same samples."""
    _, words_a, res_a = _run_stream(chain, irregular_chunks, seed=4)
    _, words_b, res_b = _run_stream(
        chain, lambda total: [total], seed=4
    )
    np.testing.assert_array_equal(words_a, words_b)
    assert res_a.success == res_b.success
    assert res_a.iterations == res_b.iterations


def test_stream_carry_preserved(chain):
    dec, mat, pa, nm, sigma = chain
    sr = StreamReconciler(dec, mat, pa, nm, batch=2)
    S = sr.N_symb
    rng = np.random.default_rng(2)
    y = rng.normal(0, 2, S + 5)
    w, s, nh = sr.bob_process(y[: S // 2])          # less than one frame
    assert w.shape[0] == 0
    w, s, nh = sr.bob_process(y[S // 2:])           # completes frame 1
    assert w.shape[0] == 1
    assert sr._carry_y.size == 5                     # tail carried


def test_stream_result_fer(chain):
    from qamreconciliation_jax.sims.streaming import StreamResult

    r = StreamResult()
    assert r.fer == 0.0
    r.success = [True, False, True, True]
    assert r.fer == pytest.approx(0.25)


def test_stream_single_compiled_program(chain):
    """Two different stream chunkings share ONE compiled program per side.

    Bob pads partial tail blocks to the fixed batch (mirroring Alice), so
    varying frame counts per call never retrace — each retrace of a DVB-S2-size
    program costs tens of seconds.
    """
    sr_a, _, res_a = _run_stream(chain, irregular_chunks, seed=7)
    assert sr_a._bob_jit._cache_size() == 1
    assert sr_a._alice_jit._cache_size() == 1

    sr_b, _, res_b = _run_stream(chain, lambda total: [total], seed=7)
    assert sr_b._bob_jit._cache_size() == 1
    assert res_a.success == res_b.success


def test_stream_defer_matches_immediate_with_fewer_dispatches(chain):
    """defer=True: identical decoded output to emit-immediately mode on
    the same stream (after flush), with ~chunks-fewer padded decode
    dispatches — the throughput mode for chunk << batch*N_symb feeds."""
    dec, mat, pa, nm, sigma = chain
    rng = np.random.default_rng(11)
    n_frames, batch = 7, 3
    S = mat.vnum // pa.bit_per_symbol
    x = rng.integers(0, pa.order, n_frames * S)
    y = pa.constellation[x] + sigma * rng.standard_normal(x.size)
    chunks = irregular_chunks(x.size)

    def run(defer):
        sr = StreamReconciler(dec, mat, pa, nm, batch=batch, defer=defer)
        words, res = [], []
        pos = 0
        for sz in chunks:
            w, s, nh = sr.bob_process(y[pos:pos + sz])
            words.append(w)
            res.append(sr.alice_process(nh, x[pos:pos + sz], s,
                                        max_iterations=30))
            pos += sz
        if defer:
            w, s, nh = sr.bob_flush()
            words.append(w)
            res.append(sr.alice_process(nh, np.empty(0, np.int64), s, 30))
            res.append(sr.alice_flush(30))
        all_words = np.concatenate([w for w in words if w.shape[0]])
        out = StreamResult()
        for r in res:
            out.frames += r.frames
            out.decoded_words.extend(r.decoded_words)
            out.success.extend(r.success)
            out.iterations.extend(r.iterations)
        return sr, all_words, out

    from qamreconciliation_jax.sims.streaming import StreamResult

    sr_i, words_i, out_i = run(False)
    sr_d, words_d, out_d = run(True)
    assert out_i.frames == out_d.frames == n_frames
    np.testing.assert_array_equal(words_i, words_d)
    assert out_i.success == out_d.success
    assert out_i.iterations == out_d.iterations
    for a, b in zip(out_i.decoded_words, out_d.decoded_words):
        np.testing.assert_array_equal(a, b)
    # immediate mode dispatches a padded batch per frame-completing chunk;
    # deferred mode only ceil(n_frames / batch) times
    assert sr_d.decode_dispatches == -(-n_frames // batch)
    assert sr_d.decode_dispatches < sr_i.decode_dispatches


def test_stream_with_qc_decoder():
    """StreamReconciler works with the circulant-roll QCDecoder (duck-typed
    via _build_decode, like the sweep engines)."""
    from qamreconciliation_jax.models.qc_decoder import QCDecoder, make_qc_ldpc

    base, vid, cid = make_qc_ldpc(12, 16, dv=3, dc=6, seed=4)
    dec = QCDecoder(base, 16, dtype=jnp.float64)
    mat = Matrix(vid, cid)
    pa = PAMAlphabet(2, 2.0)
    snr = 9.0
    N0 = pa.variance * 10 ** (-snr / 10) / 2
    nm = NoiseMapper(pa, N0, dtype=jnp.float64)
    sr = StreamReconciler(dec, mat, pa, nm, batch=3)
    rng = np.random.default_rng(1)
    x = rng.integers(0, pa.order, 5 * sr.N_symb)
    y = pa.constellation[x] + np.sqrt(N0) * rng.standard_normal(x.size)
    w, synd, nh = sr.bob_process(y)
    assert w.shape[0] == 5
    res = StreamReconciler.alice_process(sr, nh, x, synd, max_iterations=30)
    assert sum(res.success) > len(res.success) // 2


def test_defer_rejects_mid_stream_accounting_start(chain):
    """Starting bob_words accounting AFTER rows were queued without it
    would silently misalign the words queue with the frame-queue front;
    both directions must raise."""
    dec, mat, pa, nm, sigma = chain
    sr = StreamReconciler(dec, mat, pa, nm, batch=2, defer=True)
    rng = np.random.default_rng(3)
    S = sr.N_symb
    x = rng.integers(0, pa.order, 2 * S)
    y = pa.constellation[x] + sigma * rng.standard_normal(x.size)
    words, synd, nhat = sr.bob_process(y)
    # the cross-call pipeline keeps the first batch in flight; flush to
    # materialize its outputs for this test's direct alice feeding
    if words.shape[0] == 0:
        words, synd, nhat = sr.bob_flush()
    assert words.shape[0] == 2
    # queue 2 frames WITHOUT accounting ...
    sr.alice_process(nhat, x, synd, max_iterations=4)
    # ... then try to start it: must fail loudly
    x2 = rng.integers(0, pa.order, 2 * S)
    y2 = pa.constellation[x2] + sigma * rng.standard_normal(x2.size)
    words2, synd2, nhat2 = sr.bob_process(y2)
    if words2.shape[0] == 0:
        words2, synd2, nhat2 = sr.bob_flush()
    with pytest.raises(ValueError):
        sr.alice_process(nhat2, x2, synd2, max_iterations=4,
                         bob_words=words2)


def test_stream_fused_matches_split_api(chain):
    """The fused one-program protocol driver produces EXACTLY the split
    bob_process/alice_process results on the same streams: decoded
    words, success, iterations, bit_errors (the LLR/decode chain is the
    same math; packing/unpacking round-trips the words)."""
    dec, mat, pa, nm, sigma = chain
    rng = np.random.default_rng(11)
    F = 7
    S = mat.vnum // pa.bit_per_symbol
    x = rng.integers(0, pa.order, F * S)
    y = pa.constellation[x] + sigma * rng.standard_normal(x.size)
    # misaligned chunks
    cuts = [0, int(1.4 * S), int(3.7 * S), int(4.1 * S), F * S]
    y_chunks = [y[a:b] for a, b in zip(cuts, cuts[1:])]
    x_chunks = [x[a:b] for a, b in zip(cuts, cuts[1:])]

    sr1 = StreamReconciler(dec, mat, pa, nm, batch=3)
    words_l, synd_l, nhat_l = [], [], []
    for yc in y_chunks:
        w, s, nh = sr1.bob_process(yc)
        words_l.append(w); synd_l.append(s); nhat_l.append(nh)
    w = np.concatenate(words_l); s = np.concatenate(synd_l)
    nh = np.concatenate(nhat_l)
    r_split = sr1.alice_process(nh, x, s, max_iterations=8, bob_words=w)

    sr2 = StreamReconciler(dec, mat, pa, nm, batch=3)
    r_fused = sr2.stream_fused(y_chunks, x_chunks, max_iterations=8)

    assert r_fused.frames == r_split.frames == F
    assert r_fused.success == r_split.success
    assert r_fused.iterations == r_split.iterations
    assert r_fused.bit_errors == r_split.bit_errors
    for a, b in zip(r_fused.decoded_words, r_split.decoded_words):
        np.testing.assert_array_equal(a, b)


def test_stream_fused_tail_and_uneven_streams(chain):
    """Tail shorter than a batch is padded once; the shorter stream
    bounds the decodable frames."""
    dec, mat, pa, nm, sigma = chain
    rng = np.random.default_rng(12)
    S = mat.vnum // pa.bit_per_symbol
    x = rng.integers(0, pa.order, 5 * S + S // 2)   # 5.5 frames of x
    y_full = pa.constellation[x[: 5 * S]] \
        + sigma * rng.standard_normal(5 * S)        # 5 frames of y
    sr = StreamReconciler(dec, mat, pa, nm, batch=4)
    r = sr.stream_fused(y_full, x, max_iterations=8)
    assert r.frames == 5
    assert len(r.decoded_words) == 5
    assert all(wd.shape == (mat.vnum,) for wd in r.decoded_words)


def test_stream_fused_frame_sharded_matches_single_device(chain):
    """stream_fused over an 8-device mesh (frame-shard DP, no
    collectives) is bit-exact vs the single-device fused driver."""
    from qamreconciliation_jax.parallel import make_mesh

    dec, mat, pa, nm, sigma = chain
    rng = np.random.default_rng(21)
    F = 10
    S = mat.vnum // pa.bit_per_symbol
    x = rng.integers(0, pa.order, F * S)
    y = pa.constellation[x] + sigma * rng.standard_normal(x.size)

    sr1 = StreamReconciler(dec, mat, pa, nm, batch=8)
    r1 = sr1.stream_fused(y, x, max_iterations=8)
    mesh = make_mesh(8, axis_name="sdp")
    sr2 = StreamReconciler(dec, mat, pa, nm, batch=8,
                           mesh_axis=(mesh, "sdp"))
    r2 = sr2.stream_fused(y, x, max_iterations=8)
    assert r1.frames == r2.frames == F
    assert r1.success == r2.success
    assert r1.iterations == r2.iterations
    assert r1.bit_errors == r2.bit_errors
    for a, b in zip(r1.decoded_words, r2.decoded_words):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        StreamReconciler(dec, mat, pa, nm, batch=6,
                         mesh_axis=(mesh, "sdp"))


# ---------------------------------------------------------------- handoff


def test_handoff_matches_split_api(chain):
    """bob_step/alice_step (device-resident handoff) produce exactly the
    split API's results — same jitted math, no host bounce — including
    device-counted bit_errors and packed-word downloads."""
    dec, mat, pa, nm, sigma = chain
    rng = np.random.default_rng(21)
    n_frames, batch = 7, 3
    sr1 = StreamReconciler(dec, mat, pa, nm, batch=batch)
    S = sr1.N_symb
    x = rng.integers(0, pa.order, n_frames * S)
    y = pa.constellation[x] + sigma * rng.standard_normal(x.size)

    w, s, nh = sr1.bob_process(y)
    r_split = sr1.alice_process(nh, x, s, max_iterations=30, bob_words=w)

    sr2 = StreamReconciler(dec, mat, pa, nm, batch=batch)
    # irregular chunk boundary: the first call completes 2 frames (< one
    # batch of 3 -> queued, empty handle), the second the rest; the
    # padded tail (7 % 3 = 1 frame) drains through bob_step_flush
    h1 = sr2.bob_step(y[: 2 * S + 7])
    assert h1.frames == 0                        # queued, not dispatched
    h2 = sr2.bob_step(y[2 * S + 7:])
    assert h2.frames == (n_frames // batch) * batch
    r1 = sr2.alice_step(h1, x[: 2 * S + 7], max_iterations=30)
    r2 = sr2.alice_step(h2, x[2 * S + 7:], max_iterations=30)
    h3 = sr2.bob_step_flush()
    assert h3.frames == n_frames % batch
    r3 = sr2.alice_step(h3, np.empty(0, np.int64), max_iterations=30)
    assert not h2.batches and not h3.batches      # device memory released

    succ = r1.success + r2.success + r3.success
    iters = r1.iterations + r2.iterations + r3.iterations
    words = r1.decoded_words + r2.decoded_words + r3.decoded_words
    errs = r1.bit_errors + r2.bit_errors + r3.bit_errors
    assert r1.frames + r2.frames + r3.frames == r_split.frames == n_frames
    assert succ == r_split.success
    assert iters == r_split.iterations
    assert errs == r_split.bit_errors
    for got, expect in zip(words, r_split.decoded_words):
        np.testing.assert_array_equal(got, expect)


def test_handoff_validation(chain):
    """defer mode refuses the handoff pair; alice_step refuses an x
    stream that cannot cover the handle's frames."""
    dec, mat, pa, nm, sigma = chain
    sr = StreamReconciler(dec, mat, pa, nm, batch=2, defer=True)
    with pytest.raises(ValueError, match="defer"):
        sr.bob_step(np.zeros(10))
    sr = StreamReconciler(dec, mat, pa, nm, batch=2)
    S = sr.N_symb
    rng = np.random.default_rng(3)
    x = rng.integers(0, pa.order, 2 * S)
    y = pa.constellation[x] + sigma * rng.standard_normal(x.size)
    h = sr.bob_step(y)
    assert h.frames == 2
    with pytest.raises(ValueError, match="handoff carries"):
        sr.alice_step(h, x[: S // 2], max_iterations=8)


def test_handoff_mixing_and_recovery_guards(chain):
    """Review regressions: bob_process(defer=False) refuses to run past
    frames queued by bob_step (silent reordering hazard), and the
    alice_step x-shortfall error absorbs x_block into the carry so a
    retry with the missing tail resumes the aligned stream."""
    dec, mat, pa, nm, sigma = chain
    sr = StreamReconciler(dec, mat, pa, nm, batch=2)
    S = sr.N_symb
    rng = np.random.default_rng(5)
    x = rng.integers(0, pa.order, 2 * S)
    y = pa.constellation[x] + sigma * rng.standard_normal(x.size)
    sr.bob_step(y[:S])                  # 1 frame queued (< batch)
    with pytest.raises(ValueError, match="bob_step_flush"):
        sr.bob_process(y[S:])
    sr2 = StreamReconciler(dec, mat, pa, nm, batch=2)
    h = sr2.bob_step(y)                 # full batch of 2
    with pytest.raises(ValueError, match="handoff carries"):
        sr2.alice_step(h, x[: S + 3], max_iterations=8)
    # retry with ONLY the missing tail: carry absorbed the first chunk
    r = sr2.alice_step(h, x[S + 3:], max_iterations=8)
    assert r.frames == 2 and all(r.success)
