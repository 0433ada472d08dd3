import os

import numpy as np
import jax.numpy as jnp
import pytest

from qamreconciliation_jax import Matrix
from qamreconciliation_jax.models.decoder import TannerGraph
from qamreconciliation_jax.utils import (
    load_edge_csv,
    save_edge_csv,
    make_regular_ldpc,
)

HAMMING_CSV = os.path.join(os.path.dirname(__file__), "data", "hamming_7-4.csv")


def test_load_edge_csv_first_row_convention():
    vid, cid = load_edge_csv(HAMMING_CSV)
    assert vid.size == 12
    assert cid.size == 12
    assert vid.max() == 6
    assert cid.max() == 2


def test_save_load_roundtrip(tmp_path):
    vid, cid = make_regular_ldpc(24, 3, 6, seed=3)
    path = str(tmp_path / "code.csv")
    save_edge_csv(path, vid, cid)
    v2, c2 = load_edge_csv(path)
    np.testing.assert_array_equal(v2, vid)
    np.testing.assert_array_equal(c2, cid)


def test_matrix_counts():
    vid, cid = load_edge_csv(HAMMING_CSV)
    mat = Matrix(vid, cid)
    assert mat.vnum == 7
    assert mat.cnum == 3
    assert mat.ednum == 12
    with pytest.raises(ValueError):
        Matrix([0, 1], [0])


def test_eval_syndrome_vs_xor_scatter():
    vid, cid = make_regular_ldpc(48, 3, 6, seed=4)
    mat = Matrix(vid, cid)
    rng = np.random.default_rng(0)
    word = rng.integers(0, 2, size=(5, mat.vnum)).astype(np.uint8)
    got = np.asarray(mat.eval_syndrome(word))
    expect = np.zeros((5, mat.cnum), dtype=np.uint8)
    for b in range(5):
        for e in range(vid.size):
            expect[b, cid[e]] ^= word[b, vid[e]]
    np.testing.assert_array_equal(got, expect)


def test_dual_layout_roundtrip():
    """An edge value pushed var-major -> check-major -> var-major must come
    back unchanged on every real slot."""
    vid, cid = make_regular_ldpc(36, 3, 6, seed=5)
    g = TannerGraph(vid, cid)
    rng = np.random.default_rng(1)
    edge_vals = rng.standard_normal(g.ednum)

    flat_v = np.zeros((g.vnum * g.dv_max, 1))
    flat_v[g.var_slot_of_edge, 0] = edge_vals
    cmaj = g.permute_v_to_c(jnp.asarray(flat_v))
    # every edge must appear at its check slot
    got_edge_vals = np.asarray(cmaj).reshape(-1)[g.chk_slot_of_edge]
    np.testing.assert_array_equal(got_edge_vals, edge_vals)

    back = g.permute_c_to_v(jnp.asarray(np.asarray(cmaj).reshape(-1, 1)))
    got_v = np.asarray(back).reshape(-1)[g.var_slot_of_edge]
    np.testing.assert_array_equal(got_v, edge_vals)


def test_irregular_degrees_padding():
    # graph with degree-1 and degree-3 nodes
    vid = np.array([0, 1, 1, 2, 2, 2])
    cid = np.array([0, 0, 1, 0, 1, 1])
    g = TannerGraph(vid, cid)
    assert g.dv_max == 3
    assert g.dc_max == 3
    assert g.vnum == 3 and g.cnum == 2 and g.ednum == 6
    np.testing.assert_array_equal(g.dv, [1, 2, 3])
    np.testing.assert_array_equal(g.dc, [3, 3])
