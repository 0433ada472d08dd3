"""Gray/BICM table tests.

The closed-form table is validated against an independent recursive
construction of the binary-reflected Gray code (the same construction idea as
reference: qamreconciliation/bicm.pyx:26-41, re-derived here).
"""

import numpy as np
import pytest

from qamreconciliation_jax.models import bicm


def _recursive_gray(log_order: int) -> np.ndarray:
    if log_order == 1:
        return np.array([[0], [1]], dtype=np.uint8)
    prev = _recursive_gray(log_order - 1)
    half = prev.shape[0]
    out = np.empty((2 * half, log_order), dtype=np.uint8)
    out[:half, : log_order - 1] = prev
    out[half:, : log_order - 1] = prev[::-1]
    out[:half, log_order - 1] = 0
    out[half:, log_order - 1] = 1
    return out


@pytest.mark.parametrize("bps", [1, 2, 3, 4, 6])
def test_s_to_b_matches_reflected_construction(bps):
    np.testing.assert_array_equal(
        bicm.generate_table_s_to_b(bps), _recursive_gray(bps)
    )


def test_s_to_b_rejects_nonpositive():
    with pytest.raises(ValueError):
        bicm.generate_table_s_to_b(0)


def test_gray_adjacent_symbols_differ_in_one_bit():
    for bps in (2, 3, 4):
        t = bicm.generate_table_s_to_b(bps).astype(int)
        d = np.abs(np.diff(t, axis=0)).sum(axis=1)
        assert (d == 1).all()


@pytest.mark.parametrize("bps", [1, 2, 3, 4])
def test_error_number_table_is_pairwise_hamming(bps):
    t = bicm.generate_table_s_to_b(bps)
    n_err = bicm.generate_error_number_table(t)
    M = 1 << bps
    expect = np.array(
        [[(t[i].astype(int) ^ t[j].astype(int)).sum() for j in range(M)] for i in range(M)]
    )
    np.testing.assert_array_equal(n_err, expect)
    assert (n_err == n_err.T).all()
    assert (np.diag(n_err) == 0).all()


def test_gray_bit_group_matches_mod_index_rule():
    # The reference selects the LLR denominator group with
    # (mod_index*(mod_index+1)) & 0b11 where mod_index = i >> k
    # (reference: qamreconciliation/noisemapper.pyx:210).  Our mask must
    # agree with that rule: nonzero <=> Gray bit k of i is 1.
    for bps in (1, 2, 3, 4):
        mask = bicm.gray_bit_masks(bps)
        for i in range(1 << bps):
            for k in range(bps):
                m = i >> k
                ref_is_denominator = bool((m * (m + 1)) & 0b11)
                assert bool(mask[i, k]) == ref_is_denominator
