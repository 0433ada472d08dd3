"""Probabilistically-shaped M-PAM alphabet.

Capability parity with the reference PAM alphabet
(reference: qamreconciliation/alphabet.pyx:34-107), re-designed batched-first:

* the constellation / threshold / Gray tables are small host-side numpy
  float64 arrays (exact, built once per alphabet),
* symbol sampling uses ``jax.random`` (counter-based, reproducible, shardable)
  instead of the reference's global-seed ``np.random.choice``
  (reference: qamreconciliation/alphabet.pyx:79-83),
* ``index_to_value`` / ``demap_symbols_to_bits`` are vectorised gathers that
  accept arbitrary leading batch dimensions.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from . import bicm
from ..config import DEFAULT_DTYPE, INDEX_DTYPE

__all__ = ["PAMAlphabet"]


class PAMAlphabet:
    """M-PAM constellation with optional probabilistic shaping.

    Attributes (all numpy float64 on host, mirroring
    reference: qamreconciliation/alphabet.pxd:18-24):

    * ``bit_per_symbol`` — log2(order)
    * ``order`` — constellation size M = 2**bit_per_symbol
    * ``step`` — grid spacing
    * ``constellation[M]`` — ``(i - (M-1)/2) * step``
    * ``probabilities[M]`` — symbol probabilities (default uniform)
    * ``variance`` — Es = sum p_i |a_i|^2
    * ``thresholds[M+1]`` — decision thresholds: interior midpoints, outer
      sentinels at ``100 * edge`` (reference: qamreconciliation/alphabet.pyx:69-73)
    * ``s_to_b[M, bps]`` — Gray symbol->bits table
    """

    def __init__(self, bit_per_symbol: int, step: float, probabilities=None):
        if bit_per_symbol <= 0:
            raise ValueError(
                f"Bit per symbol must be at least 1, got {bit_per_symbol}"
            )
        self.bit_per_symbol = int(bit_per_symbol)
        self.order = 1 << self.bit_per_symbol
        self.step = float(step)

        if probabilities is None:
            self.probabilities = np.full(self.order, 1.0 / self.order)
        else:
            probabilities = np.asarray(probabilities, dtype=np.float64)
            if probabilities.size != self.order:
                raise ValueError(
                    "Probability vector does not match constellation size"
                )
            if np.any(probabilities <= 0):
                raise ValueError("Probabilities must be positive")
            if abs(probabilities.sum() - 1.0) > 1e-9:
                raise ValueError("Probabilities do not sum to 1")
            self.probabilities = probabilities

        self.constellation = (
            np.arange(self.order, dtype=np.float64) - (self.order - 1) / 2
        ) * self.step
        self.variance = float(
            np.sum(self.probabilities * np.abs(self.constellation) ** 2)
        )

        self.thresholds = np.empty(self.order + 1, dtype=np.float64)
        self.thresholds[1:self.order] = self.constellation[1:] - self.step / 2
        self.thresholds[0] = self.constellation[0] * 100    # very negative
        self.thresholds[-1] = self.constellation[-1] * 100  # very positive

        self.s_to_b = bicm.generate_table_s_to_b(self.bit_per_symbol)

        # Device-side copies for batched ops.
        self._constellation_dev = jnp.asarray(self.constellation, DEFAULT_DTYPE)
        self._s_to_b_dev = jnp.asarray(self.s_to_b, jnp.uint8)
        self._cum_prob = np.concatenate([[0.0], np.cumsum(self.probabilities)])

    # ------------------------------------------------------------------ #

    def random_symbols(self, key: jax.Array, shape) -> jax.Array:
        """Sample shaped symbol indices, any output shape.

        Inverse-CDF sampling on uniform draws (replaces the reference's
        ``np.random.choice``, reference: qamreconciliation/alphabet.pyx:79-83).
        """
        if np.isscalar(shape):
            shape = (int(shape),)
        u = jax.random.uniform(key, shape, dtype=jnp.float32)
        # Inverse-CDF: index = #{interior cum cut points <= u}, accumulated
        # one scalar at a time.  Equivalent to searchsorted(side="right"),
        # but pure elementwise code with no search or compare-reduce over a
        # small trailing axis.
        idx = jnp.zeros(u.shape, jnp.float32)
        for c in self._cum_prob[1:-1]:
            idx += (u >= jnp.float32(c)).astype(jnp.float32)
        return idx.astype(INDEX_DTYPE)

    def index_to_value(self, index: jax.Array, dtype=DEFAULT_DTYPE) -> jax.Array:
        """Constellation values for symbol indices (any shape).

        Mirrors reference: qamreconciliation/alphabet.pyx:86-95.
        """
        return jnp.asarray(self.constellation, dtype)[index]

    def demap_symbols_to_bits(self, symbol_index: jax.Array) -> jax.Array:
        """Gray bits of symbol indices.

        Input shape ``[..., S]`` -> output shape ``[..., S * bit_per_symbol]``
        with the per-symbol bit blocks contiguous, matching the reference's
        flat layout (reference: qamreconciliation/alphabet.pyx:98-107).
        """
        bits = self._s_to_b_dev[symbol_index]          # [..., S, bps]
        return bits.reshape(*bits.shape[:-2], -1)      # [..., S*bps]
