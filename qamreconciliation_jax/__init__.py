"""qamreconciliation_jax — a reverse-reconciliation framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
``moriglia/qam-reconciliation`` package (syndrome-based LDPC belief propagation,
PAM softening / noise mapping, LLR generation, mutual-information estimators,
Monte-Carlo BER/FER sweep engines), built batched-first for accelerators:

* every per-symbol / per-edge scalar loop of the reference becomes a batched
  tensor op over a frame batch ``B`` (the contiguous minor axis),
* the Tanner graph is compiled into static dual-layout gather metadata
  (no jagged pointers, no scatters in the decode hot loop),
* Monte-Carlo sweeps shard the frame population over a ``jax.sharding.Mesh``
  with ``psum``-reduced counters.

Public API mirrors the reference package root
(reference: qamreconciliation/__init__.py:1-4)::

    Decoder, Matrix, NoiseMapper, NoiseDemapper, NoiseMapperFlipSign,
    NoiseMapperAntiFlipSign, PAMAlphabet

Extensions exported alongside: ``QCDecoder`` (circulant-roll decoder
for quasi-cyclic codes) and ``detect_qc`` (recover the circulant lifting
from an expanded edge list).
"""

from .models.alphabet import PAMAlphabet
from .models.matrix import Matrix
from .models.decoder import Decoder, TannerGraph
from .models.noisemapper import (
    NoiseMapper,
    NoiseDemapper,
    NoiseMapperFlipSign,
    NoiseMapperAntiFlipSign,
)
from .models.qc_decoder import QCDecoder, detect_qc

__all__ = [
    "Decoder",
    "TannerGraph",
    "Matrix",
    "NoiseMapper",
    "NoiseDemapper",
    "NoiseMapperFlipSign",
    "NoiseMapperAntiFlipSign",
    "PAMAlphabet",
    "QCDecoder",
    "detect_qc",
]

__version__ = "0.1.0"
