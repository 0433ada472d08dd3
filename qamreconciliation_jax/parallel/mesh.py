"""Device mesh helpers.

The reference's only parallelism is a process pool over SNR points
(reference: sims/sim_reconciliation.py:57-93, via parfor).  The replacement
here is frame-shard data parallelism over a 1-D ``jax.sharding.Mesh``
("dp" axis): each device runs a full batch of frames and the four sweep
counters are ``psum``-reduced across devices (SURVEY.md §2 parallelism
table).  The mesh is 1-D because the algorithm has one parallel axis; GPUs
of one host are joined all to all, so there is no device topology to map.

Multi-host clusters compose transparently: ``jax.distributed.initialize`` before
calling :func:`make_mesh` makes ``jax.devices()`` span all hosts.
"""

import jax
from jax.sharding import Mesh

__all__ = ["make_mesh", "device_count", "maybe_distributed_init"]


def device_count() -> int:
    return len(jax.devices())


def make_mesh(n_devices: int | None = None, axis_name: str = "dp") -> Mesh:
    """1-D data-parallel mesh over the first ``n_devices`` devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    import numpy as np

    return Mesh(np.array(devs), (axis_name,))


_dist_state = {"initialized": False}


def maybe_distributed_init(verbose: bool = True) -> bool:
    """Initialize jax.distributed when launched under a multi-host runtime.

    Called by every sweep CLI before any device use (replacement for the
    reference's per-process parfor launch,
    reference: sims/sim_reconciliation.py:57-93).  No-op on single-host (no
    coordinator address in the environment — the common case in tests and
    single-chip runs).  Returns True iff the distributed runtime is active.

    A *failed* init on a multi-host launch is loud: it warns and reports the
    single-host fallback instead of silently mis-attributing the sweep's
    statistics to one host.
    """
    import os
    import sys
    import warnings

    if _dist_state["initialized"]:
        return True
    if not (
        "JAX_COORDINATOR_ADDRESS" in os.environ
        or "COORDINATOR_ADDRESS" in os.environ
    ):
        return False
    try:
        jax.distributed.initialize()
    except Exception as e:
        warnings.warn(
            "multi-host launch detected (coordinator address set) but "
            f"jax.distributed.initialize() failed: {e!r}; FALLING BACK to "
            "single-host — counters will only cover this host's devices",
            RuntimeWarning,
            stacklevel=2,
        )
        return False
    _dist_state["initialized"] = True
    if verbose:
        print(
            f"jax.distributed: process {jax.process_index()}/"
            f"{jax.process_count()}, {jax.local_device_count()} local / "
            f"{len(jax.devices())} global devices",
            file=sys.stderr,
        )
    return True
