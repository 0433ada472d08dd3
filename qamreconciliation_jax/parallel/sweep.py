"""Sharded Monte-Carlo rounds: frame-shard DP with psum-reduced counters.

Replaces the reference's parfor process pool (one OS process per SNR point,
results returned by pickling — reference: sims/sim_reconciliation.py:57-93)
with single-controller SPMD: each device of a 1-D mesh runs an independent
batch of frames (its RNG key folded with the mesh axis index) and the four
sweep counters are summed across devices with ``psum``.
"""

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

__all__ = ["shard_round", "sharded_sweep"]


def shard_round(round_fn, mesh, axis_name: str = "dp"):
    """Wrap a per-device round function into a mesh-wide jitted round.

    ``round_fn(key, max_iter, *args) -> counters pytree`` (a stacked [4]
    int32 array for the engines; tuples of scalars also work) runs
    replicated per device with a decorrelated key; any extra args (e.g. a
    NoiseMapper pytree, sigma/alpha scalars) are broadcast unchanged.
    Counters are psum-reduced so every device (and the host) sees the
    global totals.
    """

    def inner(key, max_iter, *args):
        key = jax.random.fold_in(key, jax.lax.axis_index(axis_name))
        counters = round_fn(key, max_iter, *args)
        return jax.tree.map(
            lambda c: jax.lax.psum(jnp.asarray(c), axis_name), counters
        )

    mapped = jax.shard_map(
        inner,
        mesh=mesh,
        in_specs=P(),      # single-spec prefix: everything replicated
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(mapped)


def sharded_sweep(engine, mode, snr_points, mesh, axis_name="dp", **point_kw):
    """Run an SNR sweep with frames sharded over ``mesh``.

    Returns a list of PointResult.  ``engine`` must have been constructed
    with ``mesh_axis=(mesh, axis_name)`` so its rounds psum their counters.
    """
    results = []
    for i, snr in enumerate(snr_points):
        kw = dict(point_kw)
        kw["seed"] = kw.get("seed", 0) + 1000003 * i
        results.append(engine.run_point(mode, float(snr), **kw))
    return results
