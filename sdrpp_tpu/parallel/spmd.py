"""Channel-shard context: lets per-channel-constant stages run under
shard_map.

Why this exists: the VFO-bank stages bake per-channel host tables into the
trace (mix_bank's phase-ramp tables, FFTChannelizerBank's tap spectra /
bin starts). Under GSPMD auto-partitioning that is fine — the compiler
splits the constants — but GSPMD does not partition Pallas custom calls,
so the production bank on a multi-device mesh runs under shard_map,
where each device traces the SAME program on LOCAL [C/d, ...] shards and
a baked [C_total, ...] constant no longer lines up.

The fix stays leaf-local: ``ScannerBank.sharded_step`` enters
``channel_shard(axis)`` around the bank body; the two table-baking stages
check :func:`current_channel_axis` and, when set, bake the FULL table as
a (small, replicated) constant and take their device's row block with a
``dynamic_slice`` at ``axis_index * C_local``. Everything else in the
bank is shape-polymorphic over the leading channel axis and needs no
change.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import jax
import jax.numpy as jnp

__all__ = ["channel_shard", "current_channel_axis", "shard_index",
           "local_rows"]

_state = threading.local()


@contextmanager
def channel_shard(axis):
    """Mark the dynamic extent as running inside shard_map over ``axis``
    (a mesh axis name, or a tuple of names sharding the channel dim
    jointly, e.g. ('host', 'chip'))."""
    prev = getattr(_state, "axis", None)
    _state.axis = axis
    try:
        yield
    finally:
        _state.axis = prev


def current_channel_axis():
    """The active channel-shard axis name(s), or None outside shard_map."""
    return getattr(_state, "axis", None)


def shard_index(axis) -> jax.Array:
    """Flattened index of this device along ``axis`` (name or tuple of
    names, row-major like PartitionSpec((a, b), ...))."""
    if isinstance(axis, (tuple, list)):
        idx = jnp.zeros((), jnp.int32)
        for name in axis:
            idx = idx * jax.lax.axis_size(name) + jax.lax.axis_index(name)
        return idx
    return jax.lax.axis_index(axis)


def local_rows(full, n_local: int, axis=None) -> jax.Array:
    """This device's ``n_local``-row block of a full [C_total, ...] table
    (baked replicated; the slice start is axis_index * n_local)."""
    if axis is None:
        axis = current_channel_axis()
    full = jnp.asarray(full)
    start = shard_index(axis) * n_local
    return jax.lax.dynamic_slice_in_dim(full, start, n_local, axis=0)
