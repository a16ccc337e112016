"""Device mesh + sharding helpers.

The reference is a single-process thread pipeline (SURVEY.md §2.15); the
scaling axes here are (a) channels — a VFO bank sharded across devices —
and (b) time — long-IQ blocks split with FIR-halo exchange. This module
holds the mesh plumbing both use: a 1- or 2-axis ``jax.sharding.Mesh`` with
named axes ``('channels', 'time')`` and NamedSharding helpers.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "channel_sharding", "time_sharding", "replicated"]


def make_mesh(n_channels_axis: int | None = None, n_time_axis: int = 1,
              devices=None) -> Mesh:
    """Build a ('channels', 'time') mesh over the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    if n_channels_axis is None:
        n_channels_axis = len(devices) // n_time_axis
    n = n_channels_axis * n_time_axis
    dev_array = np.asarray(devices[:n]).reshape(n_channels_axis, n_time_axis)
    return Mesh(dev_array, axis_names=("channels", "time"))


def channel_sharding(mesh: Mesh, ndim: int = 2) -> NamedSharding:
    """Shard the leading (channel) axis; replicate the rest."""
    spec = P("channels", *([None] * (ndim - 1)))
    return NamedSharding(mesh, spec)


def time_sharding(mesh: Mesh, ndim: int = 1) -> NamedSharding:
    """Shard the trailing (time) axis."""
    spec = P(*([None] * (ndim - 1)), "time")
    return NamedSharding(mesh, spec)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
