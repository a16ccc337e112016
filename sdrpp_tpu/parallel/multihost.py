"""Multi-host pod execution: distributed init + per-host ingest.

SURVEY §2.15/§5 distributed plan: ICI collectives intra-slice (the
channel/time sharding in vfo_bank.py and time_shard.py), DCN between
slices, and a host-side ingest layer feeding per-host device buffers (the
role the reference's TCP server protocol plays for remote IQ delivery —
io/wire.py speaks that exact wire format).

One real chip is available in this environment, so pod runs can't be
exercised here; this module is the process-level plumbing, written to the
standard jax.distributed contract and validated for structure by
tests on the single-process path. On a pod:

    # on every host (coordinator = host 0):
    rx = MultiHostReceiver(coordinator="host0:8476", num_processes=N,
                           process_id=i, channels_per_host=64, ...)
    rx.run(source)  # each host feeds its local shard of channels
"""

from __future__ import annotations

import numpy as np
import jax

from jax.sharding import Mesh

from ..io.sources import FileSource
from .vfo_bank import ScannerBank

__all__ = ["distributed_init", "global_channel_mesh", "MultiHostReceiver",
           "host_shard_paths", "put_global", "gather_global"]


def distributed_init(coordinator: str | None = None, num_processes: int = 1,
                     process_id: int = 0):
    """Initialize jax.distributed when running multi-process; no-op for a
    single process (the local-devices path used in tests)."""
    if num_processes > 1:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
    return jax.process_count(), jax.process_index()


def global_channel_mesh() -> Mesh:
    """A 1-D 'channels' mesh over ALL devices across hosts (ICI+DCN)."""
    devs = np.asarray(jax.devices())
    return Mesh(devs.reshape(len(devs)), axis_names=("channels",))


def host_shard_paths(paths, process_index: int, process_count: int):
    """Per-host file sharding: host i reads every i-th capture file
    (the per-host ingest half of the SURVEY §5 plan)."""
    return list(paths)[process_index::process_count]


def put_global(arr, sharding):
    """Place an array onto a (possibly multi-process) sharding.

    Single process: plain device_put.  Multi-process: assemble the global
    array from the per-process copy with make_array_from_process_local_data
    (each host passes the full logical array; JAX slices out its
    addressable shards) — device_put cannot target non-addressable devices.
    """
    if jax.process_count() > 1:
        arr = np.asarray(arr)
        # global_shape == local shape tells JAX the data is the full
        # logical array (replicated on every host) and each process
        # slices out its own addressable shards.
        return jax.make_array_from_process_local_data(
            sharding, arr, global_shape=arr.shape)
    return jax.device_put(arr, sharding)


def gather_global(x):
    """Fetch a (possibly non-fully-addressable) array to every host."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


class MultiHostReceiver:
    """Channel-sharded scanner bank spanning all hosts' devices.

    Each host contributes ``channels_per_host`` channels; the wideband
    block is produced per-host (each host ingests its own capture/stream)
    and the bank's state/output shard across the global mesh with
    jax.make_array_from_process_local_data, so XLA moves only what the
    collectives need over DCN.
    """

    def __init__(self, offsets_hz, in_samplerate: float, mode: str = "nfm",
                 if_rate: float = 48000.0, bandwidth: float = 12500.0,
                 coordinator: str | None = None, num_processes: int = 1,
                 process_id: int = 0):
        distributed_init(coordinator, num_processes, process_id)
        self.mesh = global_channel_mesh()
        self.bank = ScannerBank(offsets_hz, in_samplerate, mode=mode,
                                if_rate=if_rate, bandwidth=bandwidth)
        self.block_multiple = self.bank.block_multiple
        # production path = shard_map (GSPMD does not partition the Pallas
        # kernels the demods use — vfo_bank.sharded_step)
        from jax.sharding import NamedSharding, PartitionSpec as P
        self._step, specs = self.bank.sharded_step(self.mesh)
        self._state = jax.tree_util.tree_map(
            lambda l, s: put_global(l, NamedSharding(self.mesh, s)),
            self.bank.init_state(), specs)
        self._in_sh = NamedSharding(self.mesh, P())
        self._out_sh = NamedSharding(self.mesh, P("channels", None))

    def process_block(self, local_iq: np.ndarray):
        """Feed one wideband block (identical logical content on each host —
        e.g. every host reading its copy/shard of the capture stream).
        Returns the audio shard local to this host's devices."""
        x = put_global(np.asarray(local_iq), self._in_sh)
        self._state, audio = self._step(self._state, x)
        return audio

    def gather_audio(self, audio) -> np.ndarray:
        """Assemble the full [channels, n] audio on every host."""
        return gather_global(audio)

    def run_file(self, path, num_blocks: int, block_size: int):
        src = FileSource(path)
        outs = []
        for _ in range(num_blocks):
            outs.append(self.process_block(src.read(block_size)))
        return outs
