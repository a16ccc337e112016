"""VFO bank: N digital down-converters + demodulators over a channel axis.

The reference runs one thread-chain per VFO, fanned out by a Splitter
(core/src/signal_path/iq_frontend.cpp:122-142; one VFO = RxVFO at
channel/rx_vfo.h:6-135). Here the bank is a single batched computation: mix
the shared wideband block against a bank of NCOs -> [channels, n], then
resample/filter/demodulate with a leading channel axis. Sharding the
channel axis across a mesh (PartitionSpec('channels', None)) makes GSPMD
partition every per-channel op with zero communication — the wideband input
is replicated to each chip, which is the right trade for ICI (one broadcast
vs per-sample collectives). This is BASELINE config #4's "64-channel
scanner" and the "thousands of channels" scaling axis.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..models.analog import AMDemod, CWDemod, NFMDemod, SSBDemod, \
    WFMDemod
from ..ops import taps as taps_mod
from ..ops.fir import FIR
from ..ops.mix import FrequencyXlatorBank
from ..ops.resample import RationalResampler
from ..ops.scans import Squelch
from ..utils.blocks import Block

__all__ = ["VFOBank", "ScannerBank"]


class VFOBank(Block):
    """Bank of RxVFOs: per-channel mix -> shared-plan resample -> channel LPF.

    All channels share out_samplerate/bandwidth (the scanner pattern);
    offsets differ per channel. Input: wideband [n] complex64 (or [C, n]).
    Output: [C, n_out].
    """

    def __init__(self, offsets_hz, in_samplerate: float, out_samplerate: float,
                 bandwidth: float):
        offsets_hz = np.asarray(offsets_hz, np.float64)
        self.channels = len(offsets_hz)
        ls = (self.channels,)
        self.xlator = FrequencyXlatorBank(-offsets_hz, in_samplerate)
        self.resamp = RationalResampler(in_samplerate, out_samplerate, lead_shape=ls)
        self.block_multiple = self.resamp.block_multiple
        self.filter_needed = bandwidth != out_samplerate
        if self.filter_needed:
            fw = bandwidth / 2.0
            self.filter = FIR(taps_mod.low_pass(fw, fw * 0.1, out_samplerate),
                              dtype=jnp.complex64, lead_shape=ls)
        else:
            self.filter = None

    def out_count(self, n: int) -> int:
        return self.resamp.out_count(n)

    def init_state(self):
        return {
            "xlator": self.xlator.init_state(),
            "resamp": self.resamp.init_state(),
            "filter": self.filter.init_state() if self.filter else (),
        }

    def __call__(self, state, x):
        xs, y = self.xlator(state["xlator"], x)
        rs, y = self.resamp(state["resamp"], y)
        fs = ()
        if self.filter is not None:
            fs, y = self.filter(state["filter"], y)
        return {"xlator": xs, "resamp": rs, "filter": fs}, y


_DEMODS = {
    "am": lambda rate, bw, ls: AMDemod(bandwidth=bw, samplerate=rate, lead_shape=ls),
    "nfm": lambda rate, bw, ls: NFMDemod(bandwidth=bw, samplerate=rate, lead_shape=ls),
    "usb": lambda rate, bw, ls: SSBDemod("usb", bandwidth=bw, samplerate=rate,
                                         lead_shape=ls),
    "lsb": lambda rate, bw, ls: SSBDemod("lsb", bandwidth=bw, samplerate=rate,
                                         lead_shape=ls),
    "cw": lambda rate, bw, ls: CWDemod(samplerate=rate, lead_shape=ls),
    # broadcast FM stereo: demod at the IF rate; the bank resamples the
    # stereo pair to the audio rate afterwards (radio module: WFM IF is
    # 240 kHz, wfm.h:246)
    "wfm": lambda rate, bw, ls: WFMDemod(deviation=bw / 2.0,
                                         samplerate=rate, lead_shape=ls),
}


class ScannerBank(Block):
    """Multi-channel scanner: VFO bank + per-channel squelch + demod bank
    (BASELINE config #4: SSB/CW chain with AGC + squelch, 64 channels).

    Output: [C, n_audio] float32 audio per channel.
    """

    def __init__(self, offsets_hz, in_samplerate: float, mode: str = "usb",
                 if_rate: float = 48000.0, bandwidth: float = 2700.0,
                 squelch_level: float | None = None,
                 audio_rate: float = 48000.0, channelizer: str = "time"):
        self.channels = len(np.asarray(offsets_hz))
        self.mode = mode
        ls = (self.channels,)
        if channelizer == "fft":
            # shared-FFT channelizer (SURVEY §2.5 plan): one wideband
            # FFT + per-channel pruned frequency-domain filtering; needs an
            # integer in/if rate ratio (ops/channelizer.py)
            from ..ops.channelizer import FFTChannelizerBank
            self.vfo = FFTChannelizerBank(offsets_hz, in_samplerate, if_rate,
                                          bandwidth=min(bandwidth, if_rate))
        elif channelizer == "time":
            self.vfo = VFOBank(offsets_hz, in_samplerate, if_rate,
                               min(bandwidth, if_rate))
        else:
            raise ValueError(f"unknown channelizer {channelizer!r}")
        self.squelch = (Squelch(squelch_level, lead_shape=ls)
                        if squelch_level is not None else None)
        self.demod = _DEMODS[mode](if_rate, bandwidth, ls)
        # WFM demodulates stereo at the IF rate (240k); resample the
        # stereo planes down to the audio rate.
        self.af = None
        if mode == "wfm" and audio_rate != if_rate:
            self.af = RationalResampler(if_rate, audio_rate,
                                        dtype=jnp.float32,
                                        lead_shape=(self.channels, 2))
        self.block_multiple = self.vfo.block_multiple
        if self.af is not None:
            # The input block must produce an IF count divisible by the AF
            # stage's multiple: one vfo-multiple of input yields q IF
            # samples, so the input needs af_bm/gcd(q, af_bm) of them.
            q = self.vfo.out_count(self.vfo.block_multiple)
            af_bm = self.af.block_multiple
            self.block_multiple = (self.vfo.block_multiple
                                   * (af_bm // int(np.gcd(q, af_bm))))

    def init_state(self):
        return {
            "vfo": self.vfo.init_state(),
            "squelch": self.squelch.init_state() if self.squelch else (),
            "demod": self.demod.init_state(),
            "af": self.af.init_state() if self.af else (),
        }

    def __call__(self, state, x):
        vs, y = self.vfo(state["vfo"], x)
        ss = ()
        if self.squelch is not None:
            ss, y = self.squelch(state["squelch"], y)
        ds, audio = self.demod(state["demod"], y)
        afs = ()
        if self.af is not None:
            # [C, n, 2] stereo -> [C, 2, n] planes -> resample -> back
            planes = jnp.swapaxes(audio, -1, -2)
            afs, planes = self.af(state["af"], planes)
            audio = jnp.swapaxes(planes, -1, -2)
        return {"vfo": vs, "squelch": ss, "demod": ds, "af": afs}, audio

    def _leaf_spec(self, leaf, axis="channels"):
        if hasattr(leaf, "ndim") and leaf.ndim >= 1 and \
                leaf.shape[0] == self.channels:
            return P(axis, *([None] * (leaf.ndim - 1)))
        return P()

    def shard(self, mesh, state, put=None):
        """Place the carried state with the channel axis sharded over
        ``mesh``; returns (sharded_state, in_sharding, out_sharding).

        ``put(array, sharding)`` overrides the placement primitive — the
        multi-host path passes jax.make_array_from_process_local_data so
        global arrays assemble from per-process data (multihost.py)."""
        if put is None:
            put = jax.device_put

        def shard_leaf(leaf):
            return put(leaf, NamedSharding(mesh, self._leaf_spec(leaf)))

        sharded = jax.tree_util.tree_map(shard_leaf, state)
        in_sh = NamedSharding(mesh, P())  # wideband input replicated
        out_sh = NamedSharding(mesh, P("channels", None))
        return sharded, in_sh, out_sh

    def sharded_step(self, mesh, axis="channels"):
        """The PRODUCTION multi-device step: the whole bank under shard_map
        over the channel axis (``axis``: one mesh axis name or a tuple —
        e.g. ('host', 'chip') on a 2-D mesh).

        Why not plain jit + in_shardings: GSPMD does not partition Pallas
        custom calls, so the lane-kernel AGC/PLL inside the demods would
        keep auto-partitioning from splitting the program. Under
        shard_map each device runs the bank on its local [C/d] channel
        shard — Pallas kernels included — and the
        per-channel table-baking stages slice their tables via
        parallel/spmd.channel_shard.

        Returns (step, state_specs): ``step`` is jitted;
        state placement = NamedSharding(mesh, spec) per state_specs leaf.
        """
        from jax import shard_map

        from .spmd import channel_shard

        state_shapes = jax.eval_shape(self.init_state)
        st_specs = jax.tree_util.tree_map(
            lambda l: self._leaf_spec(l, axis), state_shapes)

        def fn(state, x):
            with channel_shard(axis):
                return self(state, x)

        smapped = shard_map(
            fn, mesh=mesh,
            in_specs=(st_specs, P()),
            out_specs=(st_specs, P(axis, None)),
            check_vma=False)
        return jax.jit(smapped), st_specs
