"""RxVFO: the digital down-converter (channel extraction) unit.

Reference: core/src/dsp/channel/rx_vfo.h:6-135 — frequency xlator (negated
offset) -> rational resampler -> optional channel low-pass when the
bandwidth differs from the output rate (taps = lowPass(bw/2, 0.1*bw/2,
outSamplerate)).

This is the unit that scales across channels/chips: all blocks broadcast
over leading axes, so a VFO *bank* is just ``lead_shape=(channels,)`` plus
per-channel mix (see sdrpp_tpu/parallel/vfo_bank.py for the sharded bank).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..ops import taps as taps_mod
from ..ops.fir import FIR, RuntimeFIR
from ..ops.mix import DynamicFrequencyXlator, FrequencyXlator
from ..ops.resample import RationalResampler
from ..utils.blocks import Block

__all__ = ["RxVFO"]


class RxVFO(Block):
    def __init__(self, in_samplerate: float, out_samplerate: float,
                 bandwidth: float, offset: float, lead_shape=(),
                 dynamic_offset: bool = False,
                 dynamic_bandwidth: bool = False, max_taps: int = 2049):
        self.in_samplerate = float(in_samplerate)
        self.out_samplerate = float(out_samplerate)
        self.bandwidth = float(bandwidth)
        self.offset = float(offset)
        self.dynamic_offset = bool(dynamic_offset)
        self.dynamic_bandwidth = bool(dynamic_bandwidth)
        self.max_taps = int(max_taps)

        # dynamic: the offset lives IN STATE (retune = update a scalar,
        # no re-jit — what live click-to-tune/scanning need; the exact
        # static mixer stays the default, see ops/mix.mix_dynamic)
        if dynamic_offset:
            self.xlator = DynamicFrequencyXlator(-offset, in_samplerate,
                                                 lead_shape=lead_shape)
        else:
            self.xlator = FrequencyXlator(-offset, in_samplerate,
                                          lead_shape=lead_shape)
        self.resamp = RationalResampler(in_samplerate, out_samplerate,
                                        lead_shape=lead_shape)
        self.block_multiple = self.resamp.block_multiple
        if dynamic_bandwidth:
            # taps live IN STATE (the reference's FIR::setTaps hot-swap,
            # fir.h:31-52, at block granularity): a bandwidth change is a
            # host-side tap design + state write, never a re-jit. The
            # filter block is always present so presence/absence is not
            # a graph change; bw >= out rate writes a passthrough tap.
            self.filter = RuntimeFIR(self.max_taps,
                                     self.design_channel_taps(bandwidth),
                                     dtype=jnp.complex64,
                                     lead_shape=lead_shape)
            self.filter_needed = True
        else:
            self.filter_needed = bandwidth != out_samplerate
            if self.filter_needed:
                fw = bandwidth / 2.0
                self.filter = FIR(
                    taps_mod.low_pass(fw, fw * 0.1, out_samplerate),
                    dtype=jnp.complex64, lead_shape=lead_shape)
            else:
                self.filter = None

    def design_channel_taps(self, bandwidth: float) -> np.ndarray:
        """Host-side channel-filter design for a runtime bandwidth:
        lowPass(bw/2, 0.1*bw/2, outSR) per rx_vfo.h:30-33, with the
        transition floored at 3.8*fs/max_taps when the reference formula
        would exceed the static tap budget (only reachable below ~1.8 kHz
        at 48 kHz IF — the cutoff is still exact, the skirt is slightly
        wider). bw >= out rate = no filtering (rx_vfo.h skips the FIR)."""
        bandwidth = float(bandwidth)
        if bandwidth >= self.out_samplerate:
            return np.ones(1, np.float32)
        fw = bandwidth / 2.0
        return taps_mod.budget_low_pass(fw, fw * 0.1,
                                        self.out_samplerate,
                                        self.max_taps)

    def out_count(self, n: int) -> int:
        return self.resamp.out_count(n)

    def init_state(self):
        return {
            "xlator": self.xlator.init_state(),
            "resamp": self.resamp.init_state(),
            "filter": self.filter.init_state() if self.filter else (),
        }

    def retune_state(self, state, offset_hz: float):
        """New state with the VFO moved to ``offset_hz`` (dynamic_offset
        only) — applied between blocks on the host, no rebuild."""
        assert self.dynamic_offset, "built with a static offset"
        hi, lo = self.xlator.offset_state(-float(offset_hz))
        xl = dict(state["xlator"])
        xl["omega_hi"] = jnp.full(self.xlator.lead_shape or (), hi,
                                  jnp.float32)
        xl["omega_lo"] = jnp.full(self.xlator.lead_shape or (), lo,
                                  jnp.float32)
        return dict(state, xlator=xl)

    def set_bandwidth_state(self, state, bandwidth: float):
        """New state with the channel filter retargeted to ``bandwidth``
        (dynamic_bandwidth only): host tap design + state write, the
        delay line is preserved exactly like the reference's
        state-preserving setTaps (fir.h:31-52)."""
        assert self.dynamic_bandwidth, "built with a static bandwidth"
        f = dict(state["filter"])
        f["taps"] = self.filter.taps_state(
            self.design_channel_taps(bandwidth))
        return dict(state, filter=f)

    def __call__(self, state, x):
        xs, x = self.xlator(state["xlator"], x)
        rs, x = self.resamp(state["resamp"], x)
        fs = ()
        if self.filter is not None:
            fs, x = self.filter(state["filter"], x)
        return {"xlator": xs, "resamp": rs, "filter": fs}, x
