"""RDS demodulation chain: WFM's 57 kHz subcarrier -> bitstream.

Reference: decoder_modules/radio/src/demodulators/wfm.h:56-76 — the
BroadcastFM rdsOut (5 kHz complex baseband) runs through FastAGC(1, 1e6,
0.1) -> Costas<2>(0.005) -> complex band-pass FIR (0..2375 Hz, 100 Hz
trans) -> second Costas<2>(0.01) with VCO limits around baud/2 (1187.5 Hz
+-10%) -> take real -> MM clock recovery (omega = 5000/1187.5, gains 1e-6 /
0.01) -> binary slicer -> differential decoder (mod 2) -> rds::RDSDecoder.

This is the deepest single chain in the reference (SURVEY §3.5). The DSP
runs jitted; the final bit-level group decoder is host-side
(decoders/rds.py).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..decoders.rds import RDSDecoder
from ..ops import taps as taps_mod
from ..ops.clock_recovery import MMClockRecovery
from ..ops.digital import DifferentialDecoder, binary_slicer
from ..ops.fir import FIR
from ..ops.mix import hz_to_rads
from ..ops.scans_pallas import CostasPallas as Costas, \
    FastAGCPallas as FastAGC
from ..utils.blocks import Block

__all__ = ["RDSChain", "RDSReceiver"]

RDS_BAUD = 1187.5
RDS_RATE = 5000.0


class RDSChain(Block):
    """5 kHz complex RDS baseband -> (bits, valid count) per block."""

    def __init__(self):
        self.agc = FastAGC(1.0, 1e6, 0.1)
        self.costas = Costas(2, 0.005)
        bp_taps = taps_mod.band_pass(0.0, 2375.0, 100.0, RDS_RATE,
                                     complex_taps=True)
        self.fir = FIR(bp_taps, dtype=jnp.complex64)
        baud_freq = hz_to_rads(RDS_BAUD, RDS_RATE)
        self.costas2 = Costas(2, 0.01, init_freq=baud_freq,
                              min_freq=baud_freq * 0.9, max_freq=baud_freq * 1.1)
        self.recov = MMClockRecovery(RDS_RATE / RDS_BAUD, omega_gain=1e-6,
                                     mu_gain=0.01, omega_rel_limit=0.01,
                                     complex_input=False)
        self.diff = DifferentialDecoder(2)

    def max_bits(self, n: int) -> int:
        return self.recov.max_symbols(n)

    def init_state(self):
        return {
            "agc": self.agc.init_state(),
            "costas": self.costas.init_state(),
            "fir": self.fir.init_state(),
            "costas2": self.costas2.init_state(),
            "recov": self.recov.init_state(),
            "diff": self.diff.init_state(),
        }

    def __call__(self, state, x):
        st = dict(state)
        st["agc"], y = self.agc(state["agc"], x)
        st["costas"], y = self.costas(state["costas"], y)
        st["fir"], y = self.fir(state["fir"], y)
        st["costas2"], y = self.costas2(state["costas2"], y)
        y = y.real
        st["recov"], (syms, valid) = self.recov(state["recov"], y)
        bits = binary_slicer(syms)
        nvalid = jnp.sum(valid.astype(jnp.int32))
        st["diff"], decoded = self.diff(state["diff"], (bits, nvalid))
        return st, (decoded, nvalid)


class RDSReceiver:
    """Host wrapper: jitted RDSChain + the bit-level group decoder."""

    def __init__(self):
        self.chain = RDSChain()
        self.state = self.chain.init_state()
        self._step = jax.jit(self.chain)
        self.decoder = RDSDecoder()

    def process(self, rds_baseband: np.ndarray):
        self.state, (bits, nvalid) = self._step(self.state,
                                                jnp.asarray(rds_baseband))
        n = int(nvalid)
        self.decoder.process(np.asarray(bits)[:n])
        return n
