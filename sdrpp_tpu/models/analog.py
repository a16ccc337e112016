"""Analog demodulators: AM, SSB/DSB, CW, NFM, WFM (stereo + RDS tap).

Each demodulator is a pure stateful block ``(state, iq_block) -> (state,
audio_block)`` composed from ops kernels — the equivalent of the
reference's demod classes (core/src/dsp/demod/*.h). Default rates/bandwidths
follow the radio module (decoder_modules/radio/src/demodulators/*.h):
WFM 240 kHz IF, NFM/USB/LSB/DSB 48 kHz, AM 24 kHz, CW 3 kHz.

Audio is float32 [..., n] mono; WFM emits [..., n, 2] stereo.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import convert, taps
from ..ops.delay import Delay
from ..ops.fir import FIR, RuntimeFIR
from ..ops.fm import Quadrature
from ..ops.mix import FrequencyXlator, hz_to_rads
from ..ops.resample import RationalResampler
from ..ops.scans import DCBlocker
# Chunked variants: exact recurrences (lane kernel or lax.scan) for short
# blocks, lane-parallel approximate loops (documented warm-up contract, see
# ops/scans_pallas.py) for the long 1-D blocks of the high-rate bench
# paths. SDRPP_TPU_LOOPS=exact disables the approximation globally.
from ..ops.scans_pallas import AGCChunked as AGC, PLLChunked as PLL
from ..utils.blocks import Block

__all__ = ["AMDemod", "SSBDemod", "CWDemod", "NFMDemod", "WFMDemod"]


def _budget_lowpass(cutoff: float, trans: float, fs: float,
                    max_taps: int) -> np.ndarray:
    return taps.budget_low_pass(cutoff, trans, fs, max_taps)


class AMDemod(Block):
    """AM envelope demodulator (reference: core/src/dsp/demod/am.h:10-172).

    Chain: [carrier AGC] -> magnitude -> DC block -> [audio AGC] -> LPF.
    ``agc_mode``: 'off' | 'carrier' | 'audio'. Defaults per the radio module
    (am.h wrapper): IF 24 kHz, bandwidth 12 kHz, attack 50/fs, decay 5/fs,
    DC-block rate 100/fs.
    """

    def __init__(self, bandwidth: float = 12000.0, samplerate: float = 24000.0,
                 agc_mode: str = "audio", agc_attack: float = 50.0,
                 agc_decay: float = 5.0, dc_rate: float = 100.0, lead_shape=(),
                 dynamic_bandwidth: bool = False, max_taps: int = 2049):
        assert agc_mode in ("off", "carrier", "audio")
        self.agc_mode = agc_mode
        self.samplerate = samplerate
        self.dynamic_bandwidth = bool(dynamic_bandwidth)
        self.max_taps = int(max_taps)
        ls = lead_shape
        self.carrier_agc = AGC(1.0, agc_attack / samplerate, agc_decay / samplerate,
                               10e6, 10.0, float("inf"), lead_shape=ls)
        self.audio_agc = AGC(1.0, agc_attack / samplerate, agc_decay / samplerate,
                             10e6, 10.0, float("inf"), lead_shape=ls)
        self.dc_block = DCBlocker(dc_rate / samplerate, dtype=jnp.float32, lead_shape=ls)
        if dynamic_bandwidth:
            self.lpf = RuntimeFIR(self.max_taps, self._lpf_taps(bandwidth),
                                  dtype=jnp.float32, lead_shape=ls)
        else:
            lpf_taps = taps.low_pass(bandwidth / 2.0, (bandwidth / 2.0) * 0.1,
                                     samplerate)
            self.lpf = FIR(lpf_taps, dtype=jnp.float32, lead_shape=ls)

    def _lpf_taps(self, bandwidth: float) -> np.ndarray:
        fw = float(bandwidth) / 2.0
        return _budget_lowpass(fw, fw * 0.1, self.samplerate, self.max_taps)

    def set_bandwidth_state(self, state, bandwidth: float):
        """Runtime bandwidth (dynamic_bandwidth only): retarget the audio
        low-pass via a tap state write — reference am.h setBandwidth."""
        assert self.dynamic_bandwidth
        lp = dict(state["lpf"])
        lp["taps"] = self.lpf.taps_state(self._lpf_taps(bandwidth))
        return dict(state, lpf=lp)

    def init_state(self):
        return {
            "carrier_agc": self.carrier_agc.init_state(),
            "audio_agc": self.audio_agc.init_state(),
            "dc": self.dc_block.init_state(),
            "lpf": self.lpf.init_state(),
        }

    def __call__(self, state, x):
        st = dict(state)
        if self.agc_mode == "carrier":
            st["carrier_agc"], x = self.carrier_agc(state["carrier_agc"], x)
        y = jnp.abs(x)
        st["dc"], y = self.dc_block(state["dc"], y)
        if self.agc_mode == "audio":
            st["audio_agc"], y = self.audio_agc(state["audio_agc"], y)
        st["lpf"], y = self.lpf(state["lpf"], y)
        return st, y


class SSBDemod(Block):
    """SSB/DSB product demodulator (reference: core/src/dsp/demod/ssb.h:9-134).

    Translate by +bw/2 (USB) / -bw/2 (LSB) / 0 (DSB), take the real part,
    then AGC. Radio-module defaults: IF 48 kHz, bandwidth 2.7 kHz, AGC
    attack 50/fs decay 5/fs.
    """

    def __init__(self, mode: str = "usb", bandwidth: float = 2700.0,
                 samplerate: float = 48000.0, agc_enabled: bool = True,
                 agc_attack: float = 50.0, agc_decay: float = 5.0, lead_shape=(),
                 dynamic_bandwidth: bool = False):
        assert mode in ("usb", "lsb", "dsb")
        self.mode = mode
        self.dynamic_bandwidth = bool(dynamic_bandwidth)
        translation = self._translation(bandwidth)
        if dynamic_bandwidth:
            # bandwidth changes the sideband translation frequency
            # (ssb.h setBandwidth); a dynamic xlator makes it a scalar
            # state write instead of a graph constant
            from ..ops.mix import DynamicFrequencyXlator
            self.xlator = DynamicFrequencyXlator(translation, samplerate,
                                                 lead_shape=lead_shape)
        else:
            self.xlator = FrequencyXlator(translation, samplerate,
                                          lead_shape=lead_shape)
        self.agc = AGC(1.0, agc_attack / samplerate, agc_decay / samplerate,
                       10e6, 10.0, float("inf"), enabled=agc_enabled,
                       lead_shape=lead_shape)

    def _translation(self, bandwidth: float) -> float:
        return {"usb": bandwidth / 2.0, "lsb": -bandwidth / 2.0,
                "dsb": 0.0}[self.mode]

    def set_bandwidth_state(self, state, bandwidth: float):
        """Runtime bandwidth (dynamic_bandwidth only): move the sideband
        translation — a (hi, lo) scalar state write."""
        assert self.dynamic_bandwidth
        hi, lo = self.xlator.offset_state(self._translation(bandwidth))
        xl = dict(state["xlator"])
        xl["omega_hi"] = jnp.full(self.xlator.lead_shape or (), hi,
                                  jnp.float32)
        xl["omega_lo"] = jnp.full(self.xlator.lead_shape or (), lo,
                                  jnp.float32)
        return dict(state, xlator=xl)

    def init_state(self):
        return {"xlator": self.xlator.init_state(), "agc": self.agc.init_state()}

    def __call__(self, state, x):
        xs, x = self.xlator(state["xlator"], x)
        y = convert.complex_to_real(x)
        ags, y = self.agc(state["agc"], y)
        return {"xlator": xs, "agc": ags}, y


class CWDemod(Block):
    """CW demodulator with BFO tone (reference: core/src/dsp/demod/cw.h:9-105).

    Translate by +tone, real part, AGC with maxOutputAmp/initGain = 1.0.
    Radio-module defaults: IF 3 kHz, tone 800 Hz.
    """

    def __init__(self, tone: float = 800.0, samplerate: float = 3000.0,
                 agc_enabled: bool = True, agc_attack: float = 100.0,
                 agc_decay: float = 5.0, lead_shape=()):
        self.xlator = FrequencyXlator(tone, samplerate, lead_shape=lead_shape)
        self.agc = AGC(1.0, agc_attack / samplerate, agc_decay / samplerate,
                       10e6, 1.0, 1.0, enabled=agc_enabled, lead_shape=lead_shape)

    def init_state(self):
        return {"xlator": self.xlator.init_state(), "agc": self.agc.init_state()}

    def __call__(self, state, x):
        xs, x = self.xlator(state["xlator"], x)
        y = convert.complex_to_real(x)
        ags, y = self.agc(state["agc"], y)
        return {"xlator": xs, "agc": ags}, y


class NFMDemod(Block):
    """Narrow FM (reference: core/src/dsp/demod/fm.h:11-162).

    Quadrature discriminator at deviation bw/2, then optional audio filter:
    low-pass (bw/2), high-pass (300 Hz), or band-pass(300, bw/2) when both.
    Radio-module defaults: IF 48 kHz, bandwidth 12.5 kHz.
    """

    def __init__(self, bandwidth: float = 12500.0, samplerate: float = 48000.0,
                 low_pass: bool = True, high_pass: bool = False, lead_shape=(),
                 dynamic_bandwidth: bool = False, max_taps: int = 2049):
        self.samplerate = samplerate
        self.low_pass_on = bool(low_pass)
        self.high_pass_on = bool(high_pass)
        self.dynamic_bandwidth = bool(dynamic_bandwidth)
        self.max_taps = int(max_taps)
        self.demod = Quadrature(bandwidth / 2.0, samplerate,
                                lead_shape=lead_shape,
                                dynamic_deviation=dynamic_bandwidth)
        t = self._audio_taps(bandwidth)
        if t is None:
            self.fir = None
        elif dynamic_bandwidth:
            self.fir = RuntimeFIR(self.max_taps, t, dtype=jnp.float32,
                                  lead_shape=lead_shape)
        else:
            self.fir = FIR(t, dtype=jnp.float32, lead_shape=lead_shape)

    def _audio_taps(self, bandwidth: float):
        if self.low_pass_on and self.high_pass_on:
            return taps.band_pass(300.0, bandwidth / 2.0, 100.0,
                                  self.samplerate, complex_taps=False)
        if self.high_pass_on:
            return taps.high_pass(300.0, 100.0, self.samplerate)
        if self.low_pass_on:
            fw = bandwidth / 2.0
            return _budget_lowpass(fw, fw * 0.1, self.samplerate,
                                   self.max_taps) \
                if self.dynamic_bandwidth else \
                taps.low_pass(fw, fw * 0.1, self.samplerate)
        return None

    def set_bandwidth_state(self, state, bandwidth: float):
        """Runtime bandwidth (dynamic_bandwidth only): deviation scalar +
        audio-filter tap writes — the reference's setBandwidth
        (fm.h setDeviation + filter retap) with zero re-jit."""
        assert self.dynamic_bandwidth
        dm = dict(state["demod"])
        dm["inv_dev"] = self.demod.inv_dev_state(float(bandwidth) / 2.0)
        st = dict(state, demod=dm)
        if self.fir is not None and self.low_pass_on:
            # high-pass-only taps don't depend on bandwidth
            f = dict(state["fir"])
            f["taps"] = self.fir.taps_state(self._audio_taps(bandwidth))
            st["fir"] = f
        return st

    def init_state(self):
        return {
            "demod": self.demod.init_state(),
            "fir": self.fir.init_state() if self.fir else (),
        }

    def __call__(self, state, x):
        ds, y = self.demod(state["demod"], x)
        fs = ()
        if self.fir is not None:
            fs, y = self.fir(state["fir"], y)
        return {"demod": ds, "fir": fs}, y


class WFMDemod(Block):
    """Broadcast FM with pilot-PLL stereo matrix decode and optional RDS tap
    (reference: core/src/dsp/demod/broadcast_fm.h:18-258).

    Chain: quadrature(deviation) -> MPX; stereo path filters the 19 kHz
    pilot (complex band-pass 18750-19250, 3 kHz trans, odd taps), locks a
    PLL (bw 25k/fs, freq limits ±250 Hz around 19 kHz), delay-compensates
    L+R and complex MPX by (pilotTaps-1)/2+1, multiplies by conj(pll)^2 to
    shift the 38 kHz L-R down, forms L/R, and 15 kHz low-passes. The RDS tap
    translates the complex MPX by -57 kHz and resamples to 5 kHz.

    Returns stereo [..., n, 2]; with ``rds_out`` also a complex RDS baseband
    block. Radio-module defaults: IF 240 kHz, bandwidth 200 kHz
    (deviation = bw/2 = 100k... the wrapper passes bandwidth/2 as deviation).
    """

    def __init__(self, deviation: float = 100000.0, samplerate: float = 240000.0,
                 stereo: bool = True, low_pass: bool = True, rds_out: bool = False,
                 lead_shape=(), dynamic_bandwidth: bool = False):
        ls = lead_shape
        self.samplerate = samplerate
        self.stereo = stereo
        self.low_pass = low_pass
        self.rds_out = rds_out
        self.dynamic_bandwidth = bool(dynamic_bandwidth)

        self.demod = Quadrature(deviation, samplerate, lead_shape=ls,
                                dynamic_deviation=dynamic_bandwidth)
        self.pilot_taps = taps.band_pass(18750.0, 19250.0, 3000.0, samplerate,
                                         complex_taps=True, odd_tap_count=True)
        self.pilot_fir = FIR(self.pilot_taps, dtype=jnp.complex64, lead_shape=ls)
        self.pilot_pll = PLL(
            bandwidth=25000.0 / samplerate,
            init_phase=0.0,
            init_freq=hz_to_rads(19000.0, samplerate),
            min_freq=hz_to_rads(18750.0, samplerate),
            max_freq=hz_to_rads(19250.0, samplerate),
            lead_shape=ls,
            # chunk warm-up: the pilot loop's bandwidth is ~0.1 rad/sample
            # (time constant ~10 samples); 128 is 13x that — measured
            # 3.6e-6 max phasor error at even W=64
            # (tests/test_scans_chunked.py)
            warmup=128,
        )
        d = (self.pilot_taps.shape[0] - 1) // 2 + 1
        self.lpr_delay = Delay(d, dtype=jnp.float32, lead_shape=ls)
        self.lmr_delay = Delay(d, dtype=jnp.complex64, lead_shape=ls)
        audio_taps = taps.low_pass(15000.0, 4000.0, samplerate)
        self.al_fir = FIR(audio_taps, dtype=jnp.float32, lead_shape=ls)
        self.ar_fir = FIR(audio_taps, dtype=jnp.float32, lead_shape=ls)
        if rds_out:
            self.rds_xlator = FrequencyXlator(-57000.0, samplerate, lead_shape=ls)
            self.rds_resamp = RationalResampler(samplerate, 5000.0,
                                                dtype=jnp.complex64, lead_shape=ls)
        else:
            self.rds_xlator = None
            self.rds_resamp = None

    def init_state(self):
        st = {
            "demod": self.demod.init_state(),
            "pilot_fir": self.pilot_fir.init_state(),
            "pilot_pll": self.pilot_pll.init_state(),
            "lpr_delay": self.lpr_delay.init_state(),
            "lmr_delay": self.lmr_delay.init_state(),
            "al_fir": self.al_fir.init_state(),
            "ar_fir": self.ar_fir.init_state(),
        }
        if self.rds_out:
            st["rds_xlator"] = self.rds_xlator.init_state()
            st["rds_resamp"] = self.rds_resamp.init_state()
        return st

    def set_bandwidth_state(self, state, bandwidth: float):
        """Runtime bandwidth (dynamic_bandwidth only): deviation = bw/2
        (the radio wrapper passes bandwidth/2, wfm.h) — one scalar write;
        pilot/audio filters are bandwidth-independent in the reference."""
        assert self.dynamic_bandwidth
        dm = dict(state["demod"])
        dm["inv_dev"] = self.demod.inv_dev_state(float(bandwidth) / 2.0)
        return dict(state, demod=dm)

    def __call__(self, state, x):
        st = dict(state)
        st["demod"], mpx = self.demod(state["demod"], x)
        rds = None
        if self.stereo:
            cmpx = convert.real_to_complex(mpx)
            st["pilot_fir"], pilot = self.pilot_fir(state["pilot_fir"], cmpx)
            st["pilot_pll"], vco = self.pilot_pll(state["pilot_pll"], pilot)
            st["lpr_delay"], lpr = self.lpr_delay(state["lpr_delay"], mpx)
            st["lmr_delay"], lmr_c = self.lmr_delay(state["lmr_delay"], cmpx)
            vco_c = jnp.conj(vco)
            lmr_c = lmr_c * vco_c * vco_c  # downconvert 38 kHz L-R
            if self.rds_out:
                st["rds_xlator"], rds_bb = self.rds_xlator(state["rds_xlator"], cmpx)
                st["rds_resamp"], rds = self.rds_resamp(state["rds_resamp"], rds_bb)
            lmr = convert.complex_to_real(lmr_c) * np.float32(2.0)
            l = lpr + lmr
            r = lpr - lmr
            if self.low_pass:
                st["al_fir"], l = self.al_fir(state["al_fir"], l)
                st["ar_fir"], r = self.ar_fir(state["ar_fir"], r)
            out = convert.l_r_to_stereo(l, r)
        else:
            if self.rds_out:
                cmpx = convert.real_to_complex(mpx)
                st["rds_xlator"], rds_bb = self.rds_xlator(state["rds_xlator"], cmpx)
                st["rds_resamp"], rds = self.rds_resamp(state["rds_resamp"], rds_bb)
            audio = mpx
            if self.low_pass:
                st["al_fir"], audio = self.al_fir(state["al_fir"], audio)
            out = convert.l_r_to_stereo(audio, audio)
        if self.rds_out:
            return st, (out, rds)
        return st, out
