"""RadioChannel: the full receive channel (the radio decoder module's graph).

Reference: decoder_modules/radio/src/radio_module.h — VFO + IF chain
(NoiseBlanker -> Squelch [-> FMIF]) + pluggable demodulator + AF chain
(RationalResampler to the audio rate -> optional Deemphasis 22/50/75 us).
Per-demod IF rates/bandwidths follow the demodulator wrappers
(radio/src/demodulators/*.h).

One RadioChannel is a single pure function over an IQ block; a bank of them
shares the structure with a leading channel axis (parallel/vfo_bank.py).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..ops.fm_if import FMIFNoiseReduction
from ..ops.resample import RationalResampler
from ..ops.scans import Deemphasis, NoiseBlanker, Squelch
from ..utils.blocks import Block
from .analog import AMDemod, CWDemod, NFMDemod, SSBDemod, WFMDemod
from .channel import RxVFO

__all__ = ["RadioChannel", "DEMOD_DEFAULTS"]

# Per-demod IF sample rate and default bandwidth (radio/src/demodulators/*.h)
DEMOD_DEFAULTS = {
    "wfm": dict(if_rate=240000.0, bandwidth=200000.0),
    "nfm": dict(if_rate=48000.0, bandwidth=12500.0),
    "am": dict(if_rate=24000.0, bandwidth=12000.0),
    "usb": dict(if_rate=48000.0, bandwidth=2700.0),
    "lsb": dict(if_rate=48000.0, bandwidth=2700.0),
    "dsb": dict(if_rate=48000.0, bandwidth=4600.0),
    "cw": dict(if_rate=3000.0, bandwidth=500.0),
    # RAW: IF rate follows the audio rate; I/Q out as stereo
    # (decoder_modules/radio/src/demodulators/raw.h:49,66)
    "raw": dict(if_rate=None, bandwidth=None),
}

DEEMP_TAUS = {"22us": 22e-6, "50us": 50e-6, "75us": 75e-6, None: None}

# Runtime-bandwidth clamp range per mode (reference get{Min,Max}Bandwidth,
# decoder_modules/radio/src/demodulators/*.h:105-126; max expressed as a
# fraction of the IF rate)
BANDWIDTH_RANGES = {
    "wfm": (24000.0, 1.0), "nfm": (1000.0, 1.0), "am": (1000.0, 1.0),
    "usb": (500.0, 0.5), "lsb": (500.0, 0.5), "dsb": (1000.0, 0.5),
    "cw": (10.0, 0.5),
}


def _make_demod(mode: str, bandwidth: float, if_rate: float, lead_shape,
                stereo_wfm: bool, rds: bool, dynamic_bandwidth: bool = False):
    dyn = dict(dynamic_bandwidth=dynamic_bandwidth)
    if mode == "wfm":
        return WFMDemod(deviation=bandwidth / 2.0, samplerate=if_rate,
                        stereo=stereo_wfm, rds_out=rds, lead_shape=lead_shape,
                        **dyn)
    if mode == "nfm":
        return NFMDemod(bandwidth=bandwidth, samplerate=if_rate,
                        lead_shape=lead_shape, **dyn)
    if mode == "am":
        return AMDemod(bandwidth=bandwidth, samplerate=if_rate,
                       lead_shape=lead_shape, **dyn)
    if mode in ("usb", "lsb", "dsb"):
        return SSBDemod(mode=mode, bandwidth=bandwidth, samplerate=if_rate,
                        lead_shape=lead_shape, **dyn)
    if mode == "cw":
        return CWDemod(samplerate=if_rate, lead_shape=lead_shape)
    if mode == "raw":
        return None  # RAW: VFO IQ passed through as stereo
    raise ValueError(f"unknown demod mode {mode}")


class RadioChannel(Block):
    """VFO -> [noise blanker] -> [squelch] -> demod -> AF resample -> [deemph].

    ``mode``: wfm | nfm | am | usb | lsb | dsb | cw.
    Output: float32 audio at ``audio_rate`` ([..., n] mono; [..., n, 2] for
    stereo WFM). ``block_multiple`` gives the required input block multiple.
    """

    def __init__(self, mode: str, in_samplerate: float, offset: float = 0.0,
                 bandwidth: float | None = None, audio_rate: float = 48000.0,
                 squelch_level: float | None = None, noise_blanker: bool = False,
                 fm_if_nr: bool = False, deemphasis: str | None = None,
                 stereo_wfm: bool = True, rds: bool = False, lead_shape=(),
                 dynamic_offset: bool = False,
                 dynamic_bandwidth: bool = False):
        mode = mode.lower()
        defaults = DEMOD_DEFAULTS[mode]
        self.mode = mode
        if_rate = defaults["if_rate"] if defaults["if_rate"] else audio_rate
        if bandwidth is None:
            bandwidth = defaults["bandwidth"] if defaults["bandwidth"] else if_rate
        self.if_rate = if_rate
        self.audio_rate = audio_rate
        self.rds = rds and mode == "wfm"
        # bandwidth as runtime STATE: taps/deviation/
        # sideband-translation live in the state pytree, so set_bandwidth
        # is a host tap design + state write — the reference's
        # state-preserving FIR::setTaps hot-swap (fir.h:31-52,
        # radio_module.h:461-471) at block granularity, no re-jit. RAW has
        # no bandwidth-dependent stage.
        self.dynamic_bandwidth = bool(dynamic_bandwidth) and mode != "raw"
        self.bandwidth = float(bandwidth)
        ls = lead_shape

        # VFO: bandwidth != out rate adds the channel filter (rx_vfo.h:30-33)
        self.vfo = RxVFO(in_samplerate, if_rate, min(bandwidth, if_rate), offset,
                         lead_shape=ls, dynamic_offset=dynamic_offset,
                         dynamic_bandwidth=self.dynamic_bandwidth)
        # IF chain (radio_module.h:68-79)
        self.noise_blanker = (NoiseBlanker(500.0 / 24000.0, 10.0, lead_shape=ls)
                              if noise_blanker else None)
        self.squelch = (Squelch(squelch_level, lead_shape=ls)
                        if squelch_level is not None else None)
        # FM IF noise reduction, 32 bins (radio_module.h:74 fmnr.init(...,32))
        self.fm_if = (FMIFNoiseReduction(32, lead_shape=ls) if fm_if_nr else None)
        self.demod = _make_demod(mode, bandwidth, if_rate, ls, stereo_wfm,
                                 self.rds,
                                 dynamic_bandwidth=self.dynamic_bandwidth)
        self.stereo_out = mode in ("wfm", "raw")
        # AF chain (radio_module.h:81-88): demod AF rate -> audio rate
        af_rate = if_rate  # all demods: AF rate == IF rate
        self.af_resamp = (RationalResampler(af_rate, audio_rate, dtype=jnp.float32,
                                            lead_shape=(*ls, 2) if self.stereo_out else ls)
                          if af_rate != audio_rate else None)
        tau = DEEMP_TAUS[deemphasis]
        self.deemph = (Deemphasis(tau, audio_rate, stereo=self.stereo_out, lead_shape=ls)
                       if tau is not None else None)

        # Input block-length requirement for static shapes end to end: the
        # input must divide cleanly by the VFO's multiple AND the resulting
        # IF block by the AF resampler's multiple. Search the smallest
        # multiple of the VFO requirement that satisfies both.
        m = self.vfo.block_multiple
        if_bm = 1  # constraints on the IF-block length
        if self.af_resamp is not None:
            if_bm = self.af_resamp.block_multiple
        if self.rds and hasattr(self.demod, "rds_resamp"):
            # the RDS tap resamples the SAME IF block (240k -> 5k inside
            # WFMDemod) — its multiple constrains if_n too
            import math
            if_bm = math.lcm(if_bm, int(self.demod.rds_resamp.block_multiple))
        if if_bm > 1:
            cand = m
            for _ in range(100000):
                if_n = self.vfo.out_count(cand)
                if if_n % if_bm == 0:
                    break
                cand += m
            else:
                raise ValueError("no valid block multiple found")
            m = cand
        self.block_multiple = m

    def retune_state(self, state, offset_hz: float):
        """New state with the VFO retuned (dynamic_offset channels only;
        applied between blocks, no rebuild/re-jit)."""
        return dict(state, vfo=self.vfo.retune_state(state["vfo"],
                                                     offset_hz))

    def clamp_bandwidth(self, bandwidth: float) -> float:
        """Clamp to the reference's per-mode range (get{Min,Max}Bandwidth,
        demodulators/*.h)."""
        lo, hi_frac = BANDWIDTH_RANGES.get(self.mode, (10.0, 1.0))
        return float(min(max(float(bandwidth), lo),
                         hi_frac * self.if_rate))

    def set_bandwidth_state(self, state, bandwidth: float):
        """New state with the channel retargeted to ``bandwidth`` — VFO
        channel-filter taps + the demod's bandwidth-dependent pieces
        (deviation / audio taps / sideband translation), all host-side
        designs written into the state pytree between blocks. Requires
        dynamic_bandwidth=True; mirrors RadioModule::setBandwidth
        (radio_module.h:461-471) without the reference's tempStop or our
        old re-jit."""
        if not self.dynamic_bandwidth:
            raise ValueError("channel built without dynamic_bandwidth")
        bandwidth = self.clamp_bandwidth(bandwidth)
        st = dict(state, vfo=self.vfo.set_bandwidth_state(
            state["vfo"], min(bandwidth, self.if_rate)))
        if self.demod is not None and hasattr(self.demod,
                                              "set_bandwidth_state"):
            st["demod"] = self.demod.set_bandwidth_state(state["demod"],
                                                         bandwidth)
        self.bandwidth = bandwidth
        return st

    def set_squelch_state(self, state, level_db: float):
        """New state with the squelch threshold changed — a scalar write,
        like the reference's runtime setLevel (squelch.h:63-66). Only
        valid when the channel was built with a squelch block; toggling
        squelch on/off remains a graph change."""
        if self.squelch is None:
            raise ValueError("channel has no squelch block")
        return dict(state, squelch=self.squelch.set_level_state(
            state["squelch"], level_db))

    def init_state(self):
        return {
            "vfo": self.vfo.init_state(),
            "nb": self.noise_blanker.init_state() if self.noise_blanker else (),
            "squelch": self.squelch.init_state() if self.squelch else (),
            "fm_if": self.fm_if.init_state() if self.fm_if else (),
            "demod": self.demod.init_state() if self.demod else (),
            "af_resamp": self.af_resamp.init_state() if self.af_resamp else (),
            "deemph": self.deemph.init_state() if self.deemph else (),
        }

    def __call__(self, state, x):
        st = dict(state)
        st["vfo"], x = self.vfo(state["vfo"], x)
        if self.noise_blanker is not None:
            st["nb"], x = self.noise_blanker(state["nb"], x)
        if self.squelch is not None:
            st["squelch"], x = self.squelch(state["squelch"], x)
        if self.fm_if is not None:
            st["fm_if"], x = self.fm_if(state["fm_if"], x)
        rds = None
        if self.demod is None:  # RAW: I/Q to stereo (convert/complex_to_stereo)
            import jax.numpy as _jnp
            audio = _jnp.stack([x.real, x.imag], axis=-1)
        elif self.rds:
            st["demod"], (audio, rds) = self.demod(state["demod"], x)
        else:
            st["demod"], audio = self.demod(state["demod"], x)
        if self.af_resamp is not None:
            if self.stereo_out:
                # [..., n, 2] -> [..., 2, n] for the last-axis resampler
                a = jnp.swapaxes(audio, -1, -2)
                st["af_resamp"], a = self.af_resamp(state["af_resamp"], a)
                audio = jnp.swapaxes(a, -1, -2)
            else:
                st["af_resamp"], audio = self.af_resamp(state["af_resamp"], audio)
        if self.deemph is not None:
            st["deemph"], audio = self.deemph(state["deemph"], audio)
        if self.rds:
            return st, (audio, rds)
        return st, audio
