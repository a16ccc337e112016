"""Digital demodulators: PSK, GFSK, Meteor LRPT (QPSK/OQPSK).

Reference chains:
- PSK<N>: RRC FIR -> FastAGC -> Costas<N> -> MM complex
  (core/src/dsp/demod/psk.h:25-44,135-147)
- GFSK: Quadrature(deviation=symbolrate/2 via caller) -> RRC -> MM float
  (core/src/dsp/demod/gfsk.h:24-41,131-136)
- Meteor: RRC -> FastAGC -> MeteorCostas (QPSK with the "broken
  modulation" 4-phase error option) -> optional OQPSK Q one-sample delay ->
  MM complex (decoder_modules/meteor_demodulator/src/meteor_demod.h:24-45,
  150-167, meteor_costas.h:24-56)

Outputs are (symbols[max_syms], valid[max_syms]) blocks from the MM
synchronizer where `valid` is a boolean MASK, not a prefix: the default
chunk-parallel path emits lane-major valid slots, so consumers MUST
boolean-index (`symbols[np.asarray(valid).astype(bool)]`). Only the
exact sequential scan happens to produce a prefix-shaped mask.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import taps as taps_mod
from ..ops.clock_recovery_chunked import MMClockRecoveryChunked as \
    MMClockRecovery  # chunk-parallel for long 1-D blocks; the sequential
    # scan for short blocks, [C, n] banks, and SDRPP_TPU_LOOPS=exact
from ..ops.fir import FIR
from ..ops.fm import Quadrature
from ..ops.scans import FL_PI, _normalize_phase, _pcl_advance, \
    _critically_damped
from ..ops.scans_pallas import CostasChunked as Costas, \
    FastAGCChunked as FastAGC
from ..utils.blocks import Block
from ..utils.platform import pallas_gpu_supported

__all__ = ["PSKDemod", "GFSKDemod", "MeteorCostas", "MeteorDemod"]


class PSKDemod(Block):
    """BPSK/QPSK/8PSK demodulator (reference psk.h)."""

    def __init__(self, order: int, symbolrate: float, samplerate: float,
                 rrc_tap_count: int = 31, rrc_beta: float = 0.35,
                 agc_rate: float = 0.001, costas_bandwidth: float = 0.01,
                 omega_gain: float = 0.001, mu_gain: float = 0.01,
                 omega_rel_limit: float = 0.01):
        rrc_taps = taps_mod.root_raised_cosine_rate(rrc_tap_count, rrc_beta,
                                                    symbolrate, samplerate)
        self.rrc = FIR(rrc_taps, dtype=jnp.complex64)
        self.agc = FastAGC(1.0, 10e6, agc_rate)
        self.costas = Costas(order, costas_bandwidth)
        self.recov = MMClockRecovery(samplerate / symbolrate, omega_gain, mu_gain,
                                     omega_rel_limit, complex_input=True)

    def max_symbols(self, n: int) -> int:
        return self.recov.max_symbols(n)

    def init_state(self):
        return {
            "rrc": self.rrc.init_state(),
            "agc": self.agc.init_state(),
            "costas": self.costas.init_state(),
            "recov": self.recov.init_state(),
        }

    def __call__(self, state, x):
        rs, y = self.rrc(state["rrc"], x)
        ags, y = self.agc(state["agc"], y)
        cs, y = self.costas(state["costas"], y)
        ms, (syms, valid) = self.recov(state["recov"], y)
        return {"rrc": rs, "agc": ags, "costas": cs, "recov": ms}, (syms, valid)


class GFSKDemod(Block):
    """GFSK demodulator (reference gfsk.h): FM discriminator -> RRC -> MM."""

    def __init__(self, symbolrate: float, samplerate: float, deviation: float,
                 rrc_tap_count: int = 31, rrc_beta: float = 0.35,
                 omega_gain: float = 0.001, mu_gain: float = 0.01,
                 omega_rel_limit: float = 0.01):
        self.demod = Quadrature(deviation, samplerate)
        rrc_taps = taps_mod.root_raised_cosine_rate(rrc_tap_count, rrc_beta,
                                                    symbolrate, samplerate)
        self.rrc = FIR(rrc_taps, dtype=jnp.float32)
        self.recov = MMClockRecovery(samplerate / symbolrate, omega_gain, mu_gain,
                                     omega_rel_limit, complex_input=False)

    def max_symbols(self, n: int) -> int:
        return self.recov.max_symbols(n)

    def init_state(self):
        return {
            "demod": self.demod.init_state(),
            "rrc": self.rrc.init_state(),
            "recov": self.recov.init_state(),
        }

    def __call__(self, state, x):
        ds, y = self.demod(state["demod"], x)
        rs, y = self.rrc(state["rrc"], y)
        ms, out = self.recov(state["recov"], y)
        return {"demod": ds, "rrc": rs, "recov": ms}, out


class MeteorCostas(Block):
    """QPSK Costas with Meteor M2-x "broken modulation" error function
    (reference meteor_costas.h:36-56): error = nearest of 4 fixed
    constellation phases, scaled by amplitude.
    """

    PHASES = (0.47439988279190737, 2.1777839908413044,
              3.8682349942715186, -0.29067248091319986)

    def __init__(self, bandwidth: float, broken_modulation: bool = False,
                 init_phase: float = 0.0, init_freq: float = 0.0,
                 min_freq: float = -float(FL_PI), max_freq: float = float(FL_PI),
                 warmup: int = 1024, max_lanes: int = 512):
        self.alpha, self.beta = _critically_damped(bandwidth)
        self.broken = broken_modulation
        self.init_phase = np.float32(init_phase)
        self.init_freq = np.float32(init_freq)
        self.min_freq = np.float32(min_freq)
        self.max_freq = np.float32(max_freq)
        # chunk-parallel path (ops/scans_pallas.costas_phases_chunked):
        # the broken-modulation error has a UNIQUE lock point (non-uniform
        # constellation spacing), the plain-QPSK error gets seam rotation
        # alignment; default warm-up 1024 ~= 14 loop time constants at the
        # meteor module's 0.005 bandwidth
        self.warmup = int(warmup)
        self.max_lanes = int(max_lanes)

    def init_state(self):
        # synthetic chunk-warm-up history: a locked constellation point
        # (PHASES[0] for broken modulation, pi/4 for plain QPSK — both
        # zero-error) riding the configured (init_phase, init_freq)
        two_pi = np.float32(2.0) * FL_PI
        t = jnp.arange(self.warmup, dtype=jnp.float32) - np.float32(self.warmup)
        off = np.float32(self.PHASES[0] if self.broken else FL_PI / 4.0)
        ramp = self.init_phase + self.init_freq * t + off
        ramp = jnp.mod(ramp + FL_PI, two_pi) - FL_PI
        return {"phase": jnp.zeros((), jnp.float32) + self.init_phase,
                "freq": jnp.zeros((), jnp.float32) + self.init_freq,
                "hist_re": jnp.cos(ramp), "hist_im": jnp.sin(ramp)}

    def _error(self, v):
        step_re = jnp.where(v.real > 0, 1.0, -1.0)
        step_im = jnp.where(v.imag > 0, 1.0, -1.0)
        return jnp.clip(step_re * v.imag - step_im * v.real, -1.0, 1.0)

    def __call__(self, state, x):
        from ..ops.scans_pallas import (_chunk_lanes_for,
                                        costas_phases_chunked,
                                        costas_phases_pallas, costas_streams)

        order = "meteor" if self.broken else 4
        hist = lambda h, s: jnp.concatenate(
            [h, s.astype(jnp.float32)], axis=-1)[..., -self.warmup:]
        kernel = x.ndim == 1 and pallas_gpu_supported()
        k = _chunk_lanes_for(x.shape[-1], self.warmup, self.max_lanes)

        if kernel and k >= 1:
            s1, s2 = costas_streams(x.real, x.imag, order)
            h1, h2 = costas_streams(state["hist_re"], state["hist_im"], order)
            out_phases, _, _, ph, fr = costas_phases_chunked(
                s1, s2, h1, h2, state["phase"], state["freq"], order,
                self.alpha, self.beta, self.min_freq, self.max_freq,
                lanes_k=k)
            lo = jax.lax.complex(jnp.cos(-out_phases), jnp.sin(-out_phases))
            return {"phase": ph, "freq": fr,
                    "hist_re": hist(state["hist_re"], x.real),
                    "hist_im": hist(state["hist_im"], x.imag)}, x * lo

        if kernel:
            out_phases, ph, fr = costas_phases_pallas(
                x.real, x.imag, state["phase"], state["freq"],
                order, self.alpha, self.beta,
                self.min_freq, self.max_freq)
            lo = jax.lax.complex(jnp.cos(-out_phases), jnp.sin(-out_phases))
            return {"phase": ph, "freq": fr,
                    "hist_re": hist(state["hist_re"], x.real),
                    "hist_im": hist(state["hist_im"], x.imag)}, x * lo

        if self.broken:
            # Phase-domain meteor error, the same formulation as the
            # lane kernel: rotation preserves
            # magnitude and shifts angle, so atan2/|v| vectorize OUTSIDE
            # the scan and the body works on normalize(in_phase - phase).
            # vs the reference's rotate-then-atan2 this differs by float
            # rounding only (oracle parity is tolerance-based).
            in_ph = jnp.arctan2(x.imag, x.real)
            mags = jnp.sqrt(x.real * x.real + x.imag * x.imag)

            def mstep(carry, inp):
                phase, freq = carry
                ph_t, mag_t = inp
                d0 = _normalize_phase(ph_t - phase)
                dps = jnp.stack([_normalize_phase(d0 - np.float32(p))
                                 for p in self.PHASES])
                best = dps[jnp.argmin(jnp.abs(dps))]
                err = jnp.clip(best * mag_t, -1.0, 1.0)
                out_phase = phase
                phase, freq = _pcl_advance(phase, freq, err, self.alpha,
                                           self.beta, self.min_freq,
                                           self.max_freq)
                return (phase, freq), out_phase

            (ph, fr), out_phases = jax.lax.scan(
                mstep, (state["phase"], state["freq"]), (in_ph, mags))
            lo = jax.lax.complex(jnp.cos(-out_phases), jnp.sin(-out_phases))
            return {"phase": ph, "freq": fr,
                    "hist_re": hist(state["hist_re"], x.real),
                    "hist_im": hist(state["hist_im"], x.imag)}, x * lo

        def step(carry, v):
            phase, freq = carry
            out = v * jax.lax.complex(jnp.cos(-phase), jnp.sin(-phase))
            err = self._error(out)
            phase, freq = _pcl_advance(phase, freq, err, self.alpha, self.beta,
                                       self.min_freq, self.max_freq)
            return (phase, freq), out

        (ph, fr), out = jax.lax.scan(step, (state["phase"], state["freq"]), x)
        return {"phase": ph, "freq": fr,
                "hist_re": hist(state["hist_re"], x.real),
                "hist_im": hist(state["hist_im"], x.imag)}, out


class MeteorDemod(Block):
    """Meteor M2 LRPT demodulator (BASELINE config #5 front half):
    RRC -> FastAGC -> MeteorCostas -> [OQPSK Q-delay] -> MM complex
    (reference meteor_demod.h:150-167). Default params follow the meteor
    module: symbolrate 72k, samplerate 150k, rrcTaps 31, beta 0.5(?), agc
    0.001 — pass explicitly for other birds."""

    def __init__(self, symbolrate: float = 72000.0, samplerate: float = 150000.0,
                 rrc_tap_count: int = 31, rrc_beta: float = 0.35,
                 agc_rate: float = 0.001, costas_bandwidth: float = 0.005,
                 broken_modulation: bool = False, oqpsk: bool = False,
                 omega_gain: float = 0.001, mu_gain: float = 0.01,
                 omega_rel_limit: float = 0.01):
        rrc_taps = taps_mod.root_raised_cosine_rate(rrc_tap_count, rrc_beta,
                                                    symbolrate, samplerate)
        self.rrc = FIR(rrc_taps, dtype=jnp.complex64)
        self.agc = FastAGC(1.0, 10e6, agc_rate)
        self.costas = MeteorCostas(costas_bandwidth, broken_modulation)
        self.oqpsk = oqpsk
        self.recov = MMClockRecovery(samplerate / symbolrate, omega_gain, mu_gain,
                                     omega_rel_limit, complex_input=True)

    def max_symbols(self, n: int) -> int:
        return self.recov.max_symbols(n)

    def init_state(self):
        st = {
            "rrc": self.rrc.init_state(),
            "agc": self.agc.init_state(),
            "costas": self.costas.init_state(),
            "recov": self.recov.init_state(),
        }
        if self.oqpsk:
            st["last_i"] = jnp.zeros((), jnp.float32)
        return st

    def __call__(self, state, x):
        st = dict(state)
        st["rrc"], y = self.rrc(state["rrc"], x)
        st["agc"], y = self.agc(state["agc"], y)
        st["costas"], y = self.costas(state["costas"], y)
        if self.oqpsk:
            # One-sample delay of Q only (meteor_demod.h:155-162).
            im_prev = jnp.concatenate([state["last_i"][None], y.imag[:-1]])
            st["last_i"] = y.imag[-1]
            y = jax.lax.complex(y.real, im_prev)
        st["recov"], out = self.recov(state["recov"], y)
        return st, out
