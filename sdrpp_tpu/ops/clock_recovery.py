"""Mueller-Müller clock recovery as a symbol-rate scan.

Reference: core/src/dsp/clock_recovery/mm.h:100-156 — sequential with a
data-dependent input stride. Formulation (SURVEY.md §7 "hard parts"):
scan over SYMBOLS (not samples) — each step dynamically gathers an
``interp_tap_count``-sample window at the current integer offset, runs the
polyphase-interpolation dot product at the fractional phase, computes the
M&M timing error, and advances the phase control loop. Since symbol rate is
~an order of magnitude below sample rate, the scan is short relative to the
block, and everything around it stays vectorized.

Static shapes: the number of symbols a block yields is data-dependent
(clock drift), so the output is (symbols[max_syms], valid_mask[max_syms])
with max_syms = ceil(n / min_omega) + 1; invalid slots are zero-filled.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..utils.blocks import Block
from .resample import build_polyphase_bank
from .taps import windowed_sinc

__all__ = ["MMClockRecovery", "FDClockRecovery"]


def _interp_bank(phase_count: int, tap_count: int) -> np.ndarray:
    """128-phase x 8-tap windowed-sinc interpolation bank
    (reference mm.h:173-178): lowPass at bw=0.5/phases, gain = phases."""
    bw = 0.5 / phase_count
    lp = windowed_sinc(phase_count * tap_count, 2.0 * np.pi * bw, norm=phase_count)
    return build_polyphase_bank(lp, phase_count)  # [phases, tap_count]


class MMClockRecovery(Block):
    """M&M symbol synchronizer (float or complex).

    ``omega`` = samples per symbol; gains/limits per reference
    (phase_control_loop.h CLAMP=false + mm.h advance: offset += floor(phase),
    phase -= floor(phase)).
    """

    def __init__(self, omega: float, omega_gain: float, mu_gain: float,
                 omega_rel_limit: float = 0.01, interp_phase_count: int = 128,
                 interp_tap_count: int = 8, complex_input: bool = True):
        self.omega = float(omega)
        self.mu_gain = np.float32(mu_gain)        # pcl alpha (phase gain)
        self.omega_gain = np.float32(omega_gain)  # pcl beta (freq gain)
        self.min_freq = np.float32(omega * (1.0 - omega_rel_limit))
        self.max_freq = np.float32(omega * (1.0 + omega_rel_limit))
        self.phase_count = int(interp_phase_count)
        self.tap_count = int(interp_tap_count)
        self.bank = _interp_bank(self.phase_count, self.tap_count)
        self.complex_input = complex_input
        self.dtype = jnp.complex64 if complex_input else jnp.float32

    def max_symbols(self, n: int) -> int:
        return int(np.ceil(n / float(self.min_freq))) + 1

    def init_state(self):
        st = {
            "tail": jnp.zeros(self.tap_count - 1, self.dtype),
            "offset": jnp.zeros((), jnp.int32),
            "phase": jnp.zeros((), jnp.float32),
            "freq": jnp.full((), self.omega, jnp.float32),
        }
        if self.complex_input:
            st.update({
                "p1": jnp.zeros((), jnp.complex64), "p2": jnp.zeros((), jnp.complex64),
                "c1": jnp.zeros((), jnp.complex64), "c2": jnp.zeros((), jnp.complex64),
            })
        else:
            st["last"] = jnp.zeros((), jnp.float32)
        return st

    def __call__(self, state, x):
        n = x.shape[-1]
        assert x.ndim == 1, "MM runs per channel; vmap for banks"
        max_syms = self.max_symbols(n)
        buf = jnp.concatenate([state["tail"], x])
        bank = jnp.asarray(self.bank)

        cplx = self.complex_input

        def step(carry, _):
            offset, phase, freq, err_state, done = carry
            active = (offset < n) & jnp.logical_not(done)

            ph_idx = jnp.clip(jnp.floor(phase * self.phase_count).astype(jnp.int32),
                              0, self.phase_count - 1)
            window = jax.lax.dynamic_slice(buf, (jnp.clip(offset, 0, n - 1),),
                                           (self.tap_count,))
            taps = bank[ph_idx]
            out_val = jnp.sum(window * taps.astype(window.dtype))

            if cplx:
                p1, p2, c1, c2 = err_state
                c0 = jax.lax.complex(jnp.where(out_val.real > 0, 1.0, -1.0),
                                     jnp.where(out_val.imag > 0, 1.0, -1.0))
                error = (((out_val - p2) * jnp.conj(c1))
                         - ((c0 - c2) * jnp.conj(p1))).real
                new_err_state = (out_val, p1, c0, c1)
            else:
                last = err_state
                step_last = jnp.where(last > 0, 1.0, -1.0)
                step_out = jnp.where(out_val > 0, 1.0, -1.0)
                error = step_last * out_val - last * step_out
                new_err_state = out_val
            error = jnp.clip(error, -1.0, 1.0)

            # PCL advance (CLAMP_PHASE=false) + MM stride
            new_freq = jnp.clip(freq + self.omega_gain * error,
                                self.min_freq, self.max_freq)
            new_phase = phase + new_freq + self.mu_gain * error
            delta = jnp.floor(new_phase)
            new_offset = offset + delta.astype(jnp.int32)
            new_phase = new_phase - delta

            # Only commit updates when this step was active.
            sel = lambda a, b: jnp.where(active, a, b)
            offset = sel(new_offset, offset)
            phase = sel(new_phase, phase)
            freq = sel(new_freq, freq)
            if cplx:
                err_state = tuple(jnp.where(active, a, b)
                                  for a, b in zip(new_err_state, err_state))
                out = jnp.where(active, out_val, 0.0 + 0.0j)
            else:
                err_state = sel(new_err_state, err_state)
                out = sel(out_val, 0.0)
            done = offset >= n
            return (offset, phase, freq, err_state, done), (out, active)

        if cplx:
            err0 = (state["p1"], state["p2"], state["c1"], state["c2"])
        else:
            err0 = state["last"]
        carry0 = (state["offset"], state["phase"], state["freq"], err0,
                  state["offset"] >= n)
        (offset_f, phase_f, freq_f, err_f, _), (symbols, valid) = jax.lax.scan(
            step, carry0, None, length=max_syms)

        new_state = {
            "tail": buf[n:],
            "offset": offset_f - n,
            "phase": phase_f,
            "freq": freq_f,
        }
        if cplx:
            new_state.update({"p1": err_f[0], "p2": err_f[1],
                              "c1": err_f[2], "c2": err_f[3]})
            # NOTE state layout: err tuple is (p0->p1 shifted): p1=new p_0T
            # is stored as p1 for the next block's propagation.
        else:
            new_state["last"] = err_f
        return new_state, (symbols, valid)


class FDClockRecovery(Block):
    """Frequency-discriminator (early-late derivative) symbol synchronizer.

    Reference: core/src/dsp/clock_recovery/fd.h:95-150 — float-only variant
    whose timing error is dfdt * sign(out), with dfdt estimated from the
    neighboring interpolation phases (central difference; one-sided at the
    bank edges). Same scan structure as MMClockRecovery.
    """

    def __init__(self, omega: float, omega_gain: float, mu_gain: float,
                 omega_rel_limit: float = 0.01, interp_phase_count: int = 128,
                 interp_tap_count: int = 8):
        self.omega = float(omega)
        self.mu_gain = np.float32(mu_gain)
        self.omega_gain = np.float32(omega_gain)
        self.min_freq = np.float32(omega * (1.0 - omega_rel_limit))
        self.max_freq = np.float32(omega * (1.0 + omega_rel_limit))
        self.phase_count = int(interp_phase_count)
        self.tap_count = int(interp_tap_count)
        self.bank = _interp_bank(self.phase_count, self.tap_count)

    def max_symbols(self, n: int) -> int:
        return int(np.ceil(n / float(self.min_freq))) + 1

    def init_state(self):
        return {
            "tail": jnp.zeros(self.tap_count - 1, jnp.float32),
            "offset": jnp.zeros((), jnp.int32),
            "phase": jnp.zeros((), jnp.float32),
            "freq": jnp.full((), self.omega, jnp.float32),
        }

    def __call__(self, state, x):
        n = x.shape[-1]
        assert x.ndim == 1
        max_syms = self.max_symbols(n)
        buf = jnp.concatenate([state["tail"], x])
        bank = jnp.asarray(self.bank)
        pc = self.phase_count

        def step(carry, _):
            offset, phase, freq, done = carry
            active = (offset < n) & jnp.logical_not(done)
            ph_idx = jnp.clip(jnp.floor(phase * pc).astype(jnp.int32), 0, pc - 1)
            window = jax.lax.dynamic_slice(buf, (jnp.clip(offset, 0, n - 1),),
                                           (self.tap_count,))
            out_val = jnp.sum(window * bank[ph_idx])
            lo = jnp.sum(window * bank[jnp.maximum(ph_idx - 1, 0)])
            hi = jnp.sum(window * bank[jnp.minimum(ph_idx + 1, pc - 1)])
            dfdt = jnp.where(ph_idx == 0, hi - out_val,
                             jnp.where(ph_idx == pc - 1, out_val - lo,
                                       (hi - lo) * 0.5))
            error = jnp.clip(dfdt * jnp.where(out_val > 0, 1.0, -1.0), -1.0, 1.0)
            new_freq = jnp.clip(freq + self.omega_gain * error,
                                self.min_freq, self.max_freq)
            new_phase = phase + new_freq + self.mu_gain * error
            delta = jnp.floor(new_phase)
            new_offset = offset + delta.astype(jnp.int32)
            new_phase = new_phase - delta
            sel = lambda a, b: jnp.where(active, a, b)
            offset = sel(new_offset, offset)
            phase = sel(new_phase, phase)
            freq = sel(new_freq, freq)
            out = sel(out_val, 0.0)
            done = offset >= n
            return (offset, phase, freq, done), (out, active)

        carry0 = (state["offset"], state["phase"], state["freq"],
                  state["offset"] >= n)
        (offset_f, phase_f, freq_f, _), (symbols, valid) = jax.lax.scan(
            step, carry0, None, length=max_syms)
        new_state = {"tail": buf[n:], "offset": offset_f - n,
                     "phase": phase_f, "freq": freq_f}
        return new_state, (symbols, valid)
