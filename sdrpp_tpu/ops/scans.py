"""Sequential/recurrent DSP blocks as JAX scans.

The reference implements these as per-sample C++ loops with member-variable
carries. Here each becomes either a parallel-prefix ``associative_scan``
(linear recurrences: DC blocker, de-emphasis, noise-blanker average) or a
``lax.scan`` (nonlinear: AGC, FastAGC, PLL/Costas), with the carry exposed as
explicit block state. All functions filter along the LAST axis and broadcast
over leading batch/channel axes.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..utils.blocks import Block

__all__ = [
    "affine_scan",
    "DCBlocker",
    "Deemphasis",
    "AGC",
    "FastAGC",
    "PLL",
    "CarrierTrackingPLL",
    "Costas",
    "NoiseBlanker",
    "Squelch",
]

FL_PI = np.float32(3.1415926535)


def affine_scan(a, b, y0):
    """Solve y[i] = a[i]*y[i-1] + b[i] (y[-1]=y0) via parallel prefix.

    ``a`` may be a scalar (constant-coefficient recurrence) or an array
    matching b. Composition of affine maps is associative:
    (a2,b2)∘(a1,b1) = (a2*a1, a2*b1 + b2), so lax.associative_scan computes
    all prefixes in O(log n) depth — this is how first-order IIRs
    (de-emphasis, DC blocker) run in parallel instead of a
    1-sample-per-step loop.
    """
    b = jnp.asarray(b)
    a = jnp.broadcast_to(jnp.asarray(a, dtype=b.dtype), b.shape)

    def combine(l, r):
        a1, b1 = l
        a2, b2 = r
        return a1 * a2, a2 * b1 + b2

    A, B = jax.lax.associative_scan(combine, (a, b), axis=-1)
    return A * jnp.expand_dims(y0, -1) + B


class DCBlocker(Block):
    """Leaky DC tracker: out[i] = in[i] - offset; offset += out[i]*rate
    (reference: core/src/dsp/correction/dc_blocker.h:54-61; rate = 50/fs per
    signal_path/iq_frontend.h:52-54).

    The recurrence offset[i] = (1-rate)*offset[i-1] + rate*in[i-1] is linear,
    so the whole block runs as an associative scan.
    """

    def __init__(self, rate: float, dtype=jnp.complex64, lead_shape=()):
        self.rate = float(rate)
        self.dtype = dtype
        self.lead_shape = tuple(lead_shape)

    def init_state(self):
        return jnp.zeros(self.lead_shape, dtype=self.dtype)

    def __call__(self, state, x):
        rate = np.float32(self.rate)
        a = np.float32(1.0 - self.rate)
        # y[i] = x[i] - offset[i] with
        # offset[i+1] = offset[i] + y[i]*rate = (1-rate)*offset[i] + rate*x[i].
        # offs[i] below is the offset AFTER absorbing sample i; the offset
        # applied at sample i is therefore offs[i-1] (carried state at i=0).
        offs = affine_scan(a, rate * x, state)
        offsets = jnp.concatenate([jnp.expand_dims(state, -1), offs[..., :-1]], axis=-1)
        y = x - offsets
        return offs[..., -1], y


class Deemphasis(Block):
    """1-pole de-emphasis IIR: y[i] = a*x[i] + (1-a)*y[i-1], a = dt/(tau+dt)
    (reference: core/src/dsp/filter/deephasis.h:60-83). Mono shape [..., n]
    or stereo [..., n, 2] (pass stereo=True)."""

    def __init__(self, tau: float, samplerate: float, stereo: bool = False, lead_shape=()):
        dt = 1.0 / float(samplerate)
        self.alpha = np.float32(dt / (float(tau) + dt))
        self.stereo = stereo
        self.lead_shape = tuple(lead_shape)

    def init_state(self):
        shape = (*self.lead_shape, 2) if self.stereo else self.lead_shape
        return jnp.zeros(shape, dtype=jnp.float32)

    def __call__(self, state, x):
        a = self.alpha
        if self.stereo:
            # x: [..., n, 2]; scan along axis -2.
            xs = jnp.swapaxes(x, -1, -2)  # [..., 2, n]
            ys = affine_scan(np.float32(1.0 - a), a * xs, state)
            y = jnp.swapaxes(ys, -1, -2)
            return y[..., -1, :], y
        y = affine_scan(np.float32(1.0 - a), a * x, state)
        return y[..., -1], y


def _amplitude(x):
    if jnp.iscomplexobj(x):
        return jnp.abs(x)
    return jnp.abs(x)


class AGC(Block):
    """Asymmetric attack/decay AGC with look-ahead clip correction
    (reference: core/src/dsp/loop/agc.h:88-147).

    Per sample: amp tracks |x| with attack when rising / decay when falling;
    gain = min(setPoint/amp, maxGain). If the scaled sample would clip above
    maxOutputAmp, the reference scans the REST of the block for the max
    amplitude and snaps ``amp`` to it (block-non-causal look-ahead,
    agc.h:110-123). We precompute the suffix max (a reversed cummax — fully
    parallel) so the scan body is O(1).

    The sequential amp recurrence itself runs as a lax.scan along the block.
    """

    def __init__(self, set_point: float, attack: float, decay: float,
                 max_gain: float, max_output_amp: float, init_gain: float = 1.0,
                 enabled: bool = True, lead_shape=()):
        self.set_point = np.float32(set_point)
        self.attack = np.float32(attack)
        self.decay = np.float32(decay)
        self.max_gain = np.float32(max_gain)
        self.max_output_amp = np.float32(max_output_amp)
        self.init_gain = np.float32(init_gain)
        self.enabled = enabled
        self.lead_shape = tuple(lead_shape)

    def init_state(self):
        amp = jnp.full(self.lead_shape, self.set_point / self.init_gain, jnp.float32)
        gain = jnp.full(self.lead_shape, np.minimum(self.init_gain, self.max_gain),
                        jnp.float32)
        return {"amp": amp, "gain": gain}

    def __call__(self, state, x):
        in_amp = _amplitude(x)
        if not self.enabled:
            # Manual gain with clip at max_output_amp (agc.h:128-143).
            gain = state["gain"]
            g = jnp.expand_dims(gain, -1)
            scaled_amp = in_amp * g
            clip = scaled_amp > self.max_output_amp
            safe_amp = jnp.where(in_amp == 0.0, 1.0, in_amp)
            y = jnp.where(clip, x * (self.max_output_amp / safe_amp), x * g)
            return state, y

        att, inv_att = self.attack, np.float32(1.0) - self.attack
        dec, inv_dec = self.decay, np.float32(1.0) - self.decay

        # Suffix max of |x| for the look-ahead clip correction.
        suffix_max = jnp.flip(jax.lax.cummax(jnp.flip(in_amp, -1), axis=in_amp.ndim - 1), -1)

        def step(carry, inp):
            amp, gain = carry
            a, smax = inp
            nonzero = a != 0.0
            amp_upd = jnp.where(a > amp, amp * inv_att + a * att, amp * inv_dec + a * dec)
            amp1 = jnp.where(nonzero, amp_upd, amp)
            gain1 = jnp.where(nonzero, jnp.minimum(self.set_point / amp1, self.max_gain),
                              np.float32(1.0))
            clipping = a * gain1 > self.max_output_amp
            amp2 = jnp.where(clipping, smax, amp1)
            gain2 = jnp.where(clipping,
                              jnp.minimum(self.set_point / amp2, self.max_gain), gain1)
            return (amp2, gain2), gain2

        # Scan along last axis; move it to leading for lax.scan.
        a_seq = jnp.moveaxis(in_amp, -1, 0)
        s_seq = jnp.moveaxis(suffix_max, -1, 0)
        (amp_f, gain_f), gains = jax.lax.scan(step, (state["amp"], state["gain"]),
                                              (a_seq, s_seq))
        gains = jnp.moveaxis(gains, 0, -1)
        y = x * gains.astype(x.dtype) if jnp.iscomplexobj(x) else x * gains
        return {"amp": amp_f, "gain": gain_f}, y


class FastAGC(Block):
    """Per-sample integrating AGC: out = in*gain; gain += (setPoint-|out|)*rate
    clamped to maxGain (reference: core/src/dsp/loop/fast_agc.h:62-88)."""

    def __init__(self, set_point: float, max_gain: float, rate: float,
                 init_gain: float = 1.0, lead_shape=()):
        self.set_point = np.float32(set_point)
        self.max_gain = np.float32(max_gain)
        self.rate = np.float32(rate)
        self.init_gain = np.float32(init_gain)
        self.lead_shape = tuple(lead_shape)

    def init_state(self):
        return jnp.full(self.lead_shape, self.init_gain, jnp.float32)

    def __call__(self, state, x):
        amp_in = _amplitude(x)

        def step(gain, a):
            out_amp = a * gain
            new_gain = gain + (self.set_point - out_amp) * self.rate
            new_gain = jnp.minimum(new_gain, self.max_gain)
            return new_gain, gain

        a_seq = jnp.moveaxis(amp_in, -1, 0)
        gain_f, gains = jax.lax.scan(step, state, a_seq)
        gains = jnp.moveaxis(gains, 0, -1)
        y = x * gains.astype(x.dtype) if jnp.iscomplexobj(x) else x * gains
        return gain_f, y


def _normalize_phase(d):
    """Wrap into (-pi, pi] (reference: core/src/dsp/math/normalize_phase.h)."""
    d = jnp.where(d > FL_PI, d - 2 * FL_PI, d)
    d = jnp.where(d <= -FL_PI, d + 2 * FL_PI, d)
    return d


def _critically_damped(bandwidth: float) -> tuple[np.float32, np.float32]:
    """Alpha/beta from loop bandwidth
    (reference: core/src/dsp/loop/phase_control_loop.h:31-36)."""
    zeta = np.sqrt(2.0) / 2.0
    denom = 1.0 + 2.0 * zeta * bandwidth + bandwidth * bandwidth
    alpha = (4.0 * zeta * bandwidth) / denom
    beta = (4.0 * bandwidth * bandwidth) / denom
    return np.float32(alpha), np.float32(beta)


def _pcl_advance(phase, freq, error, alpha, beta, min_freq, max_freq):
    """2nd-order loop advance (reference: phase_control_loop.h:58-66)."""
    freq = jnp.clip(freq + beta * error, min_freq, max_freq)
    phase = phase + freq + alpha * error
    phase = _normalize_phase(jnp.mod(phase + FL_PI, 2 * FL_PI) - FL_PI)
    return phase, freq


class PLL(Block):
    """Carrier-tracking PLL emitting the VCO phasor
    (reference: core/src/dsp/loop/pll.h:64-70): out[i] = phasor(phase);
    advance(normalize(angle(in[i]) - phase))."""

    def __init__(self, bandwidth: float, init_phase: float = 0.0, init_freq: float = 0.0,
                 min_freq: float = -float(FL_PI), max_freq: float = float(FL_PI),
                 lead_shape=()):
        self.alpha, self.beta = _critically_damped(bandwidth)
        self.init_phase = np.float32(init_phase)
        self.init_freq = np.float32(init_freq)
        self.min_freq = np.float32(min_freq)
        self.max_freq = np.float32(max_freq)
        self.lead_shape = tuple(lead_shape)

    def init_state(self):
        return {
            "phase": jnp.full(self.lead_shape, self.init_phase, jnp.float32),
            "freq": jnp.full(self.lead_shape, self.init_freq, jnp.float32),
        }

    def __call__(self, state, x):
        in_phase = jnp.arctan2(x.imag, x.real)

        def step(carry, ph_in):
            phase, freq = carry
            out_phase = phase
            err = _normalize_phase(ph_in - phase)
            phase, freq = _pcl_advance(phase, freq, err, self.alpha, self.beta,
                                       self.min_freq, self.max_freq)
            return (phase, freq), out_phase

        seq = jnp.moveaxis(in_phase, -1, 0)
        (phase_f, freq_f), out_phases = jax.lax.scan(
            step, (state["phase"], state["freq"]), seq)
        out_phases = jnp.moveaxis(out_phases, 0, -1)
        y = jax.lax.complex(jnp.cos(out_phases), jnp.sin(out_phases))
        return {"phase": phase_f, "freq": freq_f}, y


def _costas_error(v, order: int):
    re, im = v.real, v.imag
    if order == 2:
        err = re * im
    elif order == 4:
        # reference math::step maps <=0 to -1 (not jnp.sign's 0): replicate.
        step_re = jnp.where(re > 0, 1.0, -1.0)
        step_im = jnp.where(im > 0, 1.0, -1.0)
        err = step_re * im - step_im * re
    elif order == 8:
        k = np.float32(np.sqrt(2.0) - 1.0)
        step_re = jnp.where(re > 0, 1.0, -1.0)
        step_im = jnp.where(im > 0, 1.0, -1.0)
        err = jnp.where(jnp.abs(re) >= jnp.abs(im),
                        step_re * im - step_im * re * k,
                        step_re * im * k - step_im * re)
    else:
        raise ValueError(f"invalid costas order {order}")
    return jnp.clip(err, -1.0, 1.0)


class Costas(Block):
    """Costas loop of order 2/4/8 (reference: core/src/dsp/loop/costas.h:6-46):
    out[i] = in[i]*phasor(-phase); advance(error(out[i]))."""

    def __init__(self, order: int, bandwidth: float, init_phase: float = 0.0,
                 init_freq: float = 0.0, min_freq: float = -float(FL_PI),
                 max_freq: float = float(FL_PI), lead_shape=()):
        assert order in (2, 4, 8)
        self.order = order
        self.alpha, self.beta = _critically_damped(bandwidth)
        self.init_phase = np.float32(init_phase)
        self.init_freq = np.float32(init_freq)
        self.min_freq = np.float32(min_freq)
        self.max_freq = np.float32(max_freq)
        self.lead_shape = tuple(lead_shape)

    def init_state(self):
        return {
            "phase": jnp.full(self.lead_shape, self.init_phase, jnp.float32),
            "freq": jnp.full(self.lead_shape, self.init_freq, jnp.float32),
        }

    def __call__(self, state, x):
        def step(carry, v):
            phase, freq = carry
            lo = jax.lax.complex(jnp.cos(-phase), jnp.sin(-phase))
            out = v * lo
            err = _costas_error(out, self.order)
            phase, freq = _pcl_advance(phase, freq, err, self.alpha, self.beta,
                                       self.min_freq, self.max_freq)
            return (phase, freq), out

        seq = jnp.moveaxis(x, -1, 0)
        (phase_f, freq_f), out = jax.lax.scan(step, (state["phase"], state["freq"]), seq)
        out = jnp.moveaxis(out, 0, -1)
        return {"phase": phase_f, "freq": freq_f}, out


class NoiseBlanker(Block):
    """Running-mean amplitude limiter (reference:
    core/src/dsp/noise_reduction/noise_blanker.h:41-62): amp tracks |x| with a
    1-pole average; gain = 1/excess when excess = |x|/amp > level.

    The amp recurrence is linear in |x| (where |x| != 0), so it runs as an
    associative scan; the gain applies elementwise afterwards.
    """

    def __init__(self, rate: float, level: float, lead_shape=()):
        self.rate = np.float32(rate)
        self.level = np.float32(level)
        self.lead_shape = tuple(lead_shape)

    def init_state(self):
        return jnp.ones(self.lead_shape, jnp.float32)

    def __call__(self, state, x):
        in_amp = _amplitude(x)
        nonzero = in_amp != 0.0
        # amp[i] = (1-rate)*amp[i-1] + rate*|x[i]| when |x[i]|!=0 else amp[i-1]
        a = jnp.where(nonzero, np.float32(1.0) - self.rate, np.float32(1.0))
        b = jnp.where(nonzero, self.rate * in_amp, np.float32(0.0))
        amps = affine_scan(a, b, state)
        excess = in_amp / amps
        gain = jnp.where(nonzero & (excess > self.level), 1.0 / excess, 1.0)
        y = x * gain.astype(x.dtype) if jnp.iscomplexobj(x) else x * gain
        return amps[..., -1], y


class Squelch(Block):
    """Block-mean-power squelch with hysteresis + unmute confirmation
    (reference: core/src/dsp/noise_reduction/squelch.h:32-61): block level =
    20*log10(mean |x|); mute when level < threshold-1dB; unmute only after 10
    consecutive above-threshold blocks (~100 ms).

    NOTE: the reference evaluates this once per ~10ms stream block. We keep
    that granularity by splitting the input block into ``sub_blocks`` frames
    and scanning the tiny state machine over them.
    """

    def __init__(self, level_db: float, sub_blocks: int = 1, lead_shape=()):
        self.level = np.float32(level_db)
        self.sub_blocks = int(sub_blocks)
        self.lead_shape = tuple(lead_shape)

    def init_state(self):
        return {
            "mute": jnp.zeros(self.lead_shape, jnp.bool_),
            "cnt": jnp.zeros(self.lead_shape, jnp.int32),
            # threshold lives in STATE (like the reference's runtime
            # setLevel, squelch.h:63-66): a UI squelch-knob change is a
            # scalar state write, not a re-trace (a re-jit costs seconds)
            "level": jnp.full((), self.level, jnp.float32),
        }

    def set_level_state(self, state, level_db: float):
        """New state with the threshold changed — a write, not a rebuild."""
        return dict(state, level=jnp.full((), np.float32(level_db),
                                          jnp.float32))

    def __call__(self, state, x):
        n = x.shape[-1]
        sb = self.sub_blocks
        assert n % sb == 0
        thresh = state.get("level", self.level)  # old states: constant
        frames = x.reshape(*x.shape[:-1], sb, n // sb)
        mean_amp = jnp.mean(jnp.abs(frames), axis=-1)  # [..., sb]
        level = 20.0 * jnp.log10(jnp.maximum(mean_amp, 1e-20))

        def step(carry, lv):
            mute, cnt = carry
            below = lv < thresh
            # Muted branch (squelch.h:40-47)
            cnt_m = jnp.where(below | (cnt <= 0), 10, cnt - 1)
            unmute = (~below) & (cnt > 0) & (cnt_m == 0)
            mute_m = jnp.where(unmute, False, True)
            # Unmuted branch: hysteresis 1 dB (squelch.h:48-53)
            mute_u = lv < (thresh - 1.0)
            cnt_u = jnp.where(mute_u, 0, cnt)
            new_mute = jnp.where(mute, mute_m, mute_u)
            new_cnt = jnp.where(mute, cnt_m, cnt_u)
            return (new_mute, new_cnt), new_mute

        seq = jnp.moveaxis(level, -1, 0)
        (mute_f, cnt_f), mutes = jax.lax.scan(step, (state["mute"], state["cnt"]), seq)
        mutes = jnp.moveaxis(mutes, 0, -1)  # [..., sb]
        # Select (not multiply): the reference memsets muted blocks to +0
        # (squelch.h:59); multiplying by 0 would produce -0.0 for negative
        # samples and atan2(+0, -0) = pi in a downstream FM discriminator.
        zero = jnp.zeros((), frames.dtype)
        y = jnp.where(mutes[..., :, None], zero, frames).reshape(x.shape)
        return {"mute": mute_f, "cnt": cnt_f,
                "level": state.get("level", jnp.full((), self.level,
                                                     jnp.float32))}, y


class CarrierTrackingPLL(PLL):
    """PLL variant that outputs the mixed-down signal instead of the VCO
    (reference: core/src/dsp/loop/carrier_tracking_pll.h:14-19):
    out[i] = in[i] * phasor(-phase); advance(normalize(angle(in[i]) - phase)).
    """

    def __call__(self, state, x):
        in_phase = jnp.arctan2(x.imag, x.real)

        def step(carry, inp):
            phase, freq = carry
            ph_in, v = inp
            out = v * jax.lax.complex(jnp.cos(-phase), jnp.sin(-phase))
            err = _normalize_phase(ph_in - phase)
            phase, freq = _pcl_advance(phase, freq, err, self.alpha, self.beta,
                                       self.min_freq, self.max_freq)
            return (phase, freq), out

        seq = (jnp.moveaxis(in_phase, -1, 0), jnp.moveaxis(x, -1, 0))
        (phase_f, freq_f), out = jax.lax.scan(
            step, (state["phase"], state["freq"]), seq)
        out = jnp.moveaxis(out, 0, -1)
        return {"phase": phase_f, "freq": freq_f}, out
