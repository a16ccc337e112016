"""GPU kernel for the per-sample sequential loops (PLL, Costas, FastAGC,
AGC), written in Pallas for the Triton route.

The lax.scan formulations in ops/scans.py run one XLA loop iteration per
sample; on a GPU every iteration is at least one kernel launch. Here one
launch walks the whole block: each program owns a power-of-two tile of
lanes (channels, or the K chunk lanes of the chunk-parallel drivers
below), keeps the loop carry in registers, and reads the time-major
``[n, C]`` streams one row per step, so each row read is coalesced along
the lanes. Programs share nothing, so the grid is over lane tiles only.

Everything vectorizable stays OUTSIDE the kernel: the PLL's input phases
(atan2) and output phasors (cos/sin), FastAGC's input amplitudes, the
AGC's look-ahead suffix max — the kernel only sequences the carries.

Where the kernel does not compile (``utils.platform.pallas_gpu_supported``
is false) the classes run the lax.scan blocks they subclass; tests run the
kernel on the CPU through the explicit ``interpret`` argument.
"""

from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp

from ..utils.platform import pallas_gpu_supported
from .scans import AGC, FL_PI, PLL, Costas, FastAGC

__all__ = ["pll_phases_pallas", "fast_agc_gains_pallas", "agc_gains_pallas",
           "costas_phases_pallas", "PLLPallas", "FastAGCPallas", "AGCPallas",
           "CostasPallas", "pll_phases_chunked", "fast_agc_gains_chunked",
           "agc_gains_chunked", "PLLChunked", "FastAGCChunked", "AGCChunked",
           "costas_phases_chunked", "CostasChunked", "costas_streams",
           "lane_scan"]

# 'auto' = chunk-parallel approximate loops where the kernel runs, for
# long blocks; 'exact' = always the exact sequential recurrence.
LOOPS_MODE = os.environ.get("SDRPP_TPU_LOOPS", "auto")

LANE_TILE = 32  # lanes per program: one warp, one lane per thread
_UNROLL = 8     # time steps per loop iteration; their row loads issue together


def lane_scan(step, state: jax.Array, streams, interpret: bool = False,
              unroll: int | None = None):
    """Run ``step`` over n time steps x C lanes in one kernel launch.

    ``step(carry, xs) -> (carry, y)``: ``carry`` is a tuple of k [1, T]
    rows, ``xs`` one [1, T] row per stream, ``y`` the [1, T] output row.
    ``state``: [k, C] initial carry; ``streams``: [n, C] time-major f32
    arrays. Returns (out [n, C], fin [k, C]). Lanes are padded up to the
    tile; padded lanes compute on zeros and are dropped. ``unroll``: time
    steps per loop iteration (default 1 interpreted, _UNROLL compiled).
    """
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as pltr

    k, C = state.shape
    n = streams[0].shape[0]
    ns = len(streams)
    tile = min(LANE_TILE, pl.next_power_of_2(C))
    cp = -(-C // tile) * tile
    state = state.astype(jnp.float32)
    streams = [s.astype(jnp.float32) for s in streams]
    if cp != C:
        state = jnp.pad(state, ((0, 0), (0, cp - C)))
        streams = [jnp.pad(s, ((0, 0), (0, cp - C))) for s in streams]
    # the interpreter fuses unrolled steps differently from one step at a
    # time, which moves results by an ulp; the reference runs one step
    if unroll is None:
        unroll = 1 if interpret else _UNROLL

    def kernel(state_ref, *refs):
        in_refs, (out_ref, fin_ref) = refs[:ns], refs[ns:]

        def rows(t, carry, count):
            xs = [[r[pl.ds(t + u, 1), :] for r in in_refs]
                  for u in range(count)]
            for u in range(count):
                carry, y = step(carry, xs[u])
                out_ref[pl.ds(t + u, 1), :] = y
            return carry

        carry = tuple(state_ref[pl.ds(j, 1), :] for j in range(k))
        carry = jax.lax.fori_loop(
            0, n // unroll, lambda g, c: rows(g * unroll, c, unroll), carry)
        carry = rows(n - n % unroll, carry, n % unroll)
        for j in range(k):
            fin_ref[pl.ds(j, 1), :] = carry[j]

    def spec(rows_):
        return pl.BlockSpec((rows_, tile), lambda i: (0, i))

    out, fin = pl.pallas_call(
        kernel,
        grid=(cp // tile,),
        in_specs=[spec(k)] + [spec(n)] * ns,
        out_specs=(spec(n), spec(k)),
        out_shape=(jax.ShapeDtypeStruct((n, cp), jnp.float32),
                   jax.ShapeDtypeStruct((k, cp), jnp.float32)),
        compiler_params=pltr.CompilerParams(num_warps=1, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="lane_scan",
    )(state, *streams)
    return out[:, :C], fin[:, :C]


def _dispatch_scan_call(step, state, streams, interpret: bool):
    """Run [..., n] streams through the lane kernel, leading dims in the
    lanes (a 1-D stream is one lane). Returns streams-shaped output + a
    [k, ...] final carry."""
    lead = streams[0].shape[:-1]
    n = streams[0].shape[-1]
    tc = [jnp.swapaxes(s.astype(jnp.float32).reshape(-1, n), 0, 1)
          for s in streams]
    out, fin = lane_scan(step, state.reshape(state.shape[0], -1), tc,
                         interpret)
    return (jnp.swapaxes(out, 0, 1).reshape(*lead, n),
            fin.reshape(state.shape[0], *lead))


def _use_kernel(obj) -> bool:
    return obj.interpret or pallas_gpu_supported()


def _pll_step(alpha, beta, min_freq, max_freq):
    """PLL recurrence step (shared by the exact and chunk-parallel
    drivers). Emits the VCO phase BEFORE consuming the input phase
    (reference pll.h:64-70 ordering)."""
    alpha = np.float32(alpha)
    beta = np.float32(beta)
    min_freq = np.float32(min_freq)
    max_freq = np.float32(max_freq)
    two_pi = np.float32(2.0) * FL_PI

    def step(carry, xs):
        phase, freq = carry
        (ph_in,) = xs
        d = ph_in - phase
        d = jnp.where(d > FL_PI, d - two_pi, d)
        d = jnp.where(d <= -FL_PI, d + two_pi, d)
        freq1 = jnp.clip(freq + beta * d, min_freq, max_freq)
        phase1 = phase + freq1 + alpha * d
        # mod lands in [-pi, pi], so the scan form's `> pi` select can
        # never fire; the `<= -pi` one CAN (mod returning exactly 0 maps
        # -pi -> +pi like the reference's normalizePhase while-loop)
        phase1 = jnp.mod(phase1 + FL_PI, two_pi) - FL_PI
        phase1 = jnp.where(phase1 <= -FL_PI, phase1 + two_pi, phase1)
        return (phase1, freq1), phase

    return step


def pll_phases_pallas(in_phases: jax.Array, phase0, freq0, alpha, beta,
                      min_freq, max_freq, interpret: bool = False):
    """Sequential PLL phase recurrence -> (out_phases, phase_f, freq_f).

    out_phases[t] is the VCO phase BEFORE consuming in_phases[t]
    (reference pll.h:64-70 ordering).
    """
    step = _pll_step(alpha, beta, min_freq, max_freq)
    state = jnp.stack([jnp.asarray(phase0, jnp.float32),
                       jnp.asarray(freq0, jnp.float32)])
    out, fin = _dispatch_scan_call(step, state, [in_phases], interpret)
    return out, fin[0], fin[1]


def _fast_agc_step(set_point, max_gain, rate):
    set_point = np.float32(set_point)
    max_gain = np.float32(max_gain)
    rate = np.float32(rate)

    def step(carry, xs):
        (gain,) = carry
        (amp,) = xs
        gain1 = jnp.minimum(gain + (set_point - amp * gain) * rate, max_gain)
        return (gain1,), gain

    return step


def fast_agc_gains_pallas(amps: jax.Array, gain0, set_point, max_gain, rate,
                          interpret: bool = False):
    """FastAGC gain recurrence -> (gains[t], gain_f); out = x * gains."""
    step = _fast_agc_step(set_point, max_gain, rate)
    state = jnp.stack([jnp.asarray(gain0, jnp.float32)])
    out, fin = _dispatch_scan_call(step, state, [amps], interpret)
    return out, fin[0]


METEOR_PHASES = (0.47439988279190737, 2.1777839908413044,
                 3.8682349942715186, -0.29067248091319986)


def _costas_step(order, alpha, beta, min_freq, max_freq):
    """Shared Costas recurrence step (exact + chunked drivers).

    ``order``: 2 / 4 / 8 (reference costas.h:25-38, streams = re/im), or
    "meteor" (streams = atan2/|v| precomputed outside the loop;
    models/digital.MeteorCostas uses the identical phase-domain
    formulation)."""
    alpha = np.float32(alpha)
    beta = np.float32(beta)
    min_freq = np.float32(min_freq)
    max_freq = np.float32(max_freq)
    two_pi = np.float32(2.0) * FL_PI
    k8 = np.float32(np.sqrt(2.0) - 1.0)
    one = np.float32(1.0)
    meteor = order == "meteor"

    def step(carry, xs):
        phase, freq = carry
        a, b = xs
        if meteor:
            # a = atan2(v), b = |v| (precomputed outside the loop)
            d0 = a - phase
            d0 = jnp.where(d0 > FL_PI, d0 - two_pi, d0)
            d0 = jnp.where(d0 <= -FL_PI, d0 + two_pi, d0)
            best = jnp.zeros_like(d0)
            best_abs = jnp.full_like(d0, np.float32(1e9))
            for p in METEOR_PHASES:
                d = d0 - np.float32(p)
                d = jnp.where(d > FL_PI, d - two_pi, d)
                d = jnp.where(d <= -FL_PI, d + two_pi, d)
                take = jnp.abs(d) < best_abs
                best = jnp.where(take, d, best)
                best_abs = jnp.where(take, jnp.abs(d), best_abs)
            err = best * b
        else:
            c = jnp.cos(-phase)
            s = jnp.sin(-phase)
            rr = a * c - b * s
            ri = a * s + b * c
            if order == 2:
                err = rr * ri
            elif order == 4:
                sr = jnp.where(rr > 0, one, -one)
                si = jnp.where(ri > 0, one, -one)
                err = sr * ri - si * rr
            else:  # order == 8
                sr = jnp.where(rr > 0, one, -one)
                si = jnp.where(ri > 0, one, -one)
                err = jnp.where(jnp.abs(rr) >= jnp.abs(ri),
                                sr * ri - si * rr * k8,
                                sr * ri * k8 - si * rr)
        err = jnp.clip(err, -one, one)
        freq1 = jnp.clip(freq + beta * err, min_freq, max_freq)
        phase1 = phase + freq1 + alpha * err
        # see _pll_step: only the `<= -pi` select can fire
        phase1 = jnp.mod(phase1 + FL_PI, two_pi) - FL_PI
        phase1 = jnp.where(phase1 <= -FL_PI, phase1 + two_pi, phase1)
        return (phase1, freq1), phase

    return step


def costas_streams(re: jax.Array, im: jax.Array, order):
    """The two input streams the Costas step consumes: re/im for the
    uniform orders, atan2/|v| (vectorized outside the loop) for
    "meteor"."""
    re = re.astype(jnp.float32)
    im = im.astype(jnp.float32)
    if order == "meteor":
        return [jnp.arctan2(im, re), jnp.sqrt(re * re + im * im)]
    return [re, im]


def costas_phases_pallas(re: jax.Array, im: jax.Array, phase0, freq0,
                         order, alpha, beta, min_freq, max_freq,
                         interpret: bool = False):
    """Sequential Costas recurrence -> (out_phases, phase_f, freq_f).

    ``order``: 2 / 4 / 8, or "meteor" for the Meteor M2-x broken-
    modulation error (models/digital.MeteorCostas._error: distance to the
    nearest of 4 fixed constellation phases, scaled by amplitude).

    The 2/4/8 errors need the ROTATED sample (reference costas.h:25-38),
    so the complex input rides along as re/im planes and the loop rotates
    each sample by -phase; the output phases let the (vectorized) caller
    apply the same rotation to produce the mixed-down samples. The METEOR
    error is phase-domain: rotation preserves magnitude and shifts angle,
    so atan2/|v| are precomputed OUTSIDE as vectorized streams and the
    loop works on normalize(in_phase - phase) (models/digital.
    MeteorCostas uses the identical formulation; pinned by tests).
    """
    step = _costas_step(order, alpha, beta, min_freq, max_freq)
    streams = costas_streams(re, im, order)
    state = jnp.stack([jnp.asarray(phase0, jnp.float32),
                       jnp.asarray(freq0, jnp.float32)])
    out, fin = _dispatch_scan_call(step, state, streams, interpret)
    return out, fin[0], fin[1]


def _agc_step(set_point, attack, decay, max_gain, max_output_amp):
    set_point = np.float32(set_point)
    attack = np.float32(attack)
    inv_attack = np.float32(1.0) - attack
    decay = np.float32(decay)
    inv_decay = np.float32(1.0) - decay
    max_gain = np.float32(max_gain)
    max_out = np.float32(max_output_amp)

    def step(carry, xs):
        amp, gain = carry
        a, smax = xs
        nonzero = a != 0.0
        amp_upd = jnp.where(a > amp, amp * inv_attack + a * attack,
                            amp * inv_decay + a * decay)
        amp1 = jnp.where(nonzero, amp_upd, amp)
        gain1 = jnp.where(nonzero, jnp.minimum(set_point / amp1, max_gain),
                          np.float32(1.0))
        clipping = a * gain1 > max_out
        amp2 = jnp.where(clipping, smax, amp1)
        gain2 = jnp.where(clipping, jnp.minimum(set_point / amp2, max_gain),
                          gain1)
        return (amp2, gain2), gain2

    return step


def agc_gains_pallas(amps: jax.Array, suffix_max: jax.Array, amp0, gain0,
                     set_point, attack, decay, max_gain, max_output_amp,
                     interpret: bool = False):
    """Full AGC gain recurrence (ops/scans.AGC enabled branch) -> gains.

    ``suffix_max`` is the precomputed look-ahead clip table (reverse cummax
    of amps — vectorized outside the loop)."""
    step = _agc_step(set_point, attack, decay, max_gain, max_output_amp)
    state = jnp.stack([jnp.asarray(amp0, jnp.float32),
                       jnp.asarray(gain0, jnp.float32)])
    out, fin = _dispatch_scan_call(step, state, [amps, suffix_max],
                                   interpret)
    return out, fin[0], fin[1]


class PLLPallas(PLL):
    """PLL with the recurrence in the lane kernel where it compiles
    (lax.scan elsewhere)."""

    def __init__(self, *args, interpret: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.interpret = interpret

    def __call__(self, state, x):
        if x.ndim > 2 or not _use_kernel(self):
            return super().__call__(state, x)
        in_phase = jnp.arctan2(x.imag, x.real)
        out_phases, phase_f, freq_f = pll_phases_pallas(
            in_phase, state["phase"], state["freq"], self.alpha, self.beta,
            self.min_freq, self.max_freq, interpret=self.interpret)
        y = jax.lax.complex(jnp.cos(out_phases), jnp.sin(out_phases))
        return {"phase": phase_f, "freq": freq_f}, y


class CostasPallas(Costas):
    """Costas loop with the recurrence in the lane kernel where it
    compiles (lax.scan elsewhere)."""

    def __init__(self, *args, interpret: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.interpret = interpret

    def __call__(self, state, x):
        if x.ndim > 2 or not _use_kernel(self):
            return super().__call__(state, x)
        out_phases, phase_f, freq_f = costas_phases_pallas(
            x.real, x.imag, state["phase"], state["freq"], self.order,
            self.alpha, self.beta, self.min_freq, self.max_freq,
            interpret=self.interpret)
        lo = jax.lax.complex(jnp.cos(-out_phases), jnp.sin(-out_phases))
        return {"phase": phase_f, "freq": freq_f}, x * lo


class FastAGCPallas(FastAGC):
    """FastAGC with the recurrence in the lane kernel where it compiles
    (lax.scan elsewhere)."""

    def __init__(self, *args, interpret: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.interpret = interpret

    def __call__(self, state, x):
        if x.ndim > 2 or not _use_kernel(self):
            return super().__call__(state, x)
        amps = jnp.abs(x)
        gains, gain_f = fast_agc_gains_pallas(
            amps, state, self.set_point, self.max_gain, self.rate,
            interpret=self.interpret)
        y = x * gains.astype(x.dtype) if jnp.iscomplexobj(x) else x * gains
        return gain_f, y


class AGCPallas(AGC):
    """Full AGC with the recurrence in the lane kernel where it compiles
    (lax.scan elsewhere)."""

    def __init__(self, *args, interpret: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.interpret = interpret

    def __call__(self, state, x):
        if x.ndim > 2 or not self.enabled or \
                not _use_kernel(self):
            return super().__call__(state, x)
        in_amp = jnp.abs(x)
        suffix_max = jnp.flip(
            jax.lax.cummax(jnp.flip(in_amp, -1), axis=in_amp.ndim - 1), -1)
        gains, amp_f, gain_f = agc_gains_pallas(
            in_amp, suffix_max, state["amp"], state["gain"], self.set_point,
            self.attack, self.decay, self.max_gain, self.max_output_amp,
            interpret=self.interpret)
        y = x * gains.astype(x.dtype) if jnp.iscomplexobj(x) else x * gains
        return {"amp": amp_f, "gain": gain_f}, y


# ---------------------------------------------------------------------------
# Chunk-parallel approximate loop drivers (the stream-Viterbi trick)
# ---------------------------------------------------------------------------
#
# The exact recurrences above are sequential: a block of n samples takes n
# dependent steps however many lanes the card has. But a critically-damped
# loop *forgets* its initial condition at a rate set by its bandwidth (the
# 2nd-order error dynamics are contracting), and an AGC forgets at its
# attack/decay rate. So — exactly like ops/fec.decode_soft_stream's
# overlapping-window Viterbi — the stream can be cut into K lanes that each
# re-acquire over a W-sample warm-up window before emitting their payload,
# and the K lanes run batched as lanes of the SAME kernel steps via
# lane_scan. Convergence is helped by seeding each lane near
# lock: zero initial phase error + the warm-up's mean phase increment as
# frequency (PLL), or the warm-up's mean amplitude (AGC).
#
# Approximation contract (tests/test_scans_chunked.py pins it): once
# W >> 1/bandwidth (PLL) or W >> 1/attack_rate (AGC), payload outputs match
# the exact scan to float32 noise on locked signals; block carries hand the
# last W raw inputs forward so lane 0 of the next block warms up on real
# history. SDRPP_TPU_LOOPS=exact restores the exact path everywhere.
#
# Noise contract (tests/test_chunked_stress.py, measured bounds): the
# chunked Costas' mod-(2pi/N) lock RMS stays within 10% + 0.02 rad of the
# exact loop's under AWGN down to per-sample SNR 3 dB with the carrier at
# 75% of the pull range, cold-start or in-lock. The lane frequency seeds
# are coherence-gated circular-mean M-th-power estimates: a lane whose
# warm-up window is too noisy (or squelched to zero) to measure frequency
# inherits the CARRIED loop frequency instead, so noise cannot drag lanes
# to the clip rails — heavy-noise ACQUISITION therefore converges no
# faster than the carried state does, by design.
#
# Costas needs one extra mechanism: an order-N Costas loop has N
# indistinguishable lock points (costas.h's error is invariant under
# k*2pi/N rotations), so independent lanes can each converge to a
# DIFFERENT constellation rotation — harmless within a lane, but a hard
# discontinuity at every seam. costas_phases_chunked resolves it: each
# lane's warm-up samples ARE its predecessor's payload tail, so the seam
# rotation is directly measurable (circular-mean phase difference over
# the overlap, rounded to the nearest multiple of 2pi/N) and a cumulative
# correction snaps every lane into the carried exact frame. The "meteor"
# broken-modulation error has a UNIQUE lock point (non-uniform
# constellation spacing) and needs no alignment at all.


def _lane_slice(ext, K, L, W):
    """[..., W + K*L] extended stream -> [..., K, W+L] overlapping lanes
    (lane j = ext[..., j*L : j*L + W + L]) using two reshapes, no gather.
    Needs W <= L."""
    lead = ext.shape[:-1]
    warm = ext[..., :K * L].reshape(*lead, K, L)[..., :W]
    return jnp.concatenate([warm, ext[..., W:].reshape(*lead, K, L)],
                           axis=-1)


def _build_lanes(streams, hists, K):
    """Cut [..., n] streams into K overlapping lanes [..., K, W+L] per
    leading index, with W-sample warm-up windows drawn from the stream
    itself (lane 0's from ``hists``, the previous block's tail). Payloads
    are padded to K*L by replicating the last sample (a constant tail
    keeps a locked loop locked). Returns (lanes, L, pad)."""
    W = hists[0].shape[-1]
    n = streams[0].shape[-1]
    L = -(-n // K)
    pad = K * L - n
    assert W <= L, (W, L)
    lanes = []
    for s, h in zip(streams, hists):
        s = s.astype(jnp.float32)
        if pad:
            s = jnp.concatenate(
                [s, jnp.broadcast_to(s[..., -1:], (*s.shape[:-1], pad))],
                axis=-1)
        ext = jnp.concatenate([h.astype(jnp.float32), s], axis=-1)
        lanes.append(_lane_slice(ext, K, L, W))
    return lanes, L, pad


def pll_phases_chunked(in_phases: jax.Array, hist: jax.Array, alpha, beta,
                       min_freq, max_freq, lanes_k: int = 128,
                       interpret: bool = False):
    """Chunk-parallel PLL phase recurrence over K lanes (x any leading
    channel dims — channels and lanes share the kernel's lane axis).

    ``hist``: the previous block's last W input phases (W = warm-up).
    Seeds: per-lane phase = first warm-up input (zero initial phase
    error), per-lane freq = mean normalized warm-up phase increment
    clipped to the loop's frequency limits — near-lock immediately for a
    tone tracker like the WFM pilot PLL (broadcast_fm.h:77-83 semantics).
    Returns (out_phases [..., n], new_hist [..., W], phase_f, freq_f).
    """
    n = in_phases.shape[-1]
    lead = in_phases.shape[:-1]
    W = hist.shape[-1]
    lanes, L, _ = _build_lanes([in_phases], [hist], lanes_k)
    lane = lanes[0]  # [..., K, W+L]
    two_pi = np.float32(2.0) * FL_PI
    d = lane[..., 1:W + 1] - lane[..., :W]
    d = jnp.where(d > FL_PI, d - two_pi, d)
    d = jnp.where(d <= -FL_PI, d + two_pi, d)
    seed_phase = lane[..., 0]
    seed_freq = jnp.clip(jnp.mean(d, axis=-1), np.float32(min_freq),
                         np.float32(max_freq))
    state = jnp.stack([seed_phase, seed_freq])
    out, fin = _dispatch_scan_call(
        _pll_step(alpha, beta, min_freq, max_freq), state, lanes, interpret)
    out = out[..., W:].reshape(*lead, lanes_k * L)[..., :n]
    new_hist = in_phases[..., n - W:].astype(jnp.float32)
    return out, new_hist, fin[0, ..., -1], fin[1, ..., -1]


def fast_agc_gains_chunked(amps: jax.Array, hist: jax.Array, set_point,
                           max_gain, rate, lanes_k: int = 128,
                           interpret: bool = False):
    """Chunk-parallel FastAGC gain recurrence (x any leading channel
    dims). Seeds each lane at the steady-state gain for its warm-up
    window's mean amplitude. Returns (gains, new_hist, gain_f)."""
    n = amps.shape[-1]
    lead = amps.shape[:-1]
    W = hist.shape[-1]
    lanes, L, _ = _build_lanes([amps], [hist], lanes_k)
    a = lanes[0]
    mean_amp = jnp.mean(a[..., :W], axis=-1)
    seed_gain = jnp.where(mean_amp > 0,
                          jnp.minimum(np.float32(set_point) / mean_amp,
                                      np.float32(max_gain)),
                          np.float32(1.0))
    state = seed_gain[None]
    out, fin = _dispatch_scan_call(
        _fast_agc_step(set_point, max_gain, rate), state, lanes, interpret)
    out = out[..., W:].reshape(*lead, lanes_k * L)[..., :n]
    new_hist = amps[..., n - W:].astype(jnp.float32)
    return out, new_hist, fin[0, ..., -1]


def agc_gains_chunked(amps: jax.Array, hist: jax.Array, set_point, attack,
                      decay, max_gain, max_output_amp, lanes_k: int = 128,
                      interpret: bool = False):
    """Chunk-parallel full-AGC gain recurrence (x any leading channel
    dims; look-ahead clip kept: the suffix max is computed over the whole
    extended block and lane-sliced, so every lane sees the same
    look-ahead table as the exact scan). Seeds each lane with its warm-up
    window's mean amplitude. Returns (gains, new_hist, amp_f, gain_f)."""
    n = amps.shape[-1]
    lead = amps.shape[:-1]
    W = hist.shape[-1]
    K = lanes_k
    L = -(-n // K)
    pad = K * L - n
    assert W <= L, (W, L)
    s = amps.astype(jnp.float32)
    if pad:
        s = jnp.concatenate(
            [s, jnp.broadcast_to(s[..., -1:], (*lead, pad))], axis=-1)
    ext = jnp.concatenate([hist.astype(jnp.float32), s], axis=-1)
    sfx = jnp.flip(jax.lax.cummax(jnp.flip(ext, -1), axis=ext.ndim - 1), -1)
    lane_a = _lane_slice(ext, K, L, W)
    lane_s = _lane_slice(sfx, K, L, W)
    mean_amp = jnp.mean(lane_a[..., :W], axis=-1)
    seed_amp = jnp.where(mean_amp > 0, mean_amp, np.float32(1.0))
    seed_gain = jnp.minimum(np.float32(set_point) / seed_amp,
                            np.float32(max_gain))
    state = jnp.stack([seed_amp, seed_gain])
    out, fin = _dispatch_scan_call(
        _agc_step(set_point, attack, decay, max_gain, max_output_amp),
        state, [lane_a, lane_s], interpret)
    out = out[..., W:].reshape(*lead, K * L)[..., :n]
    new_hist = amps[..., n - W:].astype(jnp.float32)
    return out, new_hist, fin[0, ..., -1], fin[1, ..., -1]


def costas_phases_chunked(s1: jax.Array, s2: jax.Array, hist1: jax.Array,
                          hist2: jax.Array, phase0, freq0, order, alpha,
                          beta, min_freq, max_freq, lanes_k: int = 128,
                          interpret: bool = False):
    """Chunk-parallel Costas recurrence with seam rotation alignment.

    ``s1``/``s2``: the kernel's stream convention (``costas_streams``):
    re/im for order 2/4/8, atan2/|v| for "meteor". ``hist1``/``hist2``:
    the previous block's last W stream samples (warm-up history).

    Seeding: every lane's freq = the carried ``freq0`` refined (uniform
    orders) by the M-th-power estimate over its warm-up window — raising
    a PSK signal to the M-th power cancels the modulation, so the mean
    normalized increment of M*angle(x)/M is a per-lane carrier-frequency
    measurement; phase = ``phase0`` extrapolated at freq to the lane's
    first warm-up sample. The warm-up absorbs the residual.

    Rotation ambiguity: the order-M error (costas.h:25-38) is invariant
    under k*2pi/M rotations, so a lane can settle one constellation
    rotation away from its neighbor — the reason a chunked Costas was
    previously ruled out. But the overlap region (lane j's warm-up
    samples ARE lane j-1's payload tail) measures each seam's rotation
    directly: the circular mean of the pairwise phase difference over the
    warm-up tail rounds to a multiple of 2pi/M, and a cumulative
    correction snaps every lane into lane 0's frame, which is itself
    anchored to the carried exact state (seed + real history + the
    lane-0-vs-``phase0`` anchor term). The "meteor" error is invariant
    under NO rotation (its constellation spacings 0.77/1.70/1.69/2.12 rad
    are non-uniform — breaking the QPSK ambiguity is the point of the
    broken modulation), so its single lock point needs no alignment.

    Returns (out_phases [..., n], new_hist1, new_hist2, phase_f, freq_f).
    """
    n = s1.shape[-1]
    lead = s1.shape[:-1]
    W = hist1.shape[-1]
    K = lanes_k
    two_pi = np.float32(2.0) * FL_PI
    lanes, L, _ = _build_lanes([s1, s2], [hist1, hist2], K)
    a, b = lanes  # [..., K, W+L]

    phase0 = jnp.asarray(phase0, jnp.float32)
    freq0 = jnp.asarray(freq0, jnp.float32)
    meteor = order == "meteor"
    if meteor:
        seed_freq = jnp.broadcast_to(freq0[..., None], (*lead, K))
    else:
        # M-th-power carrier estimate as a CIRCULAR mean (a linear mean
        # of mod-wrapped increments collapses once the x M phase noise
        # straddles +-pi), gated on its own coherence |z|: a lane whose
        # warm-up window is too noisy (or squelched to zero) to measure
        # frequency falls back to the carried loop frequency — under
        # heavy noise the chunked loop HOLDS lock rather than letting
        # garbage estimates pull lanes to the clip rails. Acquisition
        # from a cold start under heavy noise remains the exact loop's
        # territory (documented contract, tests/test_chunked_stress.py).
        M = np.float32(int(order))
        ang = jnp.arctan2(b[..., :W], a[..., :W])
        d = M * (ang[..., 1:] - ang[..., :-1])
        z = jnp.mean(jax.lax.complex(jnp.cos(d), jnp.sin(d)), axis=-1)
        est = jnp.arctan2(z.imag, z.real) / M
        coh = jnp.sqrt(z.real * z.real + z.imag * z.imag)
        # coherence alone is fooled by an ALL-ZERO (squelched) window:
        # arctan2(0,0)=0 phases give d=0, z=1, coh=1 — so the gate also
        # requires window energy; a dead window inherits the carried
        # loop frequency as documented
        energy = jnp.mean(a[..., :W] ** 2 + b[..., :W] ** 2, axis=-1)
        ok = (coh > np.float32(0.5)) & (energy > np.float32(1e-12))
        carried = jnp.broadcast_to(freq0[..., None], (*lead, K))
        seed_freq = jnp.clip(jnp.where(ok, est, carried),
                             np.float32(min_freq), np.float32(max_freq))
    t0 = jnp.arange(K, dtype=jnp.float32) * np.float32(L) - np.float32(W)
    seed_phase = phase0[..., None] + seed_freq * t0
    seed_phase = jnp.mod(seed_phase + FL_PI, two_pi) - FL_PI

    state = jnp.stack([seed_phase, seed_freq])
    out, fin = _dispatch_scan_call(
        _costas_step(order, alpha, beta, min_freq, max_freq),
        state, lanes, interpret)

    if meteor:
        rot = jnp.zeros((*lead, K), jnp.float32)
    else:
        step_rot = two_pi / np.float32(int(order))
        tail = min(W, 32)
        # lane j's warm-up index t and lane j-1's payload index L+t hold
        # the phase for the SAME input sample
        d_seam = out[..., 1:, W - tail:W] - out[..., :-1, L + W - tail:L + W]
        z = jnp.mean(jax.lax.complex(jnp.cos(d_seam), jnp.sin(d_seam)),
                     axis=-1)
        d_hat = jnp.arctan2(z.imag, z.real)  # [..., K-1]
        d0 = out[..., 0, W] - phase0  # lane 0 at block sample 0 vs carry
        d0 = jnp.mod(d0 + FL_PI, two_pi) - FL_PI
        k_rot = jnp.round(jnp.concatenate(
            [d0[..., None], d_hat], axis=-1) / step_rot)
        rot = jnp.cumsum(k_rot, axis=-1) * step_rot

    out = out[..., W:] - rot[..., None]
    out = jnp.mod(out + FL_PI, two_pi) - FL_PI
    out = out.reshape(*lead, K * L)[..., :n]
    phase_f = jnp.mod(fin[0, ..., -1] - rot[..., -1] + FL_PI, two_pi) - FL_PI
    return (out, s1[..., n - W:].astype(jnp.float32),
            s2[..., n - W:].astype(jnp.float32), phase_f, fin[1, ..., -1])


# Lane tiles (programs of LANE_TILE lanes) that advance together at about
# the step time of a few tiles; more tiles than this run in further waves.
# tools/bench_lane_scan.py --sweep on an H100 (PERF.md): 93 ns/step for 1
# tile, 180-203 ns for 132-1056 tiles, then time grows with the tile
# count (293 ns at 2112, 889 ns at 8448).
RESIDENT_TILES = 1056


def _lane_waves(lanes: int) -> int:
    tiles = -(-lanes // LANE_TILE)
    return -(-tiles // RESIDENT_TILES)


def _chunk_lanes_for(n: int, warmup: int, max_lanes: int,
                     channels: int = 1) -> int:
    """Per-channel lane count K minimizing the lane kernel's cost model
    ``waves(channels*K) * (W + ceil(n/K))``: sequential steps times the
    waves of lane tiles the card runs one after another. Returns 0 (don't
    chunk) unless the best chunked cost beats HALF the exact kernel's
    ``waves(channels) * n`` — the 2x margin keeps the approximation out
    of blocks too short to meaningfully win."""
    if LOOPS_MODE == "exact" or warmup <= 0:
        return 0
    best_k, best_cost = 0, None
    for k in range(1, max_lanes + 1):
        L = -(-n // k)
        if L < warmup:
            break
        cost = _lane_waves(channels * k) * (warmup + L)
        if best_cost is None or cost < best_cost:
            best_k, best_cost = k, cost
    exact_cost = _lane_waves(channels) * n
    if best_k < 2 or best_cost is None or 2 * best_cost > exact_cost:
        return 0
    return best_k


class PLLChunked(PLLPallas):
    """PLL that runs chunk-parallel in the lane kernel for long blocks
    (1-D, or [C, n] banks — channels and lanes share the lane axis), the
    exact recurrence otherwise. State grows a ``hist`` buffer of
    the last ``warmup`` input phases so lane 0 warms up on real history."""

    def __init__(self, *args, warmup: int = 512, max_lanes: int = 512,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.warmup = int(warmup)
        self.max_lanes = int(max_lanes)

    def init_state(self):
        st = super().init_state()
        # synthetic history: the input phases a locked loop at
        # (init_phase, init_freq) would have seen, so lane 0's first-block
        # warm-up reproduces the exact loop's configured start state
        two_pi = np.float32(2.0) * FL_PI
        t = jnp.arange(self.warmup, dtype=jnp.float32) - np.float32(self.warmup)
        ramp = self.init_phase + self.init_freq * t
        ramp = jnp.mod(ramp + FL_PI, two_pi) - FL_PI
        ramp = jnp.where(ramp <= -FL_PI, ramp + two_pi, ramp)
        st["hist"] = jnp.broadcast_to(ramp, (*self.lead_shape, self.warmup))
        return st

    def __call__(self, state, x):
        in_phase = jnp.arctan2(x.imag, x.real)
        C = 1 if x.ndim == 1 else int(np.prod(x.shape[:-1]))
        k = _chunk_lanes_for(x.shape[-1], self.warmup, self.max_lanes, C)
        if x.ndim > 2 or k < 1 or not _use_kernel(self):
            sub = {"phase": state["phase"], "freq": state["freq"]}
            sub, y = PLLPallas.__call__(self, sub, x)
            hist = jnp.concatenate([state["hist"], in_phase],
                                   axis=-1)[..., -self.warmup:]
            return {**sub, "hist": hist}, y
        out_phases, hist, phase_f, freq_f = pll_phases_chunked(
            in_phase, state["hist"], self.alpha, self.beta, self.min_freq,
            self.max_freq, lanes_k=k, interpret=self.interpret)
        y = jax.lax.complex(jnp.cos(out_phases), jnp.sin(out_phases))
        return {"phase": phase_f, "freq": freq_f, "hist": hist}, y


class FastAGCChunked(FastAGCPallas):
    """FastAGC, chunk-parallel in the lane kernel for long 1-D/[C, n]
    blocks (state grows a ``hist`` buffer of the last ``warmup`` input amplitudes)."""

    def __init__(self, *args, warmup: int = 1024, max_lanes: int = 512,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.warmup = int(warmup)
        self.max_lanes = int(max_lanes)

    def init_state(self):
        # constant history at set_point/init_gain: lane 0's first-block
        # seed gain lands exactly on the configured init_gain
        hist0 = jnp.full((*self.lead_shape, self.warmup),
                         np.float32(self.set_point) / self.init_gain,
                         jnp.float32)
        return {"gain": super().init_state(), "hist": hist0}

    def __call__(self, state, x):
        amps = jnp.abs(x)
        C = 1 if x.ndim == 1 else int(np.prod(x.shape[:-1]))
        k = _chunk_lanes_for(x.shape[-1], self.warmup, self.max_lanes, C)
        if x.ndim > 2 or k < 1 or not _use_kernel(self):
            gain_f, y = FastAGCPallas.__call__(self, state["gain"], x)
            hist = jnp.concatenate([state["hist"], amps],
                                   axis=-1)[..., -self.warmup:]
            return {"gain": gain_f, "hist": hist}, y
        gains, hist, gain_f = fast_agc_gains_chunked(
            amps, state["hist"], self.set_point, self.max_gain, self.rate,
            lanes_k=k, interpret=self.interpret)
        y = x * gains.astype(x.dtype) if jnp.iscomplexobj(x) else x * gains
        return {"gain": gain_f, "hist": hist}, y


class AGCChunked(AGCPallas):
    """Full AGC, chunk-parallel in the lane kernel for long 1-D/[C, n]
    blocks (state grows a ``hist`` buffer of the last ``warmup`` input amplitudes)."""

    def __init__(self, *args, warmup: int = 2048, max_lanes: int = 512,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.warmup = int(warmup)
        self.max_lanes = int(max_lanes)

    def init_state(self):
        st = super().init_state()
        # constant history at the configured initial tracked amplitude
        # (set_point/init_gain): lane 0's first-block seeds land exactly
        # on the exact loop's init_state
        st["hist"] = jnp.full((*self.lead_shape, self.warmup),
                              np.float32(self.set_point) / self.init_gain,
                              jnp.float32)
        return st

    def __call__(self, state, x):
        amps = jnp.abs(x)
        C = 1 if x.ndim == 1 else int(np.prod(x.shape[:-1]))
        k = _chunk_lanes_for(x.shape[-1], self.warmup, self.max_lanes, C)
        if x.ndim > 2 or not self.enabled or k < 1 or \
                not _use_kernel(self):
            sub = {"amp": state["amp"], "gain": state["gain"]}
            sub, y = AGCPallas.__call__(self, sub, x)
            hist = jnp.concatenate([state["hist"], amps],
                                   axis=-1)[..., -self.warmup:]
            return {**sub, "hist": hist}, y
        gains, hist, amp_f, gain_f = agc_gains_chunked(
            amps, state["hist"], self.set_point, self.attack, self.decay,
            self.max_gain, self.max_output_amp, lanes_k=k,
            interpret=self.interpret)
        y = x * gains.astype(x.dtype) if jnp.iscomplexobj(x) else x * gains
        return {"amp": amp_f, "gain": gain_f, "hist": hist}, y


class CostasChunked(CostasPallas):
    """Costas loop (order 2/4/8), chunk-parallel in the lane kernel for
    long 1-D/[C, n] blocks with seam rotation alignment (see costas_phases_chunked — the
    k*2pi/order lock ambiguity is measured on each lane-overlap region and
    snapped out). State grows ``hist_re``/``hist_im`` buffers of the last
    ``warmup`` input samples. Default warm-up 512 covers loop bandwidths
    >= ~0.01 (>= 14 loop time constants); pass a longer one for narrower
    loops. SDRPP_TPU_LOOPS=exact restores the sequential path."""

    def __init__(self, *args, warmup: int = 512, max_lanes: int = 512,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.warmup = int(warmup)
        self.max_lanes = int(max_lanes)

    def init_state(self):
        st = super().init_state()
        # synthetic history: a locked constellation point riding the
        # configured (init_phase, init_freq) carrier — zero loop error, so
        # lane 0's first-block warm-up reproduces the exact loop's start
        two_pi = np.float32(2.0) * FL_PI
        t = jnp.arange(self.warmup, dtype=jnp.float32) - np.float32(self.warmup)
        off = np.float32(0.0 if self.order == 2 else FL_PI / self.order)
        ramp = self.init_phase + self.init_freq * t + off
        ramp = jnp.mod(ramp + FL_PI, two_pi) - FL_PI
        st["hist_re"] = jnp.broadcast_to(jnp.cos(ramp),
                                         (*self.lead_shape, self.warmup))
        st["hist_im"] = jnp.broadcast_to(jnp.sin(ramp),
                                         (*self.lead_shape, self.warmup))
        return st

    def __call__(self, state, x):
        C = 1 if x.ndim == 1 else int(np.prod(x.shape[:-1]))
        k = _chunk_lanes_for(x.shape[-1], self.warmup, self.max_lanes, C)
        if x.ndim > 2 or k < 1 or not _use_kernel(self):
            sub = {"phase": state["phase"], "freq": state["freq"]}
            sub, y = CostasPallas.__call__(self, sub, x)
            keep = lambda h, s: jnp.concatenate(
                [h, s.astype(jnp.float32)], axis=-1)[..., -self.warmup:]
            return {**sub, "hist_re": keep(state["hist_re"], x.real),
                    "hist_im": keep(state["hist_im"], x.imag)}, y
        out_phases, hre, him, phase_f, freq_f = costas_phases_chunked(
            x.real, x.imag, state["hist_re"], state["hist_im"],
            state["phase"], state["freq"], self.order, self.alpha,
            self.beta, self.min_freq, self.max_freq, lanes_k=k,
            interpret=self.interpret)
        lo = jax.lax.complex(jnp.cos(-out_phases), jnp.sin(-out_phases))
        return {"phase": phase_f, "freq": freq_f, "hist_re": hre,
                "hist_im": him}, x * lo
