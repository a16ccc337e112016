"""Complex NCO mixing (frequency translation) with per-block phase carry.

The reference rotates each sample by an incrementing phasor via VOLK's
rotator, carrying the phase across blocks (reference:
core/src/dsp/channel/frequency_xlator.h:44-48; out[i] = in[i] * phase,
phase *= delta). Here the whole block is mixed at once:
``out[i] = in[i] * exp(j*(phi0 + i*omega))`` and the carry is
``phi0 + n*omega mod 2pi`` — no per-sample recurrence, no magnitude drift
(the VOLK rotator renormalizes periodically; exact exp doesn't need to).
"""

from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp

from ..utils.blocks import Block

__all__ = ["mix", "mix_bank", "FrequencyXlator", "FrequencyXlatorBank", "hz_to_rads"]

TWO_PI = 2.0 * np.pi

# mix_bank LO synthesis: "product" multiplies three unit phasors
# (carried-phase phasor x two host-precomputed complex tables) — no
# per-sample transcendentals; "angle" adds wrapped phase tables and takes
# cos/sin per sample. "auto" = angle; which one the GPU prefers at the
# bench's shapes is not measured yet.
MIX_MODE = os.environ.get("SDRPP_TPU_MIX", "auto")


def _mix_use_product() -> bool:
    return MIX_MODE == "product"


def hz_to_rads(freq: float, samplerate: float) -> float:
    return TWO_PI * (freq / samplerate)


def mix(phase: jax.Array, x: jax.Array, omega: float) -> tuple[jax.Array, jax.Array]:
    """Mix block ``x`` with an NCO at ``omega`` rad/sample starting at ``phase``.

    Returns (new_phase, y). ``phase`` is a float32 scalar (or leading-batch
    array broadcastable against x's leading axes). ``omega`` is static
    configuration, so the per-sample ramp ``(i*omega) mod 2pi`` is precomputed
    on host in float64 and baked in as a float32 constant — exact for
    million-sample blocks without needing x64 inside the graph.
    """
    n = x.shape[-1]
    ramp = jnp.asarray(np.mod(np.arange(n, dtype=np.float64) * float(omega), TWO_PI)
                       .astype(np.float32))
    ph = jnp.mod(phase[..., None] + ramp, np.float32(TWO_PI))
    lo = jax.lax.complex(jnp.cos(ph), jnp.sin(ph))
    y = x * lo
    step = np.float32(np.mod(n * float(omega), TWO_PI))
    new_phase = jnp.mod(phase + step, np.float32(TWO_PI))
    return new_phase, y


def mix_bank(phase: jax.Array, x: jax.Array, omegas: np.ndarray,
             block_len: int | None = None) -> tuple[jax.Array, jax.Array]:
    """Mix a wideband block against a BANK of NCOs (one per channel).

    ``phase``: [C] float32 carried phases; ``x``: [n] (shared wideband) or
    [C, n]; ``omegas``: static per-channel rad/sample (np array, length C).
    Returns (new_phase [C], y [C, n]).

    The per-channel phase ramp mod 2pi is factored as i = a*K + b so only
    two small host-precomputed tables ([C, n/K] and [C, K], each term
    already wrapped) are materialized; their broadcast sum fuses into the
    complex multiply, so the [C, n] ramp never hits HBM as a separate
    array. This is the VFO-bank equivalent of the reference's per-VFO VOLK
    rotator (frequency_xlator.h:44-48), batched across channels.
    """
    omegas = np.asarray(omegas, dtype=np.float64)
    c = omegas.shape[0]
    n = x.shape[-1] if block_len is None else block_len
    k = 1 << min(12, max(1, (int(n).bit_length() // 2)))
    while n % k:
        k >>= 1
    a = n // k
    hi = np.mod(np.arange(a, dtype=np.float64)[None, :] * (k * omegas[:, None]),
                TWO_PI)  # [C, a]
    lo = np.mod(np.arange(k, dtype=np.float64)[None, :] * omegas[:, None],
                TWO_PI)  # [C, k]
    step = np.mod(n * omegas, TWO_PI).astype(np.float32)

    # Under shard_map (parallel/spmd.py) the carried phase is this
    # device's [C/d] shard: bake the full tables replicated and take the
    # local row block. Outside shard_map ``take`` is the identity.
    from ..parallel.spmd import current_channel_axis, local_rows
    ax = current_channel_axis()
    c_local = phase.shape[0]
    if ax is not None and c_local != c:
        def take(t):
            return local_rows(t, c_local, ax)
    else:
        def take(t):
            return jnp.asarray(t)

    new_phase = jnp.mod(phase + take(step), np.float32(TWO_PI))

    if _mix_use_product():
        # exp(j(phi0 + hi + lo)) = phasor(phi0) * HI * LOW: the two tables
        # are host-precomputed complex constants; runtime transcendentals
        # are only the [C] carried phases. Unit-magnitude products don't
        # drift — there is no recurrence (the carry is still an angle).
        hi_c = take(np.exp(1j * hi).astype(np.complex64))  # [C, a]
        lo_c = take(np.exp(1j * lo).astype(np.complex64))  # [C, k]
        ph0 = jax.lax.complex(jnp.cos(phase), jnp.sin(phase))     # [C]
        lo_osc = (ph0[:, None, None] * hi_c[:, :, None]) * lo_c[:, None, :]
        xs = x.reshape(*x.shape[:-1], a, k)
        y = (xs * lo_osc if x.ndim > 1 else xs[None] * lo_osc) \
            .reshape(*lo_osc.shape[:-2], n)
        return new_phase, y

    ph = (phase[:, None, None] + take(hi.astype(np.float32))[:, :, None]
          + take(lo.astype(np.float32))[:, None, :])
    ph = jnp.mod(ph, np.float32(TWO_PI)).reshape(c_local, n)
    lo_osc = jax.lax.complex(jnp.cos(ph), jnp.sin(ph))
    y = x * lo_osc if x.ndim > 1 else x[None, :] * lo_osc
    return new_phase, y


class FrequencyXlatorBank(Block):
    """Per-channel frequency translation over a channel axis.

    ``offsets_hz``: array of per-channel offsets (the bank mixes by
    +offset; pass negated VFO offsets as RxVFO does, rx_vfo.h:30)."""

    def __init__(self, offsets_hz, samplerate: float):
        self.omegas = np.asarray(
            [hz_to_rads(o, samplerate) for o in np.asarray(offsets_hz)], np.float64)
        self.channels = self.omegas.shape[0]

    def init_state(self):
        return jnp.zeros((self.channels,), dtype=jnp.float32)

    def __call__(self, state, x):
        return mix_bank(state, x, self.omegas)


class FrequencyXlator(Block):
    """Frequency translation block (reference frequency_xlator.h:6-66).

    ``offset_hz`` rotates the spectrum by +offset (the RxVFO passes the
    negated VFO offset to center the channel, reference rx_vfo.h:30).
    """

    def __init__(self, offset_hz: float, samplerate: float, lead_shape=()):
        self.omega = float(hz_to_rads(offset_hz, samplerate))
        self.lead_shape = tuple(lead_shape)

    def init_state(self):
        return jnp.zeros(self.lead_shape, dtype=jnp.float32)

    def __call__(self, state, x):
        return mix(state, x, self.omega)


def mix_dynamic(phase: jax.Array, x: jax.Array, omega_hi: jax.Array,
                omega_lo: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Mix with a RUNTIME NCO frequency (omega as a traced hi/lo f32 pair).

    The static :func:`mix` bakes the (host-f64-exact) phase ramp into the
    trace, so changing frequency means re-jitting — seconds of compile
    for every retune. Here the ramp computes in-graph with
    two accuracy devices: (1) the sample index factors as i = a*K + b and
    each partial product wraps mod 2pi before summing, bounding the f32
    product-rounding error; (2) omega carries as a DOUBLE-FLOAT hi/lo
    pair — the f32 quantization of omega alone accumulates to ~1e-2 rad
    over a 262144-sample block, so the residual rides in as a separate
    tiny term i*omega_lo (exact in f32 for i < 2^24 because it stays
    small). Residual: the f32 mod of the k-strided partial leaves a
    SYSTEMATIC ~5e-3 rad/block worst case — equivalent to a ~0.003 Hz
    tuning error at 1 Msps, comparable to the reference's f32 VOLK
    rotator drift and inaudible; offline/bench paths keep the exact
    static mixer.
    """
    n = x.shape[-1]
    k = 1 << (max(n.bit_length() - 1, 0) // 2)
    while n % k:
        k >>= 1
    a_count = n // k
    w_hi = jnp.asarray(omega_hi, jnp.float32)
    w_lo = jnp.asarray(omega_lo, jnp.float32)
    two_pi = np.float32(TWO_PI)
    w1 = jnp.mod(w_hi, two_pi)
    # Cody-Waite reduction of omega*k: a plain f32 mod leaves a BIAS of
    # ~0.5 ulp(|omega*k|) in wk that the a-ramp amplifies systematically
    # (measured 0.05 rad/block at omega ~ pi). With 2pi split so that
    # m * PI2_A is EXACT (PI2_A has 13 significant bits, m <= 2^11), the
    # reduced wk is accurate to ~1e-6.
    p = w_hi * np.float32(k)  # exact: k is a power of two
    m = jnp.round(p * np.float32(1.0 / TWO_PI))
    pi2_a = np.float32(12868.0 / 2048.0)
    pi2_b = np.float32(TWO_PI - 12868.0 / 2048.0)
    pi2_c = np.float32(TWO_PI - 12868.0 / 2048.0
                       - float(np.float32(TWO_PI - 12868.0 / 2048.0)))
    wk = ((p - m * pi2_a) - m * pi2_b) - m * pi2_c
    a = jnp.arange(a_count, dtype=jnp.float32)[:, None]
    b = jnp.arange(k, dtype=jnp.float32)[None, :]
    i = a * np.float32(k) + b  # exact: < 2^24
    ph = jnp.mod(phase[..., None, None] + jnp.mod(a * wk, two_pi)
                 + jnp.mod(b * w1, two_pi) + i * w_lo, two_pi)
    ph = ph.reshape(*ph.shape[:-2], n)
    lo = jax.lax.complex(jnp.cos(ph), jnp.sin(ph))
    y = x * lo
    new_phase = jnp.mod(phase + jnp.mod(np.float32(a_count) * wk, two_pi)
                        + np.float32(n) * w_lo, two_pi)
    return new_phase, y


class DynamicFrequencyXlator(Block):
    """Frequency translation with the offset carried IN STATE — retuning
    updates a scalar instead of rebuilding/re-jitting the graph (the web
    panadapter's click-to-tune and the scanner both need this: a re-jit
    costs seconds; the reference retunes live by
    just changing the rotator phase delta, frequency_xlator.h:51-58)."""

    def __init__(self, offset_hz: float, samplerate: float, lead_shape=()):
        self.samplerate = float(samplerate)
        self.init_offset = float(offset_hz)
        self.lead_shape = tuple(lead_shape)

    def init_state(self):
        hi, lo = self.offset_state(self.init_offset)
        shp = self.lead_shape
        return {"phase": jnp.zeros(shp, jnp.float32),
                "omega_hi": jnp.full(shp or (), hi, jnp.float32),
                "omega_lo": jnp.full(shp or (), lo, jnp.float32)}

    def offset_state(self, offset_hz: float) -> tuple[np.float32, np.float32]:
        """Double-float (hi, lo) state leaves for a new offset."""
        w = float(hz_to_rads(float(offset_hz), self.samplerate))
        hi = np.float32(w)
        return hi, np.float32(w - float(hi))

    def __call__(self, state, x):
        phase, y = mix_dynamic(state["phase"], x, state["omega_hi"],
                               state["omega_lo"])
        return {"phase": phase, "omega_hi": state["omega_hi"],
                "omega_lo": state["omega_lo"]}, y
