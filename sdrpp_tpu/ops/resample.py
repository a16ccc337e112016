"""Multirate: power-of-2 decimation cascade + polyphase rational resampling.

Design: the reference's per-output-sample VOLK dot products
(core/src/dsp/multirate/polyphase_resampler.h:75-92) become one batched
gather + dense multiply-reduce per block. Because interp/decim are static
configuration and block lengths are chosen as a multiple of ``decim``, the
resampler's phase pattern is block-invariant: the per-output input offsets
and phase-bank rows are precomputed on host and baked in as constants, so
shapes stay static under jit.

The power-of-2 pre-decimator uses the reference's auto-generated optimal
stage plans and coefficient tables verbatim (pure data; reference:
core/src/dsp/multirate/decim/plans.h:24-141, decim/taps/*.h) so decimated
output matches the reference.
"""

from __future__ import annotations

import functools
from pathlib import Path

import os

import numpy as np
import jax
import jax.numpy as jnp

from ..utils.blocks import Block
from .fir import decimating_fir_correlate, fir_init_tail
from .taps import low_pass

__all__ = [
    "decim_plan",
    "build_polyphase_bank",
    "PowerDecimator",
    "FFTPowerDecimator",
    "PolyphaseResampler",
    "RationalResampler",
    "RRCInterpolator",
]

_DECIM_NPZ = Path(__file__).parent / "decim_taps.npz"


@functools.lru_cache(maxsize=None)
def _decim_tables():
    return dict(np.load(_DECIM_NPZ, allow_pickle=False))


def decim_plan(ratio: int) -> list[tuple[int, np.ndarray]]:
    """Stage plan [(decimation, taps), ...] for a power-of-2 ratio
    (reference: decim/plans.h:37-141)."""
    tables = _decim_tables()
    key = f"plan_{ratio}_decim"
    if key not in tables:
        raise ValueError(f"unsupported power-of-2 decimation ratio {ratio}")
    decims = tables[key]
    names = str(tables[f"plan_{ratio}_names"]).split("|")
    return [(int(d), tables[n]) for d, n in zip(decims, names)]


def max_power_decim_ratio() -> int:
    return 8192  # 2^13 (reference: power_decimator.h:31-33)


class PowerDecimator(Block):
    """Cascaded half/quarter-band FIR power-of-2 decimator
    (reference: core/src/dsp/multirate/power_decimator.h:8-119).

    Input block length must be a multiple of ``ratio``."""

    def __init__(self, ratio: int, dtype=jnp.complex64, lead_shape=()):
        assert ratio >= 1 and (ratio & (ratio - 1)) == 0 and ratio <= max_power_decim_ratio()
        self.ratio = int(ratio)
        self.dtype = dtype
        self.lead_shape = tuple(lead_shape)
        self.stages = decim_plan(ratio) if ratio > 1 else []

    def init_state(self):
        return tuple(fir_init_tail(taps.shape[0], self.dtype, self.lead_shape)
                     for _, taps in self.stages)

    def __call__(self, state, x):
        if self.ratio == 1:
            return state, x
        new_states = []
        for (r, taps), tail in zip(self.stages, state):
            tail, x = decimating_fir_correlate(tail, x, taps, r)
            new_states.append(tail)
        return tuple(new_states), x


def equivalent_decim_taps(ratio: int) -> np.ndarray:
    """Collapse the decimation cascade to ONE wideband filter.

    Each stage is a strided correlation; composing two correlations
    convolves their tap sequences (noble identity with the inner stage's
    taps zero-stuffed by the cumulative decimation), so the whole plan
    equals a single DecimatingFIR(h_eq, ratio) with
    h_eq = t1 (*) t2^(D1) (*) t3^(D1*D2) ... — e.g. the /256 plan
    (143 @ /32, 27 @ /4, 69 @ /2) collapses to 9679 wideband taps.
    Host-side, float64 accumulation."""
    h = np.ones(1, np.float64)
    cum = 1
    for r, t in decim_plan(ratio):
        up = np.zeros((t.shape[0] - 1) * cum + 1, np.float64)
        up[::cum] = t.astype(np.float64)
        h = np.convolve(h, up)
        cum *= r
    return h.astype(np.float32)


class FFTPowerDecimator(Block):
    """Power-of-2 decimation as ONE batched FFT.

    The time-domain cascade (PowerDecimator) was 77% of the wideband
    headline chain — 8 sequential strided convs with materialized
    intermediates. Here the cascade's EXACT equivalent wideband filter
    (equivalent_decim_taps) is applied in the frequency domain with the
    channelizer's spectral alias-fold trick (ops/channelizer.py): the
    block is segmented into overlap-save frames, ONE batched FFT
    [segments, F] covers all of them (the launch-batching shape the r5
    roofline sweep showed the FFT prefers), the folded F/R-bin spectrum
    is IFFT'd at the OUTPUT rate, and the phase ramp baked into the tap
    spectrum lands the outputs exactly on the reference's stride grid
    (y[k] = sum_j h[j] buf[R k + j], decimating_fir.h:55-66).

    Per segment of F bins only ~l/F is overlap (l = 9679 for /256 at
    F = 2^20: 0.9%), and the IFFT runs at 1/R of the input rate — the
    cascade's O(2n) conv passes become ~1 FFT pass over the input.

    Block length must be a multiple of ``block_multiple`` (= the frame
    payload). State/output match PowerDecimator exactly (pinned by
    tests/test_fft_decimator.py).
    """

    def __init__(self, ratio: int, dtype=jnp.complex64, lead_shape=(),
                 fft_len: int = 1 << 20, out_multiple: int = 1):
        assert ratio >= 2 and (ratio & (ratio - 1)) == 0 \
            and ratio <= max_power_decim_ratio()
        self.ratio = int(ratio)
        self.dtype = dtype
        self.lead_shape = tuple(lead_shape)
        self.taps = equivalent_decim_taps(ratio)
        m = self.taps.shape[0]
        r = self.ratio
        self.fft_len = int(fft_len)
        # overlap (pad) = smallest multiple of R covering the tail, so
        # the payload stays a multiple of R and the fold grid is exact;
        # out_multiple additionally aligns the per-segment OUTPUT count
        # (e.g. to a downstream channelizer's block multiple)
        q = r * int(out_multiple)
        pad = -(-(m - 1) // q) * q
        if self.fft_len < pad + q:
            raise ValueError(f"fft_len {fft_len} too small for {m} taps")
        self.payload = self.fft_len - pad
        self.block_multiple = self.payload
        # tap spectrum with the stride-phase ramp baked in:
        # Z' = FFT(frame) * H * e^{2pi i f (m-1)/F} puts y_full[m-1+R k]
        # on the fold grid (shift theorem); fold + IFFT_M then evaluates
        # exactly the strided correlation outputs.
        rev = np.zeros(self.fft_len, np.complex128)
        rev[:m] = self.taps[::-1].astype(np.float64)
        H = np.fft.fft(rev)
        f = np.arange(self.fft_len)
        ramp = np.exp(2j * np.pi * f * (m - 1) / self.fft_len)
        self._spec = (H * ramp).astype(np.complex64)

    def init_state(self):
        return fir_init_tail(self.taps.shape[0], self.dtype,
                             self.lead_shape)

    def __call__(self, state, x):
        n = x.shape[-1]
        assert n % self.payload == 0, \
            f"block length {n} must be a multiple of {self.payload}"
        segs = n // self.payload
        m = self.taps.shape[0]
        r, F = self.ratio, self.fft_len
        M = F // r
        buf = jnp.concatenate([state, x], axis=-1)  # [..., n + m - 1]
        frame_len = self.payload + m - 1
        frames = jnp.stack(
            [jax.lax.slice_in_dim(buf, b * self.payload,
                                  b * self.payload + frame_len, axis=-1)
             for b in range(segs)], axis=-2)  # [..., segs, frame_len]
        Z = jnp.fft.fft(frames.astype(jnp.complex64), n=F, axis=-1)
        Z = Z * jnp.asarray(self._spec)
        fold = jnp.sum(Z.reshape(*Z.shape[:-1], r, M), axis=-2)
        z = jnp.fft.ifft(fold, axis=-1) * np.float32(M / F)
        y = z[..., : self.payload // r]  # valid strided outputs
        y = y.reshape(*y.shape[:-2], segs * (self.payload // r))
        if not jnp.iscomplexobj(x):
            y = y.real
        y = y.astype(x.dtype)
        new_tail = jax.lax.slice_in_dim(buf, n, n + m - 1, axis=-1)
        return new_tail, y


def build_polyphase_bank(taps: np.ndarray, interp: int) -> np.ndarray:
    """Split taps into interp phases, reference layout
    (core/src/dsp/multirate/polyphase_bank.h:25-45):
    bank[(interp-1) - (i % interp)][i // interp] = taps[i], zero-padded."""
    taps = np.asarray(taps)
    tpp = (taps.shape[0] + interp - 1) // interp
    bank = np.zeros((interp, tpp), dtype=taps.dtype)
    for i in range(interp * tpp):
        v = taps[i] if i < taps.shape[0] else 0
        bank[(interp - 1) - (i % interp), i // interp] = v
    return bank


# Max unrolled slice+mac ops for the grouped (gather-free) polyphase form;
# above this the gather form compiles O(1) ops instead of i*tpp.
GROUPED_MAX_UNROLL = 8192

# Polyphase strategy override: "zero_stuff", "grouped", or "auto"
# (= grouped/gather; which one the GPU prefers at the bench's shapes is
# not measured yet).
POLYPHASE_MODE = os.environ.get("SDRPP_TPU_POLYPHASE", "auto")


def _prefer_zero_stuff() -> bool:
    return POLYPHASE_MODE == "zero_stuff"


class PolyphaseResampler(Block):
    """L/M rational resampler (reference: polyphase_resampler.h:8-125).

    Per output k the reference advances a (phase, offset) pair; in closed form
    with virtual index v_k = k*decim: offset_k = v_k // interp,
    phase_k = v_k % interp. Block length must be a multiple of ``decim`` so
    the carried v wraps to 0 every block and output length is static.
    """

    def __init__(self, interp: int, decim: int, taps: np.ndarray, dtype=jnp.complex64,
                 lead_shape=()):
        self.interp = int(interp)
        self.decim = int(decim)
        self._taps = np.asarray(taps)
        self.bank = build_polyphase_bank(taps, self.interp)
        self.tpp = self.bank.shape[1]
        self.dtype = dtype
        self.lead_shape = tuple(lead_shape)

    def out_count(self, n: int) -> int:
        assert n % self.decim == 0, (n, self.decim)
        return n * self.interp // self.decim

    def init_state(self):
        return jnp.zeros((*self.lead_shape, self.tpp - 1), dtype=self.dtype)

    def _index_tables(self, n: int):
        out_n = self.out_count(n)
        v = np.arange(out_n, dtype=np.int64) * self.decim
        offsets = (v // self.interp).astype(np.int32)
        phases = (v % self.interp).astype(np.int32)
        taps_sel = self.bank[phases]  # [out_n, tpp] static
        return offsets, taps_sel

    def __call__(self, state, x):
        n = x.shape[-1]
        out_n = self.out_count(n)
        buf = jnp.concatenate([state, x], axis=-1)
        new_tail = buf[..., n:]
        i, d, tpp = self.interp, self.decim, self.tpp

        if i == 1 and tpp > 1:
            # Pure decimation (e.g. the 240k->48k AF stage in every WFM
            # chain): the bank degenerates to the plain taps and the
            # per-output recurrence to y[k] = sum_t taps[t]*buf[k*d + t]
            # with an (m-1)-sample tail — exactly decimating_fir_correlate,
            # whose polyphase/strided-conv forms run ~50x faster on the
            # chip than the tpp-unrolled grouped loop below.
            from .fir import decimating_fir_correlate

            new_tail, y = decimating_fir_correlate(state, x, self._taps, d)
            y = y.astype(self.dtype) if jnp.iscomplexobj(x) else y
            return new_tail, y

        if i > 1 and i * tpp > i and _prefer_zero_stuff():
            # Zero-stuff + decimating polyphase correlation: the textbook
            # L/M identity — upsample by i (zeros), stride-d decimating
            # FIR with the full taps. Exactly equal to the bank math (the
            # bank IS these taps re-indexed) but lowers to the same dense
            # reshape-correlations as decimating_fir_correlate instead of
            # the i*tpp unrolled slice/mac graph of the grouped form below.
            from .fir import decimating_fir_correlate

            taps = np.zeros(i * tpp, np.complex64
                            if np.iscomplexobj(self._taps) else np.float32)
            taps[:len(self._taps)] = self._taps
            m = i * tpp
            zshape = (*x.shape[:-1], n, i - 1)
            ups = jnp.concatenate(
                [x[..., None], jnp.zeros(zshape, x.dtype)], axis=-1)
            ups = ups.reshape(*x.shape[:-1], n * i)
            # upsampled-domain history: (i-1) zeros then zero-stuffed tail
            th = jnp.concatenate(
                [state[..., None],
                 jnp.zeros((*state.shape, i - 1), state.dtype)], axis=-1)
            th = th.reshape(*state.shape[:-1], (tpp - 1) * i)
            th = jnp.concatenate(
                [jnp.zeros((*state.shape[:-1], i - 1), state.dtype), th],
                axis=-1)
            assert th.shape[-1] == m - 1
            _, y = decimating_fir_correlate(th, ups, taps, d)
            y = y.astype(self.dtype) if jnp.iscomplexobj(x) else y
            return new_tail, y

        if out_n % i == 0 and i * tpp <= GROUPED_MAX_UNROLL:
            # Gather-free grouped form: outputs k = m*i + r share phase
            # bank[(r*d) % i] and their offsets advance by exactly d —
            # each group is a stride-d correlation (a decimating FIR with
            # that phase's taps). Work = out_n * tpp MACs, pure slices.
            # The i*tpp bound caps graph size (the loops unroll i*tpp
            # slice+mac ops at trace time); above it the gather form
            # compiles O(1) ops instead.
            groups = []
            m_count = out_n // i
            for r in range(i):
                v = r * d
                off0 = v // i
                phase = v % i
                taps_r = self.bank[phase]  # [tpp]
                acc = None
                for t in range(tpp):
                    start = off0 + t
                    sl = jax.lax.slice_in_dim(buf, start, start + (m_count - 1) * d + 1,
                                              axis=-1)[..., ::d]
                    term = sl * taps_r[t]
                    acc = term if acc is None else acc + term
                groups.append(acc)
            # Interleave groups: y[m*i + r] = groups[r][m]
            y = jnp.stack(groups, axis=-1).reshape(*buf.shape[:-1], out_n)
        else:
            offsets, taps_sel = self._index_tables(n)
            idx = offsets[:, None] + np.arange(tpp, dtype=np.int32)[None, :]
            windows = buf[..., jnp.asarray(idx)]  # [..., out_n, tpp]
            y = jnp.sum(windows * jnp.asarray(taps_sel), axis=-1)
        y = y.astype(self.dtype) if jnp.iscomplexobj(x) else y
        return new_tail, y


def plan_rational_resampler(in_samplerate: float, out_samplerate: float):
    """Replicates RationalResampler::reconfigure planning math
    (reference: rational_resampler.h:121-167). Returns a dict plan."""
    pre_power = int(np.floor(np.log2(in_samplerate / out_samplerate))) \
        if in_samplerate > out_samplerate else 0
    pre_power = min(pre_power, max_power_decim_ratio())
    # Planning refinement over the reference: its reconfigure() rounds the
    # post-predecimation rate to an integer, so a non-integral intermediate
    # (e.g. 250 kHz / 32 = 7812.5 Hz) silently plans a huge interp/decim
    # pair (1250/1953) with a hidden 0.0064% rate error. Back the
    # pre-decimator off until the intermediate rate is integral — for
    # 250 kHz -> 5 kHz that gives 16x -> 15625 Hz -> interp 8 / decim 25,
    # exact and with a tiny polyphase bank (graph size scales with interp).
    while pre_power > 0 and (in_samplerate / (1 << pre_power)) % 1.0 != 0.0:
        pre_power -= 1
    pre_ratio = min(1 << max(pre_power, 0), max_power_decim_ratio())
    use_decim = in_samplerate > out_samplerate and pre_power > 0
    int_samplerate = in_samplerate / pre_ratio if use_decim else in_samplerate

    int_sr = int(round(int_samplerate))
    out_sr = int(round(out_samplerate))
    g = np.gcd(int_sr, out_sr)
    interp = out_sr // g
    decim = int_sr // g

    actual_out = int_sr * interp / decim
    error = abs((actual_out - out_samplerate) / out_samplerate) * 100.0
    plan = {
        "pre_ratio": pre_ratio if use_decim else 1,
        "interp": interp,
        "decim": decim,
        "error_pct": error,
        "use_resamp": interp != decim,
        "taps": None,
    }
    if interp != decim:
        tap_samplerate = int_samplerate * interp
        tap_bandwidth = min(in_samplerate, out_samplerate) / 2.0
        taps = low_pass(tap_bandwidth, tap_bandwidth * 0.1, tap_samplerate)
        plan["taps"] = (taps * np.float32(interp)).astype(np.float32)
    return plan


class RationalResampler(Block):
    """Arbitrary-rate resampler: power-of-2 pre-decimator + gcd-planned
    polyphase stage (reference: rational_resampler.h:14-175).

    ``block_multiple`` is the required input block-length multiple for static
    shapes (pre_ratio * decim).
    """

    def __init__(self, in_samplerate: float, out_samplerate: float, dtype=jnp.complex64,
                 lead_shape=()):
        self.in_samplerate = float(in_samplerate)
        self.out_samplerate = float(out_samplerate)
        self.dtype = dtype
        p = plan_rational_resampler(in_samplerate, out_samplerate)
        self.plan = p
        self.pre = PowerDecimator(p["pre_ratio"], dtype=dtype, lead_shape=lead_shape)
        self.resamp = (PolyphaseResampler(p["interp"], p["decim"], p["taps"], dtype=dtype,
                                          lead_shape=lead_shape)
                       if p["use_resamp"] else None)
        self.block_multiple = p["pre_ratio"] * (p["decim"] if p["use_resamp"] else 1)

    def out_count(self, n: int) -> int:
        assert n % self.block_multiple == 0, (n, self.block_multiple)
        m = n // self.plan["pre_ratio"]
        if self.resamp is not None:
            m = m * self.plan["interp"] // self.plan["decim"]
        return m

    def init_state(self):
        return {
            "pre": self.pre.init_state(),
            "resamp": self.resamp.init_state() if self.resamp else (),
        }

    def __call__(self, state, x):
        if x.shape[-1] % self.block_multiple:
            raise ValueError(
                f"RationalResampler({self.in_samplerate:g}->{self.out_samplerate:g}) "
                f"needs block length a multiple of {self.block_multiple}, got {x.shape[-1]}")
        pre_state, x = self.pre(state["pre"], x)
        if self.resamp is not None:
            resamp_state, x = self.resamp(state["resamp"], x)
        else:
            resamp_state = ()
        return {"pre": pre_state, "resamp": resamp_state}, x


class RRCInterpolator(Block):
    """RRC-filtered symbol interpolator (TX pulse shaping; used by M17).

    Reference: core/src/dsp/multirate/rrc_interpolator.h:15-90 — a
    polyphase resampler whose bank is the root-raised-cosine response
    sampled at interp x the symbol rate (gcd-derived interp/decim).
    Input: symbol-rate stream; output: sample-rate RRC-shaped waveform.
    Block length must be a multiple of ``decim``.
    """

    def __init__(self, symbolrate: float, samplerate: float, rrc_beta: float,
                 rrc_tap_count: int, dtype=jnp.complex64, lead_shape=()):
        from .taps import root_raised_cosine_rate

        in_sr = int(round(symbolrate))
        out_sr = int(round(samplerate))
        g = np.gcd(in_sr, out_sr)
        interp = out_sr // g
        decim = in_sr // g
        tap_samplerate = symbolrate * interp
        taps = root_raised_cosine_rate(rrc_tap_count * interp, rrc_beta,
                                       symbolrate, tap_samplerate)
        self.interp, self.decim = interp, decim
        self.resamp = PolyphaseResampler(interp, decim, taps, dtype=dtype,
                                         lead_shape=lead_shape)
        self.block_multiple = decim

    def out_count(self, n: int) -> int:
        return self.resamp.out_count(n)

    def init_state(self):
        return self.resamp.init_state()

    def __call__(self, state, x):
        return self.resamp(state, x)
