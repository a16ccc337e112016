"""OFDM synchronization kernels (DAB front end).

Reference: decoder_modules/dab_decoder/src/dab_dsp.h —
- ``CyclicSync`` (dab_dsp.h:8-141): per-sample sliding cyclic-prefix
  correlation corr[i] = sum over the last ``prefix`` samples of
  conj(x[j]) * x[j+symbol], peak-tracked with an AGC'd average to find
  OFDM symbol boundaries.
- ``FrameFreqSync`` (dab_dsp.h:142-266): correlate the phase-reference
  symbol against the known DAB PRS via 2048-point FFTs for frame sync +
  coarse/fine CFO.

Design: the reference recomputes the correlation incrementally one
sample at a time; here the whole block's correlation comes from ONE
prefix-sum: corr = S[i] - S[i-prefix] with S = cumsum(conj(x)*x_shift) —
fully parallel. The peak/framing decisions stay a tiny lax.scan over
samples with scalar carry (same structure as the reference's counters).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..utils.blocks import Block

__all__ = ["cyclic_prefix_correlation", "CyclicSync", "phase_reference_sync"]


def cyclic_prefix_correlation(tail, x, symbol_samps: int, prefix_samps: int):
    """Sliding CP correlation magnitudes for one block.

    ``tail``: carried last symbol_samps+prefix_samps-1 input samples.
    Returns (new_tail, rcorr[n], delayed_samples[n]) where rcorr[i] is the
    correlation magnitude aligned with the reference's per-sample loop and
    delayed_samples are the symbol-delayed samples it frames
    (dab_dsp.h:57-76: val = delayBuf[i], prod = conj(val)*delayBuf[i+symbol]).
    """
    n = x.shape[-1]
    hist = symbol_samps + prefix_samps - 1
    buf = jnp.concatenate([tail, x], axis=-1)  # [..., n + hist]
    # Aligned views: val[i] = buf[i + prefix - 1 ... ]? Reference delay layout:
    # delayBuf holds [prev symbolSamps | new]; val = delayBuf[i], ahead =
    # delayBuf[i + symbolSamps]. With our buf = [tail(hist), x], index i of
    # the reference maps to buf[i + prefix - 1]... simplest faithful layout:
    # val_i = buf[prefix - 1 + i], ahead_i = val_{i + symbol}.
    val = jax.lax.slice_in_dim(buf, prefix_samps - 1, prefix_samps - 1 + n, axis=-1)
    ahead = jax.lax.slice_in_dim(buf, prefix_samps - 1 + symbol_samps,
                                 prefix_samps - 1 + symbol_samps + n, axis=-1) \
        if buf.shape[-1] >= prefix_samps - 1 + symbol_samps + n else None
    # ahead needs samples up to prefix-1+symbol+n; buf has n+hist =
    # n+symbol+prefix-1 — exactly enough.
    ahead = jax.lax.slice_in_dim(buf, prefix_samps - 1 + symbol_samps,
                                 prefix_samps - 1 + symbol_samps + n, axis=-1)
    # products over the trailing window: prod[i] = conj(b[i])*b[i+symbol]
    # with window ending at i. Build products over the full needed range
    # [i - prefix + 1, i]:
    b0 = jax.lax.slice_in_dim(buf, 0, n + prefix_samps - 1, axis=-1)
    b1 = jax.lax.slice_in_dim(buf, symbol_samps, symbol_samps + n + prefix_samps - 1,
                              axis=-1)
    prod = jnp.conj(b0) * b1  # [..., n + prefix - 1]
    csum = jnp.cumsum(prod, axis=-1)
    hi = jax.lax.slice_in_dim(csum, prefix_samps - 1, prefix_samps - 1 + n, axis=-1)
    lo = jnp.concatenate([jnp.zeros_like(csum[..., :1]),
                          jax.lax.slice_in_dim(csum, 0, n - 1, axis=-1)], axis=-1)
    corr = hi - lo
    rcorr = jnp.abs(corr)
    new_tail = buf[..., n:]
    return new_tail, rcorr, val


class CyclicSync(Block):
    """CP-correlation symbol synchronizer (framing state machine included).

    Output: (symbols[max_syms, symbol_samps], valid[max_syms]) — complete
    OFDM symbols cut at correlation peaks, prefix-valid like the other
    data-dependent-rate blocks.
    """

    def __init__(self, symbol_length: float, cyclic_prefix_length: float,
                 samplerate: float, agc_rate: float = 1e-3):
        self.symbol_samps = int(round(samplerate * symbol_length))
        self.prefix_samps = int(round(samplerate * cyclic_prefix_length))
        self.agc_rate = np.float32(agc_rate)

    def max_symbols(self, n: int) -> int:
        return n // self.symbol_samps + 2

    def init_state(self):
        return {
            "tail": jnp.zeros(self.symbol_samps + self.prefix_samps - 1,
                              jnp.complex64),
            "avg_corr": jnp.zeros((), jnp.float32),
            "peak_corr": jnp.zeros((), jnp.float32),
            "last_corr": jnp.zeros((), jnp.float32),
            "since_peak": jnp.zeros((), jnp.int32),
            "sym_buf": jnp.zeros(self.symbol_samps, jnp.complex64),
        }

    def __call__(self, state, x):
        n = x.shape[-1]
        sym = self.symbol_samps
        max_syms = self.max_symbols(n)
        tail, rcorr, vals = cyclic_prefix_correlation(
            state["tail"], x, sym, self.prefix_samps)

        agc, agc_inv = self.agc_rate, np.float32(1.0) - self.agc_rate

        def step(carry, inp):
            avg, peak, last, since, sym_buf, emitted = carry
            rc, val = inp
            is_peak = (rc > avg) & (rc > peak)
            peak = jnp.where(is_peak, rc, peak)
            since = jnp.where(is_peak, 0, since)
            sym_buf = sym_buf.at[jnp.clip(since, 0, sym - 1)].set(val)
            since = since + 1
            emit = since >= sym
            out_sym = jnp.where(emit, sym_buf, jnp.zeros_like(sym_buf))
            since = jnp.where(emit, 0, since)
            peak = jnp.where(emit, 0.0, peak)
            avg = agc * rc + agc_inv * avg
            return (avg, peak, rc, since, sym_buf, emitted + emit.astype(jnp.int32)), \
                (out_sym, emit)

        carry0 = (state["avg_corr"], state["peak_corr"], state["last_corr"],
                  state["since_peak"], state["sym_buf"], jnp.zeros((), jnp.int32))
        (avg_f, peak_f, last_f, since_f, sym_buf_f, _), (syms, emits) = \
            jax.lax.scan(step, carry0, (rcorr, vals))

        # Compact emitted symbols into a prefix-valid array.
        order = jnp.argsort(~emits, stable=True)  # emitted rows first
        syms_sorted = syms[order]
        valid = jnp.sort(emits)[::-1]
        new_state = {
            "tail": tail,
            "avg_corr": avg_f,
            "peak_corr": peak_f,
            "last_corr": last_f,
            "since_peak": since_f,
            "sym_buf": sym_buf_f,
        }
        return new_state, (syms_sorted[:max_syms], valid[:max_syms])


def phase_reference_sync(received_sym: jax.Array, prs: np.ndarray):
    """Frame sync + coarse CFO from the DAB phase-reference symbol
    (dab_dsp.h:142-266 pattern): correlate the received symbol against the
    known PRS in the frequency domain; the cross-correlation peak gives the
    timing offset, its phase slope the fractional CFO.

    Returns (timing_offset, peak_magnitude, cfo_bins).
    """
    n = received_sym.shape[-1]
    rx_f = jnp.fft.fft(received_sym, axis=-1)
    prs_f = jnp.asarray(np.fft.fft(np.asarray(prs), n).conj())
    xcorr = jnp.fft.ifft(rx_f * prs_f, axis=-1)
    mags = jnp.abs(xcorr)
    k = jnp.argmax(mags, axis=-1)
    # Integer CFO estimate from circular shift of the spectrum correlation.
    spec_corr = jnp.abs(jnp.fft.ifft(jnp.fft.fft(jnp.abs(rx_f))
                                     * jnp.conj(jnp.fft.fft(jnp.abs(prs_f)))))
    cfo = jnp.argmax(spec_corr, axis=-1)
    cfo = jnp.where(cfo > n // 2, cfo - n, cfo)
    return k, mags[..., k] if mags.ndim == 1 else jnp.max(mags, -1), cfo


# ---------------------------------------------------------------------------
# DAB frame/frequency synchronization (dab_dsp.h:142-266)
# ---------------------------------------------------------------------------

def load_dab_prs_conj() -> np.ndarray:
    """The conjugated DAB phase-reference symbol (2048 points; pure data
    extracted from decoder_modules/dab_decoder/src/dab_phase_sym.h)."""
    from pathlib import Path as _P
    return np.load(_P(__file__).parent / "dab_phase_sym.npz")["prs_conj"]


def dab_null_detect(level, avg_level, agc_rate: float = 0.01):
    """Null-symbol detection (dab_dsp.h:197-209): a symbol block whose
    total amplitude drops below half the running average marks the frame
    start. Returns (is_null, new_avg)."""
    is_null = level < avg_level * 0.5
    new_avg = agc_rate * level + (1.0 - agc_rate) * avg_level
    return is_null, new_avg


def dab_prs_cfo(symbol: jax.Array, prs_conj=None):
    """Coarse+fine CFO from the phase-reference symbol
    (dab_dsp.h:230-256): FFT of symbol * conj(PRS); the peak bin gives the
    integer offset, the neighbor-bin amplitude ratio the fractional part.
    Returns offset estimate in rad/sample (the reference's control loop
    applies offset -= 0.1*estimate).
    """
    if prs_conj is None:
        prs_conj = load_dab_prs_conj()
    n = symbol.shape[-1]
    prod = symbol * jnp.asarray(prs_conj)
    spec = jnp.fft.fft(prod, axis=-1)
    amps = jnp.abs(spec)
    peak = jnp.argmax(amps, axis=-1)
    peak_l = amps[..., (peak + n - 1) % n]
    peak_r = amps[..., (peak + 1) % n]
    off_int = jnp.where(peak < n // 2, peak.astype(jnp.float32),
                        peak.astype(jnp.float32) - n)
    frac = (peak_r - peak_l) / (peak_r + peak_l)
    return np.float32(np.pi) * (off_int + frac) / (n / 2)


def dab_prs_constellation(symbol: jax.Array) -> jax.Array:
    """Adjacent-bin differential demod of the PRS for the constellation
    display (dab_dsp.h:218-228): pi/4-rotated X[i]*conj(X[i-1]) normalized
    by |X[i-1]|^2, over centered bins excluding DC."""
    n = symbol.shape[-1]
    spec = jnp.fft.fft(symbol, axis=-1)
    amps = jnp.abs(spec)
    pi4 = np.complex64(np.exp(1j * np.pi / 4))
    idx = np.concatenate([np.arange(-767, 0), np.arange(1, 768)])
    cid1 = np.where(idx >= 0, idx, 2048 + idx)
    cid0 = np.where(idx - 1 >= 0, idx - 1, 2048 + (idx - 1))
    x1 = spec[..., jnp.asarray(cid1)]
    x0 = spec[..., jnp.asarray(cid0)]
    a0 = amps[..., jnp.asarray(cid0)]
    return pi4 * x1 * jnp.conj(x0) / (a0 * a0)
