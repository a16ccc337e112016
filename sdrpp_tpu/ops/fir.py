"""FIR filtering as overlap-save FFT convolution with carried tails.

The reference computes one VOLK dot product per output sample over a sliding
delay buffer (reference: core/src/dsp/filter/fir.h:67-84,
decimating_fir.h:49-69). Here we batch a whole block: the carried state is
the last ``ntaps-1`` input samples (the reference's delay-buffer head), the
block is filtered in one FFT-sized circular convolution, and the new tail is
sliced off the end. This keeps XLA shapes static and puts the FLOPs in
batched FFTs instead of a scalar loop.

Orientation: the reference applies taps by *correlation*
(y[i] = sum_j taps[j] * buf[i+j], buf = [tail | x]), so we convolve with the
reversed taps. Tap spectra are precomputed on host (NumPy) at trace time and
baked into the jitted graph as constants.

Decimation keeps the reference's phase semantics (first output at carried
``offset``, then every R-th input sample, decimating_fir.h:55-66); block
lengths must be a multiple of R so the offset phase is block-invariant and
shapes stay static.
"""

from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp

from ..utils.blocks import Block

__all__ = ["fir_correlate", "FIR", "DecimatingFIR", "fir_init_tail",
           "RuntimeFIR", "pad_taps_front"]

# 1:1 FIR implementation: "fft" (overlap-save, the default), "direct"
# (lax.conv correlation), or "auto" (= fft).
FIR_MODE = os.environ.get("SDRPP_TPU_FIR", "auto")


def _use_direct() -> bool:
    return FIR_MODE == "direct"


def _next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def _taps_spectrum(taps: np.ndarray, fft_len: int) -> np.ndarray:
    """FFT of zero-padded reversed taps (host-side, float64 then complex64)."""
    rev = np.asarray(taps)[::-1]
    padded = np.zeros(fft_len, dtype=np.complex128)
    padded[: rev.shape[0]] = rev
    return np.fft.fft(padded).astype(np.complex64)


def fir_init_tail(ntaps: int, dtype=jnp.complex64, lead_shape=()) -> jax.Array:
    """Zeroed delay-line tail of ntaps-1 samples (reference fir.h:24-27)."""
    return jnp.zeros((*lead_shape, ntaps - 1), dtype=dtype)


def _real_conv1d(sig: jax.Array, taps_r: np.ndarray, n: int) -> jax.Array:
    """Correlation of [..., n+m-1] with m real taps -> [..., n] via
    lax.conv (XLA convs do NOT flip the kernel, i.e. they ARE
    correlations). HIGHEST precision: a GPU may otherwise run the f32
    conv in TF32, outside the FIR's parity bound."""
    m = taps_r.shape[0]
    lead = sig.shape[:-1]
    lhs = sig.reshape(-1, 1, sig.shape[-1]).astype(jnp.float32)
    rhs = jnp.asarray(np.asarray(taps_r, np.float32).reshape(1, 1, m))
    out = jax.lax.conv_general_dilated(lhs, rhs, (1,), "VALID",
                                       precision=jax.lax.Precision.HIGHEST)
    return out.reshape(*lead, n)


def _direct_correlate(buf: jax.Array, taps: np.ndarray, n: int,
                      complex_out: bool, out_dtype) -> jax.Array:
    """FFT-free 1:1 correlation: real convs composed for complex data/taps."""
    if np.iscomplexobj(taps):
        tr, ti = np.real(taps), np.imag(taps)
        br = buf.real if jnp.iscomplexobj(buf) else buf
        bi = buf.imag if jnp.iscomplexobj(buf) else jnp.zeros_like(buf)
        yr = _real_conv1d(br, tr, n) - _real_conv1d(bi, ti, n)
        yi = _real_conv1d(bi, tr, n) + _real_conv1d(br, ti, n)
        return jax.lax.complex(yr, yi)
    if jnp.iscomplexobj(buf):
        yr = _real_conv1d(buf.real, taps, n)
        yi = _real_conv1d(buf.imag, taps, n)
        return jax.lax.complex(yr, yi)
    return _real_conv1d(buf, taps, n).astype(out_dtype)


def fir_correlate(tail: jax.Array, x: jax.Array, taps: np.ndarray) -> tuple[jax.Array, jax.Array]:
    """Filter one block; returns (new_tail, y) with y.shape == x.shape.

    y[i] = sum_j taps[j] * buf[i + j] with buf = concat([tail, x]) — exactly
    the reference's sliding correlation (fir.h:67-76). Works over arbitrary
    leading batch/channel axes (filtering along the last axis).
    """
    taps = np.asarray(taps)
    m = taps.shape[0]
    n = x.shape[-1]
    if m == 1:
        # Degenerate single-tap case (e.g. NFM's dummy filter).
        scale = taps[0]
        return tail, x * scale

    buf = jnp.concatenate([tail, x], axis=-1)  # [..., n + m - 1]
    if _use_direct():
        y = _direct_correlate(buf, taps, n, complex_out=jnp.iscomplexobj(x),
                              out_dtype=x.dtype)
        new_tail = jax.lax.slice_in_dim(buf, n, n + m - 1, axis=-1)
        return new_tail, y
    fft_len = _next_pow2(n + 2 * (m - 1))
    spec = jnp.asarray(_taps_spectrum(taps, fft_len))

    complex_in = jnp.iscomplexobj(x)
    xf = jnp.fft.fft(buf.astype(jnp.complex64), n=fft_len, axis=-1)
    yf = xf * spec
    y_full = jnp.fft.ifft(yf, axis=-1)
    # Full linear convolution index (m-1) corresponds to correlation output 0.
    y = jax.lax.slice_in_dim(y_full, m - 1, m - 1 + n, axis=-1)
    if not complex_in and not np.iscomplexobj(taps):
        y = y.real.astype(x.dtype)
    else:
        y = y.astype(jnp.complex64)
    new_tail = jax.lax.slice_in_dim(buf, n, n + m - 1, axis=-1)
    return new_tail, y


class FIR(Block):
    """1:1 FIR filter block with carried tail (reference fir.h:6-100)."""

    def __init__(self, taps: np.ndarray, dtype=jnp.complex64, lead_shape=()):
        self.taps = np.asarray(taps)
        self.dtype = dtype
        self.lead_shape = tuple(lead_shape)

    def init_state(self):
        return fir_init_tail(self.taps.shape[0], self.dtype, self.lead_shape)

    def __call__(self, state, x):
        return fir_correlate(state, x, self.taps)


def pad_taps_front(taps: np.ndarray, max_taps: int) -> np.ndarray:
    """Zero-pad real taps at the FRONT to ``max_taps``.

    Front padding (not back) preserves the exact output alignment of the
    unpadded filter: with tail length M-1 and T[j] = t[j-(M-m)],
    y[i] = sum_j' t[j'] * stream[pos + i + j' - (m-1)] — identical to
    the m-tap correlation (reference fir.h:67-76), so a RuntimeFIR at
    bandwidth B is sample-for-sample the static FIR at bandwidth B."""
    taps = np.asarray(taps, np.float32)
    m = taps.shape[0]
    if m > max_taps:
        raise ValueError(f"{m} taps exceed the static budget {max_taps}")
    out = np.zeros(max_taps, np.float32)
    out[max_taps - m:] = taps
    return out


class RuntimeFIR(Block):
    """1:1 FIR whose (real) taps live in STATE, not in the graph.

    The reference hot-swaps taps in-place in microseconds preserving the
    delay line (fir.h:31-52 setTaps); baking taps as jit constants makes
    every bandwidth change an XLA recompile instead. Here the taps are a
    [max_taps] float32 state leaf (front-padded, see pad_taps_front), the
    taps spectrum is computed IN-GRAPH (one extra FFT per block — noise
    next to the two overlap-save FFTs), and ``set_bandwidth``-style
    reconfiguration becomes a host-side tap design + state write.

    ``max_taps`` is the static budget; ``taps_state(taps)`` builds the
    padded state leaf for host writes.
    """

    def __init__(self, max_taps: int, init_taps: np.ndarray,
                 dtype=jnp.complex64, lead_shape=()):
        self.max_taps = int(max_taps)
        self.init_taps = np.asarray(init_taps, np.float32)
        self.dtype = dtype
        self.lead_shape = tuple(lead_shape)

    def taps_state(self, taps: np.ndarray) -> jnp.ndarray:
        return jnp.asarray(pad_taps_front(taps, self.max_taps))

    def init_state(self):
        return {
            "tail": fir_init_tail(self.max_taps, self.dtype,
                                  self.lead_shape),
            "taps": self.taps_state(self.init_taps),
        }

    def __call__(self, state, x):
        taps = state["taps"]
        m = self.max_taps
        n = x.shape[-1]
        buf = jnp.concatenate([state["tail"], x], axis=-1)
        fft_len = _next_pow2(n + 2 * (m - 1))
        # reversed front-padded taps have trailing zeros — same layout
        # _taps_spectrum builds, but computed on device from state
        rev = taps[::-1]
        spec = jnp.fft.fft(rev.astype(jnp.complex64), n=fft_len)
        complex_in = jnp.iscomplexobj(x)
        xf = jnp.fft.fft(buf.astype(jnp.complex64), n=fft_len, axis=-1)
        y_full = jnp.fft.ifft(xf * spec, axis=-1)
        y = jax.lax.slice_in_dim(y_full, m - 1, m - 1 + n, axis=-1)
        y = y.astype(jnp.complex64) if complex_in else y.real.astype(x.dtype)
        new_tail = jax.lax.slice_in_dim(buf, n, n + m - 1, axis=-1)
        return {"tail": new_tail, "taps": taps}, y


def _real_conv1d_strided(sig: jax.Array, taps_r: np.ndarray, out_n: int,
                         stride: int) -> jax.Array:
    """Strided correlation of [..., n+m-1] with m real taps -> [..., out_n]:
    y[k] = sum_j taps[j] * sig[stride*k + j], one lax.conv with
    window_strides that reads the input ONCE (vs the tpp sliced passes of
    the unrolled polyphase form). HIGHEST precision, as _real_conv1d."""
    m = taps_r.shape[0]
    lead = sig.shape[:-1]
    lhs = sig.reshape(-1, 1, sig.shape[-1]).astype(jnp.float32)
    rhs = jnp.asarray(np.asarray(taps_r, np.float32).reshape(1, 1, m))
    out = jax.lax.conv_general_dilated(lhs, rhs, (stride,), "VALID",
                                       precision=jax.lax.Precision.HIGHEST)
    return out[..., :out_n].reshape(*lead, out_n)


def _decimating_direct(buf: jax.Array, taps: np.ndarray, out_n: int,
                       r: int, out_dtype) -> jax.Array:
    """Strided-conv evaluation of the decimating FIR (complex via real
    conv composition, same structure as _direct_correlate)."""
    if np.iscomplexobj(taps):
        tr, ti = np.real(taps), np.imag(taps)
        br = buf.real if jnp.iscomplexobj(buf) else buf
        bi = buf.imag if jnp.iscomplexobj(buf) else jnp.zeros_like(buf)
        yr = _real_conv1d_strided(br, tr, out_n, r) \
            - _real_conv1d_strided(bi, ti, out_n, r)
        yi = _real_conv1d_strided(bi, tr, out_n, r) \
            + _real_conv1d_strided(br, ti, out_n, r)
        return jax.lax.complex(yr, yi)
    if jnp.iscomplexobj(buf):
        yr = _real_conv1d_strided(buf.real, taps, out_n, r)
        yi = _real_conv1d_strided(buf.imag, taps, out_n, r)
        return jax.lax.complex(yr, yi)
    return _real_conv1d_strided(buf, taps, out_n, r).astype(out_dtype)


# Decimating-FIR implementation: "conv" (strided lax.conv), "unrolled"
# (sliced polyphase mac loop), or "auto" (= unrolled; which one the GPU
# prefers at the bench's shapes is not measured yet).
DECIM_MODE = os.environ.get("SDRPP_TPU_DECIM", "auto")


def _decim_use_conv() -> bool:
    return DECIM_MODE == "conv"


def decimating_fir_correlate(tail: jax.Array, x: jax.Array, taps: np.ndarray,
                             decimation: int) -> tuple[jax.Array, jax.Array]:
    """FIR + keep-every-R-th-output (reference decimating_fir.h:49-69).

    Requires x block length to be a multiple of ``decimation`` so the output
    length (n // R) and decimator phase are block-invariant. Computed as a
    polyphase dot-product batch: windows of the buffer at stride R times the
    taps — a dense [n/R, m] x [m] product, instead of filtering all n samples and discarding (R-1)/R of them.
    """
    taps = np.asarray(taps)
    m = taps.shape[0]
    n = x.shape[-1]
    r = int(decimation)
    assert n % r == 0, f"block length {n} must be a multiple of decimation {r}"
    out_n = n // r

    buf = jnp.concatenate([tail, x], axis=-1)  # [..., n + m - 1]
    if _decim_use_conv():
        y = _decimating_direct(buf, taps, out_n, r, x.dtype)
        new_tail = jax.lax.slice_in_dim(buf, n, n + m - 1, axis=-1)
        return new_tail, y
    # Polyphase decomposition: with j = p + r*t,
    #   y[k] = sum_p sum_t taps[p + r*t] * buf[r*(k+t) + p]
    # i.e. r short correlations over the r strided sub-streams of buf —
    # total work n*m/r multiply-adds (vs n*m for filter-then-discard).
    tpp = -(-m // r)  # taps per phase
    pad = r * (out_n + tpp) - (n + m - 1)
    bufp = jnp.pad(buf, [(0, 0)] * (buf.ndim - 1) + [(0, pad)])
    sub = bufp.reshape(*buf.shape[:-1], out_n + tpp, r)
    sub = jnp.swapaxes(sub, -1, -2)  # [..., r, out_n + tpp]; sub[p, t'] = buf[r t' + p]
    taps_pad = np.zeros(r * tpp, taps.dtype)
    taps_pad[:m] = taps
    tp = taps_pad.reshape(tpp, r).T  # tp[p, t] = taps[p + r*t]
    acc = None
    for t in range(tpp):
        term = jax.lax.slice_in_dim(sub, t, t + out_n, axis=-1) * tp[:, t][:, None]
        acc = term if acc is None else acc + term
    y = jnp.sum(acc, axis=-2)
    if not jnp.iscomplexobj(x) and not np.iscomplexobj(taps):
        y = y.astype(x.dtype)
    new_tail = jax.lax.slice_in_dim(buf, n, n + m - 1, axis=-1)
    return new_tail, y


class DecimatingFIR(Block):
    """FIR evaluated every R-th sample (reference decimating_fir.h:6-100)."""

    def __init__(self, taps: np.ndarray, decimation: int, dtype=jnp.complex64,
                 lead_shape=()):
        self.taps = np.asarray(taps)
        self.decimation = int(decimation)
        self.dtype = dtype
        self.lead_shape = tuple(lead_shape)

    def init_state(self):
        return fir_init_tail(self.taps.shape[0], self.dtype, self.lead_shape)

    def __call__(self, state, x):
        return decimating_fir_correlate(state, x, self.taps, self.decimation)
