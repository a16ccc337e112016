"""FM IF noise reduction: per-sample sliding-DFT max-bin filter.

Reference: core/src/dsp/noise_reduction/fm_if.h:45-77 — for EVERY sample, a
``bins``-point windowed FFT of the trailing window, keep only the
highest-magnitude bin, inverse FFT, take the center sample. The reference
brute-forces one forward+inverse FFTW pair per sample.

Structure (SURVEY §2.7): the
sliding windowed ``bins``-point DFT IS a 2-in/2*bins-out real convolution —
spec[t, k] = sum_j buf[t+j] * window[j] * e^{-2πi jk/bins} — so the whole
block runs as ONE ``lax.conv_general_dilated`` whose kernel packs the
windowed DFT matrix (real/imag planes as channels); no [n, bins] gather,
no batched tiny FFTs.

Bin selection stays vectorized: argmax over the bin axis, then a one-hot
masked sum instead of ``take_along_axis`` (no gather on the hot path).

Math shortcut for the inverse: with a single nonzero bin k, the
unnormalized FFTW backward transform at index N/2 is X_k * e^{i*pi*k}
= X_k * (-1)^k — no second FFT needed.

Window: nuttall(i, bins-1) (note the N-1 denominator, fm_if.h:112).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..utils.blocks import Block
from .windows import nuttall

__all__ = ["FMIFNoiseReduction"]


class FMIFNoiseReduction(Block):
    def __init__(self, bins: int = 32, lead_shape=()):
        b = int(bins)
        self.bins = b
        self.window = nuttall(np.arange(b), float(b - 1)).astype(np.float32)
        self.lead_shape = tuple(lead_shape)
        # Windowed DFT matrix M[j, k] = w[j] * e^{-2πi jk / b}, packed as a
        # real conv kernel [out=2b, in=2, width=b]:
        #   spec_r[t,k] = Σ_j br[t+j]*Mr[j,k] - bi[t+j]*Mi[j,k]
        #   spec_i[t,k] = Σ_j br[t+j]*Mi[j,k] + bi[t+j]*Mr[j,k]
        j = np.arange(b)
        M = self.window[:, None] * np.exp(-2j * np.pi * np.outer(j, j) / b)
        kern = np.zeros((2 * b, 2, b), np.float32)
        kern[:b, 0, :] = M.real.T
        kern[:b, 1, :] = -M.imag.T
        kern[b:, 0, :] = M.imag.T
        kern[b:, 1, :] = M.real.T
        self._kernel = kern

    def init_state(self):
        return jnp.zeros((*self.lead_shape, self.bins - 1), jnp.complex64)

    def __call__(self, state, x):
        n = x.shape[-1]
        b = self.bins
        buf = jnp.concatenate([state, x], axis=-1)  # [..., n + b - 1]
        lead = buf.shape[:-1]
        inp = jnp.stack([buf.real, buf.imag], axis=-2)  # [..., 2, n+b-1]
        inp = inp.reshape(-1, 2, n + b - 1)
        out = jax.lax.conv_general_dilated(
            inp, jnp.asarray(self._kernel), (1,), "VALID",
            dimension_numbers=("NCH", "OIH", "NCH"),
            precision=jax.lax.Precision.HIGHEST,  # no TF32 on a GPU
            preferred_element_type=jnp.float32)  # [B, 2b, n]
        sr, si = out[:, :b, :], out[:, b:, :]
        mag2 = sr * sr + si * si
        k = jnp.argmax(mag2, axis=1)  # [B, n] (first max on ties, like the
        # reference's > comparison loop)
        onehot = jnp.arange(b, dtype=jnp.int32)[None, :, None] == k[:, None, :]
        xr = jnp.sum(jnp.where(onehot, sr, 0.0), axis=1)
        xi = jnp.sum(jnp.where(onehot, si, 0.0), axis=1)
        sign = jnp.where(k % 2 == 0, np.float32(1.0), np.float32(-1.0))
        y = jax.lax.complex(xr * sign, xi * sign).reshape(*lead, n)
        new_tail = buf[..., n:]
        return new_tail, y
