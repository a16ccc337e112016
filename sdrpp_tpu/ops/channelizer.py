"""Shared-FFT channelizer bank: N DDCs from ONE wideband FFT.

The SURVEY §2.5 plan for the VFO bank: "consider FFT-based channelizer
(per-channel overlap-save sharing one forward FFT of the wideband block)".
This implements it, as a drop-in alternative to the time-domain
mix -> FIR-cascade VFOBank (parallel/vfo_bank.py):

- ONE forward FFT of the wideband block (overlap-save buffer, shared
  tail of m-1 samples across all channels);
- per channel: the NCO mix by offset f_c factors into an integer-bin
  shift b_c = round(alpha_c F / 2pi) (a GATHER of the spectrum window —
  rolling the spectrum by b bins is multiplying time by e^{2pi i b t/F})
  plus a sub-bin residual delta_c baked into that channel's filter taps
  on the host (h~[k] = h[k] e^{-j delta k}), so the decomposition is
  EXACT, not an approximation;
- filtering = multiply by the tap spectrum; decimation by R = alias-fold
  of the product down to M = F/R bins + one small inverse FFT
  (y[R j] = (1/R) IFFT_M of the fold — the standard decimation-in-
  frequency identity), with the m-1 output alignment folded into the tap
  spectrum as a time-shift ramp;
- the per-block NCO phase continuity is a carried [C] phase, exactly the
  xlator carry.

With pruning (the production path), each channel touches only the 2M
spectrum bins around its offset where the filter response is above the
stopband floor, so per-channel work drops from O(F) to O(F/R): the whole
bank costs one FFT(F) + C * O(F/R) instead of C * O(n log n) — the
channel count rides almost free. Exactness vs the time-domain chain
(same taps): full mode ~1e-13; pruned ~1e-6 (tap stopband leakage
outside the window; tighten with more taps/attenuation).

Output parity: equals FrequencyXlatorBank-mix -> fir_correlate(taps) ->
decimate-by-R (phase m-1 alignment) streaming across blocks; pinned by
tests against that oracle.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..utils.blocks import Block
from . import taps as taps_mod
from .mix import TWO_PI, hz_to_rads

__all__ = ["FFTChannelizerBank"]


class FFTChannelizerBank(Block):
    """Bank of DDCs sharing one wideband FFT; VFOBank-compatible interface.

    offsets_hz: per-channel offsets (mix by -offset like RxVFO,
    rx_vfo.h:30). out = in_samplerate / R with integer R. ``taps``
    defaults to a Nuttall lowPass at 0.45*out_rate with 0.1*out_rate
    transition (taps.low_pass — the reference design formula).
    """

    def __init__(self, offsets_hz, in_samplerate: float, out_samplerate: float,
                 bandwidth: float | None = None, taps: np.ndarray | None = None,
                 prune: bool = True):
        offsets_hz = np.asarray(offsets_hz, np.float64)
        self.channels = len(offsets_hz)
        self.fs_in = float(in_samplerate)
        self.fs_out = float(out_samplerate)
        ratio = in_samplerate / out_samplerate
        self.R = int(round(ratio))
        if abs(ratio - self.R) > 1e-9 or self.R < 1:
            raise ValueError(
                f"FFTChannelizerBank needs an integer decimation ratio, got "
                f"{in_samplerate}/{out_samplerate} = {ratio}")
        # applied rotation per sample: mix by -offset (rx_vfo.h:30)
        self.alphas = np.array([hz_to_rads(-o, in_samplerate)
                                for o in offsets_hz], np.float64)
        if taps is None:
            taps = taps_mod.low_pass(0.45 * out_samplerate,
                                     0.1 * out_samplerate, in_samplerate)
        self.taps = np.asarray(taps, np.float64)
        self.m = len(self.taps)
        self.prune = bool(prune)
        self.block_multiple = self.R
        # optional channel LPF at the output rate (VFOBank.filter parity)
        self.filter = None
        if bandwidth is not None and bandwidth != out_samplerate:
            from .fir import FIR
            fw = bandwidth / 2.0
            self.filter = FIR(taps_mod.low_pass(fw, fw * 0.1, out_samplerate),
                              dtype=jnp.complex64,
                              lead_shape=(self.channels,))
        self._plans: dict[int, dict] = {}

    def out_count(self, n: int) -> int:
        return n // self.R

    def init_state(self):
        # shared overlap-save tail + per-channel carried NCO phase
        # phi_c(B) = alpha_c * (B n - (m-1)); start at -alpha (m-1)
        phase0 = np.mod(-self.alphas * (self.m - 1), TWO_PI).astype(np.float32)
        state = {"tail": jnp.zeros(self.m - 1, jnp.complex64),
                 "phase": jnp.asarray(phase0)}
        if self.filter is not None:
            state["filter"] = self.filter.init_state()
        return state

    def _plan(self, n: int) -> dict:
        """Host-side per-block-length constants."""
        if n in self._plans:
            return self._plans[n]
        if n % self.R:
            raise ValueError(f"block length {n} must be a multiple of the "
                             f"decimation ratio {self.R}")
        R, m = self.R, self.m
        T = n + m - 1
        M = 1
        while M * R < T:
            M *= 2
        F = M * R
        b = np.round(self.alphas * F / TWO_PI).astype(np.int64)
        delta = self.alphas - TWO_PI * b / F
        kk = np.arange(m, dtype=np.float64)
        # residual baked into the taps (exact: e^{j d t} pulled out of the
        # conv leaves h~[k] = h[k] e^{-j d k}); the (m-1) alignment is a
        # time-shift ramp on the tap spectrum
        h_tilde = self.taps[None, :] * np.exp(-1j * delta[:, None] * kk)
        kb = np.arange(F, dtype=np.float64)
        shift = np.exp(2j * np.pi * kb * (m - 1) / F)
        H = np.fft.fft(h_tilde, F, axis=-1) * shift  # [C, F]
        j = np.arange(n // R, dtype=np.float64)
        # corr[c, j] = e^{j d_c ((m-1) + R j)} (the block-B part is the
        # carried phase)
        corr = np.exp(1j * delta[:, None] * ((m - 1) + R * j[None, :]))
        plan = {"F": F, "M": M, "b": b,
                "step": np.mod(self.alphas * n, TWO_PI).astype(np.float32),
                "corr": corr.astype(np.complex64)}
        if self.prune:
            w = np.arange(-M, M)
            # Per channel the pruned window (w - b_c) mod F is a CONTIGUOUS
            # circular slice with a host-known start: static slices lower to
            # plain copies, where an equivalent general gather would not.
            plan["starts"] = ((-M - b) % F).astype(np.int64)
            plan["Hw"] = H[np.arange(self.channels)[:, None],
                           w[None, :] % F].astype(np.complex64)
        else:
            plan["H"] = H.astype(np.complex64)
        self._plans[n] = plan
        return plan

    def __call__(self, state, x):
        n = x.shape[-1]
        p = self._plan(n)
        R, m, F, M = self.R, self.m, p["F"], p["M"]
        buf = jnp.concatenate([state["tail"], x])
        X = jnp.fft.fft(buf, F)

        # Under shard_map (parallel/spmd.py) this device holds a [C/d]
        # channel shard: per-channel tables slice to the local row block
        # and the pruned bin starts become traced (dynamic_slice instead
        # of static slices — still per-channel copies, not a gather).
        from ..parallel.spmd import current_channel_axis, local_rows
        ax = current_channel_axis()
        c_local = state["phase"].shape[0]
        sharded = ax is not None and c_local != self.channels
        if sharded:
            def take(t):
                return local_rows(t, c_local, ax)
        else:
            def take(t):
                return jnp.asarray(t)

        if self.prune:
            Xp = jnp.concatenate([X, X[: 2 * M]])
            if sharded:
                starts = take(p["starts"].astype(np.int32))
                Sw = jnp.stack([
                    jax.lax.dynamic_slice_in_dim(Xp, starts[ci], 2 * M)
                    for ci in range(c_local)
                ]) * take(p["Hw"])
            else:
                # static-start circular slices (one per channel, unrolled
                # at trace time — plain copies on device)
                Sw = jnp.stack([
                    jax.lax.slice_in_dim(Xp, int(s), int(s) + 2 * M)
                    for s in p["starts"]
                ]) * jnp.asarray(p["Hw"])
            fold = Sw[:, M:] + Sw[:, :M]
        else:
            # roll(X, b_c) per channel == gather at (k - b) mod F
            if sharded:
                b_loc = take(p["b"].astype(np.int32))
                idx = jnp.mod(jnp.arange(F, dtype=jnp.int32)[None, :]
                              - b_loc[:, None], F)
                S = X[idx] * take(p["H"])
            else:
                idx = (np.arange(F)[None, :] - p["b"][:, None]) % F
                S = X[jnp.asarray(idx.astype(np.int32))] * jnp.asarray(p["H"])
            fold = jnp.sum(S.reshape(c_local, R, M), axis=1)
        z = jnp.fft.ifft(fold, axis=-1)[:, : n // R] * np.float32(M / F)
        ph = state["phase"]
        carry = jax.lax.complex(jnp.cos(ph), jnp.sin(ph))
        y = z * carry[:, None] * take(p["corr"])
        new_state = {
            "tail": buf[n:],
            "phase": jnp.mod(ph + take(p["step"]), np.float32(TWO_PI)),
        }
        y = y.astype(jnp.complex64)
        if self.filter is not None:
            fs, y = self.filter(state["filter"], y)
            new_state["filter"] = fs
        return new_state, y
