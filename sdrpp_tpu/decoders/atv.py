"""Analog TV (ATV) decoding blocks: line sync + chroma PLL.

Reference: decoder_modules/atv_decoder/src/{linesync.h, chroma_pll.h}.

LineSync locks a phase-control loop to the horizontal sync tips: 720
samples per line are emitted through the fractional polyphase interpolator;
at each line boundary the timing error is the difference between the
average levels of the two halves of the sync region (linesync.h:109-135 —
left = samples [703..719]+[0..26], right = [27..70], only when both sit
below the sync level).

Formulation: within a line the loop error is zero, so sample positions
advance UNIFORMLY by ``freq`` — a whole line is one vectorized 720-point
fractional-delay gather; only the per-line error update is sequential
(a scan over lines, not samples).

ChromaPLL (chroma_pll.h:22-52) locks to the color burst window of each
line and free-runs outside it; the free-run sections are vectorized mixes,
the burst is a short sequential scan.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.clock_recovery import _interp_bank
from ..ops.scans import FL_PI, _critically_damped, _normalize_phase
from ..utils.blocks import Block

__all__ = ["LineSync", "ChromaPLL", "FrameAssembler", "ATVDecoder",
           "chroma_taps", "LINE_LEN", "FRAME_LINES", "SAMPLE_RATE",
           "CHROMA_SUBCARRIER", "A_PHASE", "B_PHASE"]

LINE_LEN = 720
FRAME_LINES = 625                       # PAL (main.cpp:159-166)
SAMPLE_RATE = 625.0 * 720.0 * 25.0      # main.cpp:32 SAMPLE_RATE
CHROMA_SUBCARRIER = 4433618.75          # PAL chroma, main.cpp:48

# PAL colour-burst reference phases alternate per line (chroma_pll.h:9-10).
A_PHASE = (135.0 / 180.0) * float(FL_PI)
B_PHASE = (-135.0 / 180.0) * float(FL_PI)


def chroma_taps() -> np.ndarray:
    """231-tap complex chroma band-pass FIR (chrominance_filter.h, pure
    coefficient data extracted by tools/extract_chroma_taps.py)."""
    import os
    path = os.path.join(os.path.dirname(__file__), "atv_chroma_taps.npz")
    return np.load(path)["taps"]


CHROMA_FIR_DELAY = (231 - 1) // 2
# TODO note kept from chroma_pll.h:5: "should be 60" but 63 is what ships.
BURST_START = 63 + CHROMA_FIR_DELAY
BURST_END = BURST_START + 28


class LineSync(Block):
    """Horizontal line synchronizer -> (lines[max_lines, 720], valid)."""

    def __init__(self, omega: float, omega_gain: float = 1e-6,
                 mu_gain: float = 0.01, omega_rel_limit: float = 0.01,
                 sync_level: float = -0.03, sync_bias: float = 0.0,
                 interp_phase_count: int = 128, interp_tap_count: int = 8):
        self.omega = float(omega)  # samples per output sample
        self.mu_gain = np.float32(mu_gain)
        self.omega_gain = np.float32(omega_gain)
        self.min_freq = np.float32(omega * (1.0 - omega_rel_limit))
        self.max_freq = np.float32(omega * (1.0 + omega_rel_limit))
        self.sync_level = np.float32(sync_level)
        self.sync_bias = np.float32(sync_bias)
        self.phase_count = int(interp_phase_count)
        self.tap_count = int(interp_tap_count)
        self.bank = _interp_bank(self.phase_count, self.tap_count)

    def max_lines(self, n: int) -> int:
        return int(n / (LINE_LEN * float(self.min_freq))) + 2

    def init_state(self):
        return {
            "tail": jnp.zeros(self.tap_count - 1, jnp.float32),
            "pos": jnp.zeros((), jnp.float32),   # fractional position in block
            "freq": jnp.full((), self.omega, jnp.float32),
            "locked": jnp.zeros((), jnp.bool_),
        }

    def __call__(self, state, x):
        n = x.shape[-1]
        max_lines = self.max_lines(n)
        buf = jnp.concatenate([state["tail"], x])
        bank = jnp.asarray(self.bank)
        ks = jnp.arange(LINE_LEN, dtype=jnp.float32)
        taps_off = jnp.arange(self.tap_count, dtype=jnp.int32)

        def step(carry, _):
            pos, freq, locked = carry
            active = pos + LINE_LEN * freq < n

            # Vectorized fractional interpolation of one 720-sample line.
            p = pos + ks * freq                       # [720]
            ip = jnp.floor(p).astype(jnp.int32)
            mu = p - jnp.floor(p)
            ph = jnp.clip((mu * self.phase_count).astype(jnp.int32), 0,
                          self.phase_count - 1)
            idx = jnp.clip(ip[:, None], 0, n - 1) + taps_off[None, :]
            windows = buf[idx]                        # [720, taps]
            line = jnp.sum(windows * bank[ph], axis=-1)

            # Sync error from the wrap-around sync region (linesync.h:113-135)
            left = (jnp.sum(line[LINE_LEN - 17:]) + jnp.sum(line[:27])) / 44.0
            right = jnp.sum(line[27: 54 + 17]) / 44.0
            sync_ok = (left < self.sync_level) & (right < self.sync_level)
            error = jnp.where(sync_ok, left + self.sync_bias - right, 0.0)
            new_locked = sync_ok

            new_freq = jnp.clip(freq + self.omega_gain * error,
                                self.min_freq, self.max_freq)
            new_pos = pos + (LINE_LEN - 1) * freq + new_freq + self.mu_gain * error

            sel = lambda a, b: jnp.where(active, a, b)
            return (sel(new_pos, pos), sel(new_freq, freq),
                    sel(new_locked, locked)), \
                (jnp.where(active, line, 0.0), active)

        carry0 = (state["pos"], state["freq"], state["locked"])
        (pos_f, freq_f, locked_f), (lines, valid) = jax.lax.scan(
            step, carry0, None, length=max_lines)
        new_state = {
            "tail": buf[n:],
            "pos": pos_f - n,
            "freq": freq_f,
            "locked": locked_f,
        }
        return new_state, (lines, valid)


class ChromaPLL(Block):
    """Color-burst PLL over framed lines.

    Input: complex chroma lines [L, line_len]; the PLL advances freely
    outside the burst window [burst_start, burst_end) and phase-locks to
    the burst with error normalize(angle(v) - ref_phase)
    (chroma_pll.h:22-52). Output: lines mixed down by the tracked phase.
    """

    def __init__(self, bandwidth: float, line_len: int, burst_start: int,
                 burst_end: int, ref_phase: float = 0.0,
                 init_freq: float = 0.0, min_freq: float = -float(FL_PI),
                 max_freq: float = float(FL_PI)):
        self.alpha, self.beta = _critically_damped(bandwidth)
        self.line_len = int(line_len)
        self.burst_start = int(burst_start)
        self.burst_end = int(burst_end)
        self.ref_phase = np.float32(ref_phase)
        self.init_freq = np.float32(init_freq)
        self.min_freq = np.float32(min_freq)
        self.max_freq = np.float32(max_freq)

    def init_state(self):
        return {"phase": jnp.zeros((), jnp.float32),
                "freq": jnp.full((), self.init_freq, jnp.float32)}

    def _mix(self, phase0, freq, seg):
        k = jnp.arange(seg.shape[-1], dtype=jnp.float32)
        ph = phase0 + k * freq
        out = seg * jax.lax.complex(jnp.cos(-ph), jnp.sin(-ph))
        return ph[-1] + freq if seg.shape[-1] else phase0, out

    def __call__(self, state, lines, ref_phases=None):
        bs, be = self.burst_start, self.burst_end
        if ref_phases is None:
            ref_phases = jnp.full(lines.shape[0], self.ref_phase, jnp.float32)
        else:
            ref_phases = jnp.asarray(ref_phases, jnp.float32)

        def line_step(carry, xs):
            line, ref_phase = xs
            phase, freq = carry
            # Pre-burst free run
            phase1, pre = self._mix(phase, freq, line[:bs])

            # Burst: sequential lock
            def burst_step(c, v):
                ph, fr = c
                out = v * jax.lax.complex(jnp.cos(-ph), jnp.sin(-ph))
                err = _normalize_phase(jnp.arctan2(out.imag, out.real)
                                       - ref_phase)
                fr = jnp.clip(fr + self.beta * err, self.min_freq, self.max_freq)
                ph = ph + fr + self.alpha * err
                ph = _normalize_phase(jnp.mod(ph + FL_PI, 2 * FL_PI) - FL_PI)
                return (ph, fr), out

            (phase2, freq2), burst = jax.lax.scan(burst_step, (phase1, freq),
                                                  line[bs:be])
            # Post-burst free run
            phase3, post = self._mix(phase2, freq2, line[be:])
            phase3 = _normalize_phase(jnp.mod(phase3 + FL_PI, 2 * FL_PI) - FL_PI)
            return (phase3, freq2), jnp.concatenate([pre, burst, post])

        (ph_f, fr_f), out = jax.lax.scan(line_step,
                                         (state["phase"], state["freq"]),
                                         (lines, ref_phases))
        return {"phase": ph_f, "freq": fr_f}, out


class FrameAssembler:
    """Vertical scan + vsync detection + pixel rendering (host side).

    Mirrors the reference handler's per-line logic (main.cpp:129-196):
    each 720-sample line is rendered as ``clamp((v - min_level) * 255 /
    span_level)`` into a 625-line frame; the vertical position advances
    per line and flips (field toggle + frame emit) on rollover or when
    the 10-bit vsync history over the two half-line sync means matches
    0b0000011111.  ``plan()`` runs the luma-only part first so the
    chroma PLL can be batched with the correct per-line PAL phase flags
    (aphase = (ypos odd) ^ even_frame, main.cpp:139).
    """

    def __init__(self, min_level: float = 0.0, span_level: float = 1.0,
                 sync_level: float = -0.06):
        self.min_level = float(min_level)
        self.span_level = float(span_level)
        self.sync_level = float(sync_level)
        self.ypos = 0
        self.even_frame = False
        self.sync_history = 0
        self._frame = np.zeros((FRAME_LINES, LINE_LEN, 2), np.uint8)
        self.frames: list[np.ndarray] = []

    def plan(self, luma_lines: np.ndarray):
        """Advance the vertical-scan state over luma lines.

        Returns (ypos[L], aphase[L], flip_after[L]): the line positions
        and PAL burst-phase flags to use for this batch, and where frame
        flips happen (rollover or vsync trigger).
        """
        L = len(luma_lines)
        ypos = np.zeros(L, np.int32)
        aphase = np.zeros(L, bool)
        flip_after = np.zeros(L, bool)
        for i, line in enumerate(luma_lines):
            ypos[i] = self.ypos
            aphase[i] = ((self.ypos % 2) == 1) ^ self.even_frame
            self.ypos += 1
            rollover = self.ypos >= FRAME_LINES
            if rollover:
                self.even_frame = not self.even_frame
                self.ypos = 0
                flip_after[i] = True
            # vsync levels: means of the two half-line sync regions
            # (main.cpp:168-177; the reference divides by 305)
            sync0 = float(np.sum(line[:306])) / 305.0
            sync1 = float(np.sum(line[360:666])) / 305.0
            self.sync_history >>= 2
            self.sync_history |= ((int(sync1 < self.sync_level) << 9)
                                  | (int(sync0 < self.sync_level) << 8))
            if not rollover and self.sync_history == 0b0000011111:
                self.even_frame = not self.even_frame
                self.ypos = 0
                flip_after[i] = True
        return ypos, aphase, flip_after

    def commit(self, mixed_lines: np.ndarray, ypos: np.ndarray,
               flip_after: np.ndarray):
        """Render PLL-mixed lines at the planned positions; emit a frame
        copy at every flip (the reference's img.swap())."""
        scale = 255.0 / self.span_level
        re = np.clip((mixed_lines.real - self.min_level) * scale, 0, 255)
        im = np.clip((mixed_lines.imag - self.min_level) * scale, 0, 255)
        for i in range(len(mixed_lines)):
            self._frame[ypos[i], :, 0] = re[i].astype(np.uint8)
            self._frame[ypos[i], :, 1] = im[i].astype(np.uint8)
            if flip_after[i]:
                self.frames.append(self._frame.copy())
        return self.frames

    def take_frames(self) -> list[np.ndarray]:
        out, self.frames = self.frames, []
        return out


class ATVDecoder:
    """Full ATV receive pipeline (decoder_modules/atv_decoder/src/main.cpp):

    quadrature FM (dev = fs/2) -> LineSync(omega=1, 1e-6, mu 1.0, ±5%)
    -> [real->complex -> 231-tap chroma band-pass -> ChromaPLL @ 4.4336
    MHz ±10% with per-line PAL phase] -> FrameAssembler.

    ``process(iq)`` consumes complex64 baseband at 11.25 Msps and returns
    any completed [625, 720, 2] uint8 frames.
    """

    def __init__(self, samplerate: float = SAMPLE_RATE,
                 min_level: float = 0.0, span_level: float = 1.0):
        from ..ops.fir import fir_correlate
        from ..ops.fm import Quadrature

        self.samplerate = float(samplerate)
        self.quad = Quadrature(self.samplerate / 2.0, self.samplerate)
        self.sync = LineSync(1.0, omega_gain=1e-6, mu_gain=1.0,
                             omega_rel_limit=0.05)
        taps = chroma_taps()
        w0 = 2.0 * np.pi * CHROMA_SUBCARRIER / self.samplerate
        self.pll = ChromaPLL(0.01, LINE_LEN, BURST_START, BURST_END,
                             init_freq=w0, min_freq=w0 * 0.9,
                             max_freq=w0 * 1.1)
        self.assembler = FrameAssembler(min_level, span_level)
        self._fir_correlate = fir_correlate
        self._taps = jnp.asarray(taps, jnp.complex64)
        self._fir_state = jnp.zeros(len(taps) - 1, jnp.complex64)
        self._front = jax.jit(self._front_fn)
        self._chroma = jax.jit(self._chroma_fn)
        self.state = {"quad": self.quad.init_state(),
                      "sync": self.sync.init_state(),
                      "pll": self.pll.init_state()}

    def _front_fn(self, qs, ss, x):
        qs, y = self.quad(qs, x)
        ss, (lines, valid) = self.sync(ss, y)
        return qs, ss, lines, valid

    def _chroma_fn(self, fs, ps, lines, ref_phases):
        flat = lines.reshape(-1).astype(jnp.complex64)
        fs, chroma = self._fir_correlate(fs, flat, self._taps)
        ps, mixed = self.pll(ps, chroma.reshape(lines.shape), ref_phases)
        return fs, ps, mixed

    def process(self, iq: np.ndarray) -> list[np.ndarray]:
        self.state["quad"], self.state["sync"], lines, valid = \
            self._front(self.state["quad"], self.state["sync"],
                        jnp.asarray(iq))
        luma = np.asarray(lines)[np.asarray(valid)]
        if not len(luma):
            return []
        ypos, aphase, flip_after = self.assembler.plan(luma)
        ref_phases = np.where(aphase, A_PHASE, B_PHASE).astype(np.float32)
        self._fir_state, self.state["pll"], mixed = self._chroma(
            self._fir_state, self.state["pll"], jnp.asarray(luma),
            jnp.asarray(ref_phases))
        self.assembler.commit(np.asarray(mixed), ypos, flip_after)
        return self.assembler.take_frames()
