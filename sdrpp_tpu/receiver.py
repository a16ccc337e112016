"""Receiver: the standing graph — source -> front end -> VFOs -> sinks.

The equivalent of MainWindow's wiring + VFOManager
(core/src/gui/main_window.cpp:31-226, core/src/signal_path/vfo_manager.h):
a host loop pulls IQ blocks from the selected source, runs ONE jitted step
(front end + every radio channel), and routes per-channel audio to sinks
and FFT lines to the waterfall export. Adding/removing/retuning a VFO
rebuilds the jitted step (re-trace, cached thereafter) — the functional
analog of dsp::chain's live rewiring under tempStop/tempStart.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .io.sinks import SinkManager
from .io.sources import SourceManager
from .models.radio import RadioChannel
from .ops.windows import Window
from .signal_path import IQFrontEnd

__all__ = ["Receiver"]


class Receiver:
    def __init__(self, samplerate: float, block_size: int = 262144,
                 decim_ratio: int = 1, dc_blocking: bool = True,
                 invert_iq: bool = False, fft_size: int = 65536,
                 fft_rate: float = 20.0, fft_window: Window = Window.NUTTALL,
                 audio_rate: float = 48000.0):
        self.samplerate = float(samplerate)
        self.block_size = int(block_size)
        self.audio_rate = float(audio_rate)
        self.frontend = IQFrontEnd(samplerate, decim_ratio, dc_blocking, invert_iq,
                                   fft_size, fft_rate, fft_window,
                                   block_size=block_size)
        self.sources = SourceManager()
        self.sinks = SinkManager()
        self._channels: dict[str, RadioChannel] = {}
        self._state = None
        self._step = None
        self.fft_lines: list[np.ndarray] = []
        self.max_fft_lines = 2048  # raw-FFT ring bound (waterfall.cpp:883)

    # ---- VFO management (vfo_manager.h:6-67 equivalent) ----

    def create_vfo(self, name: str, mode: str, offset: float,
                   bandwidth: float | None = None, **kwargs):
        chan = RadioChannel(mode, self.frontend.effective_samplerate,
                            offset=offset, bandwidth=bandwidth,
                            audio_rate=self.audio_rate, **kwargs)
        eff_block = self.block_size // self.frontend.decim_ratio
        if eff_block % chan.block_multiple:
            raise ValueError(
                f"block size {eff_block} not a multiple of channel requirement "
                f"{chan.block_multiple} for mode {mode}")
        self._channels[name] = chan
        self._channel_cfg = getattr(self, "_channel_cfg", {})
        self._channel_cfg[name] = dict(mode=mode, bandwidth=bandwidth, **kwargs)
        self.sinks.register_stream(name, self.audio_rate)
        self._rebuild()
        return chan

    def delete_vfo(self, name: str):
        self._channels.pop(name, None)
        self.sinks.unregister_stream(name)
        self._rebuild()

    def set_vfo_offset(self, name: str, offset: float):
        # Rebuild the channel with the new offset, preserving its full
        # configuration (mode/bandwidth/squelch/...).
        cfg = getattr(self, "_channel_cfg", {}).get(name, {"mode":
                                                           self._channels[name].mode})
        self._channels[name] = RadioChannel(
            cfg["mode"], self.frontend.effective_samplerate, offset=offset,
            bandwidth=cfg.get("bandwidth"), audio_rate=self.audio_rate,
            **{k: v for k, v in cfg.items() if k not in ("mode", "bandwidth")})
        self._rebuild()

    # ---- graph building ----

    def _rebuild(self):
        frontend = self.frontend
        channels = dict(self._channels)

        def step(state, x):
            fe_state, (iq, fft) = frontend(state["frontend"], x)
            new_state = {"frontend": fe_state, "channels": {}}
            audio = {}
            for name, chan in channels.items():
                cs, out = chan(state["channels"][name], iq)
                new_state["channels"][name] = cs
                audio[name] = out
            return new_state, (audio, fft)

        self._step = jax.jit(step)
        old = self._state
        self._state = {
            "frontend": (old["frontend"] if old else frontend.init_state()),
            "channels": {
                name: (old["channels"][name]
                       if old and name in old.get("channels", {})
                       else chan.init_state())
                for name, chan in channels.items()
            },
        }

    # ---- run loop ----

    def process_block(self, iq: np.ndarray):
        """Run one block through the jitted graph; route outputs."""
        if self._step is None:
            self._rebuild()
        assert len(iq) == self.block_size
        self._state, (audio, fft) = self._step(self._state, jnp.asarray(iq))
        for name, out in audio.items():
            arr = np.asarray(out[0] if isinstance(out, tuple) else out)
            self.sinks.write(name, arr)
        fft_np = np.asarray(fft)
        self.fft_lines.extend(list(fft_np))
        # bound like the reference's raw-FFT ring (waterfallHeight lines,
        # waterfall.cpp:883-895) — long sessions must not grow memory
        if len(self.fft_lines) > self.max_fft_lines:
            del self.fft_lines[: len(self.fft_lines) - self.max_fft_lines]
        return audio, fft_np

    def run(self, num_blocks: int):
        src = self.sources.source
        assert src is not None, "no source selected"
        assert abs(src.samplerate - self.samplerate) < 1e-6, \
            f"source rate {src.samplerate} != receiver rate {self.samplerate}"
        for _ in range(num_blocks):
            self.process_block(src.read(self.block_size))
