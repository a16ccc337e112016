"""Tracing/profiling: jax.profiler traces + per-block throughput counters.

The reference's observability is minimal — wall-clock logs around demod
switches (decoder_modules/radio/src/radio_module.h:322-336), the
SpeedTester micro-bench, and thread lifecycle hooks
(core/src/utils/threading.h:39-41). SURVEY §5 upgrades this for this
build: XLA-level traces via jax.profiler (viewable in XProf/TensorBoard)
plus first-class per-block samples/s counters on every stream loop.

- ``trace(logdir)``: context manager dumping a device trace.
- ``annotate(name)``: named region that shows up inside the trace.
- ``StreamMonitor``: counts blocks/samples, EMA block latency, aggregate
  and instantaneous samples/s; cheap enough to leave on in production
  serving loops (host-side arithmetic only, no device sync — wait on
  the outputs with block_until_ready if you need execute time, not
  dispatch time).
"""

from __future__ import annotations

import contextlib
import time

__all__ = ["trace", "annotate", "StreamMonitor"]


@contextlib.contextmanager
def trace(logdir: str, create_perfetto_link: bool = False):
    """Profile everything inside the block into ``logdir`` (XPlane format)."""
    import jax

    jax.profiler.start_trace(logdir,
                             create_perfetto_link=create_perfetto_link)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named trace region: ``with annotate("vfo_bank"): step(...)``."""
    import jax

    return jax.profiler.TraceAnnotation(name)


class StreamMonitor:
    """Per-block throughput/latency counters for a streaming loop.

    >>> mon = StreamMonitor(samplerate=2.4e6)
    >>> with mon.block(n_samples=131072):
    ...     state, y = step(state, x)
    >>> mon.samples_per_sec
    """

    def __init__(self, samplerate: float | None = None, ema_alpha: float = 0.1):
        self.samplerate = samplerate
        self.ema_alpha = ema_alpha
        self.reset()

    def reset(self):
        self.blocks = 0
        self.samples = 0
        self.ema_block_s = None
        self._t_start = time.perf_counter()
        self._t_last = None

    @contextlib.contextmanager
    def block(self, n_samples: int):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.blocks += 1
        self.samples += int(n_samples)
        self.ema_block_s = (dt if self.ema_block_s is None else
                            (1 - self.ema_alpha) * self.ema_block_s
                            + self.ema_alpha * dt)
        self._t_last = time.perf_counter()

    @property
    def elapsed(self) -> float:
        end = self._t_last if self._t_last is not None else time.perf_counter()
        return max(end - self._t_start, 1e-12)

    @property
    def samples_per_sec(self) -> float:
        """Aggregate input samples/s over the monitored span."""
        return self.samples / self.elapsed

    @property
    def realtime_factor(self) -> float | None:
        """samples_per_sec / samplerate; >1 means faster than real time."""
        if not self.samplerate:
            return None
        return self.samples_per_sec / self.samplerate

    def report(self) -> dict:
        r = {"blocks": self.blocks, "samples": self.samples,
             "elapsed_s": self.elapsed,
             "samples_per_sec": self.samples_per_sec,
             "ema_block_ms": (self.ema_block_s or 0.0) * 1e3}
        if self.samplerate:
            r["realtime_factor"] = self.realtime_factor
        return r

    def __str__(self):
        r = self.report()
        s = (f"{r['blocks']} blocks, {r['samples']} samples in "
             f"{r['elapsed_s']:.2f}s = {r['samples_per_sec'] / 1e6:.2f} Msamp/s"
             f" (EMA {r['ema_block_ms']:.2f} ms/block)")
        if "realtime_factor" in r:
            s += f", {r['realtime_factor']:.2f}x realtime"
        return s
