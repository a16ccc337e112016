"""Host-side pipelining around the device step.

The reference pipelines for free: every dsp::block runs its own thread,
and SampleFrameBuffer decouples the source from the DSP graph
(core/src/dsp/buffer/frame_buffer.h:10-133). The jit'd device step is
dispatched asynchronously, so the equivalent here is two small pieces:

- :class:`Prefetcher` — a reader thread that keeps ``depth`` blocks ahead
  of the consumer, so source IO (file mmap decode / network recv)
  overlaps device compute;
- :class:`DeferredWriter` — hold each block's device outputs one
  iteration before forcing them to host, so the device computes block
  i+1 while the host converts/writes block i.

Together: read | device | write run as a 3-stage pipeline without any
change to the (state, x) -> (state, y) step semantics.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

__all__ = ["Prefetcher", "DeferredWriter"]


class Prefetcher:
    """Wrap a source so ``read(n)`` is fed by a background reader thread.

    Preserves the exact block sequence of the wrapped source (same n every
    call — the run loops use a fixed block size). A short read (file EOF
    with loop=False) is propagated and ends the stream.
    """

    def __init__(self, source, block: int, depth: int = 2):
        self.source = source
        self.samplerate = source.samplerate
        self.block = int(block)
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._exc: Exception | None = None
        self._eof = False
        self._thread = threading.Thread(target=self._fill, daemon=True,
                                        name="prefetcher")
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _fill(self):
        try:
            while not self._stop.is_set():
                chunk = self.source.read(self.block)
                if not self._put(chunk):
                    return
                if len(chunk) < self.block:
                    self._eof = True
                    return
        except Exception as e:
            # sticky: read() re-raises even if the queue was full at the
            # moment of failure (a dropped error would leave the consumer
            # blocked forever)
            self._exc = e

    def read(self, n: int) -> np.ndarray:
        assert n == self.block, "Prefetcher is fixed-block"
        while True:
            try:
                return self._q.get(timeout=0.2)
            except queue.Empty:
                if self._exc is not None:
                    raise self._exc
                if self._eof or not self._thread.is_alive():
                    # like FileSource(loop=False) past EOF: silence
                    return np.zeros(self.block, np.complex64)

    def close(self):
        self._stop.set()
        try:  # unblock a full queue
            self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
        if hasattr(self.source, "close"):
            self.source.close()


class DeferredWriter:
    """Depth-1 output pipeline: ``push(out)`` holds the device arrays one
    call before converting to host and handing them to ``write_fn`` —
    the device keeps computing while the host writes. ``flush()`` drains
    the last block."""

    def __init__(self, write_fn):
        self.write_fn = write_fn
        self._pending = None

    def push(self, out):
        prev, self._pending = self._pending, out
        if prev is not None:
            self.write_fn(np.asarray(prev))

    def flush(self):
        if self._pending is not None:
            self.write_fn(np.asarray(self._pending))
            self._pending = None
