"""Failure detection / elastic recovery for streaming loops.

The reference's resilience is thread-level: worker threads trap
exceptions and log (core/src/utils/threading.h:55-61), file_source
resyncs its clock on underrun (file_source/src/main.cpp:144-152). For a
device serving loop the failure modes are different — a backend call
can raise transiently (or hang), and the fix is retry/re-jit/resume, not
thread restarts. SURVEY §5's plan: DSP state is a tiny pytree, so periodic
snapshots give cheap resume.

``StepWatchdog`` wraps a jitted step callable:

- per-call wall-clock deadline (SIGALRM; main thread only) so a hung
  backend call surfaces as a timeout instead of a stuck pipeline
- on failure: exponential-backoff retries; after ``rejit_after``
  consecutive failures the step is re-traced (fresh executable) — the
  cure for a poisoned compiled-program cache
- optional periodic checkpointing via utils/checkpoint, restoring the
  last good (state, offset) after a crash-level failure

The wrapped step stays pure; the watchdog only manages the host-side
call discipline around it.
"""

from __future__ import annotations

import contextlib
import signal
import time

__all__ = ["StepTimeout", "StepWatchdog"]


class StepTimeout(Exception):
    """A single step exceeded the watchdog deadline."""


@contextlib.contextmanager
def _deadline(seconds: float):
    if not seconds or seconds <= 0:
        yield
        return

    def handler(signum, frame):
        raise StepTimeout()

    old = signal.signal(signal.SIGALRM, handler)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0.0)
        signal.signal(signal.SIGALRM, old)


class StepWatchdog:
    """Supervised execution of a streaming step function.

    ``make_step()`` must return a fresh step callable (e.g.
    ``lambda: jax.jit(chan)``); the watchdog calls it again to re-trace
    after repeated failures.
    """

    def __init__(self, make_step, timeout_s: float = 0.0, max_retries: int = 3,
                 rejit_after: int = 2, backoff_s: float = 1.0,
                 checkpoint_path=None, checkpoint_every: int = 0,
                 on_event=None):
        self._make_step = make_step
        self._step = make_step()
        self.timeout_s = float(timeout_s)
        self.max_retries = int(max_retries)
        self.rejit_after = int(rejit_after)
        self.backoff_s = float(backoff_s)
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = int(checkpoint_every)
        self.on_event = on_event or (lambda kind, **kw: None)
        self.consecutive_failures = 0
        self.total_failures = 0
        self.steps = 0
        self._last_good = None  # (state, offset)

    # -- checkpointing --------------------------------------------------
    def _maybe_checkpoint(self, state, offset: int):
        self._last_good = (state, offset)
        if (self.checkpoint_path and self.checkpoint_every
                and self.steps % self.checkpoint_every == 0):
            from .checkpoint import save_state

            save_state(self.checkpoint_path, state, stream_offset=offset)
            self.on_event("checkpoint", offset=offset)

    def restore(self, template_state):
        """(state, offset) from the newest source: in-memory last-good,
        else the checkpoint file, else (template_state, 0)."""
        if self._last_good is not None:
            return self._last_good
        if self.checkpoint_path:
            try:
                from .checkpoint import load_state

                return load_state(self.checkpoint_path, template_state)
            except Exception:
                pass
        return template_state, 0

    # -- the supervised call --------------------------------------------
    def __call__(self, state, x, offset: int = 0):
        # ``offset`` = stream position AFTER this step (the resume point)
        attempt = 0
        while True:
            try:
                with _deadline(self.timeout_s):
                    out = self._step(state, x)
                self.steps += 1
                self.consecutive_failures = 0
                new_state = out[0] if isinstance(out, tuple) else out
                self._maybe_checkpoint(new_state, offset)
                return out
            except Exception as e:
                self.consecutive_failures += 1
                self.total_failures += 1
                attempt += 1
                self.on_event("failure", error=e, attempt=attempt)
                if attempt > self.max_retries:
                    raise
                if attempt >= self.rejit_after:
                    # poisoned executable cache: re-trace from scratch
                    self._step = self._make_step()
                    self.on_event("rejit", attempt=attempt)
                time.sleep(self.backoff_s * attempt)
