"""Persistent JAX compilation cache for warm process starts.

The reference rebuilds a demod chain in microseconds because its "build"
is object wiring (decoder_modules/radio/src/radio_module.h:322-336 logs
the set-mode latency); our structural equivalent is jit re-trace, which
within one process is cached by JAX but across processes used to pay the
full XLA compile every time. Enabling ``jax_compilation_cache_dir``
persists compiled executables keyed by HLO + compile options, so a second
process with the same chain config loads the binary instead of
recompiling.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, that directory holds the
cache and no other is set here. Otherwise it lives at a fixed path
inside the checkout (``.jax_cache``, listed in .gitignore): the path is
part of the cache key, so a directory that moves never hits.

- ``jax_raise_persistent_cache_errors`` stays False — a corrupt/readonly
  cache entry degrades to a cold compile, never a crash;
- entries below 1 s of compile time are not persisted (caching trivia
  just inflates the directory);
- the cache is keyed per JAX version by JAX itself (the backend build
  hash is part of the key), so backend upgrades invalidate cleanly.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

__all__ = ["enable_persistent_cache", "default_cache_dir"]

log = logging.getLogger(__name__)

_enabled: str | None = None

_CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def default_cache_dir() -> Path:
    """``JAX_COMPILATION_CACHE_DIR`` where set, else ``.jax_cache`` at the
    root of the checkout."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    return Path(env) if env else _CHECKOUT_CACHE


def enable_persistent_cache(cache_dir: str | os.PathLike | None = None,
                            min_compile_secs: float = 1.0) -> str | None:
    """Turn on the persistent compilation cache; returns the directory,
    or None if disabled (SDRPP_TPU_NO_CACHE=1) or the directory cannot be
    created (the run then proceeds uncached)."""
    global _enabled
    if os.environ.get("SDRPP_TPU_NO_CACHE"):
        return None
    if _enabled is not None:
        return _enabled
    env_min = os.environ.get("SDRPP_TPU_CACHE_MIN_SECS")
    if env_min is not None:  # CPU-backend tests persist fast compiles
        try:
            min_compile_secs = float(env_min)
        except ValueError:  # malformed env must not make setup fatal
            pass
    import jax

    path = Path(cache_dir) if cache_dir else default_cache_dir()
    try:
        path.mkdir(parents=True, exist_ok=True)
    except OSError as e:
        log.warning("compile cache disabled: cannot create %s (%s)", path, e)
        return None
    # Cache-key determinism: Pallas kernel bodies are opaque custom-call
    # payloads, so the Python TRACEBACK locations they embed leak into
    # the compilation-cache key — the same graph built from a different
    # call site (cli preheat vs the UI engine vs its builder thread)
    # would silently MISS. Dropping tracebacks from MLIR locations
    # (innermost frame only) makes lowering byte-identical across call
    # sites and processes (tests/test_lowering_determinism.py).
    jax.config.update("jax_include_full_tracebacks_in_locations", False)
    jax.config.update("jax_compilation_cache_dir", str(path))
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_secs))
    jax.config.update("jax_raise_persistent_cache_errors", False)
    # long-lived services churn configs: cap the cache (LRU) so the
    # directory cannot grow without bound
    jax.config.update("jax_compilation_cache_max_size", 4 * 2 ** 30)
    _enabled = str(path)
    return _enabled
