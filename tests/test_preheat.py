"""`cli preheat` populates the persistent compilation cache with the UI
mode corpus, so a LATER process's first interactive session compiles
nothing (the ahead-of-time answer to the reference's microsecond demod
rebuilds, radio_module.h:322-336)."""

import os
import subprocess
import sys

ARGS = ["--samplerate", "250000", "--modes", "nfm", "--no-variants",
        "--block-size", "65536", "--fft-size", "4096", "--cpu"]

# a second process starting a REAL engine session with the same graph
# config the preheat corpus built — but from a different call site
# (engine start, not warm_plan) and at a different VFO offset (0.0 vs
# the corpus' 100000.0). Both used to change the lowered module via the
# Python tracebacks Mosaic embeds in its kernel bodies, silently
# defeating the cache; compile_cache now strips tracebacks from MLIR
# locations, so this must HIT.
UI_SCRIPT = r"""
import logging, sys, time
logging.getLogger("jax._src.compiler").setLevel(logging.DEBUG)
logging.getLogger("jax._src.compiler").addHandler(
    logging.StreamHandler(sys.stderr))
import jax
jax.config.update("jax_platforms", "cpu")
from sdrpp_tpu.io.sources import TestSource
from sdrpp_tpu.misc.webui import ReceiverEngine
src = TestSource(250000.0, tones=[(100000.0, -20.0)], noise_dbfs=-90.0)
eng = ReceiverEngine(src, mode="nfm", base_block=65536, fft_size=4096,
                     realtime=False)
eng.start()
deadline = time.monotonic() + 240
while eng.blocks < 1 and eng.error is None and time.monotonic() < deadline:
    time.sleep(0.1)
eng.stop()
assert eng.blocks >= 1 and eng.error is None, (eng.blocks, eng.error)
print("WARM", eng.blocks)
"""


def _env(tmp_path):
    return dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"),
                SDRPP_TPU_CACHE_MIN_SECS="0", JAX_PLATFORMS="cpu",
                JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="-1")


def test_preheat_then_ui_process_hits_cache(tmp_path):
    r1 = subprocess.run(
        [sys.executable, "-m", "sdrpp_tpu", "preheat"] + ARGS,
        env=_env(tmp_path), capture_output=True, text=True, timeout=600)
    assert r1.returncode == 0, r1.stderr[-2000:]
    assert "preheat done: 1 configs" in r1.stdout, r1.stdout
    cache = tmp_path / "cache"
    assert cache.exists() and any(cache.iterdir()), \
        "preheat must populate the cache"

    r2 = subprocess.run([sys.executable, "-c", UI_SCRIPT],
                        env=_env(tmp_path), capture_output=True, text=True,
                        timeout=600)
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert r2.stdout.startswith("WARM "), r2.stdout
    assert "Persistent compilation cache hit" in r2.stderr, r2.stderr[-2000:]


def test_preheat_rejects_unknown_mode(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "sdrpp_tpu", "preheat", "--modes", "zzz",
         "--no-variants"],
        env=_env(tmp_path), capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "unknown mode" in r.stderr
