"""Persistent compilation cache (utils/compile_cache): a second PROCESS
with the same chain config must load the compiled executable instead of
re-running XLA (the warm-start answer to the reference's microsecond
demod rebuilds, radio_module.h:322-336)."""

import os
import subprocess
import sys

SCRIPT = r"""
import logging, sys
logging.getLogger("jax._src.compiler").setLevel(logging.DEBUG)
h = logging.StreamHandler(sys.stderr)
logging.getLogger("jax._src.compiler").addHandler(h)
import jax
jax.config.update("jax_platforms", "cpu")
from sdrpp_tpu.utils.compile_cache import enable_persistent_cache
d = enable_persistent_cache(min_compile_secs=0.0)
assert d, "cache must enable"
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
import jax.numpy as jnp
from sdrpp_tpu.ops.mix import FrequencyXlator
from sdrpp_tpu.ops.fm import Quadrature
vfo = FrequencyXlator(-100e3, 960e3)
dm = Quadrature(5e3, 960e3)
@jax.jit
def rx(st, x):
    s0, y = vfo(st[0], x); s1, y = dm(st[1], y)
    return (s0, s1), y.sum()
st = (vfo.init_state(), dm.init_state())
st, y = rx(st, jnp.ones(4096, jnp.complex64))
print("RESULT", float(y))
"""


def _run(tmp_path):
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"),
               JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                          capture_output=True, text=True, timeout=300)


def test_second_process_hits_cache(tmp_path):
    r1 = _run(tmp_path)
    assert r1.returncode == 0, r1.stderr[-2000:]
    assert (tmp_path / "cache").exists()
    assert any((tmp_path / "cache").iterdir()), "first run must populate"
    assert "cache hit" not in r1.stderr

    r2 = _run(tmp_path)
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "Persistent compilation cache hit" in r2.stderr, \
        r2.stderr[-2000:]
    # identical numeric result from the cached executable
    assert r1.stdout.splitlines()[-1] == r2.stdout.splitlines()[-1]


def test_malformed_min_secs_env_is_not_fatal(tmp_path, monkeypatch):
    """Cache setup is documented 'never fatal': a garbage
    SDRPP_TPU_CACHE_MIN_SECS must fall back to the default instead of
    raising out of enable_persistent_cache (and thus out of
    ReceiverEngine construction) — ADVICE r4."""
    import importlib

    from sdrpp_tpu.utils import compile_cache
    monkeypatch.setenv("SDRPP_TPU_CACHE_MIN_SECS", "not-a-number")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    importlib.reload(compile_cache)
    assert compile_cache.enable_persistent_cache() is not None
    monkeypatch.delenv("SDRPP_TPU_CACHE_MIN_SECS")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    importlib.reload(compile_cache)


def test_opt_out_env(tmp_path, monkeypatch):
    monkeypatch.setenv("SDRPP_TPU_NO_CACHE", "1")
    import importlib

    from sdrpp_tpu.utils import compile_cache
    importlib.reload(compile_cache)
    assert compile_cache.enable_persistent_cache() is None
    monkeypatch.delenv("SDRPP_TPU_NO_CACHE")
    importlib.reload(compile_cache)


def test_cache_dir_follows_jax_env(tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR, where set, is the cache directory; HOME
    and XDG_CACHE_HOME play no part."""
    from sdrpp_tpu.utils import compile_cache
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "j"))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert compile_cache.default_cache_dir() == tmp_path / "j"


def test_cache_dir_defaults_inside_checkout(tmp_path, monkeypatch):
    """Without JAX_COMPILATION_CACHE_DIR the cache sits at a fixed path in
    the checkout that .gitignore lists — never under the home directory."""
    from pathlib import Path

    from sdrpp_tpu.utils import compile_cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    root = Path(compile_cache.__file__).resolve().parents[2]
    assert compile_cache.default_cache_dir() == root / ".jax_cache"
    assert ".jax_cache/" in (root / ".gitignore").read_text().split()
