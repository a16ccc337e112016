"""Every user-facing CLI command must accept --cpu and force the CPU
backend through jax.config IN-PROCESS: a site customization can override
the JAX_PLATFORMS env var, and a CPU parent spawning an (unintended)
accelerator child silently splits the persistent compilation cache by
backend hash."""

import io
import os
import subprocess
import sys
from contextlib import redirect_stdout

import pytest


def _env(tmp_path):
    return dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"),
                JAX_PLATFORMS="cpu")


@pytest.mark.parametrize("cmd", ["run", "bank", "spectrum", "serve", "ui",
                                 "scan", "decode", "preheat"])
def test_command_advertises_cpu_flag(cmd):
    """--cpu appears in every command's --help (parser wiring)."""
    from sdrpp_tpu import cli

    buf = io.StringIO()
    with pytest.raises(SystemExit) as e, redirect_stdout(buf):
        cli.COMMANDS[cmd](["--help"])
    assert e.value.code == 0
    assert "--cpu" in buf.getvalue(), f"{cmd}: no --cpu in help"


def test_run_cpu_flag_forces_backend_in_subprocess(tmp_path):
    """`cli run --cpu` processes blocks end-to-end on the CPU backend in
    a real subprocess — the path an accelerator-host user scripts
    against."""
    out = tmp_path / "audio.wav"
    r = subprocess.run(
        [sys.executable, "-m", "sdrpp_tpu", "run", "--cpu",
         "--source", "test:96000", "--mode", "nfm", "--tone", "10000",
         "--offset", "10000", "--blocks", "2", "--block-size", "24000",
         "--out", str(out)],
        env=_env(tmp_path), capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "backend: cpu (forced by --cpu)" in r.stderr, r.stderr[-2000:]
    assert out.exists() and out.stat().st_size > 44


def test_spectrum_cpu_flag_in_subprocess(tmp_path):
    out = tmp_path / "wf.npy"
    r = subprocess.run(
        [sys.executable, "-m", "sdrpp_tpu", "spectrum", "--cpu",
         "--source", "test:96000", "--blocks", "2",
         "--block-size", "65536", "--fft-size", "4096",
         "--out", str(out)],
        env=_env(tmp_path), capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "backend: cpu (forced by --cpu)" in r.stderr, r.stderr[-2000:]
    assert out.exists()
