"""Tracing/monitoring utilities (SURVEY §5: jax.profiler + per-block
counters as this build's observability layer)."""

import time

import numpy as np

from sdrpp_tpu.utils.tracing import StreamMonitor, annotate, trace


def test_stream_monitor_counters():
    mon = StreamMonitor(samplerate=1e6)
    for _ in range(5):
        with mon.block(1000):
            time.sleep(0.001)
    r = mon.report()
    assert r["blocks"] == 5
    assert r["samples"] == 5000
    assert r["samples_per_sec"] > 0
    assert r["ema_block_ms"] >= 1.0
    assert r["realtime_factor"] == r["samples_per_sec"] / 1e6
    assert "Msamp/s" in str(mon)


def test_stream_monitor_reset():
    mon = StreamMonitor()
    with mon.block(10):
        pass
    mon.reset()
    assert mon.blocks == 0 and mon.samples == 0
    assert mon.realtime_factor is None


def test_annotate_and_trace(tmp_path):
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda x: jnp.sum(x * 2))
    with trace(str(tmp_path / "tr")):
        with annotate("test_region"):
            float(f(jnp.arange(128.0)))
    # XPlane dump lands under plugins/profile/<ts>/
    dumped = list((tmp_path / "tr").rglob("*"))
    assert any(p.is_file() for p in dumped)


def test_cli_run_reports_throughput(tmp_path, caplog):
    import logging

    from sdrpp_tpu.cli import cmd_run

    with caplog.at_level(logging.INFO):
        cmd_run(["--source", "test:1024000", "--mode", "am", "--tone", "0",
                 "--out", str(tmp_path / "a.wav"), "--blocks", "2",
                 "--block-size", "131072"])
    assert any("Msamp/s" in r.message for r in caplog.records)


def test_cli_bank_multichannel(tmp_path):
    """bank command: one batched VFO-bank step -> per-channel recordings;
    the on-carrier channel demodulates to near-silence, off-channel ones
    to full-scale FM noise."""
    from sdrpp_tpu.cli import cmd_bank
    from sdrpp_tpu.io.wav import read_wav

    out = tmp_path / "bank"
    cmd_bank(["--source", "test:1024000", "--tone", "150000",
              "--offsets=-200e3,150e3", "--mode", "nfm",
              "--blocks", "2", "--block-size", "131072",
              "--out-dir", str(out)])
    files = sorted(out.glob("*.wav"))
    assert len(files) == 2
    rms = []
    for f in files:
        info, d = read_wav(f)
        assert info.samplerate == 48000
        rms.append(float(np.sqrt(np.mean(d ** 2))))
    assert rms[1] < 0.3 < rms[0]  # on-carrier quiet, off-carrier noise
