"""CLI `decode` command (digital decoder pipelines)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from sdrpp_tpu.decoders import kg_sstv as kg
from sdrpp_tpu.io import wav


def _run_cli(args, cwd):
    code = ("import jax; jax.config.update('jax_platforms','cpu');"
            "import sys; sys.path.insert(0, '%s');"
            "from sdrpp_tpu.cli import main; sys.exit(main(%r) or 0)"
            % (str(cwd), args))
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)


@pytest.fixture(scope="module")
def repo_root():
    return Path(__file__).resolve().parent.parent


def test_cli_decode_kgsstv(tmp_path, repo_root):
    rng = np.random.default_rng(0)
    frames = []
    for _ in range(2):
        b = rng.integers(0, 256, 7).astype(np.uint8)
        b[6] &= 0b11111100
        frames.append(bytes(b))
    sym = np.concatenate(
        [(rng.integers(0, 2, 400) * 2.0 - 1.0).astype(np.float32)]
        + [kg.KGSSTVDeframer.encode_frame(f) for f in frames]
        + [np.zeros(50, np.float32)])
    fs = 12000.0
    sps = fs / kg.BAUDRATE
    n = int(len(sym) * sps)
    idx = np.minimum((np.arange(n) / sps).astype(np.int64), len(sym) - 1)
    # shift to a +2 kHz VFO offset so the CLI's VFO path is exercised
    t = np.arange(n) / fs
    phase = np.cumsum(2 * np.pi * kg.DEVIATION * sym[idx] / fs)
    iq = np.exp(1j * (phase + 2 * np.pi * 2000.0 * t)).astype(np.complex64)
    # pad so the CLI's whole-block streaming covers the full transmission
    iq = np.concatenate([iq, np.zeros(6000, np.complex64)])
    cap = tmp_path / "kg.wav"
    wav.write_wav(cap, int(fs), np.stack([iq.real, iq.imag], -1), "f32")

    out = tmp_path / "frames.bin"
    r = _run_cli(["decode", "kgsstv", "--source", str(cap),
                  "--offset", "2000", "--block-size", "6000",
                  "--out", str(out)], repo_root)
    assert r.returncode == 0, r.stderr
    data = out.read_bytes()
    # both 7-byte frames recovered (last 2 bits unprotected; mask them)
    assert len(data) == 14
    got = [data[:7], data[7:]]
    for g, f in zip(got, frames):
        assert g[:6] == f[:6] and (g[6] & 0xFC) == (f[6] & 0xFC)


def test_cli_decode_meteor(tmp_path, repo_root):
    """Golden LRPT chain through the CLI path (VERDICT r2 #7): the
    committed IQ capture -> `sdrpp_tpu decode meteor` -> soft-symbol
    file + Viterbi/RS VCDU payloads matching the committed golden."""
    golden_wav = repo_root / "tests" / "data" / "meteor_lrpt_150000Hz.wav"
    golden_payload = np.fromfile(
        repo_root / "tests" / "data" / "meteor_lrpt_payload.bin",
        np.uint8).reshape(3, 892)
    out = tmp_path / "meteor.s"
    # default (auto) block sizing: short captures cap to one full block
    r = _run_cli(["decode", "meteor", "--source", str(golden_wav),
                  "--out", str(out)], cwd=repo_root)
    assert r.returncode == 0, r.stderr
    soft = np.fromfile(out, np.int8)
    assert len(soft) > 55000  # ~2 soft bytes per symbol over the capture
    vcdus = np.fromfile(tmp_path / "meteor_vcdu.bin", np.uint8)
    assert len(vcdus) == 3 * 892, len(vcdus)
    vcdus = vcdus.reshape(3, 892)
    # all three payloads recovered (order preserved by the CADU stream)
    for p in golden_payload:
        assert any(np.array_equal(v, p) for v in vcdus)


def test_cli_decode_with_vfo_resample(tmp_path, repo_root):
    """Source rate != decoder rate: the decode path inserts an RxVFO and
    moves IQ as split float32. Smoke: runs clean on a
    synthetic source and writes the soft-symbol file."""
    out = tmp_path / "m.s"
    r = _run_cli(["decode", "meteor", "--source", "test:300000",
                  "--blocks", "2", "--block-size", "131072",
                  "--out", str(out)], cwd=repo_root)
    assert r.returncode == 0, r.stderr
    assert out.exists() and out.stat().st_size > 0
