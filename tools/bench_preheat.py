"""First-interactive-session readiness: cold cache vs `cli preheat`.

The persistent compilation cache (utils/compile_cache) makes REVISITED
configs warm; `cli preheat` extends that to the very first session on a
machine by paying the mode corpus' compiles ahead of time. This tool
measures what a user actually feels: wall time from `cli ui` process
start to the first processed block (readiness), with

  A) an empty cache (cold first session),
  B) after `cli preheat` populated the same cache directory.

Each phase runs in fresh subprocesses against isolated cache dirs.

Usage: python tools/bench_preheat.py [--samplerate 1000000] [--mode wfm]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.request
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _wait_ready(port: int, timeout: float) -> float:
    """Seconds until /api/state reports a processed block."""
    t0 = time.monotonic()
    deadline = t0 + timeout
    while time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/api/state", timeout=2) as r:
                st = json.loads(r.read())
            if st.get("blocks", 0) > 0 and st.get("running"):
                return time.monotonic() - t0
        except Exception:
            pass
        time.sleep(0.25)
    raise TimeoutError(f"UI not ready within {timeout}s")


def _ui_readiness(env: dict, samplerate: float, mode: str, port: int,
                  timeout: float) -> float:
    proc = subprocess.Popen(
        [sys.executable, "-m", "sdrpp_tpu", "ui",
         "--source", f"test:{samplerate:.0f}", "--mode", mode,
         "--port", str(port), "--addr", "127.0.0.1"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    try:
        return _wait_ready(port, timeout)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--samplerate", type=float, default=1000000.0)
    ap.add_argument("--mode", default="wfm")
    ap.add_argument("--port", type=int, default=8199)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--modes", default=None,
                    help="preheat corpus modes (default: all)")
    args = ap.parse_args()

    with tempfile.TemporaryDirectory(prefix="sdrpp_preheat_") as td:
        cold_dir = Path(td) / "cold"
        warm_dir = Path(td) / "warm"

        env_cold = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(cold_dir))
        env_warm = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(warm_dir))

        print("phase A: cold first session (empty cache)", flush=True)
        cold = _ui_readiness(env_cold, args.samplerate, args.mode,
                             args.port, args.timeout)
        print(f"  readiness: {cold:.2f} s", flush=True)

        print("phase B: cli preheat, then first session", flush=True)
        cmd = [sys.executable, "-m", "sdrpp_tpu", "preheat",
               "--samplerate", f"{args.samplerate:.0f}"]
        if args.modes:
            cmd += ["--modes", args.modes]
        t0 = time.monotonic()
        r = subprocess.run(cmd, env=env_warm, capture_output=True, text=True,
                           timeout=3600)
        pre_secs = time.monotonic() - t0
        print(r.stdout.rstrip(), flush=True)
        if r.returncode != 0:
            print(r.stderr[-2000:], file=sys.stderr)
            raise SystemExit("preheat failed")
        warm = _ui_readiness(env_warm, args.samplerate, args.mode,
                             args.port + 1, args.timeout)
        print(f"  preheat wall: {pre_secs:.1f} s (once per machine)")
        print(f"  readiness:    {warm:.2f} s")
        print(f"summary: cold {cold:.2f} s -> preheated {warm:.2f} s "
              f"({cold / max(warm, 1e-9):.1f}x)")


if __name__ == "__main__":
    main()
