"""Time the lane kernel (ops/scans_pallas.lane_scan) on the card against
the plain lax.scan of the same step, at the shapes the chains run:

- ssb_exact: the 64-channel SSB bank's AGC as one exact loop, [64, 2^18];
- ssb_chunked: the same AGC chunk-parallel (K = 128 lanes per channel);
- meteor_fast_agc / meteor_costas: MeteorDemod's chunked lanes at a 2^20
  block (K = 512, W = 1024);
- one_lane: a 1-D stream of 2^16 samples (one lane vs lax.scan).

``--sweep`` also times the kernel over 1..8192 lane tiles at a fixed step
count: the tile count where the step time leaves its floor is
scans_pallas.RESIDENT_TILES.

Needs a GPU; prints one JSON object per line.
    python tools/bench_lane_scan.py [--sweep]
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _time(fn, *args, reps: int = 5) -> float:
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _case(name, step, k, lanes, steps, nstreams, rng, scan_reps=3):
    import jax
    import jax.numpy as jnp

    from sdrpp_tpu.ops.scans_pallas import lane_scan

    streams = [jnp.asarray(np.abs(rng.standard_normal((steps, lanes)))
                           .astype(np.float32)) for _ in range(nstreams)]
    state = jnp.ones((k, lanes), jnp.float32)
    kern = jax.jit(lambda s, *xs: lane_scan(step, s, list(xs)))

    def scan(s, *xs):
        def body(c, xt):
            return step(c, xt)
        fin, out = jax.lax.scan(body, tuple(s), tuple(xs))
        return out, jnp.stack(fin)

    scan = jax.jit(scan)
    out_k, fin_k = kern(state, *streams)
    out_s, fin_s = scan(state, *streams)
    err = float(jnp.max(jnp.abs(out_k - out_s)))
    rec = {"case": name, "lanes": lanes, "steps": steps,
           "kernel_s": _time(kern, state, *streams),
           "scan_s": _time(scan, state, *streams, reps=scan_reps),
           "max_abs_diff": err}
    rec["speedup"] = rec["scan_s"] / rec["kernel_s"]
    print(json.dumps(rec), flush=True)
    return rec


def main(argv) -> int:
    import jax

    from sdrpp_tpu.ops import scans_pallas as SP
    from sdrpp_tpu.utils.platform import pallas_gpu_supported

    if not pallas_gpu_supported():
        print("no GPU backend", file=sys.stderr)
        return 1
    d = jax.devices()[0]
    print(json.dumps({"device": d.device_kind, "count": len(jax.devices())}))
    rng = np.random.default_rng(0)
    agc = SP._agc_step(1.0, 50.0 / 48000.0, 5.0 / 48000.0, 1e6, 10.0)
    fagc = SP._fast_agc_step(1.0, 10e6, 0.001)
    alpha, beta = 0.005, 0.0001
    met = SP._costas_step("meteor", alpha, beta, -np.pi, np.pi)
    pll = SP._pll_step(alpha, beta, -np.pi, np.pi)
    _case("ssb_exact", agc, 2, 64, 1 << 18, 2, rng, scan_reps=1)
    _case("ssb_chunked", agc, 2, 64 * 128, 2048 + 2048, 2, rng)
    _case("meteor_fast_agc", fagc, 1, 512, 1024 + 2048, 1, rng)
    _case("meteor_costas", met, 2, 512, 1024 + 2048, 2, rng)
    _case("one_lane_pll", pll, 2, 1, 1 << 16, 1, rng, scan_reps=1)
    if "--sweep" in argv:
        from sdrpp_tpu.ops.scans_pallas import lane_scan
        import jax.numpy as jnp
        steps = 4096
        for tiles in (1, 16, 132, 264, 528, 1056, 2112, 4224, 8448):
            lanes = tiles * SP.LANE_TILE
            x = jnp.ones((steps, lanes), jnp.float32)
            st = jnp.ones((1, lanes), jnp.float32)
            f = jax.jit(lambda s, x: lane_scan(fagc, s, [x]))
            t = _time(f, st, x)
            print(json.dumps({"sweep_tiles": tiles, "lanes": lanes,
                              "steps": steps, "kernel_s": t,
                              "ns_per_step": t / steps * 1e9}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
