"""Per-mode throughput vs block size (the r3 dead-zone documentation
sweep, PERFORMANCE.md "realtime-vs-block-size").

The chunk-parallel loop drivers engage by a tile cost model
(ops/scans_pallas._chunk_lanes_for): this sweep shows where each mode's
throughput steps up as its loops engage, and the realtime multiple at
each grain (throughput / the mode's native sample rate).

Usage: python tools/bench_blocksweep.py [--cpu] [--quick]
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    import jax

    if "--cpu" in sys.argv:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from sdrpp_tpu.models.analog import AMDemod, SSBDemod, WFMDemod
    from sdrpp_tpu.models.digital import MeteorDemod
    from sdrpp_tpu.ops.scans_pallas import AGCChunked, FastAGCChunked, \
        PLLChunked
    from sdrpp_tpu.utils.speed_tester import speed_test

    quick = "--quick" in sys.argv
    sizes_small = [1 << 14, 1 << 16, 1 << 18]
    sizes_big = sizes_small + ([] if quick else [1 << 20])

    rows = []

    def sweep(name, make, rate, sizes, dtype=jnp.complex64):
        for n in sizes:
            try:
                r = speed_test(make(), n, dtype=dtype)
                rows.append((name, n, r["samples_per_sec"],
                             r["samples_per_sec"] / rate))
                print(f"{name:<28} {n:>8} {r['samples_per_sec'] / 1e6:>10.1f}"
                      f" Msamp/s  {r['samples_per_sec'] / rate:>8.0f}x rt",
                      flush=True)
            except Exception as e:
                print(f"{name:<28} {n:>8} FAILED {type(e).__name__}: "
                      f"{str(e)[:80]}", flush=True)


    sweep("WFM stereo demod (240k)",
          lambda: WFMDemod(deviation=75000.0, samplerate=240000.0,
                           stereo=True), 240000.0, sizes_big)
    sweep("AM demod audio-AGC (24k)",
          lambda: AMDemod(bandwidth=12000.0, samplerate=24000.0),
          24000.0, sizes_small)
    sweep("SSB demod auto-AGC (48k)",
          lambda: SSBDemod(mode="usb", samplerate=48000.0),
          48000.0, sizes_small)
    sweep("Meteor full demod (150k)",
          lambda: MeteorDemod(), 150000.0, sizes_big)
    sweep("PLL chunked (phases f32)",
          lambda: PLLChunked(0.01), 1.0, sizes_big, dtype=jnp.float32)
    sweep("FastAGC chunked", lambda: FastAGCChunked(1.0, 1e4, 0.01),
          1.0, sizes_big, dtype=jnp.float32)
    sweep("AGC chunked (radio W=2048)",
          lambda: AGCChunked(1.0, 1e-3, 1e-4, 1e4, 10.0),
          1.0, sizes_big, dtype=jnp.float32)

    return 0


if __name__ == "__main__":
    sys.exit(main())
