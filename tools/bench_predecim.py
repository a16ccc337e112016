"""A/B: time-domain /256 decimation cascade vs the FFT alias-fold form.
FFTPowerDecimator folds the cascade into one batched overlap-save FFT.
Measures both, same process, back-to-back, across FFT segment lengths.

Usage: python tools/bench_predecim.py [--cpu] [--ratio 256]
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    import jax
    if "--cpu" in sys.argv:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from sdrpp_tpu.ops.resample import FFTPowerDecimator, PowerDecimator
    from sdrpp_tpu.utils.speed_tester import speed_test

    ratio = 256
    if "--ratio" in sys.argv:
        ratio = int(sys.argv[sys.argv.index("--ratio") + 1])


    quick = "--cpu" in sys.argv
    target = 1 << (22 if quick else 24)

    rows = []

    def bench(name, blk, n):
        m = speed_test(blk, n, iters=4 if quick else 8)
        rows.append((name, n, m["time_per_block_us"],
                     m["samples_per_sec"] / 1e6))
        print(f"{name:<34} n={n:<9} {m['time_per_block_us']:>10.1f} us "
              f"{m['samples_per_sec'] / 1e6:>8.1f} Msamp/s", flush=True)

    # time-domain cascade (current bench.py form)
    pd = PowerDecimator(ratio)
    bench(f"cascade /{ratio} (time-domain)", pd, target)

    for logF in (18, 19, 20, 21):
        fd = FFTPowerDecimator(ratio, fft_len=1 << logF, out_multiple=128)
        n = (target // fd.block_multiple) * fd.block_multiple
        if n == 0:
            continue
        bench(f"fft-fold /{ratio} F=2^{logF} "
              f"(pay {fd.payload})", fd, n)

    base = rows[0][3]
    print("\nspeedups vs cascade:")
    for name, n, us, ms in rows[1:]:
        print(f"  {name:<34} {ms / base:5.2f}x")


if __name__ == "__main__":
    main()
