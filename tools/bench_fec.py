"""Stream-Viterbi throughput on the current backend: host-inclusive vs
compute-only.

- host-inclusive: ConvCode.decode_soft_stream end to end from host
  numpy soft bits (uint8 upload, single fused device program, packed-bit
  readback) — the number an LRPT user sees.
- compute-only: the same jitted program timed with the inputs already
  device-resident; the only transfer is the total/8-byte packed readback.

Also reports the exact one-shot decode for scale and verifies the stream
output matches decode_soft_np bit-for-bit at this SNR.

Usage: python tools/bench_fec.py [--info-bits 1048576] [--snr-sigma 24]
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--info-bits", type=int, default=1 << 20)
    ap.add_argument("--snr-sigma", type=float, default=24.0)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--exact-check", action="store_true",
                    help="also run the exact decoder for a bit-match check")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from sdrpp_tpu.ops.fec import ConvCode

    print(f"backend: {jax.default_backend()}", flush=True)
    code = ConvCode(2, 7, (0o171, 0o133))  # CCSDS r=1/2 K=7 (LRPT)
    rng = np.random.default_rng(0)
    nbytes = args.info_bits // 8
    msg = rng.integers(0, 256, nbytes).astype(np.uint8)
    coded = code.encode(msg)
    bits = np.unpackbits(coded).astype(np.float32)
    noisy = np.clip(bits * 255.0 + rng.normal(0, args.snr_sigma, bits.shape),
                    0, 255).astype(np.uint8)
    info_bits = len(noisy) // 2 - (code.order + 1)
    print(f"stream: {info_bits} info bits "
          f"({len(noisy)} soft symbols, sigma={args.snr_sigma})", flush=True)

    # host-inclusive (includes upload + jit dispatch + packed readback)
    out = code.decode_soft_stream(noisy)  # warm the jit
    t0 = time.perf_counter()
    for _ in range(args.iters):
        out = code.decode_soft_stream(noisy)
    dt = (time.perf_counter() - t0) / args.iters
    print(f"host-inclusive: {info_bits / dt / 1e6:7.2f} Mbit/s "
          f"({dt * 1e3:.0f} ms)", flush=True)

    # compute-only: same program, inputs device-resident
    total = len(noisy) // 2
    L, W = 4096, 96
    t_w = L + 2 * W
    n_chunks = -(-total // L)
    G = -(-n_chunks // code._STREAM_BATCH)
    B = -(-n_chunks // G)
    chunk = np.arange(G * B)
    starts_pad = np.clip(chunk * L - W, 0, total - t_w).astype(np.int32)
    offs_pad = (chunk * L - starts_pad).astype(np.int32)
    fn = code._jit_stream(total, L, W, G, B)
    soft_dev = jax.device_put(jnp.asarray(noisy.reshape(total, 2)))
    st_dev = jax.device_put(jnp.asarray(starts_pad))
    off_dev = jax.device_put(jnp.asarray(offs_pad))
    packed = np.asarray(fn(soft_dev, st_dev, off_dev))  # warm
    t0 = time.perf_counter()
    for _ in range(args.iters):
        packed = np.asarray(fn(soft_dev, st_dev, off_dev))
    dt_c = (time.perf_counter() - t0) / args.iters
    print(f"compute-only:     {info_bits / dt_c / 1e6:7.2f} Mbit/s "
          f"({dt_c * 1e3:.0f} ms; readback {total // 8 / 1024:.0f} KiB "
          f"included — it is the sync point)", flush=True)
    print(f"IO share of host-inclusive: "
          f"{max(0.0, 1 - dt_c / dt) * 100:.0f}%", flush=True)

    got = np.unpackbits(packed)[:total][:info_bits]
    assert np.array_equal(out[:info_bits], got), "stream paths disagree"
    if args.exact_check:
        exact = code.decode_soft_np(noisy.astype(np.float32))
        n = min(len(exact), len(out))
        assert np.array_equal(out[:n], exact[:n]), "stream != exact decode"
        print("bit-exact vs exact Viterbi: OK", flush=True)


if __name__ == "__main__":
    main()
