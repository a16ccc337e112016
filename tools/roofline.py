"""Speed-of-light fractions for the flagship kernels on the card.

For each flagship kernel (1M-point spectrum FFT, 255-tap overlap-save
FIR, 64-channel shared-FFT channelizer, the meteor chain) this measures
throughput with utils/speed_tester, then computes the fraction of two
ceilings:

- **HBM bound**: minimum bytes/sample the kernel must move (one read +
  one write of its streams at their dtypes) against the card's memory
  bandwidth. Streaming DSP at these arithmetic intensities is memory
  bound, so this is the binding roofline.
- **Compute anchor**: the kernel's useful FLOPs against the card's f32
  peak outside the tensor cores.

Peaks are published figures, keyed by ``device_kind``; a device missing
from the table is an error.

Usage: python tools/roofline.py
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# NVIDIA H100 data sheet, SXM part, dense rates: HBM3 3.35 TB/s, f32
# 67 TFLOP/s outside the tensor cores (assumes the 700 W power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0, "f32_tflops": 67.0},
}


def device_peaks() -> tuple[str, dict]:
    import jax
    kind = jax.devices()[0].device_kind
    if kind not in PEAKS:
        raise KeyError(f"no peak table for device {kind!r}; add its "
                       "published figures to tools/roofline.PEAKS")
    return kind, PEAKS[kind]


def main():
    from sdrpp_tpu.models.digital import MeteorDemod
    from sdrpp_tpu.ops import taps as taps_mod
    from sdrpp_tpu.ops.channelizer import FFTChannelizerBank
    from sdrpp_tpu.ops.fir import FIR
    from sdrpp_tpu.ops.spectrum import SpectrumFFT
    from sdrpp_tpu.utils.blocks import Block
    from sdrpp_tpu.utils.speed_tester import speed_test

    kind, peaks = device_peaks()
    hbm, f32 = peaks["hbm_gbps"], peaks["f32_tflops"]
    print(f"device: {kind}  HBM {hbm:.0f} GB/s  f32 {f32:.0f} TFLOP/s",
          flush=True)

    n = 1 << 20
    rows = []

    def add(name, meas, bytes_per_sample, flops_per_sample):
        sps = meas["samples_per_sec"]
        gbs = sps * bytes_per_sample / 1e9
        tf = sps * flops_per_sample / 1e12
        rows.append((name, sps / 1e6, bytes_per_sample, gbs,
                     100.0 * gbs / hbm, flops_per_sample, tf,
                     100.0 * tf / f32))

    # 1M-point spectrum FFT: c64 in (8 B), f32 PSD out (4 B) -> 12 B/s.
    # FLOPs ~ 5 N log2 N / N = 5*20 per sample + |.|^2 (3).
    class _Spec1M(Block):
        def __init__(self):
            self.s = SpectrumFFT(1 << 20, 100e6, 100e6 / (1 << 20))

        def __call__(self, state, x):
            return state, self.s(x)

    add("spectrum 1M-FFT", speed_test(_Spec1M(), n, iters=10),
        12.0, 5.0 * 20 + 3)

    # 255-tap FIR on c64: 8 B in + 8 B out; useful FLOPs = 8*T per
    # sample (c64 MAC = 8).
    taps255 = taps_mod.low_pass(0.1, 0.02, 1.0)[:255]
    add("FIR 255t c64", speed_test(FIR(taps255), n), 16.0, 8.0 * 255)

    # 64-ch shared-FFT channelizer /128: 8 B in, 64 ch x 8 B / 128 out
    # = 12 B/sample; FLOPs ~ one 8k FFT pass (5 log2 8192 = 65) +
    # per-channel pruned IFFT+filter amortized (~64 * 65 / 128 = 32.5).
    add("channelizer 64ch /128",
        speed_test(FFTChannelizerBank(
            np.linspace(-2.4e6, 2.4e6, 64), 6144000.0, 48000.0,
            bandwidth=12500.0), n),
        8.0 + 64 * 8.0 / 128, 65.0 + 32.5)

    # meteor chain: dominated by the chunked MM's windowed interpolation.
    # 8 B in + symbol out ~ 4 B; useful FLOPs/sample ~ 300.
    add("meteor chain (RRC+AGC+Costas+MM)",
        speed_test(MeteorDemod(72000.0, 150000.0), 1 << 19, iters=5),
        12.0, 300.0)

    print(f"{'kernel':<32} {'Msamp/s':>9} {'B/smp':>6} {'GB/s':>8} "
          f"{'%HBM':>6} {'FLOP/smp':>9} {'TFLOP/s':>8} {'%f32':>6}")
    for r in rows:
        print(f"{r[0]:<32} {r[1]:>9.1f} {r[2]:>6.1f} {r[3]:>8.1f} "
              f"{r[4]:>6.1f} {r[5]:>9.0f} {r[6]:>8.3f} {r[7]:>6.1f}")


if __name__ == "__main__":
    main()
