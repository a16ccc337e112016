"""Per-kernel throughput sweep on the current backend.

Usage: python tools/bench_kernels.py [--cpu] [--quick]
Prints a samples/s table for every hot kernel (the SpeedTester sweep the
reference lacks, SURVEY §4 implication (e))."""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    import jax
    if "--cpu" in sys.argv:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from sdrpp_tpu.models.analog import AMDemod, WFMDemod
    from sdrpp_tpu.ops import taps as taps_mod
    from sdrpp_tpu.ops.fir import FIR, DecimatingFIR
    from sdrpp_tpu.ops.fm import Quadrature
    from sdrpp_tpu.ops.fm_if import FMIFNoiseReduction
    from sdrpp_tpu.ops.mix import FrequencyXlator, FrequencyXlatorBank
    from sdrpp_tpu.ops.resample import PowerDecimator, RationalResampler
    from sdrpp_tpu.ops.scans import AGC, DCBlocker, Deemphasis, FastAGC, PLL
    from sdrpp_tpu.ops.spectrum import SpectrumFFT
    from sdrpp_tpu.utils.blocks import Block
    from sdrpp_tpu.utils.speed_tester import report_table, speed_test

    quick = "--quick" in sys.argv
    n = 1 << (16 if quick else 20)
    na = 1 << (14 if quick else 16)  # audio-rate blocks
    results = {}

    def guard(name, fn):
        # One bad kernel must not kill the rest of the table.
        try:
            results[name] = fn()
        except Exception as e:
            print(f"# {name}: FAILED {type(e).__name__}", file=sys.stderr)

    taps255 = taps_mod.low_pass(0.1, 0.02, 1.0)[:255]
    guard("mix (NCO)", lambda: speed_test(FrequencyXlator(0.1e6, 10e6), n))
    guard("mix bank x64", lambda: speed_test(
        FrequencyXlatorBank(np.linspace(-4e6, 4e6, 64), 10e6), n // 8))
    guard(f"FIR {len(taps255)}t", lambda: speed_test(FIR(taps255), n))
    guard("DecimFIR /16", lambda: speed_test(
        DecimatingFIR(taps_mod.low_pass(0.03, 0.008, 1.0)[:128], 16), n))
    guard("PowerDecim /128", lambda: speed_test(PowerDecimator(128), n))
    rr = RationalResampler(240000.0, 48000.0)
    guard("RationalResamp 240k->48k", lambda: speed_test(
        rr, (n // rr.block_multiple) * rr.block_multiple))
    guard("DCBlocker (assoc scan)", lambda: speed_test(DCBlocker(1e-4), n))
    guard("Deemphasis (assoc scan)", lambda: speed_test(
        Deemphasis(50e-6, 48000.0), n, dtype=jnp.float32))
    guard("Quadrature FM", lambda: speed_test(Quadrature(75000.0, 240000.0), n))
    guard("AGC (seq scan)", lambda: speed_test(
        AGC(1.0, 0.01, 0.001, 1e6, 10.0, float("inf")), na, dtype=jnp.float32))
    guard("FastAGC (seq scan)", lambda: speed_test(FastAGC(1.0, 1e6, 0.01), na))
    guard("PLL (seq scan)", lambda: speed_test(PLL(0.01), na))

    # the production models run these in the lane kernel on a GPU
    from sdrpp_tpu.ops.scans_pallas import (AGCPallas, FastAGCPallas,
                                            PLLPallas)
    guard("AGC (pallas)", lambda: speed_test(
        AGCPallas(1.0, 0.01, 0.001, 1e6, 10.0, float("inf")), na,
        dtype=jnp.float32))
    guard("FastAGC (pallas)", lambda: speed_test(
        FastAGCPallas(1.0, 1e6, 0.01), na))
    guard("PLL (pallas)", lambda: speed_test(PLLPallas(0.01), na))

    # chunk-parallel approximate loops (long 1-D blocks, the default in
    # the analog demods; SDRPP_TPU_LOOPS=exact disables)
    from sdrpp_tpu.ops.scans_pallas import (AGCChunked, FastAGCChunked,
                                            PLLChunked)
    guard("AGC (chunked)", lambda: speed_test(
        AGCChunked(1.0, 0.01, 0.001, 1e6, 10.0, float("inf")), n,
        dtype=jnp.float32))
    guard("FastAGC (chunked)", lambda: speed_test(
        FastAGCChunked(1.0, 1e6, 0.01), n))
    guard("PLL (chunked)", lambda: speed_test(PLLChunked(0.01), n))
    guard("WFM stereo demod", lambda: speed_test(
        WFMDemod(75000.0, 240000.0), n))
    guard("AM demod (AGC-bound)", lambda: speed_test(
        AMDemod(12000.0, 24000.0), na))

    # FFT-dependent kernels
    guard("FMIF NR 32", lambda: speed_test(FMIFNoiseReduction(32), na))

    class _Spec(Block):
        def __init__(self):
            self.s = SpectrumFFT(65536, 10e6, 10e6 / 65536)

        def __call__(self, state, x):
            return state, self.s(x)

    guard("Spectrum 64k-FFT", lambda: speed_test(_Spec(), n))

    class _Spec1M(Block):
        def __init__(self):
            self.s = SpectrumFFT(1 << 20, 100e6, 100e6 / (1 << 20))

        def __call__(self, state, x):
            return state, self.s(x)

    guard("Spectrum 1M-FFT", lambda: speed_test(_Spec1M(), 1 << 20, iters=10))

    # shared-FFT channelizer bank (the production VFO bank)
    from sdrpp_tpu.ops.channelizer import FFTChannelizerBank

    guard("FFT channelizer x64 /128", lambda: speed_test(
        FFTChannelizerBank(np.linspace(-2.4e6, 2.4e6, 64), 6144000.0,
                           48000.0, bandwidth=12500.0), n))

    # digital chains: clock recovery is the hardest sequential kernel
    from sdrpp_tpu.models.digital import GFSKDemod, MeteorDemod
    from sdrpp_tpu.ops.clock_recovery import MMClockRecovery

    guard("MM clock recovery sps=10", lambda: speed_test(
        MMClockRecovery(10.0, 0.001, 0.01, 0.01, complex_input=False),
        na, dtype=jnp.float32))
    guard("GFSK demod chain", lambda: speed_test(
        GFSKDemod(4800.0, 48000.0, 2400.0, rrc_tap_count=31, rrc_beta=0.5,
                  omega_gain=1e-6, mu_gain=0.01), na))
    guard("Meteor QPSK demod", lambda: speed_test(
        MeteorDemod(72000.0, 150000.0), na))
    # chunk-parallel Costas engages at blocks >= 2*warmup*128 samples
    guard("Meteor QPSK demod (chunked, 2^19)", lambda: speed_test(
        MeteorDemod(72000.0, 150000.0), 1 << 19, iters=5))

    print(report_table(results))


if __name__ == "__main__":
    main()
