"""Headline benchmark: wideband IQ through a FULL receive chain, end-to-end.

1. WIDEBAND (the headline ``value``): a 1.572864 Gsps synthetic wideband
   block through the complete receive chain — power-of-2 decimation
   cascade (/256, the IQFrontEnd preprocessor role,
   core/src/signal_path/iq_frontend.cpp:230-249) -> 64-channel shared-FFT
   channelizer (the RxVFO bank, rx_vfo.h:102-114) -> per-channel Squelch
   (the radio IF-chain scan stage, radio_module.h:68-79) -> quadrature
   NFM demod -> per-channel audio FIR. ``value`` = INPUT-samples/s
   consumed by the whole chain: every input sample passes through every
   stage.

2. AGGREGATE, SSB, METEOR, MUTE: the same 64-channel NFM bank at
   6.144 Msps (channels x input-rate), a 64-channel SSB bank with
   Squelch + auto AGC, the meteor LRPT front half, and the NFM bank with
   the squelch mute engaged on half the channels.

Timing: N serially-dependent steps inside ONE jit, waited on with
``block_until_ready``, minus a 1-step run. Anti-inflation: the checksum
reduces over the ENTIRE output (a partial slice lets XLA dead-code-
eliminate the chain body), and each scan iteration's input is salted with
the carried checksum so stateless sub-chains cannot be loop-hoisted.

Needs a GPU: without one it exits non-zero and prints no result. Prints
ONE JSON line naming the device (platform, device_kind, count) and the
card's power limit.
"""

import json
import sys
import time

import numpy as np

CHANNELS = 64
IF_RATE = 48000.0
BANDWIDTH = 12500.0
FS_MID = 6144000.0            # channelizer input rate (R = 128)
PRE_DECIM = 256               # wideband front decimation
FS_WIDE = FS_MID * PRE_DECIM  # 1.572864 Gsps


def _make_bank():
    """The 64-channel NFM scanner bank (BASELINE config #4's chain,
    scan stages INSIDE the measured path: per-channel Squelch between
    the channelizer and the demod, the radio module's IF-chain position,
    decoder_modules/radio/src/radio_module.h:68-79)."""
    import jax.numpy as jnp

    from sdrpp_tpu.ops.channelizer import FFTChannelizerBank
    from sdrpp_tpu.ops.fm import Quadrature
    from sdrpp_tpu.ops.fir import FIR
    from sdrpp_tpu.ops.scans import Squelch
    from sdrpp_tpu.ops import taps as taps_mod

    offsets = np.linspace(-FS_MID * 0.4, FS_MID * 0.4, CHANNELS)
    # shared-FFT channelizer (SURVEY §2.5): one wideband FFT +
    # per-channel pruned frequency-domain mix/filter/decimate — verified
    # against the time-domain mix -> FIR -> decimate oracle to 5e-5
    # (tests/test_channelizer.py).
    vfo = FFTChannelizerBank(offsets, FS_MID, IF_RATE, bandwidth=BANDWIDTH)
    # level far below the noise floor: the squelch state machine runs its
    # full per-frame compute but stays OPEN, so the chain's demod work is
    # not skipped (a muted chain would be an inflation trap the other way)
    squelch = Squelch(-100.0, sub_blocks=1, lead_shape=(CHANNELS,))
    demod = Quadrature(BANDWIDTH / 2.0, IF_RATE, lead_shape=(CHANNELS,))
    audio_taps = taps_mod.low_pass(BANDWIDTH / 2.0, BANDWIDTH * 0.05, IF_RATE)
    audio_fir = FIR(audio_taps, dtype=jnp.float32, lead_shape=(CHANNELS,))
    return vfo, squelch, demod, audio_fir


def _make_ssb_bank():
    """BASELINE config #4's actual mode family: a 64-channel SSB bank —
    channelizer -> per-channel Squelch -> SSB product demod with the
    radio module's auto AGC (attack 50/fs, decay 5/fs; ssb.h:9-134)."""
    from sdrpp_tpu.ops.channelizer import FFTChannelizerBank
    from sdrpp_tpu.ops.scans import Squelch
    from sdrpp_tpu.models.analog import SSBDemod

    offsets = np.linspace(-FS_MID * 0.4, FS_MID * 0.4, CHANNELS)
    vfo = FFTChannelizerBank(offsets, FS_MID, IF_RATE, bandwidth=BANDWIDTH)
    squelch = Squelch(-100.0, sub_blocks=1, lead_shape=(CHANNELS,))
    demod = SSBDemod(mode="usb", bandwidth=2700.0, samplerate=IF_RATE,
                     lead_shape=(CHANNELS,))
    return vfo, squelch, demod


def _measure(step, make_state, x, iters: int) -> float:
    """Seconds per step: (T_N - T_1)/(N - 1) with a compile/warm run."""
    import jax

    state = make_state()

    def run(k):
        t0 = time.perf_counter()
        st = state
        for _ in range(k):
            st, c = step(st, x)
        jax.block_until_ready(c)
        return time.perf_counter() - t0

    run(1)  # compile + warm + prove the chain executes end-to-end
    t1 = run(1)
    tn = run(iters)
    return max((tn - t1) / (iters - 1), 1e-9)


def _bench_wideband() -> float:
    """Input-samples/s of the FULL chain: /256 decim -> bank -> demod.

    SDRPP_TPU_PREDECIM selects the decimator formulation: "cascade"
    (time-domain plan cascade, the default) or "fft" (FFTPowerDecimator —
    the /256 folded into one batched overlap-save FFT with spectral
    alias-fold; equivalence pinned by tests/test_fft_decimator.py). Which
    one the GPU prefers is not measured yet (ROADMAP S3)."""
    import os

    import jax
    import jax.numpy as jnp

    from sdrpp_tpu.ops.resample import FFTPowerDecimator, PowerDecimator

    mode = os.environ.get("SDRPP_TPU_PREDECIM", "cascade")
    vfo, squelch, demod, audio_fir = _make_bank()

    # ~2^24 wideband samples per chain block (2^22 on CPU to keep the
    # fallback path inside its deadline); K blocks inside ONE jit.
    if mode == "fft":
        pre = FFTPowerDecimator(PRE_DECIM, fft_len=1 << 20,
                                out_multiple=vfo.block_multiple)
        segs = 16  # ~2^24 wideband samples
        n = segs * pre.block_multiple
        tile = 4  # n_base = segs/tile payloads
    else:
        pre = PowerDecimator(PRE_DECIM)
        n = 1 << 24
        tile = 4
    n_base = n // tile
    assert (n // PRE_DECIM) % vfo.block_multiple == 0
    K = 8

    rng = np.random.default_rng(0)
    base = jnp.asarray(rng.standard_normal((2, n_base)).astype(np.float32))

    @jax.jit
    def step(state, xb):
        def body(carry, _):
            st, salt = carry
            # in-graph wideband block: tile the uploaded base (pure HBM
            # copy; chain compute untouched) + carried-checksum salt so
            # no iteration is loop-invariant
            x = jnp.tile(xb, (1, tile)) + salt
            x = jax.lax.complex(x[0], x[1])
            ps, x = pre(st[0], x)
            vs, y = vfo(st[1], x)
            ss, y = squelch(st[2], y)
            qs, y = demod(st[3], y)
            fs, y = audio_fir(st[4], y)
            c = jnp.sum(y.astype(jnp.float32))
            return ((ps, vs, ss, qs, fs), c * np.float32(1e-20)), c

        (state, _), cs = jax.lax.scan(body, (state, jnp.float32(0.0)),
                                      None, length=K)
        return state, jnp.sum(cs)

    make_state = jax.jit(lambda: (pre.init_state(), vfo.init_state(),
                                  squelch.init_state(), demod.init_state(),
                                  audio_fir.init_state()))
    per_step = _measure(step, make_state, base,
                        iters=16)
    return K * n / per_step


def _bench_aggregate() -> float:
    """The round-1 metric: channels x input-rate through the bank."""
    import jax
    import jax.numpy as jnp

    vfo, squelch, demod, audio_fir = _make_bank()
    n = 1 << 18
    assert n % vfo.block_multiple == 0
    K = 8

    rng = np.random.default_rng(0)
    # IQ is uploaded as split float32; the complex view is formed in-graph
    x = jnp.asarray(rng.standard_normal((K, 2, n)).astype(np.float32))

    @jax.jit
    def step(state, xk):
        def body(st, xs):
            x = jax.lax.complex(xs[0], xs[1])
            vs, y = vfo(st[0], x)
            ss, y = squelch(st[1], y)
            qs, y = demod(st[2], y)
            fs, y = audio_fir(st[3], y)
            # full reduction: a partial slice would let XLA dead-code-
            # eliminate most of the chain
            return (vs, ss, qs, fs), jnp.sum(y.astype(jnp.float32))

        state, sums = jax.lax.scan(body, state, xk)
        return state, jnp.sum(sums)

    make_state = jax.jit(lambda: (vfo.init_state(), squelch.init_state(),
                                  demod.init_state(), audio_fir.init_state()))
    per_step = _measure(step, make_state, x, iters=16)
    return K * CHANNELS * n / per_step


def _bench_meteor() -> float:
    """BASELINE config #5's front half: the full MeteorDemod chain
    (RRC matched filter -> FastAGC -> Costas QPSK -> chunk-parallel MM
    clock recovery) on a 2^20-sample 1-D block — input-samples/s.

    The checksum consumes EVERYTHING the real LRPT consumer consumes
    (symbols re/im AND the valid mask), each weighted by position:
    the MM reorders/compacts data, and a permutation-invariant sum
    would let XLA delete the merge (the r3 hidden-sort trap)."""
    import jax
    import jax.numpy as jnp

    from sdrpp_tpu.models.digital import MeteorDemod

    demod = MeteorDemod()  # 72 ksym QPSK at 150 kHz, meteor module params
    n = 1 << 20
    K = 4

    # RRC-shaped QPSK base so the loops run in their locked regime (the
    # compute is data-independent, but lock keeps freq/offset dynamics in
    # the production envelope)
    rng = np.random.default_rng(2)
    sps = 150000.0 / 72000.0
    nsym = int(n / sps) + 4
    ph = np.pi / 4 + np.pi / 2 * rng.integers(0, 4, nsym)
    tsym = np.floor(np.arange(n) / sps).astype(int)
    iq = np.exp(1j * ph)[np.clip(tsym, 0, nsym - 1)]
    base = jnp.asarray(np.stack([iq.real, iq.imag]).astype(np.float32))

    msym = demod.max_symbols(n)
    iota = jnp.arange(msym, dtype=jnp.float32) * np.float32(1e-6)

    @jax.jit
    def step(state, xb):
        def body(carry, _):
            st, salt = carry
            x = jax.lax.complex(xb[0] + salt, xb[1])
            ds, (syms, valid) = demod(st, x)
            c = jnp.sum(syms.real * iota) + jnp.sum(syms.imag * iota) \
                + jnp.sum(valid.astype(jnp.float32) * iota)
            return (ds, c * np.float32(1e-20)), c

        (state, _), cs = jax.lax.scan(body, (state, jnp.float32(0.0)),
                                      None, length=K)
        return state, jnp.sum(cs)

    make_state = jax.jit(demod.init_state)
    per_step = _measure(step, make_state, base, iters=8)
    return K * n / per_step


def _bench_squelch_mute():
    """The NFM bank with the squelch mute branch ENGAGED in the measured
    path: half the channels carry a strong tone, half
    sit at the noise floor, threshold between — so the hysteresis /
    unmute-counter state machine actually mutes on-device. Returns
    (channels*input-rate samples/s, muted_ok) where muted_ok asserts the
    below-threshold channels produced all-zero audio."""
    import jax
    import jax.numpy as jnp

    from sdrpp_tpu.ops.channelizer import FFTChannelizerBank
    from sdrpp_tpu.ops.fm import Quadrature
    from sdrpp_tpu.ops.fir import FIR
    from sdrpp_tpu.ops.scans import Squelch
    from sdrpp_tpu.ops import taps as taps_mod

    offsets = np.linspace(-FS_MID * 0.4, FS_MID * 0.4, CHANNELS)
    vfo = FFTChannelizerBank(offsets, FS_MID, IF_RATE, bandwidth=BANDWIDTH)
    squelch = Squelch(-50.0, sub_blocks=1, lead_shape=(CHANNELS,))
    demod = Quadrature(BANDWIDTH / 2.0, IF_RATE, lead_shape=(CHANNELS,))
    audio_taps = taps_mod.low_pass(BANDWIDTH / 2.0, BANDWIDTH * 0.05,
                                   IF_RATE)
    audio_fir = FIR(audio_taps, dtype=jnp.float32, lead_shape=(CHANNELS,))

    n = 1 << 18
    assert n % vfo.block_multiple == 0
    K = 8

    # even channels: strong FM carrier well above -50 dB; odd channels:
    # noise floor around -80 dB -> squelch must OPEN evens, MUTE odds
    rng = np.random.default_rng(3)
    t = np.arange(n) / FS_MID
    x = (1e-4 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)))
    for ch in range(0, CHANNELS, 2):
        fm = np.exp(1j * (2 * np.pi * offsets[ch] * t
                          + 0.5 * np.sin(2 * np.pi * 1000.0 * t)))
        x = x + 0.25 * fm
    x = np.stack([x.real, x.imag]).astype(np.float32)
    xk = jnp.asarray(np.broadcast_to(x, (K, 2, n)).copy())

    @jax.jit
    def step(state, xs):
        def body(st, xb):
            x = jax.lax.complex(xb[0], xb[1])
            vs, y = vfo(st[0], x)
            ss, y = squelch(st[1], y)
            qs, y = demod(st[2], y)
            fs, y = audio_fir(st[3], y)
            # per-channel |audio| sums: the mute assertion AND the
            # full-output checksum in one reduction
            per_ch = jnp.sum(jnp.abs(y.astype(jnp.float32)), axis=-1)
            return (vs, ss, qs, fs), per_ch

        state, per_ch = jax.lax.scan(body, state, xs)
        return state, jnp.sum(per_ch, axis=0)  # [CHANNELS]

    make_state = jax.jit(lambda: (vfo.init_state(), squelch.init_state(),
                                  demod.init_state(),
                                  audio_fir.init_state()))

    state = make_state()

    def run(k):
        t0 = time.perf_counter()
        st = state
        for _ in range(k):
            st, c = step(st, xk)
        c = np.asarray(c)  # sync via full [CHANNELS] f32 readback
        return time.perf_counter() - t0, c

    run(1)
    t1, per_ch = run(1)
    tn, _ = run(16)
    per_step = max((tn - t1) / (16 - 1), 1e-9)
    # squelch state carries across warm-up blocks, so by now odd channels
    # are muted: their audio must be EXACTLY zero on-device
    muted_ok = bool(np.all(per_ch[1::2] == 0.0)
                    and np.all(per_ch[0::2] > 0.0))
    return K * CHANNELS * n / per_step, muted_ok


def _bench_ssb() -> float:
    """BASELINE config #4's mode family: the 64-channel SSB bank with
    Squelch + auto AGC inside the measured path (channels x input-rate)."""
    import jax
    import jax.numpy as jnp

    vfo, squelch, demod = _make_ssb_bank()
    n = 1 << 18
    assert n % vfo.block_multiple == 0
    K = 8

    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((K, 2, n)).astype(np.float32))

    @jax.jit
    def step(state, xk):
        def body(st, xs):
            x = jax.lax.complex(xs[0], xs[1])
            vs, y = vfo(st[0], x)
            ss, y = squelch(st[1], y)
            ds, y = demod(st[2], y)
            return (vs, ss, ds), jnp.sum(y.astype(jnp.float32))

        state, sums = jax.lax.scan(body, state, xk)
        return state, jnp.sum(sums)

    make_state = jax.jit(lambda: (vfo.init_state(), squelch.init_state(),
                                  demod.init_state()))
    per_step = _measure(step, make_state, x, iters=16)
    return K * CHANNELS * n / per_step


def main() -> int:
    import jax

    from sdrpp_tpu.utils.platform import card_name_and_power_limit

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {devs[0].platform}",
              file=sys.stderr)
        return 1
    card = card_name_and_power_limit()
    wideband = _bench_wideband()
    aggregate = _bench_aggregate()
    ssb = _bench_ssb()
    meteor = _bench_meteor()
    mute_rate, muted_ok = _bench_squelch_mute()
    print(json.dumps({
        "metric": "wideband_e2e_iq_input_throughput",
        "value": wideband,
        "unit": "input-samples/s through the full chain",
        "aggregate_nfm_bank": aggregate,
        "ssb_bank": ssb,
        "meteor_chain": meteor,
        "nfm_bank_mute_engaged": mute_rate,
        "muted_ok": muted_ok,
        "device": {"platform": devs[0].platform,
                   "kind": devs[0].device_kind, "count": len(devs)},
        "card": card,
    }))
    return 0 if muted_ok else 1


if __name__ == "__main__":
    sys.exit(main())
