"""On-card smoke test: the receive chain's main paths at full size on one
GPU, each kernel compiled for the card and compared with its plain
reference.

    python chip_smoke.py [--seed N]      # one card, every phase
    python chip_smoke.py --cards 4       # the sharded paths on four cards

Each phase prints one line: its name, ok/FAIL, what it checked and its
wall time (compilation included). A line before the last gives the
card's name and power limit; the last line is one JSON object with
``ok`` and the device as JAX reports it. The script exits non-zero, and
prints no result, when JAX finds no GPU; any failed phase makes the exit
code non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


class CheckFailed(AssertionError):
    pass


def _check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def _tone_snr_db(y, fs, f):
    """SNR of a tone at ``f`` in real signal ``y``: power within 3 bins of
    the tone over the rest of the spectrum (DC excluded)."""
    y = np.asarray(y, np.float64)
    y = y - y.mean()
    spec = np.abs(np.fft.rfft(y * np.hanning(len(y)))) ** 2
    k = int(round(f * len(y) / fs))
    sig = spec[k - 3:k + 4].sum()
    return 10 * np.log10(sig / max(spec[4:].sum() - sig, 1e-30))


def _diff_snr_db(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return 10 * np.log10(np.sum(ref ** 2)
                         / max(np.sum((ref - got) ** 2), 1e-300))


def _fm(n, fs, f_carrier, dev, f_audio, t0=0):
    """Complex FM carrier at ``f_carrier`` (Hz, baseband) modulated by a
    tone; phase in float64 on the host, wrapped before the cast."""
    t = (np.arange(n) + t0) / fs
    ph = 2 * np.pi * f_carrier * t + (dev / f_audio) * np.sin(
        2 * np.pi * f_audio * t)
    return np.exp(1j * np.mod(ph, 2 * np.pi)).astype(np.complex64)


def _timed(fn, *args):
    """Run ``fn`` once to compile, then once more timed (s)."""
    import jax
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def plain_loops():
    """Trace the loop blocks as their lax.scan forms (the kernel's
    plain reference) for the duration: the A/B of the lane kernel."""
    from sdrpp_tpu.models import digital
    from sdrpp_tpu.ops import scans_pallas
    saved = (scans_pallas.pallas_gpu_supported, digital.pallas_gpu_supported)
    scans_pallas.pallas_gpu_supported = lambda: False
    digital.pallas_gpu_supported = lambda: False
    try:
        yield
    finally:
        scans_pallas.pallas_gpu_supported, digital.pallas_gpu_supported = \
            saved


# --------------------------------------------------------------------------
# one-card phases


def phase_wideband(seed, n=1 << 24, blocks=3):
    """bench.py's headline chain: 1.572864 Gsps, /256 cascade, 64-channel
    shared-FFT channelizer, squelch, NFM, audio FIR. A synthetic NFM tone
    in one channel must come out at its audio frequency."""
    import jax
    import jax.numpy as jnp

    import bench
    from sdrpp_tpu.ops.resample import PowerDecimator

    pre = PowerDecimator(bench.PRE_DECIM)
    vfo, squelch, demod, audio_fir = bench._make_bank()
    ch, f_aud = 21, 48000.0 * 32 / 1024  # tone on an FFT bin of the check
    f_ch = float(np.linspace(-bench.FS_MID * 0.4, bench.FS_MID * 0.4,
                             bench.CHANNELS)[ch])

    @jax.jit
    def step(st, xs):
        x = jax.lax.complex(xs[0], xs[1])
        ps, x = pre(st[0], x)
        vs, y = vfo(st[1], x)
        ss, y = squelch(st[2], y)
        qs, y = demod(st[3], y)
        fs_, y = audio_fir(st[4], y)
        return (ps, vs, ss, qs, fs_), y

    st = jax.jit(lambda: (pre.init_state(), vfo.init_state(),
                          squelch.init_state(), demod.init_state(),
                          audio_fir.init_state()))()
    outs, times = [], []
    for b in range(blocks):
        iq = _fm(n, bench.FS_WIDE, f_ch, 2500.0, f_aud, t0=b * n)
        xs = jnp.asarray(np.stack([iq.real, iq.imag]))
        t0 = time.perf_counter()
        st, y = step(st, xs)
        y = jax.block_until_ready(y)
        times.append(time.perf_counter() - t0)
        outs.append(np.asarray(y))
    # the filters' start-up takes ~400 audio samples (10 ms): skip 512
    y = np.concatenate(outs, axis=-1)[:, 512:]
    _check(np.all(np.isfinite(y)), "non-finite audio")
    _check(y.shape == (bench.CHANNELS, blocks * n // 256 // 128 - 512),
           f"shape {y.shape}")
    snr = _tone_snr_db(y[ch], bench.IF_RATE, f_aud)
    _check(snr > 30.0, f"tone SNR {snr:.1f} dB")
    per_block = min(times[1:])
    return (f"64-ch audio {y.shape}, ch{ch} {f_aud:.0f} Hz tone SNR "
            f"{snr:.1f} dB > 30; steady block {per_block * 1e3:.2f} ms = "
            f"{n / per_block / 1e9:.3f} Gsamp/s, real-time x"
            f"{n / bench.FS_WIDE / per_block:.2f}")


def _ssb_run(n, blocks, ch, f_tone):
    import jax
    import jax.numpy as jnp

    import bench

    vfo, squelch, demod = bench._make_ssb_bank()
    f_ch = float(np.linspace(-bench.FS_MID * 0.4, bench.FS_MID * 0.4,
                             bench.CHANNELS)[ch])

    @jax.jit
    def step(st, xs):
        x = jax.lax.complex(xs[0], xs[1])
        vs, y = vfo(st[0], x)
        ss, y = squelch(st[1], y)
        ds, y = demod(st[2], y)
        return (vs, ss, ds), y

    st = jax.jit(lambda: (vfo.init_state(), squelch.init_state(),
                          demod.init_state()))()
    # the USB demod shifts its passband up by bandwidth/2 = 1350 Hz
    # (ssb.h), so the tone sits f_tone - 1350 Hz above the channel centre
    t = np.arange(n * blocks) / bench.FS_MID
    f_in = f_ch + f_tone - 1350.0
    iq = (0.5 * np.exp(2j * np.pi * np.mod(f_in * t, 1.0))
          ).astype(np.complex64)
    outs, times = [], []
    for b in range(blocks):
        seg = iq[b * n:(b + 1) * n]
        xs = jnp.asarray(np.stack([seg.real, seg.imag]))
        t0 = time.perf_counter()
        st, y = step(st, xs)
        y = jax.block_until_ready(y)
        times.append(time.perf_counter() - t0)
        outs.append(np.asarray(y))
    return np.concatenate(outs, axis=-1), min(times[1:])


def phase_ssb_bank(seed, n=1 << 18, blocks=4):
    """bench.py's 64-channel SSB bank (squelch + auto AGC; the AGC runs
    in the lane kernel at [64, n/128]) against the same chain with the
    loops as lax.scan."""
    import bench

    ch, f_tone = 40, 1500.0
    y, t_kernel = _ssb_run(n, blocks, ch, f_tone)
    with plain_loops():
        y_ref, t_scan = _ssb_run(n, blocks, ch, f_tone)
    _check(np.all(np.isfinite(y)), "non-finite audio")
    m = y.shape[-1] // 2
    snr = _tone_snr_db(y[ch, m:], bench.IF_RATE, f_tone)
    _check(snr > 30.0, f"tone SNR {snr:.1f} dB")
    # the AGC amplifies 1-ulp differences at isolated samples, so the
    # chains are compared by the SNR of their difference
    d_snr = _diff_snr_db(y_ref, y)
    _check(d_snr > 40.0, f"kernel vs lax.scan SNR of diff {d_snr:.1f} dB")
    return (f"audio {y.shape}, ch{ch} {f_tone:.0f} Hz SNR {snr:.1f} dB > 30; "
            f"vs lax.scan chain SNR of diff {d_snr:.1f} dB > 40; steady block "
            f"kernel {t_kernel * 1e3:.2f} ms vs lax.scan "
            f"{t_scan * 1e3:.2f} ms; real-time x"
            f"{n / bench.FS_MID / t_kernel:.1f}")


def phase_wfm_stereo(seed):
    """__graft_entry__.entry: WFM stereo RadioChannel at 960 kHz, two
    blocks, pilot PLL engaged: a left-only tone must come out on the left
    only, which needs the pilot PLL locked on the 19 kHz pilot."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__

    fn, (state, x0) = __graft_entry__.entry()
    n = x0.shape[-1]
    fs, f_off, f_l = 960000.0, 100000.0, 1000.0
    t = np.arange(2 * n) / fs
    left = np.sin(2 * np.pi * f_l * t)
    # broadcast MPX: pilot sin(wp t), L-R on sin(2 wp t)
    mpx = (0.45 * left + 0.1 * np.sin(2 * np.pi * 19000.0 * t)
           + 0.45 * left * np.sin(2 * np.pi * 38000.0 * t))
    ph = 2 * np.pi * f_off * t + 2 * np.pi * 75000.0 * np.cumsum(mpx) / fs
    iq = np.exp(1j * np.mod(ph, 2 * np.pi)).astype(np.complex64)
    step = jax.jit(fn)
    audio = []
    t0 = time.perf_counter()
    for b in range(2):
        seg = iq[b * n:(b + 1) * n]
        state, a = step(state, jnp.asarray(np.stack([seg.real, seg.imag])))
        audio.append(np.asarray(a))
    wall = time.perf_counter() - t0
    a = audio[1]
    _check(np.all(np.isfinite(a)) and a.ndim == 2 and a.shape[-1] == 2,
           f"audio shape {a.shape}")
    snr = _tone_snr_db(a[:, 0], 48000.0, f_l)
    sep = 10 * np.log10(np.mean(a[:, 0] ** 2) / max(np.mean(a[:, 1] ** 2),
                                                    1e-30))
    _check(snr > 20.0, f"left tone SNR {snr:.1f} dB")
    # L and R separate only when the pilot PLL tracks the 19 kHz pilot
    _check(sep > 10.0, f"stereo separation {sep:.1f} dB")
    return (f"audio {a.shape}, left {f_l:.0f} Hz SNR {snr:.1f} dB > 20, "
            f"L/R {sep:.1f} dB > 10 (pilot PLL locked); 2 blocks "
            f"{wall:.2f} s incl. compile")


def phase_decode_meteor(seed):
    """``python -m sdrpp_tpu decode meteor`` (in-process) on the committed
    capture: the VCDUs must equal the golden payload."""
    from sdrpp_tpu import cli

    wav = ROOT / "tests" / "data" / "meteor_lrpt_150000Hz.wav"
    golden = np.fromfile(ROOT / "tests" / "data" / "meteor_lrpt_payload.bin",
                         np.uint8).reshape(-1, 892)
    with tempfile.TemporaryDirectory() as d:
        out = Path(d) / "meteor.s"
        rc = cli.main(["decode", "meteor", "--source", str(wav),
                       "--out", str(out)])
        _check(not rc, f"cli rc {rc}")
        vcdus = np.fromfile(Path(d) / "meteor_vcdu.bin", np.uint8)
    _check(vcdus.size == golden.size, f"{vcdus.size // 892} VCDUs")
    _check(np.array_equal(vcdus.reshape(-1, 892), golden),
           "VCDUs differ from the golden payload")
    return f"{golden.shape[0]} VCDUs == tests/data/meteor_lrpt_payload.bin"


def _meteor_block(n, seed):
    rng = np.random.default_rng(seed)
    sps = 150000.0 / 72000.0
    nsym = int(n / sps) + 8
    sym = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, nsym)))
    k = np.floor(np.arange(n) / sps).astype(int)
    x = sym[np.clip(k, 0, nsym - 1)]
    x = x + 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return x.astype(np.complex64)


def _meteor_symbols(n, seed, blocks=2):
    import jax
    import jax.numpy as jnp

    from sdrpp_tpu.models.digital import MeteorDemod

    d = MeteorDemod(costas_bandwidth=0.01, agc_rate=0.01)
    step = jax.jit(d)
    st = jax.jit(d.init_state)()
    x = _meteor_block(n * blocks, seed)
    syms, times = [], []
    for b in range(blocks):
        xb = jnp.asarray(x[b * n:(b + 1) * n])
        t0 = time.perf_counter()
        st, (s, v) = step(st, xb)
        s = jax.block_until_ready(s)
        times.append(time.perf_counter() - t0)
        syms.append(np.asarray(s)[np.asarray(v).astype(bool)])
    return np.concatenate(syms), min(times[1:]) if blocks > 1 else times[0]


def phase_meteor_demod(seed, n=1 << 20):
    """MeteorDemod on 2^20-sample blocks (FastAGC and Costas in the lane
    kernel, chunk-parallel MM in plain XLA) against the same chain with
    lax.scan loops; real-time factor at 150 ksps."""
    syms, t_kernel = _meteor_symbols(n, seed)
    with plain_loops():
        ref, t_scan = _meteor_symbols(n, seed)
    _check(np.all(np.isfinite(syms)), "non-finite symbols")
    expect = 2 * n * 72000.0 / 150000.0
    _check(abs(len(syms) - expect) < 0.01 * expect, f"{len(syms)} symbols")
    m = min(len(syms), len(ref))
    q = lambda s: np.floor(np.angle(s) / (np.pi / 2)).astype(int) % 4  # noqa
    agree = float(np.mean(q(syms[1024:m]) == q(ref[1024:m])))
    _check(abs(len(syms) - len(ref)) <= 2 and agree > 0.99,
           f"kernel vs lax.scan: {len(syms)} vs {len(ref)} symbols, "
           f"{agree:.4f} decisions agree")
    return (f"{len(syms)} symbols from 2 blocks, decisions vs lax.scan chain "
            f"{agree:.4f} > 0.99; block kernel {t_kernel * 1e3:.2f} ms vs "
            f"lax.scan {t_scan * 1e3:.2f} ms; real-time x"
            f"{n / 150000.0 / t_kernel:.1f}")


def _encode_bits(bits, polys, order):
    """Vectorised rate-1/2 convolutional encode of message bits (with the
    order+1 flush zeros appended), the same bits as ConvCode.encode."""
    b = np.concatenate([bits, np.zeros(order + 1, np.uint8)])
    out = np.zeros((len(b), len(polys)), np.uint8)
    for j, p in enumerate(polys):
        for i in range(order):
            if p >> i & 1:
                out[i:, j] ^= b[:len(b) - i]
    return out.reshape(-1)


def phase_viterbi_pass(seed, minutes=10.0, sym_rate=72000.0):
    """ConvCode.decode_soft_stream on the soft bits of a whole pass
    (10 minutes at 72 ksym/s, one trellis step per symbol), made from
    --seed: decoded bits == message, and a real-width slice == the exact
    decode."""
    import jax.numpy as jnp

    from sdrpp_tpu.models.lrpt import CCSDS_CONV_POLYS
    from sdrpp_tpu.ops.fec import ConvCode

    code = ConvCode(2, 7, CCSDS_CONV_POLYS)
    rng = np.random.default_rng(seed)
    nbits = int(minutes * 60 * sym_rate) - (code.order + 1)
    msg = rng.integers(0, 2, nbits).astype(np.uint8)
    coded = _encode_bits(msg, code.polys, code.order)
    ref_enc = np.unpackbits(code.encode(np.packbits(msg[:800])))
    _check(np.array_equal(coded[:1600], ref_enc[:1600]), "encoder mismatch")
    noise = rng.standard_normal(coded.size, dtype=np.float32)
    soft = np.clip(coded * np.float32(255.0) + np.float32(40.0) * noise,
                   0, 255)
    soft = np.round(soft).astype(np.uint8)
    del noise
    code.decode_soft_stream(soft)  # compiles the pass's program
    t0 = time.perf_counter()
    bits = code.decode_soft_stream(soft)
    wall = time.perf_counter() - t0
    ber = float(np.mean(bits[:nbits] != msg))
    _check(bits.shape == (nbits,) and ber == 0.0,
           f"{bits.shape} bits, BER {ber:.2e}")
    w = 1 << 16
    exact = np.asarray(code.decode_soft(jnp.asarray(soft[:2 * w]
                                                    .astype(np.float32))))
    stream = code.decode_soft_stream(soft[:2 * w])
    _check(np.array_equal(exact, stream), "stream != exact decode")
    return (f"{nbits} bits ({minutes:.0f} min at {sym_rate / 1e3:.0f} "
            f"ksym/s) decoded with BER 0; {w}-step slice == exact decode; "
            f"{wall:.2f} s, real-time x{minutes * 60 / wall:.0f}")


def phase_lane_kernel_vs_scan(seed, n1=1 << 16, bank=(64, 2048),
                              timing=((1 << 18), 3072)):
    """The lane kernel (Triton) against the lax.scan of ops/scans.py for
    every loop, exact form, 1-D 2^16 and [64, 2048] (the SSB bank's IF
    block); plus the timing at [64, 2^18] and meteor's chunked lanes."""
    import jax
    import jax.numpy as jnp

    from sdrpp_tpu.ops import scans as S
    from sdrpp_tpu.ops import scans_pallas as SP

    rng = np.random.default_rng(seed)
    worst = {}
    pairs = lambda ls: [  # noqa: E731
        ("PLL", S.PLL(0.01, init_freq=0.3, lead_shape=ls),
         SP.PLLPallas(0.01, init_freq=0.3, lead_shape=ls)),
        ("Costas2", S.Costas(2, 0.01, lead_shape=ls),
         SP.CostasPallas(2, 0.01, lead_shape=ls)),
        ("Costas4", S.Costas(4, 0.01, lead_shape=ls),
         SP.CostasPallas(4, 0.01, lead_shape=ls)),
        ("Costas8", S.Costas(8, 0.01, lead_shape=ls),
         SP.CostasPallas(8, 0.01, lead_shape=ls)),
        ("FastAGC", S.FastAGC(1.0, 10.0, 0.01, lead_shape=ls),
         SP.FastAGCPallas(1.0, 10.0, 0.01, lead_shape=ls)),
        ("AGC", S.AGC(1.0, 50 / 48e3, 5 / 48e3, 1e6, 10.0, lead_shape=ls),
         SP.AGCPallas(1.0, 50 / 48e3, 5 / 48e3, 1e6, 10.0, lead_shape=ls)),
    ]
    for shape in ((n1,), bank):
        x = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
        x = jnp.asarray((0.7 * x).astype(np.complex64))
        for name, ref, ker in pairs(shape[:-1]):
            _, y1 = jax.jit(ref)(ref.init_state(), x)
            _, y2 = jax.jit(ker)(ker.init_state(), x)
            err = float(jnp.max(jnp.abs(y1 - y2)))
            worst[name] = max(worst.get(name, 0.0), err)
    bad = {k: v for k, v in worst.items() if not v < 1e-3}
    _check(not bad, f"max |kernel - lax.scan| >= 1e-3: {bad}")

    # timing: the kernel vs the lax.scan of the same step
    agc = SP._agc_step(1.0, 50 / 48e3, 5 / 48e3, 1e6, 10.0)
    met = SP._costas_step("meteor", 0.005, 1e-4, -np.pi, np.pi)
    rows = []
    for name, step, k, lanes, steps, ns in (
            (f"AGC [64, {timing[0]}]", agc, 2, 64, timing[0], 2),
            (f"meteor Costas lanes 512 x {timing[1]}", met, 2, 512,
             timing[1], 2)):
        xs = [jnp.asarray(np.abs(rng.standard_normal((steps, lanes)))
                          .astype(np.float32)) for _ in range(ns)]
        s0 = jnp.ones((k, lanes), jnp.float32)
        kern = jax.jit(lambda s, *xs, step=step: SP.lane_scan(step, s, xs))
        scan = jax.jit(lambda s, *xs, step=step: jax.lax.scan(
            step, tuple(s), tuple(xs))[1])
        (ok_, _), tk = _timed(kern, s0, *xs)
        ref, ts = _timed(scan, s0, *xs)
        err = float(jnp.max(jnp.abs(ok_ - ref)))
        _check(err < 1e-3, f"{name}: |diff| {err:.2e}")
        rows.append(f"{name} kernel {tk * 1e3:.3f} ms vs lax.scan "
                    f"{ts * 1e3:.1f} ms")
    return ("max|kernel - lax.scan| " + ", ".join(
        f"{k} {v:.1e}" for k, v in worst.items()) + " (< 1e-3); "
        + "; ".join(rows))


def phase_mm_chunked_vs_exact(seed, n=1 << 20):
    """The chunk-parallel MM (plain XLA) against the exact sequential
    M&M loop on a matched-filtered meteor block: same symbol count, same
    decisions."""
    import jax
    import jax.numpy as jnp

    from sdrpp_tpu.ops.clock_recovery import MMClockRecovery
    from sdrpp_tpu.ops.clock_recovery_chunked import MMClockRecoveryChunked

    from sdrpp_tpu.models.digital import MeteorDemod

    kw = dict(omega=150000.0 / 72000.0, omega_gain=0.001, mu_gain=0.01,
              omega_rel_limit=0.01, complex_input=True)
    rrc = MeteorDemod().rrc  # the meteor chain's matched filter
    _, x = jax.jit(rrc)(jax.jit(rrc.init_state)(),
                        jnp.asarray(_meteor_block(n, seed)))
    out = {}
    for name, mm in (("exact", MMClockRecovery(**kw)),
                     ("chunked", MMClockRecoveryChunked(**kw))):
        f = jax.jit(mm)
        (st, (s, v)), t = _timed(f, jax.jit(mm.init_state)(), x)
        out[name] = (np.asarray(s)[np.asarray(v).astype(bool)], t)
    (r, tr), (c, tc) = out["exact"], out["chunked"]
    m = min(len(r), len(c))
    q = lambda s: np.floor(np.angle(s) / (np.pi / 2)).astype(int) % 4  # noqa
    agree = float(np.mean(q(r[512:m]) == q(c[512:m])))
    _check(abs(len(r) - len(c)) <= 2 and agree > 0.999,
           f"{len(r)} vs {len(c)} symbols, {agree:.4f} agree")
    return (f"{len(c)} vs {len(r)} symbols, decisions agree {agree:.5f} > "
            f"0.999; chunked {tc * 1e3:.2f} ms vs exact {tr * 1e3:.1f} ms")


ONE_CARD = [
    ("wideband_chain", phase_wideband),
    ("ssb_bank", phase_ssb_bank),
    ("wfm_stereo", phase_wfm_stereo),
    ("decode_meteor_cli", phase_decode_meteor),
    ("meteor_demod", phase_meteor_demod),
    ("viterbi_pass", phase_viterbi_pass),
    ("compare_lane_kernel", phase_lane_kernel_vs_scan),
    ("compare_mm_chunked", phase_mm_chunked_vs_exact),
]


# --------------------------------------------------------------------------
# four-card phases: each sharded path against its one-device result


def phase_sharded_bank(seed, cards=4, n=1 << 18):
    """ScannerBank.sharded_step over a 4-card channel mesh vs the same
    bank unsharded on one card; tolerance: audio SNR of the difference
    > 40 dB (the AGC amplifies 1-ulp compile-order differences)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    import bench
    from sdrpp_tpu.parallel.mesh import make_mesh
    from sdrpp_tpu.parallel.vfo_bank import ScannerBank

    offs = np.linspace(-bench.FS_MID * 0.4, bench.FS_MID * 0.4,
                       bench.CHANNELS)
    bank = ScannerBank(offs, bench.FS_MID, mode="usb", if_rate=48000.0,
                       bandwidth=2700.0, squelch_level=-120.0,
                       channelizer="fft")
    n = bank.block_multiple * (n // bank.block_multiple)
    rng = np.random.default_rng(seed)
    xs = [jnp.asarray((0.1 * (rng.standard_normal(n)
                              + 1j * rng.standard_normal(n)))
                      .astype(np.complex64)) for _ in range(2)]
    one = jax.jit(bank)
    st1 = jax.jit(bank.init_state)()
    mesh = make_mesh(cards, 1)
    step, specs = bank.sharded_step(mesh)
    st2 = jax.tree_util.tree_map(
        lambda l, s: jax.device_put(l, NamedSharding(mesh, s)),
        jax.jit(bank.init_state)(), specs)
    snrs = []
    for x in xs:
        st1, y1 = one(st1, x)
        st2, y2 = step(st2, x)
        _check(len(y2.sharding.device_set) == cards,
               f"output on {len(y2.sharding.device_set)} devices")
        snrs.append(_diff_snr_db(y1, y2))
    _, t = _timed(step, st2, xs[0])
    _check(min(snrs) > 40.0, f"SNR vs unsharded {snrs}")
    return (f"64-ch USB bank on {cards} cards vs 1: SNR of diff "
            f"{min(snrs):.1f} dB > 40 over 2 blocks; block {t * 1e3:.2f} ms")


def phase_time_shard(seed, cards=4, n=1 << 20):
    """parallel.time_shard NFM step over a 4-card 'time' mesh vs the
    plain chain (FrequencyXlator -> FIR -> Quadrature -> FIR) on one
    card; tolerance: max |diff| < 1e-3 over two blocks."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from sdrpp_tpu.ops import taps as taps_mod
    from sdrpp_tpu.ops.fir import FIR
    from sdrpp_tpu.ops.fm import Quadrature
    from sdrpp_tpu.ops.mix import FrequencyXlator
    from sdrpp_tpu.parallel.time_shard import make_time_step_nfm

    fs, f_ch, bw = 1024000.0, 200000.0, 12500.0
    mesh = Mesh(np.array(jax.devices()[:cards]), axis_names=("time",))
    step, init = make_time_step_nfm(mesh, f_ch, fs, bw, n)
    vfo = FrequencyXlator(-f_ch, fs)
    cfir = FIR(taps_mod.low_pass(bw / 2.0, bw * 0.05, fs))
    dm = Quadrature(bw / 2.0, fs)
    afir = FIR(taps_mod.low_pass(bw / 2.0, bw * 0.1, fs), dtype=jnp.float32)

    @jax.jit
    def plain(st, x):
        s0, y = vfo(st[0], x)
        s1, y = cfir(st[1], y)
        s2, y = dm(st[2], y)
        s3, y = afir(st[3], y)
        return (s0, s1, s2, s3), y

    pst = jax.jit(lambda: (vfo.init_state(), cfir.init_state(),
                           dm.init_state(), afir.init_state()))()
    tst = init()
    iq = _fm(2 * n, fs, f_ch, 3000.0, 1000.0)
    got, want = [], []
    for b in range(2):
        x = jnp.asarray(iq[b * n:(b + 1) * n])
        tst, y1 = step(tst, x)
        pst, y2 = plain(pst, x)
        _check(len(y1.sharding.device_set) == cards,
               f"output on {len(y1.sharding.device_set)} devices")
        got.append(np.asarray(y1))
        want.append(np.asarray(y2))
    # skip the filters' start-up, where the discriminator takes the angle
    # of near-zero samples and either chain may read any value
    skip = 4096
    err = float(np.max(np.abs(np.concatenate(got)[skip:]
                              - np.concatenate(want)[skip:])))
    _, t = _timed(step, tst, x)
    _check(err < 1e-3, f"max |diff| {err:.2e}")
    return (f"NFM time-sharded on {cards} cards vs plain chain: max|diff| "
            f"{err:.1e} < 1e-3 over 2 x {n} samples after {skip}; block "
            f"{t * 1e3:.2f} ms")


def phase_dist_fft(seed, cards=4, n=1 << 24):
    """parallel.dist_fft over a 4-card 'fft' mesh vs jnp.fft.fft on one
    card; tolerance: max |diff| / max |X| < 1e-5 (float32 FFT)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from sdrpp_tpu.parallel.dist_fft import dist_fft

    mesh = Mesh(np.array(jax.devices()[:cards]), axis_names=("fft",))
    rng = np.random.default_rng(seed)
    x = jnp.asarray((rng.standard_normal(n) + 1j * rng.standard_normal(n))
                    .astype(np.complex64))
    got, t = _timed(jax.jit(lambda v: dist_fft(v, mesh)), x)
    _check(len(got.sharding.device_set) == cards,
           f"output on {len(got.sharding.device_set)} devices")
    ref = jax.jit(jnp.fft.fft)(jax.device_put(x, jax.devices()[0]))
    scale = float(jnp.max(jnp.abs(ref)))
    err = float(np.max(np.abs(np.asarray(got) - np.asarray(ref)))) / scale
    _check(err < 1e-5, f"relative max |diff| {err:.2e}")
    return (f"{n}-point FFT on {cards} cards vs jnp.fft.fft: relative "
            f"max|diff| {err:.1e} < 1e-5; {t * 1e3:.2f} ms")


FOUR_CARD = [
    ("sharded_bank", phase_sharded_bank),
    ("time_shard_nfm", phase_time_shard),
    ("dist_fft", phase_dist_fft),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke needs a GPU; JAX found {devs[0].platform}",
              file=sys.stderr)
        return 2
    if len(devs) < args.cards:
        print(f"--cards {args.cards} needs {args.cards} GPUs; JAX found "
              f"{len(devs)}", file=sys.stderr)
        return 2

    from sdrpp_tpu.utils.compile_cache import enable_persistent_cache
    from sdrpp_tpu.utils.platform import card_name_and_power_limit

    enable_persistent_cache()
    card = card_name_and_power_limit()
    print(f"card: {card}", flush=True)
    phases = ONE_CARD if args.cards == 1 else FOUR_CARD
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            msg = fn(args.seed) if args.cards == 1 \
                else fn(args.seed, cards=args.cards)
            status = "ok"
        except Exception as e:  # report every phase; any failure fails the run
            msg, status = f"{type(e).__name__}: {e}", "FAIL"
            failed.append(name)
        print(f"{name}: {status} | {msg} | {time.perf_counter() - t0:.2f} s",
              flush=True)
    print(card, flush=True)
    if failed:
        print(f"failed phases: {', '.join(failed)}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
