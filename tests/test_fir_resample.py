"""FIR / decimator / polyphase resampler parity vs. NumPy oracles that
replicate the reference's sliding-correlation semantics exactly."""

import numpy as np
import jax.numpy as jnp
import pytest

from sdrpp_tpu.ops import fir, resample, taps


def ref_fir_process(history, x, t):
    """Reference FIR::process semantics (fir.h:67-84): correlation over
    buffer = [history | x], returns (new_history, y)."""
    m = len(t)
    buf = np.concatenate([history, x])
    y = np.array([np.dot(buf[i : i + m], t) for i in range(len(x))])
    return buf[len(x):], y


def ref_decim_fir(history, x, t, r, offset=0):
    """Reference DecimatingFIR::process (decimating_fir.h:49-69)."""
    m = len(t)
    buf = np.concatenate([history, x])
    outs = []
    while offset < len(x):
        outs.append(np.dot(buf[offset : offset + m], t))
        offset += r
    return buf[len(x):], np.array(outs), offset - len(x)


def test_fir_matches_reference_real():
    rng = np.random.default_rng(0)
    t = taps.low_pass(3000.0, 2000.0, 48000.0).astype(np.float64)
    x = rng.standard_normal(512).astype(np.float32)
    hist = np.zeros(len(t) - 1, np.float32)
    _, want = ref_fir_process(hist, x, t.astype(np.float32))

    blk = fir.FIR(t.astype(np.float32), dtype=jnp.float32)
    st = blk.init_state()
    st, got = blk(st, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(got), want, atol=2e-5)


def test_fir_matches_reference_complex_multiblock():
    rng = np.random.default_rng(1)
    t = taps.low_pass(3000.0, 2000.0, 48000.0).astype(np.float32)
    x = (rng.standard_normal(1024) + 1j * rng.standard_normal(1024)).astype(np.complex64)

    hist = np.zeros(len(t) - 1, np.complex64)
    blk = fir.FIR(t, dtype=jnp.complex64)
    st = blk.init_state()
    for blk_x in (x[:512], x[512:]):
        hist, want = ref_fir_process(hist, blk_x, t)
        st, got = blk(st, jnp.asarray(blk_x))
        np.testing.assert_allclose(np.asarray(got), want, atol=5e-5)


def test_fir_complex_taps():
    rng = np.random.default_rng(2)
    t = taps.band_pass(18750.0, 19250.0, 6000.0, 250000.0, complex_taps=True)
    n = 256
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    hist = np.zeros(len(t) - 1, np.complex64)
    _, want = ref_fir_process(hist, x, t)
    blk = fir.FIR(t, dtype=jnp.complex64)
    st, got = blk(blk.init_state(), jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-4)


@pytest.mark.parametrize("r", [2, 4, 8])
def test_decimating_fir_matches_reference(r):
    rng = np.random.default_rng(3)
    stages = resample.decim_plan(r)
    t = stages[0][1]
    n = 64 * r
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    hist = np.zeros(len(t) - 1, np.complex64)
    _, want, off = ref_decim_fir(hist, x, t, r)
    assert off == 0  # block length multiple of r keeps phase invariant

    blk = fir.DecimatingFIR(t, r, dtype=jnp.complex64)
    st, got = blk(blk.init_state(), jnp.asarray(x))
    assert got.shape[-1] == n // r
    np.testing.assert_allclose(np.asarray(got), want, atol=5e-5)


def test_power_decimator_cascade():
    rng = np.random.default_rng(4)
    ratio = 8
    n = 1024
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    pd = resample.PowerDecimator(ratio)
    st, y = pd(pd.init_state(), jnp.asarray(x))
    assert y.shape[-1] == n // ratio

    # Oracle: run each stage's reference decim FIR in sequence.
    cur = x
    for r, t in resample.decim_plan(ratio):
        hist = np.zeros(len(t) - 1, np.complex64)
        _, cur, _ = ref_decim_fir(hist, cur, t, r)
    np.testing.assert_allclose(np.asarray(y), cur, atol=1e-4)


def test_polyphase_bank_layout():
    t = np.arange(10, dtype=np.float32)
    bank = resample.build_polyphase_bank(t, 3)
    # tpp = ceil(10/3) = 4; bank[(3-1)-(i%3)][i//3] = t[i]
    assert bank.shape == (3, 4)
    want = np.zeros((3, 4), np.float32)
    for i in range(12):
        want[2 - (i % 3), i // 3] = t[i] if i < 10 else 0
    np.testing.assert_array_equal(bank, want)


def ref_polyphase_resample(x, interp, decim, t):
    """Reference PolyphaseResampler::process (polyphase_resampler.h:75-92)."""
    bank = resample.build_polyphase_bank(t, interp)
    tpp = bank.shape[1]
    buf = np.concatenate([np.zeros(tpp - 1, x.dtype), x])
    outs = []
    phase, offset = 0, 0
    while offset < len(x):
        outs.append(np.dot(buf[offset : offset + tpp], bank[phase]))
        phase += decim
        offset += phase // interp
        phase %= interp
    return np.array(outs)


@pytest.mark.parametrize("interp,decim", [(2, 3), (3, 2), (5, 4), (147, 160)])
def test_polyphase_resampler_matches_reference(interp, decim):
    rng = np.random.default_rng(5)
    t = taps.low_pass(0.25, 0.1, 1.0) * interp
    n = 4 * decim * max(1, 512 // (4 * decim))
    if n % decim:
        n = decim * 8
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    want = ref_polyphase_resample(x, interp, decim, t)

    pr = resample.PolyphaseResampler(interp, decim, t)
    st, got = pr(pr.init_state(), jnp.asarray(x))
    assert got.shape[-1] == n * interp // decim == len(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-4)


def test_rational_resampler_plan_wfm():
    # 240 kHz -> 48 kHz: pure power-of-2? 240/48=5: predec 4, then 60->48:
    # gcd(60000,48000)=12000, interp 4 decim 5.
    rr = resample.RationalResampler(240000.0, 48000.0)
    assert rr.plan["pre_ratio"] == 4
    assert rr.plan["interp"] == 4 and rr.plan["decim"] == 5
    n = rr.block_multiple * 100
    assert rr.out_count(n) == n * 48000 // 240000


def test_rational_resampler_end_to_end_tone():
    fs_in, fs_out = 96000.0, 48000.0
    rr = resample.RationalResampler(fs_in, fs_out)
    n = rr.block_multiple * 2048
    tt = np.arange(n) / fs_in
    f0 = 1000.0
    x = np.exp(2j * np.pi * f0 * tt).astype(np.complex64)
    st = rr.init_state()
    st, y = rr(st, jnp.asarray(x))
    y = np.asarray(y)
    assert y.shape[-1] == rr.out_count(n)
    # Measure output tone frequency via FFT peak (skip transient).
    seg = y[len(y) // 2 :]
    spec = np.abs(np.fft.fft(seg))
    k = np.argmax(spec)
    freq = k / len(seg) * fs_out
    assert abs(freq - f0) < fs_out / len(seg) * 2


def test_rrc_interpolator_pulse_shaping():
    from sdrpp_tpu.ops.resample import RRCInterpolator
    rng = np.random.default_rng(9)
    rrc = RRCInterpolator(4800.0, 48000.0, 0.5, 9, dtype=jnp.float32)
    syms = (rng.integers(0, 2, 500) * 2.0 - 1.0).astype(np.float32)
    st, y = rrc(rrc.init_state(), jnp.asarray(syms))
    y = np.asarray(y)
    assert y.shape[0] == 500 * 10
    S = np.abs(np.fft.rfft(y * np.hanning(len(y)))) ** 2
    f = np.fft.rfftfreq(len(y), 1 / 48000)
    inb = S[f < 3800].sum()
    outb = S[f > 5000].sum()
    assert 10 * np.log10(inb / outb) > 30


def test_decimating_fir_conv_path_matches_unrolled():
    """The strided-lax.conv decimator (SDRPP_TPU_DECIM=conv) must match the
    unrolled polyphase form bit-closely for every dtype/taps combo."""
    import sdrpp_tpu.ops.fir as F

    rng = np.random.default_rng(42)
    old = F.DECIM_MODE
    try:
        for r, m, n in [(2, 11, 64), (4, 23, 128), (16, 64, 512), (2, 2, 16)]:
            for cplx_x, cplx_t in [(True, False), (False, False), (True, True)]:
                x = rng.standard_normal(n).astype(np.float32)
                if cplx_x:
                    x = (x + 1j * rng.standard_normal(n)).astype(np.complex64)
                taps = rng.standard_normal(m).astype(np.float32)
                if cplx_t:
                    taps = (taps + 1j * rng.standard_normal(m)) \
                        .astype(np.complex64)
                tail = jnp.asarray(np.zeros(m - 1, x.dtype))
                F.DECIM_MODE = "unrolled"
                t1, y1 = F.decimating_fir_correlate(tail, jnp.asarray(x),
                                                    taps, r)
                F.DECIM_MODE = "conv"
                t2, y2 = F.decimating_fir_correlate(tail, jnp.asarray(x),
                                                    taps, r)
                np.testing.assert_allclose(np.asarray(y1), np.asarray(y2),
                                           atol=2e-5, rtol=2e-5)
                np.testing.assert_array_equal(np.asarray(t1), np.asarray(t2))
                # leading channel axis (the VFO-bank layout)
                xb = jnp.stack([jnp.asarray(x)] * 3)
                tb = jnp.stack([tail] * 3)
                _, yb = F.decimating_fir_correlate(tb, xb, taps, r)
                np.testing.assert_allclose(np.asarray(yb[2]), np.asarray(y2),
                                           atol=2e-5, rtol=2e-5)
    finally:
        F.DECIM_MODE = old


def test_mix_bank_product_path_matches_angle():
    """The phasor-product LO synthesis (SDRPP_TPU_MIX=product) must match the
    wrapped-angle cos/sin form, including the carried phase."""
    import sdrpp_tpu.ops.mix as M

    rng = np.random.default_rng(7)
    old = M.MIX_MODE
    try:
        n, c = 8192, 5
        x = (rng.standard_normal(n)
             + 1j * rng.standard_normal(n)).astype(np.complex64)
        omegas = rng.uniform(-3, 3, c)
        phase = jnp.asarray(rng.uniform(0, 2 * np.pi, c).astype(np.float32))
        M.MIX_MODE = "angle"
        p1, y1 = M.mix_bank(phase, jnp.asarray(x), omegas)
        # two blocks: phase carry must agree too
        p1b, y1b = M.mix_bank(p1, jnp.asarray(x), omegas)
        M.MIX_MODE = "product"
        p2, y2 = M.mix_bank(phase, jnp.asarray(x), omegas)
        p2b, y2b = M.mix_bank(p2, jnp.asarray(x), omegas)
        np.testing.assert_allclose(np.asarray(p1b), np.asarray(p2b), atol=1e-5)
        np.testing.assert_allclose(np.asarray(y1), np.asarray(y2),
                                   atol=3e-5, rtol=3e-5)
        np.testing.assert_allclose(np.asarray(y1b), np.asarray(y2b),
                                   atol=3e-5, rtol=3e-5)
        # LO stays unit magnitude (no drift)
        mag = np.abs(np.asarray(y2b)) / np.abs(x)[None, :]
        np.testing.assert_allclose(mag, 1.0, atol=1e-5)
    finally:
        M.MIX_MODE = old
