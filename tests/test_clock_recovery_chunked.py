"""Chunk-parallel MM clock recovery contract
(ops/clock_recovery_chunked.py).

The M&M loop slews timing at only mu_gain*err per symbol (a tracker, not
an acquirer), so lanes seed data-aided (Oerder-Meyr square-law over the
warm-up window; lane 0 continues the carried grid). The contract on a
timing-locked shaped-PSK stream:

- emitted symbol COUNT matches the sequential loop exactly (the
  position-sort + omega/2 dedup absorbs seam straddles);
- symbol DECISIONS match 100% and values to interpolation tolerance;
- short blocks / SDRPP_TPU_LOOPS=exact fall back to the sequential
  kernel (to its established 2e-5 tolerance), still carrying the
  warm-up history.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from sdrpp_tpu.ops import taps as taps_mod
from sdrpp_tpu.ops.clock_recovery import MMClockRecovery
from sdrpp_tpu.ops.clock_recovery_chunked import MMClockRecoveryChunked


def _bpsk_real(n2, fs=48000.0, rs=4800.0, seed=5):
    sps = fs / rs
    rng = np.random.default_rng(seed)
    nsym = int(n2 / sps) + 16
    bits = rng.integers(0, 2, size=nsym) * 2.0 - 1.0
    imp = np.zeros(n2, np.float32)
    pos = (np.arange(nsym) * sps).astype(int)
    pos = pos[pos < n2]
    imp[pos] = bits[:len(pos)]
    h = taps_mod.root_raised_cosine_rate(101, 0.5, rs, fs)
    sig = np.convolve(imp, h, mode="same").astype(np.float32)
    return sig / np.abs(sig).max(), sps


def _qpsk_cplx(n2, fs=150000.0, rs=72000.0, seed=5):
    # exact fractional symbol timing: 25x upsample then /12 decimate
    up, down = 25, 12
    rng = np.random.default_rng(seed)
    n_hi = n2 * down
    nsym = n_hi // up + 8
    c = np.exp(1j * (np.pi / 4 + np.pi / 2
                     * rng.integers(0, 4, size=nsym)))
    imp = np.zeros(n_hi, np.complex64)
    imp[::up] = c[:len(imp[::up])]
    h = taps_mod.root_raised_cosine_rate(up * 8 + 1, 0.35, rs, fs * down)
    sig = np.convolve(imp, h, mode="same")[::down][:n2]
    return (sig / np.abs(sig).max()).astype(np.complex64), fs / rs


def _run_pair(sig, ref, chk, blocks=2):
    n = sig.shape[0] // blocks
    s1, s2 = ref.init_state(), chk.init_state()
    r_all, c_all = [], []
    for i in range(blocks):
        blk = jnp.asarray(sig[i * n:(i + 1) * n])
        s1, (y1, v1) = ref(s1, blk)
        s2, (y2, v2) = chk(s2, blk)
        r_all.append(np.asarray(y1)[np.asarray(v1).astype(bool)])
        c_all.append(np.asarray(y2)[np.asarray(v2).astype(bool)])
    return np.concatenate(r_all), np.concatenate(c_all), s1, s2


def test_mm_chunked_float_matches_sequential():
    sig, sps = _bpsk_real(1 << 18)
    kw = dict(omega=sps, omega_gain=0.001, mu_gain=0.01,
              omega_rel_limit=0.01, complex_input=False)
    r, c, _, s2 = _run_pair(sig, MMClockRecovery(**kw),
                            MMClockRecoveryChunked(**kw, warmup=512))
    assert abs(len(r) - len(c)) <= 1, (len(r), len(c))
    m = min(len(r), len(c))
    assert np.mean(np.sign(r[200:m]) == np.sign(c[200:m])) == 1.0
    assert np.mean(np.abs(r[200:m] - c[200:m])) < 0.05
    assert s2["hist"].shape == (512 + 7,)


def test_mm_chunked_complex_matches_sequential():
    sig, sps = _qpsk_cplx(1 << 18)
    kw = dict(omega=sps, omega_gain=0.001, mu_gain=0.01,
              omega_rel_limit=0.01, complex_input=True)
    r, c, _, _ = _run_pair(sig, MMClockRecovery(**kw),
                           MMClockRecoveryChunked(**kw, warmup=512))
    assert abs(len(r) - len(c)) <= 1, (len(r), len(c))
    m = min(len(r), len(c))
    qr = np.floor(np.angle(r[500:m]) / (np.pi / 2)).astype(int) % 4
    qc = np.floor(np.angle(c[500:m]) / (np.pi / 2)).astype(int) % 4
    assert np.mean(qr == qc) == 1.0
    assert np.mean(np.abs(r[500:m] - c[500:m])) < 0.05


def test_mm_chunked_falls_back_on_short_blocks():
    sig, sps = _bpsk_real(1024)  # <= 2*W: chunking cannot win, exact path
    kw = dict(omega=sps, omega_gain=0.001, mu_gain=0.01,
              omega_rel_limit=0.01, complex_input=False)
    ref = MMClockRecovery(**kw)
    chk = MMClockRecoveryChunked(**kw, warmup=512)
    s1, (y1, v1) = ref(ref.init_state(), jnp.asarray(sig))
    s2, (y2, v2) = chk(chk.init_state(), jnp.asarray(sig))
    y1 = np.asarray(y1)[np.asarray(v1).astype(bool)]
    y2 = np.asarray(y2)[np.asarray(v2).astype(bool)]
    # same sequential scan
    np.testing.assert_allclose(y1, y2, rtol=0, atol=2e-5)
    np.testing.assert_allclose(np.asarray(s2["hist"])[-8192:],
                               sig[-(512 + 7):], atol=1e-6)


def test_mm_chunked_exact_mode_is_sequential(monkeypatch):
    import sdrpp_tpu.ops.scans_pallas as SP

    monkeypatch.setattr(SP, "LOOPS_MODE", "exact")
    sig, sps = _bpsk_real(1 << 17)
    kw = dict(omega=sps, omega_gain=0.001, mu_gain=0.01,
              omega_rel_limit=0.01, complex_input=False)
    ref = MMClockRecovery(**kw)
    chk = MMClockRecoveryChunked(**kw, warmup=512)
    s1, (y1, v1) = ref(ref.init_state(), jnp.asarray(sig))
    s2, (y2, v2) = chk(chk.init_state(), jnp.asarray(sig))
    y1 = np.asarray(y1)[np.asarray(v1).astype(bool)]
    y2 = np.asarray(y2)[np.asarray(v2).astype(bool)]
    np.testing.assert_allclose(y1, y2, rtol=0, atol=2e-5)


def test_mm_chunked_positions_strictly_monotone():
    """The dedup invariant: emitted positions are strictly increasing
    with gaps in (omega/2, 3*omega/2) on a locked stream — no doubles,
    no drops, chronological order."""
    from sdrpp_tpu.ops.clock_recovery_chunked import mm_symbols_chunked

    sig, sps = _bpsk_real(1 << 17)
    kw = dict(omega=sps, omega_gain=0.001, mu_gain=0.01,
              omega_rel_limit=0.01, complex_input=False)
    chk = MMClockRecoveryChunked(**kw, warmup=512)
    st = chk.init_state()
    syms, valid, pos, carry = mm_symbols_chunked(
        jnp.asarray(sig), st["hist"], st["offset"], st["phase"],
        st["freq"], st["last"], chk.bank, chk.mu_gain, chk.omega_gain,
        chk.min_freq, chk.max_freq, lanes_k=128, warmup=512)
    pos = np.asarray(pos)[np.asarray(valid).astype(bool)]
    d = np.diff(pos)
    # skip the cold-start region where the sequential grid (lane 0) and
    # the data-aided lanes may disagree before lock
    d = d[200:]
    assert d.min() > sps / 2, d.min()
    assert d.max() < 1.5 * sps, d.max()


def test_mm_chunked_no_seam_loss_with_lane_padding():
    """Two r4 regressions, caught on a realistic RRC-shaped QPSK stream
    at meteor's omega ~2.083 (reference meteor_demod.h:150-167 rates):

    1. When K*ceil(n/K) > n, lane K-1's payload tail is replicate
       padding; its emit ceiling must exclude it or the carry maps to
       buf n + pad and every block seam silently drops pad/omega REAL
       symbols (measured: 41/block at n=62500, K=122).
    2. Per-lane freq integrators let data-driven M&M self-noise spread
       lane offsets past the static interpolation band, making leader
       lanes silently stop emitting (measured: 149 more symbols lost
       per block). The shared ensemble integrator bounds the spread.

    Together these cost ~0.6%/block — fatal for framed downstreams
    (LRPT Viterbi, M17). Contract: per-block counts exact to +-2."""
    from sdrpp_tpu.ops.resample import RRCInterpolator

    rng = np.random.default_rng(5)
    nsym = 60000
    ph = np.pi / 4 + np.pi / 2 * rng.integers(0, 4, nsym)
    sh = RRCInterpolator(72000.0, 150000.0, 0.35, rrc_tap_count=31,
                         dtype=jnp.complex64)
    wave = np.asarray(sh(sh.init_state(),
                         jnp.asarray(np.exp(1j * ph).astype(np.complex64)))[1])
    wave = wave.astype(np.complex64)
    wave += 0.02 * (rng.standard_normal(len(wave))
                    + 1j * rng.standard_normal(len(wave))).astype(np.complex64)
    # matched filter so the MM sees symbol-shaped pulses
    from sdrpp_tpu.ops import taps as taps_mod
    from sdrpp_tpu.ops.fir import FIR
    mf = FIR(taps_mod.root_raised_cosine_rate(31, 0.35, 72000., 150000.),
             dtype=jnp.complex64)
    y = np.asarray(mf(mf.init_state(), jnp.asarray(wave))[1])
    y = (y / np.abs(y).max()).astype(np.complex64)

    omega = 150000.0 / 72000.0
    chk = MMClockRecoveryChunked(omega, 0.001, 0.01, 0.01,
                                 complex_input=True)
    bs = len(y) // 2                       # 62500: pad = 86 at K = 122
    assert chk._lanes_for(bs) * (-(-bs // chk._lanes_for(bs))) > bs, \
        "test must exercise a padded lane layout"
    st = chk.init_state()
    for i in range(2):
        st, (syms, valid) = chk(st, jnp.asarray(y[i * bs:(i + 1) * bs]))
        cnt = int(np.asarray(valid).astype(bool).sum())
        assert abs(cnt - bs / omega) <= 3, (i, cnt, bs / omega)
    # the carry must continue the grid, not skip the padding
    assert int(np.asarray(st["offset"])) < int(np.ceil(omega)) + 1


def test_mm_chunked_max_symbols_matches_kernel_output():
    """max_symbols must replicate the kernel's ADAPTIVE group size (M in
    {8,16,32} from the warm-up span), not the static _GROUP=32 ceiling:
    M17's omega=10 gives M=8, where rounding msc to 32 would report a
    length the kernel never produces — preallocating callers would
    shape-mismatch."""
    for omega in (10.0, 4.0, 2.0):  # M = 8, 16, 32 respectively
        kw = dict(omega=omega, omega_gain=0.001, mu_gain=0.01,
                  omega_rel_limit=0.01, complex_input=False)
        chk = MMClockRecoveryChunked(**kw, warmup=512)
        n = 1 << 15
        sig = np.random.default_rng(0).standard_normal(n).astype(np.float32)
        _, (syms, valid) = chk(chk.init_state(), jnp.asarray(sig))
        assert syms.shape[-1] == chk.max_symbols(n), \
            (omega, syms.shape[-1], chk.max_symbols(n))
        assert valid.shape[-1] == chk.max_symbols(n)


def test_mm_chunked_engages_midsize_block():
    """8k blocks now chunk (k = 16 sub-tile lanes, the round-2 dead
    zone): same count, 100% matching decisions vs the sequential loop.
    Interpolated VALUES carry a looser bound than the 2^18-block contract
    (0.12 vs 0.05 mean abs): short lane payloads (~51 symbols at k=16)
    leave more of each lane still converging toward the exact loop's
    timing trajectory — decisions are unaffected, and modes that consume
    soft symbols (LRPT) run 2^19+ blocks where the tight bound holds."""
    sig, sps = _bpsk_real(1 << 15)
    kw = dict(omega=sps, omega_gain=0.001, mu_gain=0.01,
              omega_rel_limit=0.01, complex_input=False)
    chk = MMClockRecoveryChunked(**kw, warmup=512)
    assert chk._lanes_for(1 << 13) == 16
    r, c, _, _ = _run_pair(sig, MMClockRecovery(**kw), chk, blocks=4)
    assert abs(len(r) - len(c)) <= 1, (len(r), len(c))
    m = min(len(r), len(c))
    assert np.mean(np.sign(r[200:m]) == np.sign(c[200:m])) == 1.0
    assert np.mean(np.abs(r[200:m] - c[200:m])) < 0.12


def test_mm_chunked_nondefault_tap_count():
    """The coarse predictor's 2-tap interpolation rows derive from the
    bank's (T-1)//2 group delay, not the default-T=8 literals — a
    non-default interp_tap_count must still track and emit the full
    symbol count (found by review: rows 3/4 were hardcoded)."""
    sig, sps = _bpsk_real(1 << 18)
    kw = dict(omega=sps, omega_gain=0.001, mu_gain=0.01,
              omega_rel_limit=0.01, complex_input=False,
              interp_tap_count=6)
    r, c, _, _ = _run_pair(sig, MMClockRecovery(**kw),
                           MMClockRecoveryChunked(**kw, warmup=512))
    assert abs(len(r) - len(c)) <= 1, (len(r), len(c))
    m = min(len(r), len(c))
    assert np.mean(np.sign(r[200:m]) == np.sign(c[200:m])) == 1.0
    assert np.mean(np.abs(r[200:m] - c[200:m])) < 0.05


@pytest.mark.parametrize("n,chunked", [(1 << 15, True), (1024, False)])
def test_mm_chunked_gate(n, chunked):
    """The chunked MM is plain XLA, so no kernel or interpret flag gates
    it: a long 1-D block takes the chunk-parallel path on any backend (its
    output length is the lane layout's), a short one the sequential
    scan (the base class's length)."""
    import jax

    sig, sps = _bpsk_real(n)
    kw = dict(omega=sps, omega_gain=0.001, mu_gain=0.01,
              omega_rel_limit=0.01, complex_input=False)
    chk = MMClockRecoveryChunked(**kw, warmup=512)
    base = MMClockRecovery(**kw)
    assert (chk._lanes_for(n) >= 1) == chunked
    assert (chk.max_symbols(n) != base.max_symbols(n)) == chunked
    _, (y, v) = jax.jit(chk)(chk.init_state(), jnp.asarray(sig))
    assert y.shape == v.shape == (chk.max_symbols(n),)
