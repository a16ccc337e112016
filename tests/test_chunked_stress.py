"""Chunked-loop approximation contracts BEYOND the happy path
(VERDICT r2 #2): AWGN at the SNRs the modes are specified for, clock-rate
offset near omega_rel_limit, carrier offset near the pull-in edge, and a
squelched (all-zero) warm-up window.

Measured bounds these tests pin (CPU, interpret mode, deterministic
seeds — margins ~2x the observed values):

- MM + AWGN at Eb/N0 = 5 dB (LRPT operates at 2-5 dB; below ~4 dB the
  EXACT loop itself degrades, so the approximation contract is pinned at
  the top of the band where the reference chain is healthy): windowed
  SER degradation of chunked vs exact <= 1% absolute (measured 0.3%),
  timing slips <= 2 (measured 1 vs 0).
- MM with the loop omega mis-set by 0.8% of the symbol rate
  (omega_rel_limit = 1%): both loops pull in; symbol count exact and
  decisions 100% identical (measured exactly that).
- Chunked Costas under AWGN with the carrier at 75% of the pull range:
  mod-pi/2 lock RMS within 10% + 0.02 rad of the exact loop at
  per-sample SNR >= 3 dB, both cold-start and in-lock (measured: equal
  to exact at 3 dB, BETTER at 1.5 dB). The lane freq seeding is a
  coherence-gated circular-mean M-th-power estimate: an incoherent
  (noisy or squelched) warm-up window falls back to the CARRIED loop
  frequency, so heavy noise cannot pull lanes to the clip rails.
- MM with a 3000-sample zero gap (squelch) covering multiple lane
  warm-up windows: no NaNs anywhere, and the tail (last quarter)
  re-locks to zero symbol errors vs ground truth (measured 0.0 for both
  loops; chunked lanes re-seed data-aided after the gap while the exact
  loop free-runs through it, so their symbol COUNTS may differ by a few
  inside the gap region).
"""

import numpy as np
import jax
import jax.numpy as jnp

from sdrpp_tpu.ops import taps as taps_mod
from sdrpp_tpu.ops.clock_recovery import MMClockRecovery
from sdrpp_tpu.ops.clock_recovery_chunked import MMClockRecoveryChunked
from sdrpp_tpu.ops import scans_pallas as SP
from sdrpp_tpu.ops.scans_pallas import CostasChunked, CostasPallas


def _qpsk_shaped(n2, fs=150000.0, rs=72000.0, seed=5, ebn0_db=None,
                 matched_filter=True):
    """RRC-shaped QPSK at the meteor rates (exact 25/12 fractional
    timing), optional AWGN at a given Eb/N0 + receiver matched filter."""
    up, down = 25, 12
    rng = np.random.default_rng(seed)
    n_hi = n2 * down
    nsym = n_hi // up + 8
    tx = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, nsym)))
    imp = np.zeros(n_hi, np.complex64)
    imp[::up] = tx[:len(imp[::up])]
    h = taps_mod.root_raised_cosine_rate(up * 8 + 1, 0.35, rs, fs * down)
    sig = np.convolve(imp, h, mode="same")[::down][:n2]
    sig = (sig / np.abs(sig).max()).astype(np.complex64)
    sps = fs / rs
    if ebn0_db is not None:
        es = np.mean(np.abs(sig) ** 2) * sps
        n0 = es / (2 * 10 ** (ebn0_db / 10.0))
        sigma = np.sqrt(n0 / 2)
        noise = (rng.standard_normal(n2) + 1j * rng.standard_normal(n2)
                 ).astype(np.complex64) * sigma
        sig = (sig + noise).astype(np.complex64)
        if matched_filter:
            hr = taps_mod.root_raised_cosine_rate(31, 0.35, rs, fs)
            sig = np.convolve(sig, hr, mode="same").astype(np.complex64)
    return sig, tx, sps


def _quant(z):
    return np.round((np.angle(z) - np.pi / 4) / (np.pi / 2)).astype(int) % 4


def _windowed_ser(got, tx, win=4096, srch=6):
    """Per-window SER vs the transmitted symbols with a tracked alignment
    offset (a timing slip moves the offset; a global offset comparison
    would smear one slip over the whole stream). Returns (sers, offsets)."""
    gq, tq = _quant(got), _quant(tx)
    sers, offs, off = [], [], 0
    for s in range(win, len(gq) - win, win):
        best, boff = 1.0, off
        for o in range(off - srch, off + srch + 1):
            if s + o < 0 or s + win + o > len(tq):
                continue
            e = np.mean(gq[s:s + win] != tq[s + o:s + win + o])
            if e < best:
                best, boff = e, o
        off = boff
        sers.append(best)
        offs.append(boff)
    return np.array(sers), np.array(offs)


def _run_mm(mm, sig, blocks=2):
    st = mm.init_state()
    out = []
    n = len(sig) // blocks
    for i in range(blocks):
        st, (s, v) = jax.jit(mm)(st, jnp.asarray(sig[i * n:(i + 1) * n]))
        out.append(np.asarray(s)[np.asarray(v).astype(bool)])
    return np.concatenate(out), st


def test_mm_chunked_awgn_bounded_degradation():
    """Eb/N0 = 5 dB (LRPT band top): chunked SER within 1% absolute of
    the exact loop, at most 2 timing slips (exact has 0)."""
    sig, tx, sps = _qpsk_shaped(1 << 18, ebn0_db=5.0)
    kw = dict(omega=sps, omega_gain=0.001, mu_gain=0.01,
              omega_rel_limit=0.01, complex_input=True)
    r, _ = _run_mm(MMClockRecovery(**kw), sig)
    c, _ = _run_mm(MMClockRecoveryChunked(**kw, warmup=512), sig)
    sr, offr = _windowed_ser(r, tx)
    sc, offc = _windowed_ser(c, tx)
    assert sr.mean() < 0.03, sr.mean()  # the exact loop is healthy here
    assert sc.mean() <= sr.mean() + 0.01, (sc.mean(), sr.mean())
    assert np.abs(np.diff(offc)).sum() <= 2, offc
    assert np.abs(np.diff(offr)).sum() <= 1, offr


def test_mm_chunked_clock_rate_offset_near_limit():
    """Loop omega mis-set 0.8% high with omega_rel_limit = 1%: both loops
    pull in to the true rate; counts match and decisions are identical."""
    sig, tx, sps = _qpsk_shaped(1 << 18)
    kw = dict(omega=sps * 1.008, omega_gain=0.001, mu_gain=0.01,
              omega_rel_limit=0.01, complex_input=True)
    r, s1 = _run_mm(MMClockRecovery(**kw), sig)
    c, s2 = _run_mm(MMClockRecoveryChunked(**kw, warmup=512), sig)
    assert abs(len(r) - len(c)) <= 1, (len(r), len(c))
    m = min(len(r), len(c))
    qr, qc = _quant(r[500:m]), _quant(c[500:m])
    assert np.mean(qr == qc) == 1.0
    # both converged to the true symbol period
    assert abs(float(s1["freq"]) - sps) < 1e-3, float(s1["freq"])
    assert abs(float(s2["freq"]) - sps) < 1e-3, float(s2["freq"])


def test_mm_chunked_squelched_warmup_gap():
    """A 3000-sample zero gap (squelched stretch) spanning several lane
    warm-up windows: no NaNs in outputs or carry, and the tail re-locks
    to zero errors vs ground truth."""
    sig, tx, sps = _qpsk_shaped(1 << 17, seed=9)
    sigg = sig.copy()
    sigg[60000:63000] = 0
    kw = dict(omega=sps, omega_gain=0.001, mu_gain=0.01,
              omega_rel_limit=0.01, complex_input=True)

    def tail_ser(got):
        gq, tq = _quant(got), _quant(tx)
        s = 3 * len(gq) // 4
        best = 1.0
        for o in range(-30, 31):
            if s + o < 0 or s + o + (len(gq) - s) > len(tq):
                continue
            best = min(best, np.mean(gq[s:] != tq[s + o:s + o + len(gq) - s]))
        return best

    for cls, extra in [(MMClockRecovery, {}),
                       (MMClockRecoveryChunked, dict(warmup=512))]:
        mm = cls(**kw, **extra)
        got, st = _run_mm(mm, sigg, blocks=1)
        assert not np.isnan(got).any()
        assert not any(np.isnan(np.asarray(v)).any()
                       for v in jax.tree_util.tree_leaves(st))
        assert tail_ser(got) < 1e-3, (cls.__name__, tail_ser(got))


def _qpsk_nrz(n, fo, phi0=0.3, sps=8, seed=11, noise=0.0):
    rng = np.random.default_rng(seed)
    syms = rng.integers(0, 4, size=n // sps + 2)
    mod = np.repeat(np.pi / 4 + np.pi / 2 * syms, sps)[:n]
    x = np.exp(1j * (mod + fo * np.arange(n) + phi0)).astype(np.complex64)
    if noise:
        x += noise * (rng.standard_normal(n)
                      + 1j * rng.standard_normal(n)).astype(np.complex64)
    return x


def test_costas_chunked_awgn_near_pullin_edge():
    """Carrier at 75% of the pull range under AWGN (per-sample SNR 3 dB
    ~= Es/N0 12 dB at 8 sps): the chunked loop's mod-pi/2 lock RMS stays
    within 10% + 0.02 rad of the exact loop's, cold-start AND in-lock,
    and both converge to the same frequency. (Before the coherence-gated
    circular-mean seeding, noisy lanes were dragged to the clip rails.)"""
    n, W, fo = 1 << 17, 512, 0.015
    for namp, init_freq in [(0.3, 0.0), (0.5, 0.0), (0.5, fo)]:
        kw = dict(order=4, bandwidth=0.01, min_freq=-0.02, max_freq=0.02,
                  init_freq=init_freq)
        x = _qpsk_nrz(2 * n, fo=fo, noise=namp)
        true_ph = fo * np.arange(2 * n) + 0.3
        ref = CostasPallas(**kw, interpret=True)
        chk = CostasChunked(**kw, warmup=W, max_lanes=512, interpret=True)
        s1, s2 = ref.init_state(), chk.init_state()
        for i in range(2):
            blk = jnp.asarray(x[i * n:(i + 1) * n])
            s1, y1 = ref(s1, blk)
            s2, y2 = chk(s2, blk)
        rms = {}
        for nm, y in [("exact", np.asarray(y1)), ("chunked", np.asarray(y2))]:
            lo = np.angle(x[n:]) - np.angle(y)
            err = np.angle(np.exp(4j * (lo - true_ph[n:]))) / 4
            rms[nm] = np.sqrt(np.mean(err ** 2))
        assert rms["chunked"] <= rms["exact"] * 1.1 + 0.02, (namp, rms)
        assert abs(float(s2["freq"]) - float(s1["freq"])) < 2e-3, \
            (namp, float(s1["freq"]), float(s2["freq"]))


def test_costas_chunked_squelched_warmup_window():
    """Lanes whose warm-up window is all zeros (squelched gap) must not
    produce NaNs and must fall back to the carried frequency (the
    coherence gate: atan2(0,0) coherence = 0 < 0.5)."""
    n, W, fo = 1 << 17, 512, 0.01
    x = _qpsk_nrz(n, fo=fo)
    xg = x.copy()
    xg[40000:44000] = 0
    kw = dict(order=4, bandwidth=0.01, min_freq=-0.02, max_freq=0.02,
              init_freq=fo)
    chk = CostasChunked(**kw, warmup=W, max_lanes=512, interpret=True)
    st, y = chk(chk.init_state(), jnp.asarray(xg))
    y = np.asarray(y)
    assert not np.isnan(y).any()
    assert not any(np.isnan(np.asarray(v)).any()
                   for v in jax.tree_util.tree_leaves(st))
    # post-gap: locked again (mod-pi/2 error small in the last quarter)
    true_ph = fo * np.arange(n) + 0.3
    lo = np.angle(x[3 * n // 4:]) - np.angle(y[3 * n // 4:])
    err = np.angle(np.exp(4j * (lo - true_ph[3 * n // 4:]))) / 4
    assert np.sqrt(np.mean(err ** 2)) < 0.05, np.sqrt(np.mean(err ** 2))


def test_meteor_chain_awgn_chunked_vs_exact(monkeypatch):
    """Chain-level (RRC -> AGC -> Costas -> chunked MM) at Eb/N0 = 5 dB:
    decisions agree with the exact-MM chain within 3% (common noise
    flips borderline symbols both ways) with zero relative timing
    slips."""
    from sdrpp_tpu.models.digital import MeteorDemod

    sig, tx, sps = _qpsk_shaped(1 << 18, ebn0_db=5.0, matched_filter=False)

    def run(engage):
        monkeypatch.setattr(SP, "LOOPS_MODE", "auto" if engage else "exact")
        d = MeteorDemod(costas_bandwidth=0.01, agc_rate=0.01)
        st = d.init_state()
        out = []
        nb = len(sig) // 2
        for i in range(2):
            st, (s, v) = jax.jit(d)(st, jnp.asarray(sig[i * nb:(i + 1) * nb]))
            out.append(np.asarray(s)[np.asarray(v).astype(bool)])
        return np.concatenate(out)

    r, c = run(False), run(True)
    rq, cq = _quant(r), _quant(c)
    win, srch = 4096, 6
    mism, offs, off = [], [], 0
    for s in range(win, min(len(rq), len(cq)) - win - srch, win):
        best, boff = 1.0, off
        for o in range(off - srch, off + srch + 1):
            if s + o < 0:
                continue
            d = (cq[s:s + win] - rq[s + o:s + win + o]) % 4
            e = 1.0 - np.bincount(d, minlength=4).max() / win
            if e < best:
                best, boff = e, o
        off = boff
        mism.append(best)
        offs.append(boff)
    mism, offs = np.array(mism), np.array(offs)
    assert mism.mean() <= 0.03, mism.mean()
    # at 5 dB a borderline seam symbol may insert/delete once vs the
    # exact loop (the loop-level AWGN bound above allows 2 slips)
    assert np.abs(np.diff(offs)).sum() <= 1, offs
