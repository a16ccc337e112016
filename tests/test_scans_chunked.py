"""Chunk-parallel loop approximation contract (ops/scans_pallas.py).

The chunked PLL/AGC drivers cut a long block into K overlapping lanes that
each re-acquire over a W-sample warm-up window (the stream-Viterbi trick
from ops/fec.decode_soft_stream). These tests pin the documented
contract in interpret mode on CPU:

- on a locked signal, payload outputs match the exact sequential scan to
  small error once W >> 1/bandwidth (PLL) / 1/rate (AGC);
- the carried ``hist`` hands real history across blocks (no first-sample
  glitch on block 2);
- SDRPP_TPU_LOOPS=exact and short blocks fall back BIT-identically to the
  exact lane-kernel recurrence.
"""

import numpy as np
import jax.numpy as jnp

from sdrpp_tpu.ops.scans import FL_PI
from sdrpp_tpu.ops import scans_pallas as SP
from sdrpp_tpu.ops.scans_pallas import (AGCChunked, AGCPallas,
                                        FastAGCChunked, FastAGCPallas,
                                        PLLChunked, PLLPallas)

FS = 240000.0


def _hz(f):
    return np.float32(2.0 * np.pi * f / FS)


def _pilot_pll_pair(warmup, interpret=True):
    """Exact + chunked WFM-pilot-style PLLs (broadcast_fm.h:77-83 config)."""
    kw = dict(bandwidth=25000.0 / FS, init_phase=0.0, init_freq=_hz(19000.0),
              min_freq=_hz(18750.0), max_freq=_hz(19250.0))
    return (PLLPallas(**kw, interpret=interpret),
            PLLChunked(**kw, warmup=warmup, max_lanes=512,
                       interpret=interpret))


def _pilot_tone(n, seed=0, snr_amp=0.01):
    rng = np.random.default_rng(seed)
    ph = 2 * np.pi * 19000.0 * np.arange(n) / FS + 0.3
    return (np.exp(1j * ph) + snr_amp * (rng.standard_normal(n)
            + 1j * rng.standard_normal(n))).astype(np.complex64)


def test_pll_chunked_matches_exact_on_locked_pilot():
    n, W = 32768, 64
    x = _pilot_tone(2 * n)
    ref, chk = _pilot_pll_pair(W)
    s1, s2 = ref.init_state(), chk.init_state()
    for i in range(2):
        blk = jnp.asarray(x[i * n:(i + 1) * n])
        s1, y1 = ref(s1, blk)
        s2, y2 = chk(s2, blk)
        err = np.abs(np.asarray(y1) - np.asarray(y2))
        # tight lock: VCO phasor error stays at float32-accumulation noise
        assert err.max() < PLL_TOL, (i, err.max())
    # final carries land on the same lock point
    assert abs(float(s1["freq"]) - float(s2["freq"])) < 1e-4


# measured on the locked-pilot config above: max |Δphasor| = 3.6e-6 across
# both blocks (the 64-sample warm-up at bw=0.104 fully re-converges each
# lane; what remains is float32 rounding-path noise). 1e-4 gives ~30x
# headroom while staying far below a lost lock (which shows up as O(1)
# error).
PLL_TOL = 1e-4


def test_pll_chunked_block_seam_has_no_glitch():
    """Block 2's first payload samples come from lanes warmed on block 1's
    carried hist — the seam must be as accurate as the interior."""
    n, W = 32768, 64
    x = _pilot_tone(2 * n, seed=1)
    ref, chk = _pilot_pll_pair(W)
    s1, s2 = ref.init_state(), chk.init_state()
    s1, y1a = ref(s1, jnp.asarray(x[:n]))
    s2, y2a = chk(s2, jnp.asarray(x[:n]))
    s1, y1b = ref(s1, jnp.asarray(x[n:]))
    s2, y2b = chk(s2, jnp.asarray(x[n:]))
    seam = np.abs(np.asarray(y1b)[:256] - np.asarray(y2b)[:256])
    assert seam.max() < PLL_TOL, seam.max()


def test_fast_agc_chunked_matches_exact():
    n, W = 32768, 128
    rng = np.random.default_rng(2)
    # slowly-varying envelope on noise: the AGC's tracked gain is the
    # quantity that must match after warm-up
    env = (1.0 + 0.3 * np.sin(2 * np.pi * np.arange(2 * n) / n)).astype(np.float32)
    x = (env * (rng.standard_normal(2 * n) + 1j * rng.standard_normal(2 * n))
         ).astype(np.complex64)
    ref = FastAGCPallas(1.0, 1e4, 0.05, interpret=True)
    chk = FastAGCChunked(1.0, 1e4, 0.05, warmup=W, max_lanes=512,
                         interpret=True)
    s1, s2 = ref.init_state(), chk.init_state()
    for i in range(2):
        blk = jnp.asarray(x[i * n:(i + 1) * n])
        s1, y1 = ref(s1, blk)
        s2, y2 = chk(s2, blk)
        y1, y2 = np.asarray(y1), np.asarray(y2)
        denom = np.maximum(np.abs(y1), 1e-3)
        rel = (np.abs(y1 - y2) / denom)
        assert np.percentile(rel, 99) < FAST_AGC_TOL, (i, np.percentile(rel, 99))
    assert abs(float(s1) - float(s2["gain"])) / float(s1) < 0.05


FAST_AGC_TOL = 0.05


def test_agc_chunked_matches_exact():
    n, W = 32768, 256
    rng = np.random.default_rng(3)
    env = (1.0 + 0.5 * np.sin(2 * np.pi * np.arange(2 * n) / n)).astype(np.float32)
    x = (env * np.abs(rng.standard_normal(2 * n))).astype(np.float32)
    args = (1.0, 0.1, 0.05, 1e4, 10.0)
    ref = AGCPallas(*args, interpret=True)
    chk = AGCChunked(*args, warmup=W, max_lanes=512, interpret=True)
    s1, s2 = ref.init_state(), chk.init_state()
    for i in range(2):
        blk = jnp.asarray(x[i * n:(i + 1) * n])
        s1, y1 = ref(s1, blk)
        s2, y2 = chk(s2, blk)
        y1, y2 = np.asarray(y1), np.asarray(y2)
        denom = np.maximum(np.abs(y1), 1e-3)
        rel = np.abs(y1 - y2) / denom
        assert np.percentile(rel, 99) < AGC_TOL, (i, np.percentile(rel, 99))


AGC_TOL = 0.05


def test_chunked_exact_mode_is_bit_identical(monkeypatch):
    """SDRPP_TPU_LOOPS=exact routes every chunked block to the exact
    recurrence — outputs (and non-hist carries) bit-match the Pallas form."""
    monkeypatch.setattr(SP, "LOOPS_MODE", "exact")
    n = 32768
    x = jnp.asarray(_pilot_tone(n, seed=4))
    ref, chk = _pilot_pll_pair(64)
    s1, y1 = ref(ref.init_state(), x)
    s2, y2 = chk(chk.init_state(), x)
    np.testing.assert_array_equal(np.asarray(y1), np.asarray(y2))
    assert float(s1["phase"]) == float(s2["phase"])
    assert float(s1["freq"]) == float(s2["freq"])


def test_chunked_falls_back_exact_on_short_blocks():
    """Blocks too short to fit two warm-up lanes (k < 2) use the exact
    path — bit-identical, and the hist carry still updates."""
    n = 96  # < 2*W for W=64: no lane split possible
    x = jnp.asarray(_pilot_tone(n, seed=5))
    ref, chk = _pilot_pll_pair(64)
    s1, y1 = ref(ref.init_state(), x)
    s2, y2 = chk(chk.init_state(), x)
    np.testing.assert_array_equal(np.asarray(y1), np.asarray(y2))
    hist = np.asarray(s2["hist"])
    expected = np.angle(np.asarray(x)[-64:]).astype(np.float32)
    np.testing.assert_allclose(hist, expected, atol=1e-5)


def test_chunked_falls_back_on_batched_input():
    n, C = 96, 3  # blocks too short to chunk: exact lane-batched path
    x = np.stack([_pilot_tone(n, seed=6 + c) for c in range(C)])
    kw = dict(bandwidth=25000.0 / FS, init_phase=0.0, init_freq=_hz(19000.0),
              min_freq=_hz(18750.0), max_freq=_hz(19250.0), lead_shape=(C,))
    ref = PLLPallas(**kw, interpret=True)
    chk = PLLChunked(**kw, warmup=64, interpret=True)
    s1, y1 = ref(ref.init_state(), jnp.asarray(x))
    s2, y2 = chk(chk.init_state(), jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(y1), np.asarray(y2))
    assert s2["hist"].shape == (C, 64)


def test_agc_chunked_first_block_seed_matches_exact_init():
    """The synthetic init hist must land lane 0's seeds exactly on the
    exact loop's init_state (no cold-start divergence on block 1)."""
    chk = AGCChunked(1.0, 0.1, 0.05, 1e4, 10.0, init_gain=2.0,
                     warmup=64, interpret=True)
    st = chk.init_state()
    np.testing.assert_allclose(np.asarray(st["hist"]), 0.5)
    assert float(st["amp"]) == 0.5
    assert float(st["gain"]) == 2.0


def test_pll_chunked_batched_channels_match_exact():
    """[C, n] bank inputs chunk too (channels x lanes share the VPU lane
    axis): per-channel payloads match the exact lane-batched recurrence
    on locked pilots, and the hist carry keeps seams clean."""
    C, n, W = 4, 32768, 64
    x = np.stack([_pilot_tone(2 * n, seed=20 + c) for c in range(C)])
    kw = dict(bandwidth=25000.0 / FS, init_phase=0.0, init_freq=_hz(19000.0),
              min_freq=_hz(18750.0), max_freq=_hz(19250.0), lead_shape=(C,))
    ref = PLLPallas(**kw, interpret=True)
    chk = PLLChunked(**kw, warmup=W, max_lanes=512, interpret=True)
    s1, s2 = ref.init_state(), chk.init_state()
    assert s2["hist"].shape == (C, W)
    engaged = False
    for i in range(2):
        blk = jnp.asarray(x[:, i * n:(i + 1) * n])
        s1, y1 = ref(s1, blk)
        s2, y2 = chk(s2, blk)
        err = np.abs(np.asarray(y1) - np.asarray(y2))
        assert err.max() < PLL_TOL, (i, err.max())
        engaged = engaged or err.max() > 0  # chunked = different path
    assert engaged  # if bit-identical, the chunked path never ran
    np.testing.assert_allclose(np.asarray(s1["freq"]),
                               np.asarray(s2["freq"]), atol=1e-4)


def test_agc_chunked_batched_channels_match_exact():
    C, n, W = 4, 32768, 256
    rng = np.random.default_rng(9)
    env = (1.0 + 0.5 * np.sin(2 * np.pi * np.arange(n) / n)).astype(np.float32)
    x = (env[None, :] * np.abs(rng.standard_normal((C, n)))).astype(np.float32)
    args = (1.0, 0.1, 0.05, 1e4, 10.0)
    ref = AGCPallas(*args, lead_shape=(C,), interpret=True)
    chk = AGCChunked(*args, lead_shape=(C,), warmup=W, max_lanes=512,
                     interpret=True)
    s1, y1 = ref(ref.init_state(), jnp.asarray(x))
    s2, y2 = chk(chk.init_state(), jnp.asarray(x))
    y1, y2 = np.asarray(y1), np.asarray(y2)
    rel = np.abs(y1 - y2) / np.maximum(np.abs(y1), 1e-3)
    assert np.percentile(rel, 99) < AGC_TOL, np.percentile(rel, 99)


# ---------------------------------------------------------------------------
# Chunked Costas (seam rotation alignment — ops/scans_pallas.py)
# ---------------------------------------------------------------------------

from sdrpp_tpu.ops.scans_pallas import (CostasChunked, CostasPallas,
                                        costas_phases_chunked,
                                        costas_streams)


def _qpsk(n, fo=0.002, phi0=0.3, sps=8, seed=11, noise=0.0):
    rng = np.random.default_rng(seed)
    syms = rng.integers(0, 4, size=n // sps + 2)
    mod = np.repeat(np.pi / 4 + np.pi / 2 * syms, sps)[:n]
    x = np.exp(1j * (mod + fo * np.arange(n) + phi0)).astype(np.complex64)
    if noise:
        x += noise * (rng.standard_normal(n)
                      + 1j * rng.standard_normal(n)).astype(np.complex64)
    return x


def test_costas_chunked_matches_exact_on_locked_qpsk():
    """Order-4 chunked Costas payload phases match the exact sequential
    loop on a locked QPSK stream (residual = both loops' own symbol
    jitter), with NO k*pi/2 seam discontinuities."""
    n, W = 32768, 128
    x = _qpsk(2 * n)
    kw = dict(order=4, bandwidth=0.01)
    ref = CostasPallas(**kw, interpret=True)
    chk = CostasChunked(**kw, warmup=W, max_lanes=512, interpret=True)
    s1, s2 = ref.init_state(), chk.init_state()
    for i in range(2):
        blk = jnp.asarray(x[i * n:(i + 1) * n])
        s1, y1 = ref(s1, blk)
        s2, y2 = chk(s2, blk)
    ph1 = -np.angle(np.asarray(y1) / x[n:])
    ph2 = -np.angle(np.asarray(y2) / x[n:])
    d = (ph1 - ph2 + np.pi) % (2 * np.pi) - np.pi
    assert np.abs(d).max() < 0.1, np.abs(d).max()
    # seam continuity: adjacent payload phase steps never jump a rotation
    dd = np.diff(ph2)
    dd = (dd + np.pi) % (2 * np.pi) - np.pi
    assert np.abs(dd).max() < np.pi / 4, np.abs(dd).max()
    np.testing.assert_allclose(float(s2["freq"]), 0.002, atol=1e-4)


def test_costas_chunked_anchors_to_carried_rotation():
    """The lane-0 anchor term: with a carried phase one QPSK rotation
    (pi/2) away from the raw carrier, the aligned output stays in the
    CARRIED frame — continuity with the previous block's constellation
    mapping, exactly like the exact sequential loop."""
    n, W, fo = 32768, 128, 0.001
    x = _qpsk(W + n, fo=fo, phi0=0.0)
    out, _, _, _, _ = costas_phases_chunked(
        jnp.asarray(x.real[W:]), jnp.asarray(x.imag[W:]),
        jnp.asarray(x.real[:W]), jnp.asarray(x.imag[:W]),
        jnp.asarray(np.float32(np.pi / 2)), jnp.asarray(np.float32(fo)),
        4, 0.03, 0.0005, -0.5, 0.5, lanes_k=64, interpret=True)
    out = np.asarray(out)
    want = fo * np.arange(W, W + n) + np.pi / 2
    d = (out - want + np.pi) % (2 * np.pi) - np.pi
    # loop jitter at symbol transitions, nowhere near a pi/2 (1.57) slip
    assert np.abs(d[n // 4:]).max() < 0.05, np.abs(d[n // 4:]).max()


def test_meteor_costas_chunked_tracks_unique_lock():
    """The broken-modulation error has a UNIQUE lock point (non-uniform
    constellation spacing), so chunked lanes all converge to the TRUE
    carrier with no alignment step at all."""
    from sdrpp_tpu.models.digital import MeteorCostas

    n, W, fo = 32768, 512, 0.001
    rng = np.random.default_rng(2)
    syms = rng.integers(0, 4, size=(W + n) // 4 + 2)
    mod = np.repeat(np.asarray(MeteorCostas.PHASES)[syms], 4)[:W + n]
    x = np.exp(1j * (mod + fo * np.arange(W + n) + 0.2)).astype(np.complex64)
    x += 0.02 * (rng.standard_normal(W + n)
                 + 1j * rng.standard_normal(W + n)).astype(np.complex64)
    s1, s2 = costas_streams(jnp.asarray(x.real), jnp.asarray(x.imag),
                            "meteor")
    out, _, _, _, ff = costas_phases_chunked(
        s1[W:], s2[W:], s1[:W], s2[:W],
        jnp.asarray(np.float32(0.2)), jnp.asarray(np.float32(fo)),
        "meteor", 0.014, 0.0001, -0.5, 0.5, lanes_k=32, interpret=True)
    out = np.asarray(out)
    want = fo * np.arange(W, W + n) + 0.2
    d = (out - want + np.pi) % (2 * np.pi) - np.pi
    assert np.abs(d[n // 4:]).max() < 0.05, np.abs(d[n // 4:]).max()
    np.testing.assert_allclose(float(ff), fo, atol=1e-4)


def test_costas_chunked_zero_block_inherits_carried_freq():
    """An all-zero (squelched) block must NOT reseed lanes at est=0: the
    raw coherence gate is fooled by arctan2(0,0)=0 phases (d=0 -> |z|=1),
    so the seed gate also checks window energy and falls back to the
    CARRIED loop frequency. With zero input the error is identically
    zero, so every lane free-runs at its seed: the final carried freq
    must still be the pre-gap loop frequency."""
    n, W, fo = 32768, 128, 0.01
    z = jnp.zeros(n, jnp.float32)
    zh = jnp.zeros(W, jnp.float32)
    out, _, _, pf, ff = costas_phases_chunked(
        z, z, zh, zh,
        jnp.asarray(np.float32(0.3)), jnp.asarray(np.float32(fo)),
        4, 0.03, 0.0005, -0.5, 0.5, lanes_k=64, interpret=True)
    np.testing.assert_allclose(float(ff), fo, atol=1e-6)
    assert np.all(np.isfinite(np.asarray(out)))


def test_costas_chunked_exact_mode_is_bit_identical(monkeypatch):
    monkeypatch.setattr(SP, "LOOPS_MODE", "exact")
    n = 32768
    x = jnp.asarray(_qpsk(n))
    ref = CostasPallas(4, 0.01, interpret=True)
    chk = CostasChunked(4, 0.01, warmup=128, interpret=True)
    s1, y1 = ref(ref.init_state(), x)
    s2, y2 = chk(chk.init_state(), x)
    np.testing.assert_array_equal(np.asarray(y1), np.asarray(y2))
    assert float(s1["phase"]) == float(s2["phase"])
    assert float(s1["freq"]) == float(s2["freq"])


def test_meteor_costas_scan_path_carries_hist():
    """The CPU lax.scan fallback of models.digital.MeteorCostas maintains
    the chunk warm-up history so a later chunked block warms on real
    samples."""
    from sdrpp_tpu.models.digital import MeteorCostas

    mc = MeteorCostas(0.005, broken_modulation=True, warmup=256)
    n = 2048
    x = _qpsk(n, seed=3)
    st = mc.init_state()
    assert st["hist_re"].shape == (256,)
    st, _ = mc(st, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(st["hist_re"]),
                               x.real[-256:], atol=1e-6)


# ---------------------------------------------------------------------------
# Mid-size blocks (the round-2 "dead zone"): the tile-cost model now engages
# k < 128 lanes — a [*, K] array with K < 128 occupies one VPU tile either
# way, so a 16k block runs 32 lanes at a 4x-shorter scan instead of falling
# back to the exact kernel.


def test_pll_chunked_engages_midsize_block():
    n, W = 16384, 512
    x = _pilot_tone(2 * n, seed=7)
    kw = dict(bandwidth=25000.0 / FS, init_phase=0.0, init_freq=_hz(19000.0),
              min_freq=_hz(18750.0), max_freq=_hz(19250.0))
    ref = PLLPallas(**kw, interpret=True)
    chk = PLLChunked(**kw, warmup=W, max_lanes=512, interpret=True)
    assert SP._chunk_lanes_for(n, W, 512) == 32  # engaged, sub-tile lanes
    s1, s2 = ref.init_state(), chk.init_state()
    for i in range(2):
        blk = jnp.asarray(x[i * n:(i + 1) * n])
        s1, y1 = ref(s1, blk)
        s2, y2 = chk(s2, blk)
        err = np.abs(np.asarray(y1) - np.asarray(y2))
        assert err.max() < PLL_TOL, (i, err.max())


def test_agc_chunked_engages_midsize_block():
    """AGC at its radio-chain warm-up (2048) on a 16k block: k = 8 lanes
    — the AM-demod default block is no longer AGC-scan-bound."""
    n, W = 16384, 2048
    rng = np.random.default_rng(8)
    env = (1.0 + 0.5 * np.sin(2 * np.pi * np.arange(2 * n) / n)).astype(np.float32)
    x = (env * np.abs(rng.standard_normal(2 * n))).astype(np.float32)
    args = (1.0, 0.1, 0.05, 1e4, 10.0)
    ref = AGCPallas(*args, interpret=True)
    chk = AGCChunked(*args, warmup=W, max_lanes=512, interpret=True)
    assert SP._chunk_lanes_for(n, W, 512) == 8
    s1, s2 = ref.init_state(), chk.init_state()
    for i in range(2):
        blk = jnp.asarray(x[i * n:(i + 1) * n])
        s1, y1 = ref(s1, blk)
        s2, y2 = chk(s2, blk)
        y1, y2 = np.asarray(y1), np.asarray(y2)
        rel = np.abs(y1 - y2) / np.maximum(np.abs(y1), 1e-3)
        assert np.percentile(rel, 99) < AGC_TOL, (i, np.percentile(rel, 99))
