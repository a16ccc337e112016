"""Pallas sequential-loop kernels: exact equivalence vs lax.scan blocks."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sdrpp_tpu.ops.scans import PLL, FastAGC
from sdrpp_tpu.ops.scans_pallas import FastAGCPallas, PLLPallas


def test_pll_pallas_matches_scan():
    fs, f0, n = 48000.0, 1234.0, 4096
    ph = 2 * np.pi * f0 * np.arange(n) / fs + 0.5
    x = np.exp(1j * ph).astype(np.complex64)
    ref = PLL(0.02)
    st1, y1 = ref(ref.init_state(), jnp.asarray(x))
    pal = PLLPallas(0.02, interpret=True)
    st2, y2 = pal(pal.init_state(), jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(y1), np.asarray(y2))
    assert float(st1["phase"]) == float(st2["phase"])
    assert float(st1["freq"]) == float(st2["freq"])


def test_fast_agc_pallas_matches_scan_multiblock():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)) \
        .astype(np.complex64)
    ref = FastAGC(1.0, 1e4, 0.01)
    pal = FastAGCPallas(1.0, 1e4, 0.01, interpret=True)
    s1, s2 = ref.init_state(), pal.init_state()
    for blk in (x[:2048], x[2048:]):
        s1, y1 = ref(s1, jnp.asarray(blk))
        s2, y2 = pal(s2, jnp.asarray(blk))
        np.testing.assert_array_equal(np.asarray(y1), np.asarray(y2))
    assert float(s1) == float(s2)


def test_agc_pallas_matches_scan():
    from sdrpp_tpu.ops.scans import AGC
    from sdrpp_tpu.ops.scans_pallas import AGCPallas
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(2048) * np.linspace(0.1, 3.0, 2048)) \
        .astype(np.float32)
    x[500] = 80.0  # trigger the look-ahead clip path
    ref = AGC(1.0, 0.1, 0.01, 1e4, 10.0, float("inf"))
    pal = AGCPallas(1.0, 0.1, 0.01, 1e4, 10.0, float("inf"), interpret=True)
    s1, y1 = ref(ref.init_state(), jnp.asarray(x))
    s2, y2 = pal(pal.init_state(), jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(y1), np.asarray(y2))
    assert float(s1["amp"]) == float(s2["amp"])
    assert float(s1["gain"]) == float(s2["gain"])


def test_costas_pallas_matches_scan():
    from sdrpp_tpu.ops.scans import Costas
    from sdrpp_tpu.ops.scans_pallas import CostasPallas

    rng = np.random.default_rng(3)
    n = 4096
    for order in (2, 4, 8):
        # noisy rotating M-PSK constellation
        symbols = rng.integers(0, order, n)
        ph = 2 * np.pi * symbols / order + 0.02 * np.arange(n) + 0.3
        x = (np.exp(1j * ph) + 0.05 * (rng.standard_normal(n)
             + 1j * rng.standard_normal(n))).astype(np.complex64)
        ref = Costas(order, 0.01)
        pal = CostasPallas(order, 0.01, interpret=True)
        s1, s2 = ref.init_state(), pal.init_state()
        for blk in (x[:2048], x[2048:]):
            s1, y1 = ref(s1, jnp.asarray(blk))
            s2, y2 = pal(s2, jnp.asarray(blk))
            # the kernel's inline rotation contracts differently (FMA)
            # than XLA's complex multiply: ULP-level tolerance, not exact
            np.testing.assert_allclose(np.asarray(y1), np.asarray(y2),
                                       rtol=0, atol=1e-4)
        assert abs(float(s1["phase"]) - float(s2["phase"])) < 1e-3
        assert abs(float(s1["freq"]) - float(s2["freq"])) < 1e-4


def test_costas_pallas_falls_back_on_batched_input():
    from sdrpp_tpu.ops.scans_pallas import CostasPallas

    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 512)) + 1j * rng.standard_normal((3, 512))) \
        .astype(np.complex64)
    pal = CostasPallas(4, 0.01, interpret=True, lead_shape=(3,))
    st, y = pal(pal.init_state(), jnp.asarray(x))
    assert y.shape == (3, 512)


def test_pallas_carry_correct_for_non_chunk_multiple_blocks():
    """Padded tail samples must not advance the carry: block lengths that
    aren't multiples of the SMEM chunk previously corrupted the state
    handed to the next block."""
    from sdrpp_tpu.ops.scans import PLL
    from sdrpp_tpu.ops.scans_pallas import PLLPallas

    rng = np.random.default_rng(3)
    for n in (100, 8192, 10000, 20000):
        x = np.exp(1j * rng.uniform(-np.pi, np.pi, n)).astype(np.complex64)
        ref = PLL(bandwidth=0.01, init_freq=0.5)
        pal = PLLPallas(bandwidth=0.01, init_freq=0.5, interpret=True)
        s1, y1 = ref(ref.init_state(), jnp.asarray(x))
        s2, y2 = pal(pal.init_state(), jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(y1), np.asarray(y2), atol=1e-4)
        assert abs(float(s1["phase"]) - float(s2["phase"])) < 1e-4, n
        assert abs(float(s1["freq"]) - float(s2["freq"])) < 1e-5, n


def test_lane_batched_kernels_match_lax_scan():
    """[C, n] inputs route to the lane-batched kernel (channels in VPU
    lanes); outputs and carries must match the lax.scan forms."""
    from sdrpp_tpu.ops import scans as S
    from sdrpp_tpu.ops import scans_pallas as SP

    rng = np.random.default_rng(5)
    C, n = 5, 5000  # odd channel count, non-chunk-multiple length
    x = (rng.standard_normal((C, n))
         + 1j * rng.standard_normal((C, n))).astype(np.complex64) * 0.7

    pairs = [
        (S.PLL(bandwidth=0.01, init_freq=0.3, lead_shape=(C,)),
         SP.PLLPallas(bandwidth=0.01, init_freq=0.3, lead_shape=(C,),
                      interpret=True)),
        (S.Costas(2, 0.01, lead_shape=(C,)),
         SP.CostasPallas(2, 0.01, lead_shape=(C,), interpret=True)),
        (S.Costas(4, 0.01, lead_shape=(C,)),
         SP.CostasPallas(4, 0.01, lead_shape=(C,), interpret=True)),
        (S.FastAGC(1.0, 10.0, 0.01, lead_shape=(C,)),
         SP.FastAGCPallas(1.0, 10.0, 0.01, lead_shape=(C,), interpret=True)),
        (S.AGC(1.0, 0.1, 0.01, 1000.0, 1.0, lead_shape=(C,)),
         SP.AGCPallas(1.0, 0.1, 0.01, 1000.0, 1.0, lead_shape=(C,),
                      interpret=True)),
    ]
    for ref, pal in pairs:
        s1, y1 = ref(ref.init_state(), jnp.asarray(x))
        s2, y2 = pal(pal.init_state(), jnp.asarray(x))
        name = type(ref).__name__
        np.testing.assert_allclose(np.asarray(y1), np.asarray(y2),
                                   atol=2e-4, rtol=2e-4, err_msg=name)
        for leaf1, leaf2 in zip(jax.tree_util.tree_leaves(s1),
                                jax.tree_util.tree_leaves(s2)):
            np.testing.assert_allclose(np.asarray(leaf1), np.asarray(leaf2),
                                       atol=2e-4, err_msg=name)


def _loop_pairs(lead):
    from sdrpp_tpu.ops import scans as S
    from sdrpp_tpu.ops import scans_pallas as SP
    return [
        (S.PLL(bandwidth=0.01, init_freq=0.3, lead_shape=lead),
         SP.PLLPallas(bandwidth=0.01, init_freq=0.3, lead_shape=lead,
                      interpret=True)),
        (S.Costas(2, 0.01, lead_shape=lead),
         SP.CostasPallas(2, 0.01, lead_shape=lead, interpret=True)),
        (S.Costas(4, 0.01, lead_shape=lead),
         SP.CostasPallas(4, 0.01, lead_shape=lead, interpret=True)),
        (S.Costas(8, 0.01, lead_shape=lead),
         SP.CostasPallas(8, 0.01, lead_shape=lead, interpret=True)),
        (S.FastAGC(1.0, 10.0, 0.01, lead_shape=lead),
         SP.FastAGCPallas(1.0, 10.0, 0.01, lead_shape=lead, interpret=True)),
        (S.AGC(1.0, 0.1, 0.01, 1000.0, 1.0, lead_shape=lead),
         SP.AGCPallas(1.0, 0.1, 0.01, 1000.0, 1.0, lead_shape=lead,
                      interpret=True)),
    ]


@pytest.mark.parametrize("shape", [(1000,), (5, 700), (40, 300)])
@pytest.mark.parametrize("loop", range(6))
def test_lane_kernel_matches_lax_scan(shape, loop):
    """The lane kernel (interpret mode) == ops/scans.py's lax.scan for
    every loop: 1-D (one lane) and [C, n] banks whose C is not a multiple
    of the 32-lane tile (5 -> an 8-lane tile, 40 -> two 32-lane tiles,
    both padded)."""
    rng = np.random.default_rng(loop)
    x = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(np.complex64) * 0.7
    ref, ker = _loop_pairs(shape[:-1])[loop]
    s1, y1 = ref(ref.init_state(), jnp.asarray(x))
    s2, y2 = ker(ker.init_state(), jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y2),
                               atol=2e-4, rtol=2e-4)
    for a, b in zip(jax.tree_util.tree_leaves(s1),
                    jax.tree_util.tree_leaves(s2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-4)


@pytest.mark.parametrize("n", [64, 1003])
def test_lane_kernel_unrolled_steps_and_tail(n):
    """The compiled form's unrolled time loop (8 steps per iteration plus
    an n % 8 tail), run in the interpreter: same recurrence as one step
    at a time, up to float rounding."""
    from sdrpp_tpu.ops import scans_pallas as SP

    rng = np.random.default_rng(n)
    step = SP._agc_step(1.0, 0.1, 0.01, 1e4, 10.0)
    amps = jnp.asarray(np.abs(rng.standard_normal((n, 37)))
                       .astype(np.float32))
    smax = jnp.flip(jax.lax.cummax(jnp.flip(amps, 0), axis=0), 0)
    state = jnp.ones((2, 37), jnp.float32)
    o1, f1 = SP.lane_scan(step, state, [amps, smax], interpret=True)
    o8, f8 = SP.lane_scan(step, state, [amps, smax], interpret=True,
                          unroll=8)
    np.testing.assert_allclose(np.asarray(o8), np.asarray(o1), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(f8), np.asarray(f1), rtol=1e-5)


def test_meteor_costas_lane_kernel_matches_scan():
    """The "meteor" Costas step in the lane kernel == MeteorCostas's
    phase-domain lax.scan (the formulation both share)."""
    from sdrpp_tpu.models.digital import MeteorCostas
    from sdrpp_tpu.ops import scans_pallas as SP

    rng = np.random.default_rng(6)
    n = 2000
    ph = np.pi / 4 + np.pi / 2 * rng.integers(0, 4, n) + 0.01 * np.arange(n)
    x = (np.exp(1j * ph) + 0.05 * rng.standard_normal(n)).astype(np.complex64)
    mc = MeteorCostas(0.01, broken_modulation=True)
    st = mc.init_state()
    st1, y1 = mc(st, jnp.asarray(x))
    out, ph_f, fr_f = SP.costas_phases_pallas(
        x.real, x.imag, st["phase"], st["freq"], "meteor", mc.alpha,
        mc.beta, mc.min_freq, mc.max_freq, interpret=True)
    y2 = x * np.exp(-1j * np.asarray(out))
    np.testing.assert_allclose(np.asarray(y1), y2, atol=1e-4)
    assert abs(float(st1["freq"]) - float(fr_f)) < 1e-5


def test_lane_cost_model():
    """Chunk lanes under the lane kernel's cost model: lanes are nearly
    free up to RESIDENT_TILES tiles, so K grows until L reaches the
    warm-up; past one wave the model trades lanes for steps; short blocks
    stay exact."""
    from sdrpp_tpu.ops import scans_pallas as SP

    assert SP._lane_waves(1) == 1
    assert SP._lane_waves(SP.LANE_TILE * SP.RESIDENT_TILES) == 1
    assert SP._lane_waves(SP.LANE_TILE * SP.RESIDENT_TILES + 1) == 2
    # meteor's 2^20 block, W = 1024: max lanes, 1 wave
    assert SP._chunk_lanes_for(1 << 20, 1024, 512) == 512
    # SSB-bank-sized AGC [64, 2^18], W = 2048: L must stay >= W
    assert SP._chunk_lanes_for(1 << 18, 2048, 512, channels=64) == 128
    # a bank wide enough that 128 lanes each would need a second wave
    big = SP.LANE_TILE * SP.RESIDENT_TILES // 64
    k = SP._chunk_lanes_for(1 << 18, 2048, 512, channels=big)
    assert 0 < k and big * k <= SP.LANE_TILE * SP.RESIDENT_TILES
    # too short to win by 2x: exact
    assert SP._chunk_lanes_for(3000, 1024, 512) == 0
