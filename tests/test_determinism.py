"""Determinism guarantees (SURVEY §5: the reference's concurrency safety is
mutex-by-convention; this build's equivalent is pure functions, so we
pin bitwise run-to-run determinism instead of racing threads).

Same input + same state must give bit-identical output across repeated
calls, fresh jit caches, and batched-vs-single execution.
"""

import jax
import jax.numpy as jnp
import numpy as np

from sdrpp_tpu.models.radio import RadioChannel
from sdrpp_tpu.ops.scans import AGC, PLL
from sdrpp_tpu.parallel.vfo_bank import VFOBank


def _iq(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        .astype(np.complex64)


def test_radio_chain_bitwise_repeatable():
    chan = RadioChannel("nfm", 1024000.0, bandwidth=12500.0)
    x = jnp.asarray(_iq(chan.block_multiple * 4))
    step = jax.jit(chan)

    def run():
        st = chan.init_state()
        st, a1 = step(st, x)
        st, a2 = step(st, x)
        return np.asarray(a1), np.asarray(a2)

    a1, a2 = run()
    b1, b2 = run()
    np.testing.assert_array_equal(a1, b1)
    np.testing.assert_array_equal(a2, b2)


def test_fresh_jit_cache_same_bits():
    chan = RadioChannel("am", 1024000.0, bandwidth=10000.0)
    x = jnp.asarray(_iq(chan.block_multiple * 2, seed=3))
    outs = []
    for _ in range(2):
        step = jax.jit(chan)  # fresh traced callable each time
        st = chan.init_state()
        _, audio = step(st, x)
        outs.append(np.asarray(audio))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_scan_loops_deterministic():
    x = jnp.asarray(np.abs(_iq(4096, seed=1)).astype(np.float32))
    agc = AGC(set_point=1.0, attack=50.0 / 48000.0, decay=5.0 / 48000.0,
              max_gain=1e4, max_output_amp=1.0)
    runs = []
    for _ in range(2):
        st = agc.init_state()
        _, y = jax.jit(agc)(st, x)
        runs.append(np.asarray(y))
    np.testing.assert_array_equal(runs[0], runs[1])

    xc = jnp.asarray(_iq(4096, seed=2))
    pll = PLL(bandwidth=0.01)
    runs = []
    for _ in range(2):
        st = pll.init_state()
        _, y = jax.jit(pll)(st, xc)
        runs.append(np.asarray(y))
    np.testing.assert_array_equal(runs[0], runs[1])


def test_vfo_bank_batch_matches_singles():
    """Batched channel axis must equal per-channel runs (vmap soundness)."""
    fs_in, if_rate, bw = 1024000.0, 64000.0, 12500.0
    offsets = np.array([-200000.0, 0.0, 150000.0])
    bank = VFOBank(offsets, fs_in, if_rate, bw)
    x = jnp.asarray(_iq(bank.block_multiple * 2, seed=5))
    st = bank.init_state()
    _, batched = jax.jit(bank)(st, x)
    batched = np.asarray(batched)
    for i, off in enumerate(offsets):
        single = VFOBank(np.array([off]), fs_in, if_rate, bw)
        sst = single.init_state()
        _, y = jax.jit(single)(sst, x)
        np.testing.assert_allclose(np.asarray(y)[0], batched[i], rtol=0,
                                   atol=1e-5)
