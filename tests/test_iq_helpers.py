"""Split-f32 IQ transfer helpers (utils/iq.py)."""

import jax
import jax.numpy as jnp
import numpy as np

from sdrpp_tpu.utils.iq import complex_input, split_iq


def test_split_iq_roundtrip():
    rng = np.random.default_rng(0)
    iq = (rng.standard_normal(1000) + 1j * rng.standard_normal(1000)
          ).astype(np.complex64)
    s = split_iq(iq)
    assert s.shape == (2, 1000) and s.dtype == np.float32
    np.testing.assert_array_equal(s[0] + 1j * s[1], iq)


def test_complex_input_equivalence():
    from sdrpp_tpu.ops.mix import FrequencyXlator

    rng = np.random.default_rng(1)
    iq = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)
          ).astype(np.complex64)
    b = FrequencyXlator(10000.0, 96000.0)
    st, y_direct = jax.jit(b)(b.init_state(), jnp.asarray(iq))
    st2, y_split = jax.jit(complex_input(b))(
        b.init_state(), jnp.asarray(split_iq(iq)))
    np.testing.assert_array_equal(np.asarray(y_direct), np.asarray(y_split))
    np.testing.assert_array_equal(np.asarray(st), np.asarray(st2))


def test_dynamic_xlator_matches_static():
    """DynamicFrequencyXlator (offset in state) == FrequencyXlator (offset
    baked) within ~1e-2 rad over a 262144-sample block, and retuning via
    offset_state needs NO retrace."""
    import jax
    import jax.numpy as jnp

    from sdrpp_tpu.ops.mix import DynamicFrequencyXlator, FrequencyXlator

    rng = np.random.default_rng(0)
    n = 262144
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        .astype(np.complex64)
    for off in (12345.0, -98765.4321, 0.0, 499999.0):
        st_x = FrequencyXlator(off, 1e6)
        dy = DynamicFrequencyXlator(off, 1e6)
        s1, y1 = jax.jit(st_x)(st_x.init_state(), jnp.asarray(x))
        s2, y2 = jax.jit(dy)(dy.init_state(), jnp.asarray(x))
        rel = (np.abs(np.asarray(y1) - np.asarray(y2)) / np.abs(x)).max()
        perr = abs(float(s1) - float(s2["phase"])) % (2 * np.pi)
        perr = min(perr, 2 * np.pi - perr)
        assert rel < 1e-2 and perr < 1e-2, (off, rel, perr)

    # retune: same jitted fn, new omega leaves; lands on the new frequency
    dy = DynamicFrequencyXlator(0.0, 1e6)
    f = jax.jit(dy)
    st = dy.init_state()
    st, _ = f(st, jnp.asarray(x))
    hi, lo = dy.offset_state(-125000.0)
    st = dict(st, omega_hi=jnp.asarray(hi), omega_lo=jnp.asarray(lo))
    tone = np.exp(2j * np.pi * 125000.0 / 1e6
                  * np.arange(n)).astype(np.complex64)
    _, y = f(st, jnp.asarray(tone))
    spec = np.abs(np.fft.fft(np.asarray(y)))
    assert np.argmax(spec) == 0  # mixed down to DC
