"""chip_smoke.py's contract where there is no card, and the lane kernel
compiled for the card where there is one (``-m gpu``)."""

import numpy as np
import pytest


@pytest.mark.parametrize("argv", [[], ["--cards", "4"]])
def test_chip_smoke_refuses_cpu(argv, capsys):
    """Without a GPU the smoke test exits non-zero and prints no result."""
    import chip_smoke

    assert chip_smoke.main(argv) != 0
    out = capsys.readouterr()
    assert out.out == ""
    assert "needs a GPU" in out.err


@pytest.fixture
def gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.gpu
def test_lane_kernel_compiled_matches_scan(gpu):
    """The lane kernel compiled by Triton (not interpreted) == the
    lax.scan of the same step, at the SSB bank's [64, 2048] IF block."""
    import jax
    import jax.numpy as jnp

    from sdrpp_tpu.ops import scans_pallas as SP

    rng = np.random.default_rng(0)
    step = SP._agc_step(1.0, 50 / 48e3, 5 / 48e3, 1e6, 10.0)
    xs = [jnp.asarray(np.abs(rng.standard_normal((2048, 64)))
                      .astype(np.float32)) for _ in range(2)]
    s0 = jnp.ones((2, 64), jnp.float32)
    out, _ = jax.jit(lambda s, a, b: SP.lane_scan(step, s, [a, b]))(s0, *xs)
    _, ref = jax.lax.scan(step, tuple(s0), tuple(xs))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-5)
