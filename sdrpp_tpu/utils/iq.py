"""Host<->device IQ transfer helpers.

Entry paths that upload IQ ship split float32 [2, n] and form the
complex view in-graph; readback splits complex outputs the same way. On
CPU the split is a free reinterpretation of the interleaved layout.
"""

from __future__ import annotations

import numpy as np

__all__ = ["split_iq", "complex_input", "to_host", "device_state"]


def split_iq(iq: np.ndarray) -> np.ndarray:
    """complex64 [..., n] -> float32 [2, ..., n] (re, im)."""
    iq = np.asarray(iq)
    return np.stack([iq.real.astype(np.float32),
                     iq.imag.astype(np.float32)])


def device_state(init_fn):
    """Create Block state ON DEVICE: state construction runs under jit."""
    import jax

    return jax.jit(init_fn)()


def to_host(x) -> np.ndarray:
    """Device -> host readback: complex arrays are split to float32
    planes by a tiny jit and rejoined on host; everything else is a plain
    np.asarray."""
    import jax
    import jax.numpy as jnp

    if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.complexfloating):
        planes = np.asarray(jax.jit(
            lambda v: jnp.stack([v.real.astype(jnp.float32),
                                 v.imag.astype(jnp.float32)]))(x))
        return planes[0] + 1j * planes[1]
    return np.asarray(x)


def complex_input(fn):
    """Wrap a Block-style callable so its IQ arg arrives as split f32
    and is joined in-graph: wrapped(state, x_split) == fn(state, x)."""
    import jax

    def wrapped(state, x_split, *a, **kw):
        return fn(state, jax.lax.complex(x_split[0], x_split[1]), *a, **kw)

    return wrapped
