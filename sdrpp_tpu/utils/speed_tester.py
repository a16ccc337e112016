"""Per-kernel throughput benchmark harness.

Reference: core/src/dsp/bench/speed_tester.h:31-56 — saturate one block
with random samples and report samples/s.

The harness:

1. builds everything (inputs via host->device transfer, state under jit),
2. runs N serially-dependent iterations of the jitted step inside one
   executable (a lax.scan), whose outputs include a float32 checksum over
   the whole output,
3. waits for the result with ``block_until_ready``, and
4. subtracts the one-off dispatch overhead with a 1-iteration run:
   per_iter = (T_N - T_1) / (N - 1).
"""

from __future__ import annotations

import time

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["speed_test", "report_table"]


def _make_chain(fn):
    """Wrap a step fn as a single-launch N-iteration serial chain: a
    lax.scan over the step keeps per-launch host overhead out of the
    measurement. Returns chain(state, x, n) (n static)."""
    import functools

    @functools.partial(jax.jit, static_argnums=2)
    def chain(state, x, n):
        # A tiny checksum-derived salt makes each iteration's input
        # distinct — otherwise a STATELESS block's scan body is loop-
        # invariant and XLA hoists it to a single evaluation.
        def body(carry, _):
            st, salt = carry
            st, c = fn(st, x + salt.astype(x.dtype))
            return (st, c * np.float32(1e-20)), c
        (st, _), cs = jax.lax.scan(
            body, (state, jnp.float32(0.0)), None, length=n)
        return st, jnp.sum(cs)

    return chain


def _timed(chain, state, x, iters: int, warm: set) -> float:
    if iters not in warm:
        jax.block_until_ready(chain(state, x, iters))  # compile untimed
        warm.add(iters)
    t0 = time.perf_counter()
    jax.block_until_ready(chain(state, x, iters))
    return time.perf_counter() - t0


def _checksum(y):
    """Full reduction over the output — a cheap-looking slice would let
    XLA dead-code-eliminate the actual kernel work."""
    leaf = jax.tree_util.tree_leaves(y)[0]
    if jnp.iscomplexobj(leaf):
        leaf = leaf.real
    return jnp.sum(leaf.astype(jnp.float32))


def speed_test(block, n: int, dtype=jnp.complex64, iters: int = 16,
               lead_shape=(), seed: int = 0) -> dict:
    """Measure a Block's throughput at block length n (input samples/s
    counting all leading axes)."""
    rng = np.random.default_rng(seed)
    shape = (*lead_shape, n)
    # Complex inputs are uploaded as split float32 and the complex view
    # is formed in-graph.
    is_complex = jnp.issubdtype(dtype, jnp.complexfloating)
    x = jnp.asarray(rng.standard_normal((2, *shape) if is_complex else shape)
                    .astype(np.float32))

    @jax.jit
    def step(state, x):
        if is_complex:
            x = jax.lax.complex(x[0], x[1])
        state, y = block(state, x)
        return state, _checksum(y)

    state = jax.jit(lambda d: block.init_state())(np.float32(0))
    chain = _make_chain(step)
    warm: set = set()
    t1 = _timed(chain, state, x, 1, warm)
    # Grow the iteration count until the serial chain is comfortably above
    # the sync/dispatch overhead (tn - t1), or fast kernels read as 0 us.
    while True:
        tn = _timed(chain, state, x, iters, warm)
        if tn - t1 > 0.05 or iters >= 1024:
            break
        iters *= 4
    per_iter = max((tn - t1) / (iters - 1), 1e-9)

    total = int(np.prod(shape))
    return {
        "block_len": n,
        "lead_shape": tuple(lead_shape),
        "time_per_block_us": per_iter * 1e6,
        "samples_per_sec": total / per_iter,
    }


def report_table(results: dict[str, dict]) -> str:
    lines = [f"{'kernel':<28} {'block':>9} {'us/blk':>10} {'Msamp/s':>10}"]
    for name, r in results.items():
        lines.append(f"{name:<28} {r['block_len']:>9} "
                     f"{r['time_per_block_us']:>10.1f} "
                     f"{r['samples_per_sec'] / 1e6:>10.1f}")
    return "\n".join(lines)
