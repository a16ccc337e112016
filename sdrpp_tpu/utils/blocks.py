"""Execution model: pure stateful block functions.

The reference runs one worker thread per DSP block connected by blocking
double-buffered streams (reference: core/src/dsp/block.h:70-76,
stream.h:43-92). Here that layer disappears: a *block* here is a pure
function ``(state, x) -> (state, y)`` over a batched sample array, a *chain*
is function composition, and the whole graph runs inside one ``jax.jit``.
Carried state (filter tails, NCO phase, loop carries) is an explicit pytree.

``Block`` is a tiny protocol class: static configuration lives on ``self``
(hashable, closed over by jit), dynamic state in the pytree returned by
``init_state()``. ``Chain`` mirrors dsp::chain's per-block enable/bypass
(reference: core/src/dsp/chain.h:32-142) — toggling membership re-traces.
"""

from __future__ import annotations

from typing import Any, Sequence

import jax

__all__ = ["Block", "Chain", "scan_blocks"]

State = Any


class Block:
    """Base class for stateful DSP blocks.

    Subclasses implement ``init_state()`` returning a pytree of arrays and
    ``__call__(state, x) -> (state, y)`` as a pure, traceable function.
    Stateless blocks return ``()`` from init_state and ignore it.
    """

    def init_state(self) -> State:
        return ()

    def __call__(self, state: State, x):  # pragma: no cover - interface
        raise NotImplementedError


class Chain(Block):
    """Linear pipeline of blocks with per-block enable/bypass.

    Equivalent capability to dsp::chain<T> (reference:
    core/src/dsp/chain.h:32-142): blocks can be enabled/disabled between
    jitted steps; the composed function only includes enabled blocks, so a
    topology change triggers a re-trace (cheap, cached thereafter).
    """

    def __init__(self, blocks: Sequence[Block], enabled: Sequence[bool] | None = None):
        self.blocks = list(blocks)
        self.enabled = list(enabled) if enabled is not None else [True] * len(self.blocks)

    def set_enabled(self, idx: int, enabled: bool) -> None:
        self.enabled[idx] = enabled

    def init_state(self) -> State:
        return tuple(b.init_state() for b in self.blocks)

    def __call__(self, state: State, x):
        new_states = []
        for block, st, en in zip(self.blocks, state, self.enabled):
            if en:
                st, x = block(st, x)
            new_states.append(st)
        return tuple(new_states), x


def scan_blocks(block: Block, state: State, xs):
    """Run a block over a leading sequence-of-blocks axis via lax.scan."""
    def step(carry, x):
        carry, y = block(carry, x)
        return carry, y

    return jax.lax.scan(step, state, xs)
