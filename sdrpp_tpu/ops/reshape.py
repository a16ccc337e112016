"""Keep/skip re-blocking (Reshaper) and fixed-frame packing (Packer).

Reference: core/src/dsp/buffer/reshaper.h:11-137 (keep N samples, skip M,
emit N-sample frames — feeds the FFT display and constellation/symbol
diagrams) and buffer/packer.h:6-68 (accumulate into fixed-size frames).
Here these are strided reshapes with a carried partial frame.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.blocks import Block

__all__ = ["KeepSkipReshaper", "Packer"]


class KeepSkipReshaper(Block):
    """Emit ``keep``-sample frames every ``keep+skip`` input samples.

    Block length must be a multiple of keep+skip (the receiver snaps its
    block size; see signal_path.IQFrontEnd._snap_fft_interval). Output:
    [..., frames, keep].
    """

    def __init__(self, keep: int, skip: int):
        self.keep = int(keep)
        self.skip = int(skip)
        self.frame_len = self.keep + self.skip

    def frames_per_block(self, n: int) -> int:
        assert n % self.frame_len == 0, (n, self.frame_len)
        return n // self.frame_len

    def __call__(self, state, x):
        n = x.shape[-1]
        frames = self.frames_per_block(n)
        fr = x.reshape(*x.shape[:-1], frames, self.frame_len)
        return state, fr[..., : self.keep]


class Packer(Block):
    """Re-block a stream into exact ``frame_len`` frames with a carried
    partial frame (packer.h). Returns ([..., frames, frame_len], count)."""

    def __init__(self, frame_len: int, dtype=jnp.complex64):
        self.frame_len = int(frame_len)
        self.dtype = dtype

    def init_state(self):
        # carried partial frame + its fill count
        return {"partial": jnp.zeros(self.frame_len, self.dtype),
                "fill": jnp.zeros((), jnp.int32)}

    def __call__(self, state, x):
        n = x.shape[-1]
        fl = self.frame_len
        max_frames = (n + fl - 1) // fl + 1
        buf = jnp.concatenate([state["partial"], x])
        fill = state["fill"]
        total = fill + n
        nframes = total // fl
        # Frame k spans buf[(fl - fill) + ... ]? The partial occupies
        # buf[:fl] with `fill` valid samples at its END? Keep it simple:
        # valid data = buf[fl - fill : fl + n]; frame k = that[k*fl:(k+1)*fl].
        start = fl - fill
        idx = start + jnp.arange(max_frames * fl).reshape(max_frames, fl)
        frames = buf[jnp.clip(idx, 0, buf.shape[0] - 1)]
        new_fill = total - nframes * fl
        # new partial: last new_fill valid samples, stored at the END of the
        # partial buffer slot.
        tail_idx = start + total - fl + jnp.arange(fl)
        new_partial_full = buf[jnp.clip(tail_idx, 0, buf.shape[0] - 1)]
        # mask so only the last new_fill entries are meaningful; position them
        # at the end like the fill convention expects.
        pos = jnp.arange(fl)
        new_partial = jnp.where(pos >= fl - new_fill, new_partial_full,
                                jnp.zeros((), self.dtype))
        return {"partial": new_partial, "fill": new_fill}, (frames, nframes)
