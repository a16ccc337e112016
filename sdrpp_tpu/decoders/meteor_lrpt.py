"""Meteor M2 LRPT downlink decoder (BASELINE config #5, full depth).

Reference scope: the meteor_demodulator module stops at soft-symbol files
(decoder_modules/meteor_demodulator/src/main.cpp:268-276, s8 quantized
x84); Viterbi+RS live in offline LRPT tools built on the same libcorrect
codes this framework reimplements bit-exactly (ops/fec.py). This module
provides the COMPLETE chain behind one object:

    IQ @150k -> MeteorDemod (RRC/AGC/Costas/MM) -> soft symbols (s8 x84)
    -> stream Viterbi (rotation-ambiguity search, CCSDS K=7 r=1/2)
    -> CADU sync on the 0x1ACFFC1D attached sync marker
    -> CCSDS derandomize (x^8+x^7+x^5+x^3+1, all-ones seed)
    -> RS(255,223) deinterleave-4 -> 892-byte VCDU payloads

The QPSK Costas locks with a k*90-degree ambiguity; the decoder runs the
Viterbi under each of the 4 rotations and keeps the one whose decoded
bitstream contains the ASM. ``encode_cadus`` provides the exact inverse
(used by the committed golden capture, tests/data/meteor_lrpt_*).
"""

from __future__ import annotations

import numpy as np

from ..models.lrpt import LRPTDecoder, symbols_to_soft_bits, soft_s8_to_u8
from .falcon9 import _ccsds_randomizer

__all__ = ["MeteorLRPTDecoder", "encode_cadus", "ASM", "CADU_BYTES"]

ASM = 0x1ACFFC1D                 # CCSDS attached sync marker
ASM_BYTES = np.frombuffer(ASM.to_bytes(4, "big"), np.uint8)
ASM_BITS = np.unpackbits(ASM_BYTES)
CADU_BYTES = 1024                # ASM (4) + randomized codeblock (1020)
FRAME_DATA = 1020                # 4 interleaved RS(255,223) codewords
VCDU_BYTES = 4 * 223             # payload per CADU

_RAND_1020 = np.resize(_ccsds_randomizer(255), FRAME_DATA)


def encode_cadus(payloads: np.ndarray, lrpt: LRPTDecoder | None = None
                 ) -> np.ndarray:
    """[N, 892] payload bytes -> QPSK symbols (complex64, 72 ksym rate).

    The exact TX inverse of MeteorLRPTDecoder: RS-encode each 223-byte
    quarter, byte-interleave by 4, randomize, prepend the ASM,
    convolutionally encode the whole CADU stream, map coded bit pairs to
    QPSK (I = bit 0, Q = bit 1, unit energy)."""
    lrpt = lrpt or LRPTDecoder()
    payloads = np.asarray(payloads, np.uint8).reshape(-1, VCDU_BYTES)
    stream = []
    for p in payloads:
        cws = [np.asarray(lrpt.rs.encode(p[223 * j:223 * (j + 1)]), np.uint8)
               for j in range(4)]
        inter = np.zeros(FRAME_DATA, np.uint8)
        for j in range(4):
            inter[j::4] = cws[j]
        stream.append(np.concatenate([ASM_BYTES, inter ^ _RAND_1020]))
    msg = np.concatenate(stream)
    coded = lrpt.conv.encode(msg)
    nbits = lrpt.conv.encode_len_bits(len(msg))
    bits = np.unpackbits(np.asarray(coded, np.uint8))[:nbits]
    if len(bits) % 2:
        bits = np.append(bits, 0)
    i = bits[0::2] * 2.0 - 1.0
    q = bits[1::2] * 2.0 - 1.0
    return ((i + 1j * q) / np.sqrt(2)).astype(np.complex64)


class MeteorLRPTDecoder:
    """Streaming front (accumulate soft symbols per IQ block) + one-shot
    ``finalize`` that runs the Viterbi/CADU/RS tail over the whole pass
    (LRPT captures are minutes long; the tail is a single device-resident
    stream decode per rotation)."""

    def __init__(self, samplerate: float = 150000.0,
                 symbolrate: float = 72000.0, oqpsk: bool = False,
                 broken_modulation: bool = False):
        import jax

        from ..models.digital import MeteorDemod

        self.demod = MeteorDemod(symbolrate=symbolrate,
                                 samplerate=samplerate, oqpsk=oqpsk,
                                 broken_modulation=broken_modulation)

        # IQ crosses the host<->device boundary as split float32 in BOTH
        # directions; complex math stays inside the jit.
        def step(state, x2):
            import jax as _jax
            st, (syms, valid) = self.demod(
                state, _jax.lax.complex(x2[0], x2[1]))
            return st, (syms.real, syms.imag, valid)

        self._step = jax.jit(step)
        # state built under jit, on the device
        self._state = jax.jit(self.demod.init_state)()
        self._chunks: list[np.ndarray] = []

    def process(self, iq: np.ndarray) -> int:
        """Demodulate one IQ block; returns symbols emitted so far."""
        import jax.numpy as jnp

        iq = np.asarray(iq)
        x2 = jnp.asarray(np.stack([iq.real.astype(np.float32),
                                   iq.imag.astype(np.float32)]))
        self._state, (sr, si, valid) = self._step(self._state, x2)
        keep = np.asarray(valid).astype(bool)  # mask, not prefix
        syms = np.asarray(sr)[keep] + 1j * np.asarray(si)[keep]
        self._chunks.append(syms.astype(np.complex64))
        return sum(len(c) for c in self._chunks)

    @property
    def symbols(self) -> np.ndarray:
        return (np.concatenate(self._chunks) if self._chunks
                else np.zeros(0, np.complex64))

    def soft_s8(self) -> np.ndarray:
        """The reference module's output surface: s8 x84 soft symbols."""
        return symbols_to_soft_bits(self.symbols * np.sqrt(2))

    def finalize(self):
        """Run the Viterbi -> CADU -> RS tail. Returns (soft_s8, vcdus,
        info) with ``vcdus`` a [N, 892] uint8 array of RS-corrected
        payloads and ``info`` a dict (rotation used, CADU count)."""
        from numpy.lib.stride_tricks import sliding_window_view

        lrpt = LRPTDecoder()
        syms = self.symbols
        soft = self.soft_s8()
        best = (None, -1, 0)  # (vcdus, rotation, cadus_seen)
        for rot in range(4):
            r = syms * np.exp(-1j * np.pi / 2 * rot)
            s8 = symbols_to_soft_bits(r * np.sqrt(2))
            u8 = soft_s8_to_u8(s8)
            usable = len(u8) - len(u8) % 2
            if usable < 16 * CADU_BYTES:
                continue
            bits = np.asarray(lrpt.conv.decode_soft_stream(
                u8[:usable].astype(np.float32)), np.uint8)
            if len(bits) < 8 * CADU_BYTES + 32:
                continue
            w = sliding_window_view(bits, 32)
            hits = np.nonzero((w == ASM_BITS).all(axis=1))[0]
            vcdus, seen, last_end = [], 0, -1
            for p in hits:
                if p < last_end or p + 8 * CADU_BYTES > len(bits):
                    continue
                frame = np.packbits(bits[p:p + 8 * CADU_BYTES])
                data = frame[4:] ^ _RAND_1020
                cws = np.stack([data[j::4] for j in range(4)])
                out, ok = lrpt.rs_decode_blocks(cws)
                seen += 1
                last_end = p + 8 * CADU_BYTES
                if bool(np.asarray(ok).all()):
                    vcdus.append(np.asarray(out, np.uint8).reshape(-1))
            if seen > best[2] or (vcdus and best[0] is None):
                best = (vcdus, rot, seen)
            if vcdus:
                break
        vcdus, rot, seen = best
        vcdus = (np.stack(vcdus) if vcdus
                 else np.zeros((0, VCDU_BYTES), np.uint8))
        return soft, vcdus, {"rotation": rot, "cadus_seen": seen,
                             "vcdus_ok": len(vcdus)}
