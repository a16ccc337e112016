"""LRPT downlink decode chain (BASELINE config #5).

Composition: MeteorDemod QPSK symbols (models/digital.py) -> soft bits ->
Viterbi (rate 1/2, CCSDS K=7 polynomials) -> Reed-Solomon (255,223) CCSDS.
The reference's meteor module stops at soft-symbol files
(decoder_modules/meteor_demodulator/src/main.cpp:268-276, s8 quantized
x84); the Viterbi+RS stages live in offline LRPT decoders built on the
same libcorrect codes this framework reimplements (ops/fec.py, bit-exact).

This module provides the glue: symbol->soft-bit mapping with the
reference's s8 x84 scaling convention, and an LRPTDecoder that runs
deframed CVCDU payloads through Viterbi + RS.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.fec import RS_CCSDS, ConvCode, ReedSolomon

__all__ = ["CCSDS_CONV_POLYS", "symbols_to_soft_bits", "soft_s8_to_u8",
           "LRPTDecoder", "MeteorChannel"]


class MeteorChannel:
    """Digital receive channel for the web UI / receiver: RxVFO
    (input rate -> 150 kHz IF) -> MeteorDemod (72 ksym QPSK). Output =
    (symbols, valid) prefix-valid block — the constellation / soft-symbol
    surface of the reference meteor module (the VFO at 150 kHz and the
    Reshaper-fed constellation widget,
    decoder_modules/meteor_demodulator/src/main.cpp:52-77)."""

    IF_RATE = 150000.0
    SYMBOL_RATE = 72000.0

    def __init__(self, in_samplerate: float, offset: float = 0.0,
                 bandwidth: float | None = None, oqpsk: bool = False,
                 broken_modulation: bool = False,
                 dynamic_offset: bool = False):
        from .channel import RxVFO
        from .digital import MeteorDemod

        bw = float(bandwidth) if bandwidth else 140000.0
        self.vfo = RxVFO(float(in_samplerate), self.IF_RATE,
                         min(bw, self.IF_RATE), offset,
                         dynamic_offset=dynamic_offset)
        self.demod = MeteorDemod(symbolrate=self.SYMBOL_RATE,
                                 samplerate=self.IF_RATE, oqpsk=oqpsk,
                                 broken_modulation=broken_modulation)
        self.rds = False  # uniform surface with RadioChannel for the UI
        self.block_multiple = self.vfo.block_multiple

    def max_symbols(self, n: int) -> int:
        return self.demod.max_symbols(self.vfo.out_count(n))

    def retune_state(self, state, offset_hz: float):
        return dict(state, vfo=self.vfo.retune_state(state["vfo"],
                                                     offset_hz))

    def init_state(self):
        return {"vfo": self.vfo.init_state(),
                "demod": self.demod.init_state()}

    def __call__(self, state, x):
        vs, x = self.vfo(state["vfo"], x)
        ds, (syms, valid) = self.demod(state["demod"], x)
        return {"vfo": vs, "demod": ds}, (syms, valid)

# CCSDS rate-1/2 K=7 polynomials (0o171, 0o133) used by LRPT.
CCSDS_CONV_POLYS = (0o171, 0o133)


def symbols_to_soft_bits(symbols: np.ndarray, scale: float = 84.0) -> np.ndarray:
    """QPSK symbols -> interleaved s8 soft bits (I then Q per symbol),
    the meteor module's file format (main.cpp:268-276: clamp(v*84, -128..127)).
    """
    re = np.clip(np.real(symbols) * scale, -128, 127)
    im = np.clip(np.imag(symbols) * scale, -128, 127)
    out = np.empty(2 * len(symbols), np.int8)
    out[0::2] = re.astype(np.int8)
    out[1::2] = im.astype(np.int8)
    return out


def soft_s8_to_u8(soft: np.ndarray) -> np.ndarray:
    """s8 soft symbols (-128 strong 0 ... +127 strong 1) -> the Viterbi
    decoder's u8 convention (0 strong 0 ... 255 strong 1)."""
    return (np.asarray(soft, np.int16) + 128).astype(np.uint8)


class LRPTDecoder:
    """Viterbi + RS tail of the LRPT chain.

    decode_soft(soft_u8) Viterbi-decodes one coded block;
    decode_cvcdu(bytes) RS-decodes 255-byte codewords (vmapped batch).
    """

    def __init__(self):
        self.conv = ConvCode(2, 7, CCSDS_CONV_POLYS)
        self.rs = ReedSolomon(RS_CCSDS, 112, 11, 32)
        self._rs_batch = jax.jit(jax.vmap(self.rs.decode))

    def viterbi(self, soft_u8: np.ndarray,
                chunk_bits: int = 4096,
                overlap_bits: int = 96) -> np.ndarray:
        """Viterbi-decode a coded soft-bit stream to packed bytes.

        Uses the chunk-parallel truncated decode (overlapping warm-up
        windows decoded side by side): with the default 96-bit overlap
        (~14 constraint lengths for K=7) the output can differ from the
        exact libcorrect decode near chunk seams only at very low SNR.
        Weak-signal users can trade speed for exactness: raise
        ``overlap_bits`` (seam-error probability falls exponentially), or
        call ``self.conv.decode_soft_np`` for the exact full-trellis
        decode (what the reference's libcorrect always does).
        """
        from .. import ops

        # pass the u8 symbols through unchanged: the stream decoder ships
        # integral soft bits as uint8 (4x cheaper host->device upload)
        bits = self.conv.decode_soft_stream(np.asarray(soft_u8),
                                            chunk_bits=chunk_bits,
                                            overlap_bits=overlap_bits)
        n = (len(bits) // 8) * 8
        return ops.fec._bytes_from_bits(bits[:n])

    def rs_decode_blocks(self, blocks: np.ndarray):
        """[N, 255] uint8 -> ([N, 223] corrected, [N] ok flags)."""
        out, ok = self._rs_batch(jnp.asarray(blocks))
        return np.asarray(out), np.asarray(ok)
