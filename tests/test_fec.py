"""FEC bit-exactness vs libcorrect golden vectors + property tests.

Golden vectors in tests/data/libcorrect_vectors.npz were generated by
running the reference's vendored libcorrect (core/libcorrect) on random
payloads (SURVEY.md §4: libcorrect's test suite is the bit-exactness
oracle for the FEC decoders).
"""

from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sdrpp_tpu.ops.fec import (CONV_R12_7, CONV_R12_9, RS_CCSDS, ConvCode,
                               ReedSolomon)

VEC = np.load(Path(__file__).parent / "data" / "libcorrect_vectors.npz")


def test_conv_encode_bit_exact_k7():
    cc = ConvCode(2, 7, CONV_R12_7)
    enc = cc.encode(VEC["conv_msg"])
    assert cc.encode_len_bits(len(VEC["conv_msg"])) == int(VEC["conv_nbits"])
    np.testing.assert_array_equal(enc, VEC["conv_enc"])


def test_conv_encode_bit_exact_k9():
    cc = ConvCode(2, 9, CONV_R12_9)
    enc = cc.encode(VEC["conv_msg"])
    assert cc.encode_len_bits(len(VEC["conv_msg"])) == int(VEC["conv9_nbits"])
    np.testing.assert_array_equal(enc, VEC["conv9_enc"])


def test_conv_decode_soft_matches_libcorrect():
    cc = ConvCode(2, 7, CONV_R12_7)
    dec = cc.decode_soft_bytes(VEC["conv_soft"])
    np.testing.assert_array_equal(dec[: int(VEC["conv_declen"])], VEC["conv_dec"])
    # And both equal the original message (noise was correctable).
    np.testing.assert_array_equal(VEC["conv_dec"], VEC["conv_msg"])


def test_conv_roundtrip_with_errors():
    rng = np.random.default_rng(1)
    cc = ConvCode(2, 7, CONV_R12_7)
    msg = rng.integers(0, 256, 128).astype(np.uint8)
    enc = cc.encode(msg)
    nbits = cc.encode_len_bits(len(msg))
    bits = np.unpackbits(enc)[:nbits].astype(np.float32) * 255
    flip = rng.choice(nbits, nbits // 50, replace=False)  # 2% bit errors
    bits[flip] = 255 - bits[flip]
    dec = cc.decode_soft_bytes(bits)
    np.testing.assert_array_equal(dec[: len(msg)], msg)


def test_rs_encode_bit_exact_ccsds():
    rs = ReedSolomon(RS_CCSDS, 112, 11, 32)
    enc = rs.encode(VEC["rs_msg"])
    np.testing.assert_array_equal(enc, VEC["rs_enc_ccsds"])


def test_rs_encode_bit_exact_default():
    rs = ReedSolomon(RS_CCSDS, 1, 1, 32)
    enc = rs.encode(VEC["rs_msg"])
    np.testing.assert_array_equal(enc, VEC["rs_enc_default"])


def test_rs_decode_matches_libcorrect():
    rs = ReedSolomon(RS_CCSDS, 112, 11, 32)
    out, ok = jax.jit(rs.decode)(jnp.asarray(VEC["rs_corrupted"]))
    assert bool(ok)
    np.testing.assert_array_equal(np.asarray(out), VEC["rs_dec"])
    np.testing.assert_array_equal(np.asarray(out), VEC["rs_msg"])


@pytest.mark.parametrize("nerr", [0, 1, 8, 16])
def test_rs_property_correctable(nerr):
    rng = np.random.default_rng(nerr)
    rs = ReedSolomon(RS_CCSDS, 112, 11, 32)
    msg = rng.integers(0, 256, rs.msg_len).astype(np.uint8)
    block = rs.encode(msg)
    c = block.copy()
    if nerr:
        pos = rng.choice(255, nerr, replace=False)
        c[pos] ^= rng.integers(1, 256, nerr).astype(np.uint8)
    out, ok = jax.jit(rs.decode)(jnp.asarray(c))
    assert bool(ok)
    np.testing.assert_array_equal(np.asarray(out), msg)


def test_rs_beyond_capacity_flagged():
    rng = np.random.default_rng(99)
    rs = ReedSolomon(RS_CCSDS, 1, 1, 32)
    msg = rng.integers(0, 256, rs.msg_len).astype(np.uint8)
    c = rs.encode(msg)
    pos = rng.choice(255, 25, replace=False)
    c[pos] ^= rng.integers(1, 256, 25).astype(np.uint8)
    out, ok = jax.jit(rs.decode)(jnp.asarray(c))
    assert not bool(ok)


def test_rs_batched_decode():
    rng = np.random.default_rng(7)
    rs = ReedSolomon(RS_CCSDS, 112, 11, 32)
    msgs = rng.integers(0, 256, (8, rs.msg_len)).astype(np.uint8)
    blocks = np.stack([rs.encode(m) for m in msgs])
    for b in blocks[:4]:
        pos = rng.choice(255, 10, replace=False)
        b[pos] ^= rng.integers(1, 256, 10).astype(np.uint8)
    outs, oks = jax.jit(jax.vmap(rs.decode))(jnp.asarray(blocks))
    assert bool(np.all(np.asarray(oks)))
    np.testing.assert_array_equal(np.asarray(outs), msgs)


def test_rs_erasure_decode_matches_libcorrect():
    rs = ReedSolomon(RS_CCSDS, 112, 11, 32)
    epos = np.zeros(32, np.int32)
    npos = len(VEC["rs_er_positions"])
    epos[:npos] = VEC["rs_er_positions"]
    out, ok = jax.jit(rs.decode_with_erasures)(
        jnp.asarray(VEC["rs_er_corrupted"]), jnp.asarray(epos),
        jnp.int32(npos))
    assert bool(ok)
    np.testing.assert_array_equal(np.asarray(out), VEC["rs_er_dec"])
    np.testing.assert_array_equal(np.asarray(out), VEC["rs_er_msg"])


@pytest.mark.parametrize("f,e", [(32, 0), (20, 6), (10, 11), (4, 14)])
def test_rs_erasure_capacity(f, e):
    rng = np.random.default_rng(f * 100 + e)
    rs = ReedSolomon(RS_CCSDS, 112, 11, 32)
    msg = rng.integers(0, 256, rs.msg_len).astype(np.uint8)
    c = rs.encode(msg)
    pos = rng.choice(255, f + e, replace=False)
    c[pos] ^= rng.integers(1, 256, f + e).astype(np.uint8)
    epos = np.zeros(32, np.int32)
    epos[:f] = pos[:f]
    out, ok = jax.jit(rs.decode_with_erasures)(
        jnp.asarray(c), jnp.asarray(epos), jnp.int32(f))
    assert bool(ok)
    np.testing.assert_array_equal(np.asarray(out), msg)


def test_native_traceback_matches_graph_backtrace():
    """decode_soft_np (jitted ACS + C traceback) == decode_soft (in-graph
    backtrace), including noisy symbols and non-default flush_bits."""
    import jax.numpy as jnp

    from sdrpp_tpu.ops.fec import ConvCode

    code = ConvCode(2, 7, (0o171, 0o133))
    rng = np.random.default_rng(5)
    msg = rng.integers(0, 256, 200).astype(np.uint8)
    coded = code.encode(msg)
    bits = np.unpackbits(coded).astype(np.float32)
    noisy = np.clip(bits * 255.0 + rng.normal(0, 60, bits.shape), 0, 255) \
        .astype(np.float32)
    ref = np.asarray(code.decode_soft(jnp.asarray(noisy)))
    got = code.decode_soft_np(noisy)
    np.testing.assert_array_equal(got, ref)
    # flush_bits variant (M17 uses K-1)
    ref4 = np.asarray(code.decode_soft(jnp.asarray(noisy), flush_bits=4))
    got4 = code.decode_soft_np(noisy, flush_bits=4)
    np.testing.assert_array_equal(got4, ref4)


def _noisy_stream(code, nbytes, sigma, seed):
    rng = np.random.default_rng(seed)
    msg = rng.integers(0, 256, nbytes).astype(np.uint8)
    bits = np.unpackbits(code.encode(msg)).astype(np.float32)
    return msg, np.clip(bits * 255.0 + rng.normal(0, sigma, bits.shape),
                        0, 255).astype(np.float32)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_decode_soft_stream_matches_exact(dtype):
    """The batched stream Viterbi (vmapped ACS scan + reverse-scan
    traceback in one jit) == the exact decode on a long noisy stream, for
    f32 soft bits and for integral u8 symbols (shipped as uint8)."""
    code = ConvCode(2, 7, CONV_R12_7)
    _, noisy = _noisy_stream(code, 1500, 48, seed=11)
    if dtype == np.uint8:
        noisy = np.round(noisy).astype(np.uint8)
    exact = np.asarray(code.decode_soft(jnp.asarray(noisy.astype(np.float32))))
    stream = code.decode_soft_stream(noisy, chunk_bits=1024, overlap_bits=96)
    assert stream.shape == exact.shape
    np.testing.assert_array_equal(stream, exact)


@pytest.mark.parametrize("chunk_bits", [512, 700, 1024])
def test_decode_soft_stream_seams(chunk_bits):
    """Seams at every chunk boundary, including a chunk length that does
    not divide the trellis and windows clipped at the stream's end: the
    decoded message is recovered bit-exactly across all of them."""
    code = ConvCode(2, 7, CONV_R12_7)
    msg, noisy = _noisy_stream(code, 800, 40, seed=chunk_bits)
    bits = code.decode_soft_stream(noisy, chunk_bits=chunk_bits,
                                   overlap_bits=96)
    np.testing.assert_array_equal(np.packbits(bits)[: len(msg)], msg)


def test_decode_soft_stream_short_input_is_exact():
    """Input no longer than one window takes the exact decode, including
    the libcorrect golden vector."""
    code = ConvCode(2, 7, CONV_R12_7)
    _, noisy = _noisy_stream(code, 200, 48, seed=3)
    np.testing.assert_array_equal(code.decode_soft_stream(noisy),
                                  code.decode_soft_np(noisy))
    bits = code.decode_soft_stream(VEC["conv_soft"].astype(np.float32))
    n = int(VEC["conv_declen"])
    np.testing.assert_array_equal(np.packbits(bits)[:n], VEC["conv_dec"])


def test_decode_soft_stream_libcorrect_vector_at_seams():
    """The libcorrect golden soft vector, decoded as a stream with
    windows much shorter than it (every seam inside the vector), equals
    libcorrect's own decode."""
    code = ConvCode(2, 7, CONV_R12_7)
    bits = code.decode_soft_stream(VEC["conv_soft"], chunk_bits=64,
                                   overlap_bits=48)
    n = int(VEC["conv_declen"])
    np.testing.assert_array_equal(np.packbits(bits)[:n], VEC["conv_dec"])


def test_packed_acs_decisions_match_unpacked():
    """The stream path's bit-packed decisions carry the same bits as the
    exact path's [T, S] decisions, for S below and above one word."""
    rng = np.random.default_rng(9)
    for order, polys in ((5, (0o23, 0o35)), (7, CONV_R12_7)):
        code = ConvCode(2, order, polys)
        soft = jnp.asarray(rng.uniform(0, 255, (300, 2)).astype(np.float32))
        m1, dec = code._acs(soft)
        m2, packed = code._acs(soft, pack=True)
        S = code.num_states
        n = np.arange(S)
        unpacked = (np.asarray(packed)[:, n // 32] >> (n % 32)) & 1
        np.testing.assert_array_equal(unpacked.astype(bool), np.asarray(dec))
        np.testing.assert_array_equal(np.asarray(m1), np.asarray(m2))
