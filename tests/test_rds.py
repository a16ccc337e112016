"""RDS decoder tests: block code, group decode, and the DSP chain."""

import numpy as np
import jax
import jax.numpy as jnp

from sdrpp_tpu.decoders import rds
from sdrpp_tpu.models.rds_chain import RDS_BAUD, RDS_RATE, RDSChain, RDSReceiver


def make_group(pi=0x54A8, pty=5, ps4=None, group_type=0, offset=0, chars=b"AB"):
    """Build a valid group-0A bitstream: PI, PTY, PS segment."""
    block_a = pi
    block_b = (group_type << 12) | (0 << 11) | (0 << 10) | (pty << 5) | offset
    block_c = 0xE0E0  # AF
    block_d = (chars[0] << 8) | chars[1]
    return rds.encode_group([block_a, block_b, block_c, block_d])


def test_syndrome_of_valid_block_is_zero():
    bits = make_group()
    # First 26 bits = block A with offset; syndrome must hit the A syndrome
    block = 0
    for b in bits[:26]:
        block = (block << 1) | b
    syn = rds.calc_syndrome(block)
    assert syn in rds.SYNDROMES and rds.SYNDROMES[syn] == rds.BLOCK_A


def test_decoder_full_ps_name():
    dec = rds.RDSDecoder()
    # Send PS name "JAX SDR " via four group-0 segments, twice for sync.
    bits = []
    name = b"JAX SDR "
    for rep in range(3):
        for seg in range(4):
            bits += make_group(pi=0x54A8, pty=7, group_type=0, offset=seg,
                               chars=name[seg * 2: seg * 2 + 2])
    dec.process(bits)
    assert dec.pi_code == 0x54A8
    assert dec.program_type == 7
    assert dec.ps_name == "JAX SDR "
    assert dec.groups_decoded >= 4


def test_decoder_radiotext():
    dec = rds.RDSDecoder()
    text = b"HELLO FROM JAX RADIO"
    bits = []
    for rep in range(2):
        for seg in range((len(text) + 3) // 4):
            chunk = text[seg * 4: seg * 4 + 4].ljust(4)
            block_b = (2 << 12) | (0 << 11) | (0 << 10) | (4 << 5) | seg
            blocks = [0x1234, block_b,
                      (chunk[0] << 8) | chunk[1], (chunk[2] << 8) | chunk[3]]
            bits += rds.encode_group(blocks)
    dec.process(bits)
    assert dec.radio_text_str.startswith("HELLO FROM JAX RADIO")


def test_decoder_error_correction():
    dec = rds.RDSDecoder()
    bits = []
    for rep in range(3):
        for seg in range(4):
            bits += make_group(offset=seg, chars=b"XY")
    bits = np.array(bits)
    # Flip a burst of 3 bits inside one block's data (after sync acquired).
    bits[26 * 12 + 4: 26 * 12 + 7] ^= 1
    dec.process(bits)
    assert dec.pi_code == 0x54A8


def test_callsign_decode():
    dec = rds.RDSDecoder()
    bits = []
    for rep in range(2):
        bits += make_group(pi=4096)  # 'KAAA'
    dec.process(bits)
    assert dec.callsign == "KAAA"


def biphase_encode(bits, sps_num=RDS_RATE, baud=RDS_BAUD):
    """Differential + biphase (Manchester) encode an RDS bitstream at 5 kHz.

    Each data bit: diff-encode, then represent as a +/- biphase symbol pair
    shaped at 2*baud.
    """
    diff = np.cumsum(bits) % 2
    # biphase: bit 1 -> [+1,-1], bit 0 -> [-1,+1] at 2*baud
    symbols = np.where(diff[:, None] == 1, [1.0, -1.0], [-1.0, 1.0]).reshape(-1)
    sps = sps_num / (2 * baud)  # samples per half-bit (~2.105)
    n = int(len(symbols) * sps)
    idx = np.floor(np.arange(n) / sps).astype(int)
    return symbols[np.clip(idx, 0, len(symbols) - 1)]


def test_rds_chain_runs_and_locks():
    # End-to-end DSP sanity: a biphase-ish RDS baseband through the chain
    # produces a locked bitstream (group decode needs exact standard biphase
    # timing; here we validate the DSP plumbing and rates).
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, 600)
    wave = biphase_encode(bits)
    x = (wave + 0.01 * rng.standard_normal(len(wave))).astype(np.complex64)
    chain = RDSChain()
    st = chain.init_state()
    st, (decoded, nvalid) = jax.jit(chain)(st, jnp.asarray(x))
    n = int(nvalid)
    # ~1187.5 bits/s at 5 kHz: one block of len(wave) samples -> ~len/4.2 bits
    assert abs(n - len(x) / (RDS_RATE / RDS_BAUD)) < 30
    d = np.asarray(decoded)[:n]
    assert set(np.unique(d)).issubset({0, 1})


def test_full_wfm_rds_chain_from_rf():
    """SURVEY §3.5's deepest chain, end to end: FM-modulated MPX (pilot +
    stereo + 57 kHz RDS subcarrier) -> WFMDemod stereo + RDS tap -> RDS DSP
    chain -> group decoder -> PI/PS recovered."""
    import jax
    from sdrpp_tpu.models.analog import WFMDemod

    fs, dev = 240000.0, 75000.0
    bits = []
    name = b"JAXRADIO"
    for rep in range(8):
        for seg in range(4):
            block_b = (0 << 12) | (9 << 5) | seg
            blocks = [0x2ABC, block_b, 0xE0E0,
                      (name[seg * 2] << 8) | name[seg * 2 + 1]]
            bits += rds.encode_group(blocks)
    bits = np.array(bits, np.uint8)
    diff = np.zeros(len(bits), np.uint8)
    last = 0
    for i, b in enumerate(bits):
        last ^= b
        diff[i] = last
    half = np.where(diff[:, None] == 1, [1.0, -1.0], [-1.0, 1.0]).reshape(-1)
    sps = fs / (2 * RDS_BAUD)
    n = int(len(half) * sps)
    k = np.floor(np.arange(n) / sps).astype(int)
    rds_bb = half[np.clip(k, 0, len(half) - 1)]
    rds_bb = np.convolve(rds_bb, np.ones(64) / 64.0, mode="same")

    t = np.arange(n) / fs
    l = 0.4 * np.sin(2 * np.pi * 1000.0 * t)
    r = 0.4 * np.sin(2 * np.pi * 3000.0 * t)
    mpx = (0.41 * (l + r) + 0.1 * np.sin(2 * np.pi * 19000.0 * t)
           + 0.41 * (l - r) * np.sin(2 * np.pi * 38000.0 * t)
           + 0.06 * rds_bb * np.cos(2 * np.pi * 57000.0 * t))
    iq = np.exp(1j * np.cumsum(2 * np.pi * dev * mpx / fs)).astype(np.complex64)

    d = WFMDemod(deviation=dev, samplerate=fs, stereo=True, rds_out=True)
    bm = d.rds_resamp.block_multiple
    blk = (n // bm) * bm
    st, (stereo, rdsout) = jax.jit(d)(d.init_state(), jnp.asarray(iq[:blk]))

    rx = RDSReceiver()
    rx.process(np.asarray(rdsout))
    assert rx.decoder.pi_code == 0x2ABC
    assert rx.decoder.ps_name == "JAXRADIO"
    assert rx.decoder.groups_decoded >= 10
