"""M17 frame layer + end-to-end receive chain (m17dsp.h:96-720)."""

import numpy as np
import pytest

from sdrpp_tpu.decoders import m17_frame as mf
from sdrpp_tpu.decoders.m17 import encode_lsf

TYPE_WORD = (1 << 0) | (2 << 1) | (5 << 7)  # stream, voice, CAN 5
LSF = encode_lsf("SP5WWP", "N0CALL", TYPE_WORD, b"HELLO")


def test_slice_4fsk_roundtrip():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, 768).astype(np.uint8)
    assert np.array_equal(mf.slice_4fsk(mf.symbols_from_bits(bits)), bits)


def test_lsf_frame_roundtrip_with_noise_bits():
    fb = mf.encode_lsf_frame(LSF)
    rng = np.random.default_rng(1)
    noise = rng.integers(0, 2, 101).astype(np.uint8)
    demux = mf.FrameDemux()
    frames = demux.process(np.concatenate([noise, fb, noise]))
    # trailing noise is retained for the next block, frame is found
    assert len(frames) == 1 and frames[0][0] == mf.FRAME_LSF
    lsf = mf.decode_lsf_frame(frames[0][1]["lsf"])
    assert lsf.valid and lsf.dst == "SP5WWP" and lsf.src == "N0CALL"
    assert lsf.meta.startswith(b"HELLO")


def test_demux_frame_straddles_blocks():
    fb = mf.encode_lsf_frame(LSF)
    demux = mf.FrameDemux()
    frames = demux.process(fb[:200])
    frames += demux.process(fb[200:])
    assert len(frames) == 1
    assert mf.decode_lsf_frame(frames[0][1]["lsf"]).valid


def test_stream_frame_payload_and_lich():
    voice = bytes(range(16))
    demux = mf.FrameDemux()
    asm = mf.LICHAssembler()
    got_lsf = None
    for fn in range(12):
        frames = demux.process(mf.encode_stream_frame(LSF, fn, voice))
        assert len(frames) == 1 and frames[0][0] == mf.FRAME_STREAM
        payload = mf.decode_stream_payload(frames[0][1]["payload"])
        assert payload[:2] == bytes([fn >> 8, fn & 0xFF])
        assert payload[2:18] == voice
        lsf = asm.process(frames[0][1]["lich"])
        if lsf is not None:
            got_lsf = lsf
    # 12 frames = 2 complete LICH cycles -> LSF recovered from LICH alone
    assert got_lsf is not None and got_lsf.dst == "SP5WWP"


def test_lich_golay_corrects_bit_errors():
    voice = bytes(16)
    asm = mf.LICHAssembler()
    rng = np.random.default_rng(2)
    got = None
    for fn in range(6):
        frames = mf.FrameDemux().process(
            mf.encode_stream_frame(LSF, fn, voice))
        lich = frames[0][1]["lich"].copy()
        # flip 2 random bits in each 24-bit Golay block
        for b in range(4):
            for p in rng.choice(24, 2, replace=False):
                lich[b * 24 + p] ^= 1
        r = asm.process(lich)
        if r is not None:
            got = r
    assert got is not None and got.dst == "SP5WWP" and got.src == "N0CALL"


def _modulate(frame_bit_blocks, fs, n_preamble=1200, rng=None):
    """4FSK-modulate M17 frames: RRC-shaped frequency pulses @4800 baud
    (the spec's TX pulse shaping; ops/resample.RRCInterpolator) -> FM.

    Run-in is a PN +-1 sequence rather than the spec's alternating
    preamble: Mueller-Muller timing error is identically zero on a pure
    alternating pattern (any sampling phase gives equal-magnitude
    alternating outputs), so the reference's MM loop — and ours, which
    matches it — only converges on data-like symbols. Real receivers
    converge over seconds of voice; tests use a PN run-in to lock fast."""
    import jax.numpy as jnp

    from sdrpp_tpu.ops.resample import RRCInterpolator

    prng = np.random.default_rng(99)
    syms = [(prng.integers(0, 2, n_preamble) * 2.0 - 1.0).astype(np.float32)]
    syms += [mf.symbols_from_bits(b) for b in frame_bit_blocks]
    syms.append(np.zeros(100, np.float32))
    sym = np.concatenate(syms)

    shaper = RRCInterpolator(mf.M17_BAUDRATE, fs, mf.M17_RRC_ALPHA,
                             rrc_tap_count=31, dtype=jnp.float32)
    pad = (-len(sym)) % shaper.block_multiple
    sym = np.concatenate([sym, np.zeros(pad, np.float32)])
    _, wave = shaper(shaper.init_state(), jnp.asarray(sym))
    wave = np.asarray(wave, np.float64)
    # Calibrate the TX-shaper x RX-matched-filter cascade so the receiver
    # sees unit symbols at symbol instants (the cascade is a raised cosine
    # => zero ISI there; only its gain needs normalizing).
    from sdrpp_tpu.ops.taps import root_raised_cosine_rate
    nimp = 64 + (-64) % shaper.block_multiple
    imp = np.zeros(nimp, np.float32)
    imp[32] = 1.0
    _, imp_shaped = shaper(shaper.init_state(), jnp.asarray(imp))
    rx = root_raised_cosine_rate(31, mf.M17_RRC_ALPHA, mf.M17_BAUDRATE, fs)
    cascade = np.convolve(np.asarray(imp_shaped, np.float64), rx)
    wave /= np.max(np.abs(cascade))
    phase = np.cumsum(2 * np.pi * mf.M17_DEVIATION * wave / fs)
    iq = np.exp(1j * phase).astype(np.complex64)
    if rng is not None:  # light channel noise
        iq += (rng.normal(0, 0.02, len(iq)) +
               1j * rng.normal(0, 0.02, len(iq))).astype(np.complex64)
    return iq


def test_m17_lsf_through_chunked_mm_interpret():
    """The chunk-parallel MM emits a lane-major boolean MASK (not a
    prefix); M17Decoder must boolean-index or the 4FSK bitstream garbles
    with zero-filled slots. The chunked MM is plain XLA, so it engages on
    the CPU too at this block size."""
    from sdrpp_tpu.models.m17_chain import M17Decoder

    fs = 48000.0
    blocks = [mf.encode_lsf_frame(LSF) for _ in range(3)]
    iq = _modulate(blocks, fs, rng=np.random.default_rng(7))

    dec = M17Decoder(fs)
    events = []
    bs = 16000
    for i in range(0, len(iq) - bs + 1, bs):
        _, ev = dec.process(iq[i:i + bs])
        events.extend(ev)
        # the chunked path must actually have engaged for this to test
        # anything: lane count >= 1 at this block size
        assert dec.demod.recov._lanes_for(bs) >= 1
    assert any(e.valid and e.dst == "SP5WWP" and e.src == "N0CALL"
               for e in events)


def test_m17_end_to_end_voice():
    codec2 = pytest.importorskip("sdrpp_tpu.decoders.codec2")
    if not codec2.available():
        pytest.skip("libcodec2 not present")
    from sdrpp_tpu.models.m17_chain import M17Decoder

    # Build a voice transmission: encode a 300 Hz tone with codec2-3200
    enc = codec2.Codec2()
    nframes = 12  # stream frames, 2 codec2 frames each
    t = np.arange(nframes * 2 * 160) / 8000.0
    speech = (np.sin(2 * np.pi * 300.0 * t) * 8000).astype(np.int16)
    bits = enc.encode(speech)

    blocks = [mf.encode_lsf_frame(LSF)]
    for fn in range(nframes):
        blocks.append(mf.encode_stream_frame(LSF, fn, bits[fn * 16:(fn + 1) * 16]))

    fs = 48000.0
    iq = _modulate(blocks, fs, rng=np.random.default_rng(3))

    dec = M17Decoder(fs)
    audio = []
    events = []
    bs = 12000
    for i in range(0, len(iq) - bs + 1, bs):
        a, ev = dec.process(iq[i:i + bs])
        audio.append(a)
        events.extend(ev)

    # LSF recovered (from the LSF frame and/or LICH)
    assert any(e.dst == "SP5WWP" and e.src == "N0CALL" for e in events)

    audio = np.concatenate(audio, axis=0)
    # voice gating drops the first frame; expect most of the audio
    assert audio.shape[0] >= (nframes - 2) * 320
    mono = audio[:, 0].astype(np.float64)
    # synthesized tone: loud, dominant near 300 Hz
    seg = mono[320:]
    assert np.sqrt(np.mean(seg**2)) > 0.01
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    peak_hz = np.argmax(spec) * 8000.0 / len(seg)
    assert abs(peak_hz - 300.0) < 50.0
