"""Web panadapter (misc/webui.py): engine + HTTP API, headless.

The browser page is not exercised here; the API it consumes is — state
JSON, binary FFT/waterfall endpoints, the control plane (click-to-tune =
set_offset, demod menu = set_mode), and the progressive WAV audio stream.
"""

import json
import struct
import time
import urllib.request

import jax
import numpy as np
import pytest

from sdrpp_tpu.io.sources import TestSource
from sdrpp_tpu.misc.webui import ReceiverEngine, WebUIServer


def _engine(**kw):
    src = TestSource(1000000.0, tones=[(100000.0, -20.0)], noise_dbfs=-90.0)
    kw.setdefault("mode", "nfm")
    kw.setdefault("offset", 100000.0)
    kw.setdefault("fft_size", 4096)
    kw.setdefault("base_block", 65536)
    kw.setdefault("realtime", False)
    return ReceiverEngine(src, **kw)


def _wait(pred, timeout=180.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.05)
    return False


def _settle(eng, timeout=180.0):
    """Wait until no background rebuild is pending/compiling and the
    engine has adopted it — needed before asserting 'no rebuild
    happened', since reconfigs now compile asynchronously."""
    ok = _wait(lambda: not eng.snapshot()["switching"], timeout)
    b0 = eng.blocks
    return ok and _wait(lambda: eng.blocks > b0, timeout)


@pytest.fixture(scope="module")
def server():
    eng = _engine()
    srv = WebUIServer(eng, port=0)
    import threading

    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    eng.start()
    assert _wait(lambda: eng.blocks >= 2), eng.error
    yield srv, eng, f"http://127.0.0.1:{srv.server_address[1]}"
    eng.stop()
    srv.shutdown()
    srv.server_close()


def _get(url, binary=False):
    with urllib.request.urlopen(url, timeout=30) as r:
        body = r.read()
        return (body, dict(r.headers)) if binary else json.loads(body)


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_index_and_state(server):
    _, eng, base = server
    with urllib.request.urlopen(base + "/", timeout=30) as r:
        page = r.read().decode()
    assert "<canvas" in page and "/api/state" in page

    st = _get(base + "/api/state")
    assert st["samplerate"] == 1000000.0
    assert st["mode"] == "nfm" and st["offset"] == 100000.0
    assert st["running"] and st["error"] is None
    assert st["blocks"] >= 2


def test_fft_endpoint_sees_the_tone(server):
    _, eng, base = server
    body, hdrs = _get(base + "/api/fft", binary=True)
    line = np.frombuffer(body, "<f4")
    assert len(line) == eng.waterfall.data_width
    # the -20 dBFS tone at +100 kHz must be the spectral peak
    peak = np.argmax(line)
    frac = peak / len(line) - 0.5
    assert abs(frac * 1000000.0 - 100000.0) < 5000.0
    assert line[peak] > line.mean() + 20.0


def test_waterfall_rows_advance(server):
    _, eng, base = server
    body, hdrs = _get(base + "/api/waterfall?since=0", binary=True)
    line0 = int(hdrs["X-Line"])
    rows = int(hdrs["X-Rows"])
    width = int(hdrs["X-Width"])
    assert rows >= 1 and width == eng.waterfall.data_width
    assert len(body) == rows * width * 4
    blocks0 = eng.blocks
    assert _wait(lambda: eng.blocks > blocks0)
    _, hdrs2 = _get(base + f"/api/waterfall?since={line0}", binary=True)
    assert int(hdrs2["X-Line"]) > line0


def test_control_set_offset_and_mode(server):
    _, eng, base = server
    code, resp = _post(base + "/api/control",
                       {"action": "set_offset", "value": -200000.0})
    assert code == 200 and resp["ok"]
    blocks0 = eng.blocks
    assert _wait(lambda: eng.blocks > blocks0)  # rebuild + next block
    st = _get(base + "/api/state")
    assert st["offset"] == -200000.0

    code, resp = _post(base + "/api/control",
                       {"action": "set_mode", "value": "am"})
    assert code == 200
    blocks0 = eng.blocks
    assert _wait(lambda: eng.blocks > blocks0)
    st = _get(base + "/api/state")
    assert st["mode"] == "am" and st["error"] is None
    # restore
    _post(base + "/api/control", {"action": "set_mode", "value": "nfm"})
    _post(base + "/api/control", {"action": "set_offset", "value": 100000.0})


def test_control_rejects_garbage(server):
    _, _, base = server
    code, resp = _post(base + "/api/control", {"action": "frobnicate"})
    assert code == 400 and "unknown action" in resp["error"]
    code, resp = _post(base + "/api/control",
                       {"action": "set_mode", "value": "chirp"})
    assert code == 400


def test_audio_stream_is_progressive_wav(server):
    _, eng, base = server
    with urllib.request.urlopen(base + "/audio.wav", timeout=30) as r:
        hdr = r.read(44)
        assert hdr[:4] == b"RIFF" and hdr[8:12] == b"WAVE"
        fmt, channels, rate = struct.unpack_from("<HHI", hdr, 20)
        assert (fmt, channels, rate) == (1, 2, int(eng.audio_rate))
        (bits,) = struct.unpack_from("<H", hdr, 34)
        assert bits == 16
        pcm = r.read(4 * 4800)  # 4800 stereo frames
        assert len(pcm) == 4 * 4800


def test_volume_and_range_controls(server):
    _, eng, base = server
    _post(base + "/api/control", {"action": "set_volume", "value": 0.5})
    assert eng.volume == 0.5
    _post(base + "/api/control", {"action": "set_range",
                                  "value": [-90.0, -10.0]})
    st = _get(base + "/api/state")
    assert st["waterfall_min"] == -90.0 and st["waterfall_max"] == -10.0
    _post(base + "/api/control", {"action": "auto_range"})
    st = _get(base + "/api/state")
    assert st["waterfall_min"] != -90.0 or st["waterfall_max"] != -10.0


def test_engine_fft_hold_trace(server):
    _, eng, base = server
    _post(base + "/api/control", {"action": "set_fft_hold", "value": True})
    blocks0 = eng.blocks
    assert _wait(lambda: eng.blocks > blocks0)
    body, hdrs = _get(base + "/api/fft", binary=True)
    assert hdrs.get("X-Hold") == "1"
    both = np.frombuffer(body, "<f4")
    assert len(both) == 2 * eng.waterfall.data_width
    _post(base + "/api/control", {"action": "set_fft_hold", "value": False})


def test_multi_vfo_add_select_delete(server):
    _, eng, base = server
    code, resp = _post(base + "/api/control",
                       {"action": "add_vfo",
                        "value": {"name": "vfoB", "mode": "am",
                                  "offset": -150000.0}})
    assert code == 200, resp
    blocks0 = eng.blocks
    assert _wait(lambda: eng.blocks > blocks0)
    st = _get(base + "/api/state")
    assert set(st["vfos"]) == {"vfo0", "vfoB"}
    assert st["selected"] == "vfoB"  # add selects the new VFO
    assert st["vfos"]["vfoB"]["mode"] == "am"
    assert st["vfos"]["vfoB"]["offset"] == -150000.0

    # both audio streams serve independently
    for name in ("vfo0", "vfoB"):
        with urllib.request.urlopen(base + f"/audio.wav?vfo={name}",
                                    timeout=30) as r:
            hdr = r.read(44)
            assert hdr[:4] == b"RIFF"
            assert len(r.read(4 * 480)) == 4 * 480

    # set_offset applies to the SELECTED vfo
    _post(base + "/api/control", {"action": "set_offset", "value": 50000.0})
    blocks0 = eng.blocks
    assert _wait(lambda: eng.blocks > blocks0)
    st = _get(base + "/api/state")
    assert st["vfos"]["vfoB"]["offset"] == 50000.0
    assert st["vfos"]["vfo0"]["offset"] != 50000.0

    # select back, delete vfoB
    code, _ = _post(base + "/api/control",
                    {"action": "select_vfo", "value": "vfo0"})
    assert code == 200
    code, _ = _post(base + "/api/control",
                    {"action": "delete_vfo", "value": "vfoB"})
    assert code == 200
    blocks0 = eng.blocks
    assert _wait(lambda: eng.blocks > blocks0)
    st = _get(base + "/api/state")
    assert set(st["vfos"]) == {"vfo0"} and st["selected"] == "vfo0"
    assert st["error"] is None

    # guard rails
    code, resp = _post(base + "/api/control",
                       {"action": "delete_vfo", "value": "vfo0"})
    assert code == 400 and "last" in resp["error"]
    code, resp = _post(base + "/api/control",
                       {"action": "add_vfo", "value": {"name": "vfo0"}})
    assert code == 400
    code, resp = _post(base + "/api/control",
                       {"action": "select_vfo", "value": "nope"})
    assert code == 400
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(base + "/audio.wav?vfo=nope", timeout=30)
    assert exc.value.code == 404


def test_set_view_zoom(server):
    _, eng, base = server
    code, _ = _post(base + "/api/control",
                    {"action": "set_view", "value": [100000.0, 250000.0]})
    assert code == 200
    st = _get(base + "/api/state")
    assert st["view_offset"] == 100000.0
    assert st["view_bandwidth"] == 250000.0
    blocks0 = eng.blocks
    assert _wait(lambda: eng.blocks > blocks0)
    # the zoomed FFT line still shows the +100 kHz tone, now view-centered
    body, _ = _get(base + "/api/fft", binary=True)
    line = np.frombuffer(body, "<f4")
    peak = np.argmax(line)
    f_peak = 100000.0 + (peak / len(line) - 0.5) * 250000.0
    assert abs(f_peak - 100000.0) < 2000.0
    _post(base + "/api/control",
          {"action": "set_view", "value": [0.0, 1000000.0]})


def test_control_type_validation_and_state_preservation(server):
    _, eng, base = server
    # garbage numeric fields are rejected at request time (a bad value in
    # the engine thread would kill every VFO's stream)
    code, _ = _post(base + "/api/control",
                    {"action": "set_offset", "value": "oops"})
    assert code == 400
    code, _ = _post(base + "/api/control",
                    {"action": "add_vfo",
                     "value": {"name": "bad", "offset": "oops"}})
    assert code == 400
    st = _get(base + "/api/state")
    assert "bad" not in st["vfos"] and st["error"] is None

    # retuning a NEW vfo must not reset vfo0's carried DSP state
    code, _ = _post(base + "/api/control",
                    {"action": "add_vfo",
                     "value": {"name": "vfoC", "mode": "nfm",
                               "offset": -100000.0}})
    assert code == 200
    blocks0 = eng.blocks
    assert _wait(lambda: eng.blocks > blocks0)
    ref_state = eng._state[1]["vfo0"]
    _post(base + "/api/control", {"action": "set_offset", "value": -90000.0})
    blocks0 = eng.blocks
    assert _wait(lambda: eng.blocks > blocks0 + 1)
    # vfo0's state object advanced with the stream but was NOT re-inited
    # (its built cfg is unchanged, so the rebuild carried it over);
    # compare against a fresh init: carried phases differ from zeros
    leaf = jax.tree_util.tree_leaves(eng._state[1]["vfo0"])
    fresh = jax.tree_util.tree_leaves(eng._channels["vfo0"].init_state())
    same_as_fresh = all(
        a.shape != b.shape or np.allclose(np.asarray(a), np.asarray(b))
        for a, b in zip(leaf, fresh))
    assert not same_as_fresh, "vfo0 state was reset by another vfo's retune"
    _post(base + "/api/control", {"action": "select_vfo", "value": "vfo0"})
    _post(base + "/api/control", {"action": "delete_vfo", "value": "vfoC"})


def test_rds_through_engine(tmp_path):
    """SURVEY §3.5's deepest chain served by the web engine: WFM MPX with
    a 57 kHz RDS subcarrier -> wfm VFO with rds=True -> PI/PS fields in
    the state snapshot (what the reference shows in its radio menu)."""
    from sdrpp_tpu.decoders import rds as rds_mod
    from sdrpp_tpu.io.sources import FileSource
    from sdrpp_tpu.io.wav import write_wav
    from sdrpp_tpu.models.rds_chain import RDS_BAUD

    fs, dev = 240000.0, 75000.0
    bits = []
    name = b"JAXRADIO"
    for rep in range(16):
        for seg in range(4):
            block_b = (0 << 12) | (9 << 5) | seg
            blocks = [0x2ABC, block_b, 0xE0E0,
                      (name[seg * 2] << 8) | name[seg * 2 + 1]]
            bits += rds_mod.encode_group(blocks)
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
    mpx = (0.41 * l + 0.1 * np.sin(2 * np.pi * 19000.0 * t)
           + 0.06 * rds_bb * np.cos(2 * np.pi * 57000.0 * t))
    iq = np.exp(1j * np.cumsum(2 * np.pi * dev * mpx / fs))
    p = tmp_path / "rds_240000Hz.wav"
    write_wav(p, int(fs), np.stack([iq.real * 0.8, iq.imag * 0.8], -1)
              .astype(np.float32), "f32")

    src = FileSource(p, loop=True)
    eng = ReceiverEngine(src, mode="wfm", offset=0.0, realtime=False,
                         base_block=131072, fft_size=4096)
    eng.control("set_rds", True)
    eng.start()
    try:
        def locked():
            if eng.error:
                raise AssertionError(eng.error)
            rx = eng._rds.get("vfo0")
            return rx is not None and rx.decoder.pi_code == 0x2ABC \
                and rx.decoder.ps_name == "JAXRADIO"
        # generous ceiling: under full-suite parallel load the wfm+rds
        # rebuild alone can take tens of seconds before decode starts
        # (passes in ~7 s on an idle machine)
        assert _wait(locked, timeout=300.0), (
            eng.error, {k: v.decoder.groups_decoded
                        for k, v in eng._rds.items()})
    finally:
        eng.stop()
    snap = eng.snapshot()
    rd = snap["vfos"]["vfo0"]["rds_data"]
    assert rd["pi"] == "2ABC" and rd["ps_name"] == "JAXRADIO"
    # a full PS name needs all 4 segment groups
    assert rd["groups"] >= 4


def test_session_persistence_roundtrip(tmp_path):
    from sdrpp_tpu.misc.webui import load_session, save_session

    cfg = tmp_path / "ui.json"
    eng = _engine()
    eng.control("add_vfo", {"name": "music", "mode": "wfm",
                            "offset": 250000.0})
    eng.control("set_rds", True)
    eng.control("set_volume", 0.7)
    eng.start()
    assert _wait(lambda: eng.blocks >= 1 and "music" in eng.vfos), eng.error
    eng.stop()
    save_session(eng, cfg)

    eng2 = _engine()
    load_session(eng2, cfg)
    assert set(eng2.vfos) == {"vfo0", "music"}
    assert eng2.selected == "music"
    assert eng2.vfos["music"]["mode"] == "wfm"
    assert eng2.vfos["music"]["rds"] is True
    assert eng2.volume == 0.7
    eng2.start()
    assert _wait(lambda: eng2.blocks >= 1), eng2.error
    eng2.stop()
    assert eng2.error is None


def test_raw_mode_and_deemphasis_controls(server):
    _, eng, base = server
    code, _ = _post(base + "/api/control",
                    {"action": "set_deemphasis", "value": "bogus"})
    assert code == 400
    for value, want in (("50us", "50us"), (None, None)):
        code, _ = _post(base + "/api/control",
                        {"action": "set_deemphasis", "value": value})
        assert code == 200
        blocks0 = eng.blocks
        assert _wait(lambda: eng.blocks > blocks0)
        st = _get(base + "/api/state")
        assert st["deemphasis"] == want and st["error"] is None

    code, _ = _post(base + "/api/control",
                    {"action": "set_mode", "value": "raw"})
    assert code == 200
    blocks0 = eng.blocks
    assert _wait(lambda: eng.blocks > blocks0)
    st = _get(base + "/api/state")
    assert st["mode"] == "raw" and st["error"] is None
    # raw = IQ as stereo; the audio stream still serves
    with urllib.request.urlopen(base + "/audio.wav", timeout=30) as r:
        assert r.read(44)[:4] == b"RIFF"
        assert len(r.read(4 * 480)) == 4 * 480
    _post(base + "/api/control", {"action": "set_mode", "value": "nfm"})
    _post(base + "/api/control", {"action": "set_offset", "value": 100000.0})


def test_bookmarks_roundtrip(tmp_path, server):
    _, eng, base = server
    eng.attach_bookmarks(tmp_path / "bm.json")
    st = _get(base + "/api/bookmarks")
    assert st["enabled"] and st["bookmarks"] == {}

    # bookmark the current VFO (defaults from its cfg)
    _post(base + "/api/control", {"action": "set_offset", "value": 120000.0})
    blocks0 = eng.blocks
    assert _wait(lambda: eng.blocks > blocks0)
    code, _ = _post(base + "/api/control",
                    {"action": "add_bookmark", "value": {"name": "beacon"}})
    assert code == 200
    st = _get(base + "/api/bookmarks")
    assert st["bookmarks"]["beacon"]["frequency"] == 120000.0
    assert st["bookmarks"]["beacon"]["mode"] == "nfm"

    # move away, then apply the bookmark -> back to 120 kHz
    _post(base + "/api/control", {"action": "set_offset", "value": -50000.0})
    blocks0 = eng.blocks
    assert _wait(lambda: eng.blocks > blocks0)
    code, _ = _post(base + "/api/control",
                    {"action": "apply_bookmark", "value": "beacon"})
    assert code == 200
    blocks0 = eng.blocks
    assert _wait(lambda: eng.blocks > blocks0)
    s = _get(base + "/api/state")
    assert s["offset"] == 120000.0 and s["mode"] == "nfm"
    assert s["error"] is None

    # persisted to the config file
    import json as _json
    saved = _json.loads((tmp_path / "bm.json").read_text())
    assert saved["lists"]["General"]["bookmarks"]["beacon"]["frequency"] \
        == 120000.0

    code, _ = _post(base + "/api/control",
                    {"action": "delete_bookmark", "value": "beacon"})
    assert code == 200
    st = _get(base + "/api/bookmarks")
    assert st["bookmarks"] == {}
    code, _ = _post(base + "/api/control",
                    {"action": "apply_bookmark", "value": "nope"})
    assert code == 400
    # restore for other tests
    _post(base + "/api/control", {"action": "set_offset", "value": 100000.0})


def test_set_offset_is_a_state_retune_not_a_rebuild(server):
    """Dynamic-offset VFOs: click-to-tune updates a state scalar — the
    jitted step must be REUSED (a re-jit costs seconds) and the tone must be recovered at the new offset."""
    _, eng, base = server
    assert _settle(eng)  # drain any prior test's async rebuild
    _post(base + "/api/control", {"action": "set_offset", "value": 100000.0})
    blocks0 = eng.blocks
    assert _wait(lambda: eng.blocks > blocks0)
    step_before = eng._step
    _post(base + "/api/control", {"action": "set_offset", "value": -250000.0})
    blocks0 = eng.blocks
    assert _wait(lambda: eng.blocks > blocks0 + 1)
    assert eng._step is step_before, "offset change rebuilt the graph"
    st = _get(base + "/api/state")
    assert st["offset"] == -250000.0 and st["error"] is None
    # retune back onto the test tone; NFM of an unmodulated carrier is
    # near-silence but the chain must keep running
    _post(base + "/api/control", {"action": "set_offset", "value": 100000.0})
    blocks0 = eng.blocks
    assert _wait(lambda: eng.blocks > blocks0 + 1)
    assert eng._step is step_before
    assert eng.snapshot()["error"] is None


def test_scanner_parks_on_the_tone(server):
    """The scanner sweeps the span and stops on the -20 dBFS test tone at
    +100 kHz (reference misc_modules/scanner behavior over the web API)."""
    _, eng, base = server
    _post(base + "/api/control", {"action": "set_offset",
                                  "value": -400000.0})
    code, resp = _post(base + "/api/control",
                       {"action": "scan_start",
                        "value": {"start": -450000.0, "stop": 450000.0,
                                  "interval": 25000.0, "level": -45.0}})
    assert code == 200, resp
    def parked():
        if eng.error:
            raise AssertionError(eng.error)
        s = eng.snapshot()
        return (s["scanning"] and s["scan_receiving"]
                and abs(s["offset"] - 100000.0) < 26000.0)
    assert _wait(parked, timeout=120.0), eng.snapshot()
    code, _ = _post(base + "/api/control", {"action": "scan_stop"})
    assert code == 200
    blocks0 = eng.blocks
    assert _wait(lambda: eng.blocks > blocks0)
    assert not eng.snapshot()["scanning"]
    # garbage rejected
    code, _ = _post(base + "/api/control",
                    {"action": "scan_start",
                     "value": {"start": 10.0, "stop": 5.0, "interval": 1.0}})
    assert code == 400
    _post(base + "/api/control", {"action": "set_offset", "value": 100000.0})


def test_meteor_constellation_endpoint(tmp_path):
    """A meteor (digital) VFO session: QPSK IQ -> MeteorChannel ->
    /api/constellation serves the s8 x84 symbol pairs and they form a
    4-point constellation (the reference constellation_diagram wired in
    meteor main.cpp:70-77)."""
    import threading

    from sdrpp_tpu.io.sources import FileSource
    from sdrpp_tpu.io.wav import write_wav

    fs, rs = 600000.0, 72000.0
    sps = fs / rs
    rng = np.random.default_rng(0)
    n = 1 << 19
    nsym = int(n / sps) + 2
    qpsk = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, nsym)))
    k = np.floor(np.arange(n) / sps).astype(int)
    iq = qpsk[np.clip(k, 0, nsym - 1)]
    p = tmp_path / "meteor_600000Hz.wav"
    write_wav(p, int(fs), np.stack([iq.real * 0.7, iq.imag * 0.7], -1)
              .astype(np.float32), "f32")

    src = FileSource(p, loop=True)
    eng = ReceiverEngine(src, mode="meteor", offset=0.0, realtime=False,
                         base_block=131072, fft_size=4096)
    srv = WebUIServer(eng, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    eng.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        assert _wait(lambda: eng.blocks >= 3), eng.error
        body, hdrs = _get(base + "/api/constellation?vfo=vfo0&n=1024",
                          binary=True)
        assert int(hdrs["X-Count"]) >= 512
        pts = np.frombuffer(body, np.int8).astype(np.float32) / 84.0
        z = pts[0::2] + 1j * pts[1::2]
        z = z[np.abs(z) > 0.3]
        assert len(z) > 400
        # live 4-point constellation: phases mod pi/2 cluster tightly
        coh = np.abs(np.mean(np.exp(4j * np.mod(np.angle(z), np.pi / 2))))
        assert coh > 0.5, coh
        stt = _get(base + "/api/state")
        assert "meteor" in stt["modes"] and stt["mode"] == "meteor"
        assert stt["vfos"]["vfo0"]["mode"] == "meteor"
    finally:
        eng.stop()
        srv.shutdown()
        srv.server_close()


def test_constellation_ring_wraparound():
    """read_constellation returns the newest symbols in order across the
    ring seam (regression for the wrap index math)."""
    eng = _engine()
    try:
        from sdrpp_tpu.misc.webui import CONSTELLATION_RING
        R = CONSTELLATION_RING
        a = (np.arange(R - 100) + 1j * 0).astype(np.complex64)
        eng._write_constellation("vfo0", a)
        out = eng.read_constellation("vfo0", max_points=64)
        np.testing.assert_array_equal(out.real, np.arange(R - 164, R - 100))
        # wrap: 300 more symbols pushes the window across the seam
        b = (np.arange(300) + 1000000.0).astype(np.complex64)
        eng._write_constellation("vfo0", b)
        out = eng.read_constellation("vfo0", max_points=512)
        want = np.concatenate([np.arange(R - 312, R - 100),
                               np.arange(300) + 1000000.0])
        np.testing.assert_array_equal(out.real, want.astype(np.float32))
    finally:
        eng.stop()


def test_meteor_vfo_retune_is_state_only(tmp_path):
    """Retuning a digital (meteor) VFO applies as a state write (dynamic
    offset), not a graph rebuild — same contract as analog VFOs."""
    from sdrpp_tpu.io.sources import TestSource

    src = TestSource(600000.0, tones=[(50000.0, -20.0)], noise_dbfs=-60.0)
    eng = ReceiverEngine(src, mode="meteor", offset=0.0, realtime=False,
                         base_block=65536, fft_size=4096)
    try:
        eng.start()
        assert _wait(lambda: eng.blocks >= 1), eng.error
        step_before = eng._step
        eng.control("set_offset", 50000.0)
        b0 = eng.blocks
        assert _wait(lambda: eng.blocks >= b0 + 2), eng.error
        assert eng.vfos["vfo0"]["offset"] == 50000.0
        assert eng._step is step_before  # no rebuild happened
        assert eng.error is None
    finally:
        eng.stop()


def test_engine_survives_step_failure():
    """The engine loop must treat a step exception as a transient (retry,
    then re-trace) instead of dying: a spurious backend error can hit
    any block, and one blip must not permanently kill every VFO."""
    eng = _engine()
    try:
        eng.start()
        assert _wait(lambda: eng.blocks >= 2), eng.error
        real_step = eng._step
        boom = {"left": 2}

        def flaky(state, x):
            if boom["left"] > 0:
                boom["left"] -= 1
                raise RuntimeError("UNIMPLEMENTED: backend error")
            return real_step(state, x)

        eng._step = flaky
        b0 = eng.blocks
        # survives the two injected failures (second one triggers a
        # re-trace, which also replaces the flaky wrapper) and streams on
        assert _wait(lambda: eng.blocks >= b0 + 3), eng.error
        assert eng.failures >= 1
        assert eng._thread.is_alive()
        st = eng.snapshot()
        assert st["running"] and st["failures"] >= 1
    finally:
        eng.stop()


def test_engine_reverts_bad_mode_switch(monkeypatch):
    """A mode switch whose graph cannot be built/run must degrade to the
    last-good config, not kill the session (reference: live reconfig
    without teardown, radio_module.h:498-580)."""
    import sdrpp_tpu.models.lrpt as lrpt

    class Broken:
        def __init__(self, *a, **kw):
            raise RuntimeError("synthetic meteor build failure")

    eng = _engine()
    try:
        eng.start()
        assert _wait(lambda: eng.blocks >= 2), eng.error
        monkeypatch.setattr(lrpt, "MeteorChannel", Broken)
        eng.control("set_mode", "meteor")
        # ladder: fail -> retry -> re-trace (fails) -> revert to nfm
        assert _wait(lambda: eng.vfos["vfo0"]["mode"] == "nfm", timeout=60)
        b0 = eng.blocks
        assert _wait(lambda: eng.blocks >= b0 + 2), eng.error
        assert eng._thread.is_alive()
        assert eng.failures >= 1
        # and audio keeps flowing on the reverted analog mode
        a0 = eng.audio_written("vfo0")
        assert _wait(lambda: eng.audio_written("vfo0") > a0)
    finally:
        eng.stop()


def test_queued_add_then_delete_validates_in_request_order():
    """Controls apply at block boundaries; an add_vfo immediately
    followed by delete_vfo/select_vfo of the same name must validate
    against the EFFECTIVE (queue-applied) vfo set — found by the
    soak tool racing the engine thread."""
    eng = _engine()
    try:
        # no engine thread: controls stay queued, exposing the race
        eng.control("add_vfo", {"name": "q1", "offset": 0.0})
        eng.control("select_vfo", "q1")  # must not raise
        eng.control("delete_vfo", "q1")  # must not raise
        with pytest.raises(ValueError):
            eng.control("delete_vfo", "q1")  # now effectively gone
        with pytest.raises(ValueError):
            eng.control("add_vfo", {"name": "vfo0", "offset": 0.0})
        eng.start()
        assert _wait(lambda: eng.blocks >= 2), eng.error
        assert set(eng.vfos) == {"vfo0"}
    finally:
        eng.stop()


def test_set_squelch_is_a_state_write_not_a_rebuild():
    """Changing the squelch THRESHOLD mirrors the reference's runtime
    setLevel (squelch.h:63-66): a scalar state write between blocks, no
    re-jit. Only None<->number
    (adding/removing the block) rebuilds."""
    eng = _engine(squelch=-70.0)
    try:
        eng.start()
        assert _wait(lambda: eng.blocks >= 1), eng.error
        step_before = eng._step
        eng.control("set_squelch", -55.0)
        b0 = eng.blocks
        assert _wait(lambda: eng.blocks >= b0 + 2), eng.error
        assert eng.vfos["vfo0"]["squelch"] == -55.0
        assert eng._step is step_before  # no rebuild
        lvl = float(np.asarray(eng._state[1]["vfo0"]["squelch"]["level"]))
        assert lvl == -55.0
        # removing the squelch block IS structural: rebuild expected
        eng.control("set_squelch", None)
        assert _wait(lambda: eng._step is not step_before), eng.error
    finally:
        eng.stop()


def test_set_bandwidth_is_a_state_write_not_a_rebuild():
    """Bandwidth is runtime STATE (VERDICT r4 #3): changing it — to ANY
    value, not just a preset — mirrors the reference's state-preserving
    FIR::setTaps hot-swap (fir.h:31-52, radio_module.h:461-471): a host
    tap design + state write between blocks, no re-jit."""
    eng = _engine()
    try:
        eng.start()
        assert _wait(lambda: eng.blocks >= 1), eng.error
        step_before = eng._step
        # an arbitrary, off-preset value
        eng.control("set_bandwidth", 9137.0)
        b0 = eng.blocks
        assert _wait(lambda: eng.blocks >= b0 + 2), eng.error
        assert eng.vfos["vfo0"]["bandwidth"] == 9137.0
        assert eng._step is step_before  # no rebuild
        # the runtime taps actually changed: the VFO channel filter's
        # taps state leaf is no longer the 12.5 kHz default design
        chan = eng._channels["vfo0"]
        t = np.asarray(eng._state[1]["vfo0"]["vfo"]["filter"]["taps"])
        expect = chan.vfo.filter.taps_state(
            chan.vfo.design_channel_taps(9137.0))
        assert np.allclose(t, np.asarray(expect))
        # out-of-range values clamp to the reference's mode range
        eng.control("set_bandwidth", 5.0)
        assert _wait(lambda: eng.vfos["vfo0"]["bandwidth"] == 1000.0), \
            eng.vfos["vfo0"]["bandwidth"]
        assert eng._step is step_before
        # back to the mode default (None) is also a state write
        eng.control("set_bandwidth", None)
        b0 = eng.blocks
        assert _wait(lambda: eng.blocks >= b0 + 2), eng.error
        assert eng.vfos["vfo0"]["bandwidth"] is None
        assert eng._step is step_before
        assert eng.failures == 0
    finally:
        eng.stop()


def test_raw_bandwidth_change_rebuilds_cleanly():
    """RAW channels have dynamic_bandwidth OFF (no bandwidth-dependent
    stage), so a raw bandwidth change is structural: the graph key must
    INCLUDE bandwidth for raw or _adopt carries a shape-mismatched
    state into the rebuilt graph (r5 review finding: the engine then
    walks the recovery ladder instead of a clean rebuild)."""
    eng = _engine()
    try:
        eng.start()
        assert _wait(lambda: eng.blocks >= 1), eng.error
        eng.control("set_mode", "raw")
        assert _settle(eng, timeout=240)
        assert eng._built_cfgs["vfo0"]["mode"] == "raw"
        f0 = eng.failures
        eng.control("set_bandwidth", 30000.0)
        assert _wait(lambda: eng._built_cfgs["vfo0"].get("bandwidth")
                     is not None, timeout=240)
        b0 = eng.blocks
        assert _wait(lambda: eng.blocks >= b0 + 2), eng.error
        # clean rebuild: no ladder trips, no errors
        assert eng.failures == f0 and eng.error is None
        # raw/digital bandwidths snap to the compile-safe grid
        from sdrpp_tpu.misc.webui import _DIGITAL_BW_GRID
        assert eng.vfos["vfo0"]["bandwidth"] in _DIGITAL_BW_GRID
    finally:
        eng.stop()


def test_adopt_carries_untouched_vfo_state():
    """Swapping to a new graph (async rebuild) must hand untouched VFOs
    their carried DSP state unchanged — retuning/rebuilding one VFO must
    not pop or re-lock the others (the reference restarts only the
    touched module, dsp/block.h:47-65 tempStop/tempStart)."""
    eng = _engine()
    try:
        # engine NOT started: drive plan/adopt by hand so no engine
        # thread races the state-identity comparison
        with eng.lock:
            eng.vfos["b"] = dict(mode="am", offset=-150000.0,
                                 bandwidth=None, squelch=None,
                                 deemphasis=None, rds=False)
        eng._build()
        state_a = eng._state[1]["vfo0"]
        # change ONLY vfo b's mode; adopt synchronously via plan/adopt
        with eng.lock:
            cfgs = {k: dict(v) for k, v in eng.vfos.items()}
        cfgs["b"]["mode"] = "usb"
        with eng.lock:
            eng.vfos["b"]["mode"] = "usb"
        eng._adopt(eng._plan(cfgs))
        # vfo0's carried state must be the very same pytree leaves
        import jax
        old_leaves = jax.tree_util.tree_leaves(state_a)
        new_leaves = jax.tree_util.tree_leaves(eng._state[1]["vfo0"])
        assert len(old_leaves) == len(new_leaves)
        assert all(a is b for a, b in zip(old_leaves, new_leaves))
        # ...while vfo b was re-initialized (fresh graph)
        assert eng._built_cfgs["b"]["mode"] == "usb"
    finally:
        eng.stop()


def test_rapid_mode_churn_coalesces_to_last():
    """Rapid successive structural changes coalesce in the background
    builder: the engine must end up on the LAST requested config with
    audio flowing (stale plans are discarded, not adopted)."""
    eng = _engine()
    try:
        eng.start()
        assert _wait(lambda: eng.blocks >= 1), eng.error
        for m in ("am", "usb", "wfm", "lsb", "cw"):
            eng.control("set_mode", m)
        assert _settle(eng, timeout=240)
        assert eng.vfos["vfo0"]["mode"] == "cw"
        assert eng._built_cfgs["vfo0"]["mode"] == "cw"
        a0 = eng.audio_written("vfo0")
        assert _wait(lambda: eng.audio_written("vfo0") > a0)
        assert eng.error is None and eng._thread.is_alive()
    finally:
        eng.stop()


def test_background_preheat_warms_next_modes(monkeypatch):
    """With background_preheat on, the engine warm-compiles the graphs a
    set_mode on the selected VFO would build, while streaming — so the
    user's first switch loads a compiled executable. Corpus shrunk to
    two modes to keep the CPU compile budget small."""
    from sdrpp_tpu.misc import webui as webui_mod

    monkeypatch.setattr(webui_mod, "ALL_MODES", ["nfm", "am"])
    eng = _engine(background_preheat=True)
    try:
        eng.start()
        assert _wait(lambda: eng.blocks >= 1), eng.error
        # both corpus entries (the current nfm set and the am variant)
        # must get preheated in the background while blocks advance
        assert _wait(lambda: len(eng._preheated) >= 2, timeout=300), \
            eng._preheated
        b0 = eng.blocks
        assert _wait(lambda: eng.blocks > b0)
        eng.control("set_mode", "am")
        assert _settle(eng, timeout=240)
        assert eng._built_cfgs["vfo0"]["mode"] == "am"
        assert eng.error is None and eng.failures == 0
        assert eng._preheater is not None and eng._preheater.is_alive()
    finally:
        eng.stop()


def test_preheat_retries_after_transient_failure(monkeypatch):
    """A transient warm_plan failure (backend/compile blip) must NOT mark
    the config as preheated — a later preheater pass retries it, so the
    user's first switch still gets the warmed graph. A
    config that keeps failing is given up after 3 attempts."""
    from sdrpp_tpu.misc import webui as webui_mod

    monkeypatch.setattr(webui_mod, "ALL_MODES", ["nfm"])
    eng = _engine(background_preheat=True)
    real_warm = eng.warm_plan
    boom = {"left": 1, "calls": 0}

    def flaky_warm(cfgs):
        boom["calls"] += 1
        if boom["left"] > 0:
            boom["left"] -= 1
            raise RuntimeError("synthetic preheat blip")
        return real_warm(cfgs)

    eng.warm_plan = flaky_warm
    try:
        eng.start()
        assert _wait(lambda: eng.blocks >= 1), eng.error
        # first attempt fails -> NOT marked preheated -> retried -> done
        assert _wait(lambda: len(eng._preheated) >= 1, timeout=300)
        assert boom["calls"] >= 2  # the blip did not permanently skip it
        assert eng.failures == 0 and eng._thread.is_alive()
    finally:
        eng.stop()


def test_preheat_gives_up_after_repeated_failures(monkeypatch):
    """A config whose warm_plan ALWAYS fails is abandoned after 3
    attempts so one bad mode cannot starve the corpus."""
    from sdrpp_tpu.misc import webui as webui_mod

    monkeypatch.setattr(webui_mod, "ALL_MODES", ["nfm"])
    eng = _engine(background_preheat=True)
    calls = {"n": 0}

    def always_fail(cfgs):
        calls["n"] += 1
        raise RuntimeError("synthetic permanent preheat failure")

    eng.warm_plan = always_fail
    try:
        eng.start()
        assert _wait(lambda: eng.blocks >= 1), eng.error
        assert _wait(lambda: len(eng._preheated) >= 1, timeout=120)
        assert calls["n"] == 3
        assert eng.failures == 0 and eng._thread.is_alive()
    finally:
        eng.stop()


def test_failed_plan_before_first_promotion_reverts_to_running(monkeypatch):
    """A structural control whose graph cannot even be planned, arriving
    BEFORE any step promoted a last-good config, must revert self.vfos
    to the currently-RUNNING config (which the engine never stopped
    streaming) instead of stranding the session on an unbuildable
    config with a forever-lying snapshot."""
    import sdrpp_tpu.models.lrpt as lrpt

    class Broken:
        def __init__(self, *a, **kw):
            raise RuntimeError("synthetic meteor build failure")

    monkeypatch.setattr(lrpt, "MeteorChannel", Broken)
    eng = _engine()
    # no last-good yet: queue the bad switch before the engine starts
    eng.control("set_mode", "meteor")
    try:
        eng.start()
        assert _wait(lambda: eng.failures >= 1, timeout=120)
        # reverted to the built/running config, still streaming
        assert _wait(lambda: eng.vfos["vfo0"]["mode"] == "nfm", timeout=120)
        b0 = eng.blocks
        assert _wait(lambda: eng.blocks > b0 + 1), eng.error
        assert eng._thread.is_alive()
        assert not eng.snapshot()["switching"]
    finally:
        eng.stop()


def test_error_clears_after_recovery():
    """A survived failure must not leave a stale error in /api/state:
    one clean step clears it (failures stays as the history)."""
    eng = _engine()
    try:
        eng.start()
        assert _wait(lambda: eng.blocks >= 1), eng.error
        eng.error = "RuntimeError: synthetic stale blip"
        assert _wait(lambda: eng.error is None, timeout=60)
        assert eng._thread.is_alive()
    finally:
        eng.stop()


def test_ladder_recovers_from_poisoned_device_state():
    """A corrupted/poisoned carried state pytree must NOT survive the
    ladder's re-trace: before the r5 fix, an unchanged graph config made
    _adopt carry the poisoned state into the re-traced graph and the
    engine failed forever (found by an on-hardware ladder drill)."""
    eng = _engine()
    try:
        eng.start()
        assert _wait(lambda: eng.blocks >= 2), eng.error
        f0 = eng.failures
        with eng.lock:
            fe_st, ch_st = eng._state
            bad = dict(ch_st)
            bad["vfo0"] = ()  # structurally wrong channel state
            eng._state = (fe_st, bad)
        assert _wait(lambda: eng.failures > f0, timeout=60)
        # the re-trace (consecutive==2) must drop the poisoned state and
        # resume streaming
        b0 = eng.blocks
        assert _wait(lambda: eng.blocks >= b0 + 3, timeout=120), eng.error
        a0 = eng.audio_written("vfo0")
        assert _wait(lambda: eng.audio_written("vfo0") > a0, timeout=60)
        assert _wait(lambda: eng.error is None, timeout=60)
        assert eng._thread.is_alive()
        assert eng.failures <= f0 + 3  # bounded, not 71
    finally:
        eng.stop()


def test_ladder_rung4_declares_fatal_after_exhaustion(monkeypatch):
    """When the FULL ladder fails on one streak (retry, fresh-state
    re-trace, revert, grace), the engine must stop the retry spam and
    surface a truthful terminal state — the poisoned-process signature
    (no in-process recovery exists). The HTTP surface stays alive; under SDRPP_TPU_SUPERVISED
    the process would instead exit 86 for the supervisor."""
    monkeypatch.delenv("SDRPP_TPU_SUPERVISED", raising=False)
    eng = _engine()
    try:
        eng.start()
        assert _wait(lambda: eng.blocks >= 2), eng.error

        def boom(*a, **kw):
            raise RuntimeError("UNIMPLEMENTED: backend error")

        # every execution AND every rebuild fails — the poisoned-client
        # shape (pre-compiled executables fail too)
        eng._step = boom
        monkeypatch.setattr(type(eng), "_plan", boom)
        assert _wait(lambda: eng.fatal, timeout=120)
        assert eng.error and "restart required" in eng.error
        assert eng._thread.is_alive()  # HTTP surface stays serviceable
        snap = eng.snapshot()
        assert snap["fatal"] is True and snap["error"] == eng.error
    finally:
        eng.stop()


def test_supervised_engine_exits_86_on_fatal():
    """Under SDRPP_TPU_SUPERVISED the rung-4 fatal path must actually
    os._exit(BACKEND_FATAL_EXIT) — executed for real in a subprocess
    (the handshake the supervisor loop restarts on)."""
    import os
    import subprocess
    import sys

    script = r"""
import os, sys, time
import jax; jax.config.update("jax_platforms", "cpu")
from sdrpp_tpu.io.sources import TestSource
from sdrpp_tpu.misc.webui import ReceiverEngine
src = TestSource(250000.0, tones=[(50000.0, -20.0)], noise_dbfs=-90.0)
eng = ReceiverEngine(src, mode="nfm", offset=50000.0, realtime=False,
                     base_block=65536, fft_size=4096)
eng.start()
t0 = time.time()
while eng.blocks < 1 and time.time() - t0 < 240:
    time.sleep(0.1)
assert eng.blocks >= 1, eng.error

def boom(*a, **kw):
    raise RuntimeError("UNIMPLEMENTED: backend error")

eng._step = boom
type(eng)._plan = boom
eng._thread.join(120)  # the fatal path os._exit()s from the engine
print("ENGINE THREAD RETURNED WITHOUT EXIT", flush=True)
sys.exit(3)
"""
    env = dict(os.environ, SDRPP_TPU_SUPERVISED="1", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=600)
    from sdrpp_tpu.misc.webui import BACKEND_FATAL_EXIT
    assert r.returncode == BACKEND_FATAL_EXIT, \
        (r.returncode, r.stdout[-500:], r.stderr[-1000:])


def test_supervisor_restarts_on_backend_fatal():
    """cli's _supervise loop: restart on BACKEND_FATAL_EXIT, propagate
    any other exit code."""
    from sdrpp_tpu.cli import BACKEND_FATAL_EXIT, _supervise

    codes = [BACKEND_FATAL_EXIT, BACKEND_FATAL_EXIT, 0]
    calls = {"n": 0}

    def spawn():
        rc = codes[calls["n"]]
        calls["n"] += 1
        return rc

    import time as _time
    real_sleep = _time.sleep
    _time.sleep = lambda s: real_sleep(0)
    try:
        assert _supervise(["unused"], _spawn=spawn) == 0
    finally:
        _time.sleep = real_sleep
    assert calls["n"] == 3

    calls["n"] = 0
    codes[:] = [3]
    assert _supervise(["unused"], _spawn=spawn) == 3
    assert calls["n"] == 1


def test_rebuild_failure_error_stays_until_next_control(monkeypatch):
    """A failed background rebuild reverts and the engine immediately
    streams clean blocks on the reverted graph — the error must STAY in
    /api/state until the next control arrives, or a user's failed
    set_mode reverts essentially silently (ADVICE r4)."""
    import sdrpp_tpu.models.lrpt as lrpt

    class Broken:
        def __init__(self, *a, **kw):
            raise RuntimeError("synthetic meteor build failure")

    eng = _engine()
    try:
        eng.start()
        assert _wait(lambda: eng.blocks >= 2), eng.error
        monkeypatch.setattr(lrpt, "MeteorChannel", Broken)
        eng.control("set_mode", "meteor")
        assert _wait(lambda: eng.failures >= 1, timeout=120)
        assert _wait(lambda: eng.vfos["vfo0"]["mode"] == "nfm", timeout=120)
        # many clean steps later the rebuild-failure error is still there
        b0 = eng.blocks
        assert _wait(lambda: eng.blocks >= b0 + 3), eng.error
        assert eng.error is not None and "build failure" in eng.error
        assert eng.snapshot()["error"] == eng.error
        # the next control supersedes it; a clean step then clears it
        eng.control("set_offset", 90000.0)
        assert _wait(lambda: eng.error is None, timeout=60)
    finally:
        eng.stop()


def test_runtime_scalars_survive_ladder_revert():
    """Retune/squelch-knob writes are runtime state; a graph revert must
    restore the last good GRAPH but keep the knobs where the user left
    them — so the scalar writes propagate into the revert targets."""
    eng = _engine(squelch=-50.0)
    try:
        eng.start()
        assert _wait(lambda: eng.blocks >= 1), eng.error
        # wait for promotion so _last_good_vfos exists
        assert _wait(lambda: eng._last_good_vfos is not None)
        eng.control("set_squelch", -70.0)
        eng.control("set_offset", 120000.0)
        assert _wait(lambda: eng.vfos["vfo0"]["squelch"] == -70.0
                     and eng.vfos["vfo0"]["offset"] == 120000.0)
        assert _wait(lambda: eng._last_good_vfos["vfo0"]["squelch"]
                     == -70.0)
        assert eng._last_good_vfos["vfo0"]["offset"] == 120000.0
    finally:
        eng.stop()


def test_session_persists_digital_vfo(tmp_path):
    """save_session writes digital (meteor) VFOs; load_session must
    restore them too, not silently drop them."""
    from sdrpp_tpu.misc.webui import load_session, save_session

    cfg = tmp_path / "ui.json"
    eng = _engine()
    with eng.lock:
        eng.vfos["sat"] = dict(mode="meteor", offset=-150000.0,
                               bandwidth=140000.0, squelch=None,
                               deemphasis=None, rds=False)
        eng._ensure_audio_ring("sat")
    save_session(eng, cfg)

    eng2 = _engine()
    load_session(eng2, cfg)
    assert "sat" in eng2.vfos and eng2.vfos["sat"]["mode"] == "meteor"
    assert "sat" in eng2._digital  # planned as a digital channel
