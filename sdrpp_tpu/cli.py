"""Command-line entry points: run / spectrum / serve / bench.

The reference's entry points are the GUI app and ``sdrpp --server``
(core/src/core.cpp:67-415, server.cpp:49-161). Headless equivalents:

- ``run``      IQ source -> demod chain -> WAV/FLAC/MP3 (+ checkpoint/resume)
- ``bank``     N channels at once: batched VFO bank -> per-channel files
- ``spectrum`` IQ -> waterfall dB lines -> .npy
- ``scan``     sweep a band, park on active signals
- ``decode``   digital decoders: m17 / hrpt / falcon9 / kgsstv / meteor
- ``serve``    stream quantized baseband over TCP (the server protocol)
- ``preheat``  precompile the UI mode corpus into the persistent cache
- ``bench``    the headline throughput benchmark

Usage: python -m sdrpp_tpu <command> [options]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .utils import log


def _add_backend_args(p):
    p.add_argument("--cpu", action="store_true",
                   help="force the CPU backend through jax.config "
                        "in-process, before any jax-touching import (a "
                        "site customization can override JAX_PLATFORMS, "
                        "and a child on another backend splits the "
                        "persistent compilation cache by backend hash)")


def _apply_backend(args):
    if getattr(args, "cpu", False):
        import jax

        jax.config.update("jax_platforms", "cpu")
        log.info("backend: cpu (forced by --cpu)")


def _add_source_args(p):
    p.add_argument("--source", required=True,
                   help="IQ WAV path, 'test:<samplerate>', "
                        "'rtltcp:<host>:<port>[:<samplerate>]', "
                        "'spyserver:<host>:<port>', "
                        "'kiwisdr:<host>:<port>[:<freq_hz>]', "
                        "'hpsdr:<host>[:<port>[:<samplerate>]]', "
                        "'hermes:<host>[:<port>[:<samplerate>]]', "
                        "'rfspace:<host>:<port>[:<samplerate>]', or "
                        "'spectran:<host>[:<port>]'")
    p.add_argument("--tone", type=float, default=100000.0,
                   help="test source tone offset Hz")


def _make_source(args):
    from .io.sources import FileSource, TestSource

    src = args.source
    if src.startswith("test:"):
        fs = float(src.split(":", 1)[1])
        return TestSource(fs, tones=[(args.tone, -20.0)], noise_dbfs=-90.0)
    if src.startswith("rtltcp:"):
        from .io.rtl_tcp import RtlTcpSource
        parts = src.split(":")
        sr = float(parts[3]) if len(parts) > 3 else 2400000.0
        return RtlTcpSource(parts[1], int(parts[2]), samplerate=sr)
    if src.startswith("spyserver:"):
        from .io.spyserver import SpyServerSource
        parts = src.split(":")
        s = SpyServerSource(parts[1], int(parts[2]))
        s.start()
        return s
    if src.startswith("kiwisdr:"):
        from .io.kiwisdr import KiwiSDRSource
        parts = src.split(":")
        freq = float(parts[3]) if len(parts) > 3 else 10000000.0
        return KiwiSDRSource(parts[1], int(parts[2]), freq_hz=freq)
    if src.startswith(("hpsdr:", "hermes:")):
        from .io.hpsdr import HermesLite2Source, HpsdrSource
        parts = src.split(":")
        port = int(parts[2]) if len(parts) > 2 else 1024
        cls = HermesLite2Source if src.startswith("hermes:") else HpsdrSource
        sr = float(parts[3]) if len(parts) > 3 else \
            (384000.0 if cls is HermesLite2Source else 192000.0)
        s = cls(parts[1], port, samplerate=sr)
        s.start()
        return s
    if src.startswith("rfspace:"):
        from .io.rfspace import RFspaceSource
        parts = src.split(":")
        s = RFspaceSource(parts[1], int(parts[2]))
        if len(parts) > 3:
            s.set_samplerate(float(parts[3]))
        s.start()
        return s
    if src.startswith("spectran:"):
        from .io.spectran import SpectranHTTPSource
        parts = src.split(":")
        port = int(parts[2]) if len(parts) > 2 else 54664
        return SpectranHTTPSource(parts[1], port)
    return FileSource(src, loop=False)


def cmd_run(argv):
    p = argparse.ArgumentParser(prog="sdrpp_tpu run")
    _add_source_args(p)
    p.add_argument("--mode", default="wfm",
                   choices=["wfm", "nfm", "am", "usb", "lsb", "dsb", "cw", "raw"])
    p.add_argument("--offset", type=float, default=0.0, help="VFO offset Hz")
    p.add_argument("--bandwidth", type=float, default=None)
    p.add_argument("--audio-rate", type=float, default=48000.0)
    p.add_argument("--out", default="audio.wav")
    p.add_argument("--container", default="wav", choices=["wav", "flac", "mp3"],
                   help="recording container (the recorder's WAV/FLAC/MP3)")
    p.add_argument("--sample-format", default="i16",
                   choices=["u8", "i16", "i24", "i32", "f32"],
                   help="sample depth (recorder main.cpp:48-60; f32 WAV only)")
    p.add_argument("--blocks", type=int, default=0, help="0 = until EOF")
    p.add_argument("--block-size", type=int, default=None,
                   help="input samples per device step (default: auto — "
                        "sized so the demod's IF-rate block engages the "
                        "chunk-parallel loop kernels)")
    p.add_argument("--squelch", type=float, default=None)
    p.add_argument("--deemphasis", default=None, choices=[None, "22us", "50us", "75us"])
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="also checkpoint every N blocks during the run")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--trace", default=None, metavar="LOGDIR",
                   help="dump a jax.profiler trace of the run to LOGDIR")
    _add_backend_args(p)
    args = p.parse_args(argv)
    _apply_backend(args)

    import jax.numpy as jnp
    import jax

    from .io.sinks import RecorderSink
    from .models.radio import RadioChannel
    from .utils.checkpoint import load_state, save_state

    src = _make_source(args)
    fs = src.samplerate

    if args.mode == "raw":
        # Baseband recording (the recorder module's baseband mode,
        # misc_modules/recorder): IQ as stereo WAV (L=I, R=Q).
        if args.block_size is None:
            args.block_size = 262144
        n_total = 0
        chunks = []
        block = args.block_size
        src_len = getattr(src, "num_frames", None)
        nblocks = 0
        while args.blocks == 0 or nblocks < args.blocks:
            if src_len is not None and n_total + block > src_len:
                break
            iq = src.read(block)
            chunks.append(np.stack([iq.real, iq.imag], -1))
            n_total += block
            nblocks += 1
            if args.blocks == 0 and src_len is None and nblocks >= 100:
                break
        from .io import wav as wav_mod
        wav_mod.write_wav(args.out, int(fs), np.concatenate(chunks),
                          args.sample_format)
        log.info(f"recorded {n_total} IQ samples -> {args.out}")
        return

    chan = RadioChannel(args.mode, fs, offset=args.offset,
                        bandwidth=args.bandwidth, audio_rate=args.audio_rate,
                        squelch_level=args.squelch, deemphasis=args.deemphasis)
    bm = chan.block_multiple
    block = _auto_block(fs, chan.if_rate, bm) if args.block_size is None \
        else max(bm, (args.block_size // bm) * bm)
    cap = getattr(src, "num_frames", None)
    if args.block_size is None and cap is not None and cap >= bm:
        block = min(block, (cap // bm) * bm)  # short captures: one block
    log.info(f"mode={args.mode} fs={fs:g} block={block} -> audio {args.audio_rate:g}")

    from .utils.iq import device_state
    state = device_state(chan.init_state)
    offset = 0
    if args.resume and args.checkpoint:
        try:
            state, offset = load_state(args.checkpoint, state)
        except ValueError as e:
            log.error(f"cannot resume: checkpoint was written by a different "
                      f"chain configuration ({e})")
            return 2
        if hasattr(src, "seek"):
            src.seek(offset)
        log.info(f"resumed from {args.checkpoint} at sample {offset}")

    import contextlib

    from .utils.tracing import StreamMonitor, annotate, trace
    from .utils.watchdog import StepWatchdog

    from .utils.iq import complex_input, split_iq
    step = StepWatchdog(lambda: jax.jit(complex_input(chan)), max_retries=2,
                        backoff_s=2.0, checkpoint_path=args.checkpoint,
                        checkpoint_every=args.checkpoint_every)
    sink = RecorderSink(args.out, int(args.audio_rate),
                        container=args.container,
                        channels=2 if chan.stereo_out else 1,
                        sample_format=args.sample_format)
    total = 0
    nblocks = 0
    src_len = getattr(src, "num_frames", None)
    mon = StreamMonitor(samplerate=fs)
    ctx = trace(args.trace) if args.trace else contextlib.nullcontext()
    # 3-stage host pipeline (utils/pipeline.py): a reader thread keeps
    # blocks ahead of the device, and each block's outputs are forced to
    # host one iteration late — IO | device | sink write overlap (the
    # SampleFrameBuffer + async-dispatch role).
    from .utils.pipeline import DeferredWriter, Prefetcher

    pre = Prefetcher(src, block)
    writer = DeferredWriter(sink.write)
    try:
        with ctx:
            while args.blocks == 0 or nblocks < args.blocks:
                if src_len is not None and offset + block > src_len:
                    break
                iq = pre.read(block)
                with mon.block(block), annotate(f"run:{args.mode}"):
                    state, audio = step(state, jnp.asarray(split_iq(iq)),
                                        offset=offset + block)
                    out = audio[0] if isinstance(audio, tuple) else audio
                    writer.push(out)
                offset += block
                total += block
                nblocks += 1
                if args.blocks == 0 and src_len is None and nblocks >= 100:
                    break
        writer.flush()
    finally:
        pre.close()
    sink.close()
    log.info(str(mon))
    if args.trace:
        log.info(f"profiler trace -> {args.trace}")
    if args.checkpoint:
        save_state(args.checkpoint, state, stream_offset=offset)
        log.info(f"checkpoint -> {args.checkpoint}")
    log.info(f"processed {total} samples -> {args.out}")


def cmd_bank(argv):
    """Demodulate MANY channels at once: one batched VFO-bank computation
    (the reference's N per-VFO thread chains; SURVEY §2.15)."""
    p = argparse.ArgumentParser(prog="sdrpp_tpu bank")
    _add_source_args(p)
    p.add_argument("--offsets", required=True,
                   help="comma-separated VFO offsets in Hz; use the "
                        "--offsets=-200e3,0,150e3 form when the first "
                        "offset is negative")
    p.add_argument("--mode", default="nfm",
                   choices=["nfm", "am", "usb", "lsb", "cw", "wfm"])
    p.add_argument("--bandwidth", type=float, default=12500.0)
    p.add_argument("--if-rate", type=float, default=48000.0)
    p.add_argument("--squelch", type=float, default=None)
    p.add_argument("--channelizer", default="time", choices=["time", "fft"],
                   help="'fft' = shared-FFT channelizer (one wideband FFT "
                        "for all channels; needs integer fs/if ratio)")
    p.add_argument("--out-dir", default="bank_audio")
    p.add_argument("--container", default="wav", choices=["wav", "flac", "mp3"])
    p.add_argument("--blocks", type=int, default=4)
    p.add_argument("--block-size", type=int, default=262144)
    _add_backend_args(p)
    args = p.parse_args(argv)
    _apply_backend(args)

    import pathlib

    import jax
    import jax.numpy as jnp

    from .io.sinks import RecorderSink
    from .parallel.vfo_bank import ScannerBank
    from .utils.tracing import StreamMonitor

    src = _make_source(args)
    fs = src.samplerate
    offsets = np.array([float(o) for o in args.offsets.split(",")])
    bank = ScannerBank(offsets, fs, mode=args.mode, if_rate=args.if_rate,
                       bandwidth=args.bandwidth, squelch_level=args.squelch,
                       channelizer=args.channelizer)
    bm = bank.block_multiple
    block = max(bm, (args.block_size // bm) * bm)
    log.info(f"{len(offsets)}-channel {args.mode} bank, fs={fs:g}, block={block}")

    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    ext = args.container
    sinks = [RecorderSink(out_dir / f"ch{i}_{int(o):+d}Hz.{ext}",
                          int(args.if_rate), container=args.container)
             for i, o in enumerate(offsets)]
    from .utils.iq import complex_input, split_iq
    step = jax.jit(complex_input(bank))
    from .utils.iq import device_state
    state = device_state(bank.init_state)
    mon = StreamMonitor(samplerate=fs)
    # same 3-stage pipeline as cmd_run: prefetch IO, defer readback
    from .utils.pipeline import DeferredWriter, Prefetcher

    pre = Prefetcher(src, block)
    writer = DeferredWriter(
        lambda a: [sink.write(a[i]) for i, sink in enumerate(sinks)])
    try:
        for _ in range(args.blocks):
            iq = pre.read(block)
            with mon.block(block):
                state, audio = step(state, jnp.asarray(split_iq(iq)))
                writer.push(audio)
        writer.flush()
    finally:
        pre.close()
    for sink in sinks:
        sink.close()
    log.info(f"{mon} (x{len(offsets)} channels = "
             f"{mon.samples_per_sec * len(offsets) / 1e6:.1f} Maggsamp/s)")
    log.info(f"{len(sinks)} channel recordings -> {out_dir}/")


def cmd_spectrum(argv):
    p = argparse.ArgumentParser(prog="sdrpp_tpu spectrum")
    _add_source_args(p)
    p.add_argument("--fft-size", type=int, default=65536)
    p.add_argument("--fft-rate", type=float, default=20.0)
    p.add_argument("--window", default="nuttall",
                   choices=["rectangular", "hamming", "hann", "blackman",
                            "nuttall", "blackman_harris4", "blackman_harris7"])
    p.add_argument("--blocks", type=int, default=4)
    p.add_argument("--block-size", type=int, default=262144)
    p.add_argument("--out", default="waterfall.npy")
    p.add_argument("--framebuffer", default=None,
                   help="also render the palette-mapped waterfall "
                        "framebuffer (uint32 ABGR) to this .npy")
    p.add_argument("--fb-width", type=int, default=1024)
    _add_backend_args(p)
    args = p.parse_args(argv)
    _apply_backend(args)

    import jax
    import jax.numpy as jnp

    from .ops.windows import Window
    from .signal_path import IQFrontEnd

    src = _make_source(args)
    fe = IQFrontEnd(src.samplerate, fft_size=args.fft_size, fft_rate=args.fft_rate,
                    fft_window=Window(args.window), block_size=args.block_size)
    from .utils.iq import complex_input, split_iq
    step = jax.jit(complex_input(fe))
    st = fe.init_state()
    lines = []
    for _ in range(args.blocks):
        st, (_iq, fft) = step(st, jnp.asarray(split_iq(src.read(args.block_size))))
        lines.append(np.asarray(fft))
    wf = np.concatenate(lines, axis=0)
    np.save(args.out, wf)
    log.info(f"waterfall {wf.shape} dB -> {args.out}")

    if args.framebuffer:
        from .misc.waterfall import WaterfallDisplay
        disp = WaterfallDisplay(raw_fft_size=wf.shape[-1],
                                data_width=args.fb_width,
                                waterfall_height=max(len(wf), 2),
                                whole_bandwidth=src.samplerate)
        for line in wf:
            disp.push_fft(line)
        disp.auto_range()
        # re-render at the auto range so the image uses the full palette
        for line in wf:
            disp.push_fft(line)
        np.save(args.framebuffer, disp.framebuffer)
        log.info(f"framebuffer {disp.framebuffer.shape} ABGR -> "
                 f"{args.framebuffer}")


def cmd_serve(argv):
    p = argparse.ArgumentParser(prog="sdrpp_tpu serve")
    _add_source_args(p)
    p.add_argument("--addr", default="127.0.0.1")
    p.add_argument("--port", type=int, default=5259)
    p.add_argument("--block-size", type=int, default=65536)
    p.add_argument("--blocks", type=int, default=0, help="0 = run forever")
    _add_backend_args(p)
    args = p.parse_args(argv)
    _apply_backend(args)

    import time

    from .io.wire import BasebandServer
    from .ops.compression import PCM_TYPE_I16

    src = _make_source(args)
    srv = BasebandServer(args.addr, args.port, samplerate=src.samplerate,
                         pcm_type=PCM_TYPE_I16)
    srv.on_tune = lambda f: src.tune(f)
    # remote-UI controls (the headless SmGui): expose what the selected
    # source supports, like the reference server mirrors the source menu
    srv.register_control("samplerate", "float", src.samplerate,
                         label="Sample rate (Hz)", min=0.0)
    if hasattr(src, "set_gain"):
        srv.register_control("gain", "float", 0.0, label="Gain (dB)",
                             min=0.0, max=50.0)
    if hasattr(src, "tones"):
        srv.register_control("tone_offset", "float", args.tone,
                             label="Test tone offset (Hz)")

    def _on_control(name, value):
        if name == "gain" and hasattr(src, "set_gain"):
            src.set_gain(value)
        elif name == "tone_offset" and hasattr(src, "tones"):
            src.tones = [(value, -20.0)]

    srv.on_control = _on_control
    log.info(f"baseband server on {args.addr}:{srv.port} fs={src.samplerate:g}")
    sent = 0
    try:
        while args.blocks == 0 or sent < args.blocks:
            if srv.running:
                srv.send_baseband(src.read(args.block_size))
                sent += 1
            else:
                time.sleep(0.05)
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()


# child exit code meaning "restart me" — the engine side lives in
# misc/webui.py; re-exported here for the supervisor and tests
from .misc.webui import BACKEND_FATAL_EXIT  # noqa: E402


def _supervise(cmd, max_restarts: int = 20, _spawn=None):
    """Process-level recovery loop (the recovery ladder's rung 4): run
    ``cmd`` as a child with SDRPP_TPU_SUPERVISED set; when it exits with
    BACKEND_FATAL_EXIT (the engine detected an unrecoverable backend that
    neither retry/re-trace nor backend re-creation can fix in-process),
    restart it. Any other exit code propagates. The reference's
    equivalent resilience is per-thread trap-and-continue
    (core/src/utils/threading.h:55-61); a device client's fault domain is
    the PROCESS, so that is where the trap goes."""
    import os
    import subprocess
    import time

    env = dict(os.environ, SDRPP_TPU_SUPERVISED="1")
    spawn = _spawn or (lambda: subprocess.run(cmd, env=env).returncode)
    restarts = 0
    while True:
        rc = spawn()
        if rc != BACKEND_FATAL_EXIT:
            return rc
        restarts += 1
        if restarts > max_restarts:
            log.error(f"supervisor: giving up after {restarts - 1} "
                      "backend-fatal restarts")
            return 1
        log.warn(f"supervisor: backend unrecoverable (exit {rc}); "
                 f"restarting session (attempt {restarts})")
        time.sleep(min(5.0 * restarts, 60.0))


def cmd_ui(argv):
    """Web panadapter: spectrum/waterfall + tuning + audio in a browser
    (the reference GUI's role on a headless accelerator host,
    misc/webui.py)."""
    p = argparse.ArgumentParser(prog="sdrpp_tpu ui")
    _add_source_args(p)
    p.add_argument("--addr", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8073)
    from .misc.webui import ALL_MODES
    p.add_argument("--mode", default="wfm", choices=ALL_MODES,
                   help="demod mode; digital modes (e.g. meteor) start a "
                        "constellation VFO instead of audio")
    p.add_argument("--offset", type=float, default=0.0, help="VFO offset Hz")
    p.add_argument("--bandwidth", type=float, default=None)
    p.add_argument("--squelch", type=float, default=None)
    p.add_argument("--audio-rate", type=float, default=48000.0)
    p.add_argument("--fft-size", type=int, default=16384)
    p.add_argument("--fft-rate", type=float, default=20.0)
    p.add_argument("--block-size", type=int, default=262144)
    p.add_argument("--no-realtime", action="store_true",
                   help="process as fast as possible (file benchmarking)")
    p.add_argument("--no-bg-preheat", action="store_true",
                   help="don't warm-compile the other modes' graphs in "
                        "the background once streaming starts")
    p.add_argument("--config", default=None, metavar="JSON",
                   help="persist the UI session (VFOs/volume/range) to this "
                        "file and restore it on start (ConfigManager role)")
    p.add_argument("--supervise", action="store_true",
                   help="run the session in a supervised child process "
                        "and restart it if the backend becomes "
                        "unrecoverable (the recovery ladder's last rung "
                        "is a process restart; pair with --config so the "
                        "session's VFOs survive the respawn)")
    _add_backend_args(p)
    args = p.parse_args(argv)
    _apply_backend(args)

    if args.supervise:
        import os
        if os.environ.get("SDRPP_TPU_SUPERVISED"):
            # already a supervised child (e.g. --supervise leaked into
            # the child argv via an argparse abbreviation): never nest
            p.error("--supervise inside a supervised child")
        # strip the flag INCLUDING argparse prefix abbreviations
        # (--sup, --super, ...) or the child re-supervises forever
        child_argv = ["ui"] + [
            a for a in argv
            if not (a.startswith("--s") and "--supervise".startswith(a))]
        return _supervise([sys.executable, "-m", "sdrpp_tpu"] + child_argv)

    from .misc.webui import ReceiverEngine, serve_ui

    src = _make_source(args)
    if hasattr(src, "loop"):
        src.loop = True  # a UI session should not stop at file EOF
    engine = ReceiverEngine(src, mode=args.mode, offset=args.offset,
                            bandwidth=args.bandwidth, squelch=args.squelch,
                            audio_rate=args.audio_rate, fft_size=args.fft_size,
                            fft_rate=args.fft_rate, base_block=args.block_size,
                            realtime=not args.no_realtime,
                            background_preheat=not args.no_bg_preheat)
    serve_ui(engine, args.addr, args.port, config_path=args.config)


def cmd_preheat(argv):
    """Precompile the interactive mode corpus into the persistent
    compilation cache (utils/compile_cache) so even the FIRST `cli ui`
    session starts warm. The reference rebuilds a demod chain in
    microseconds (decoder_modules/radio/src/radio_module.h:322-336);
    ours is an XLA compile the first time a config is ever seen — this
    command pays those compiles ahead of time, once per machine."""
    p = argparse.ArgumentParser(prog="sdrpp_tpu preheat")
    p.add_argument("--samplerate", type=float, default=1000000.0,
                   help="source sample rate the UI will run at (the "
                        "compiled graphs are rate-specific)")
    p.add_argument("--audio-rate", type=float, default=48000.0)
    p.add_argument("--fft-size", type=int, default=16384)
    p.add_argument("--fft-rate", type=float, default=20.0)
    p.add_argument("--block-size", type=int, default=262144)
    p.add_argument("--modes", default=None,
                   help="comma list (default: every UI mode)")
    p.add_argument("--no-variants", action="store_true",
                   help="skip the squelch/RDS/multi-VFO variants")
    _add_backend_args(p)
    args = p.parse_args(argv)
    _apply_backend(args)

    from .io.sources import TestSource
    from .misc.webui import ALL_MODES, ReceiverEngine

    modes = (args.modes.split(",") if args.modes else ALL_MODES)
    for m in modes:
        if m not in ALL_MODES:
            p.error(f"unknown mode {m!r} (choose from {ALL_MODES})")

    def _vfo(mode, **kw):
        d = dict(mode=mode, offset=100000.0, bandwidth=None, squelch=None,
                 deemphasis=None, rds=False)
        d.update(kw)
        return d

    corpus = [(f"mode:{m}", {"vfo0": _vfo(m)}) for m in modes]
    if not args.no_variants:
        # the structural variants mode cycling actually visits: squelch
        # presence is a graph change (webui._graph_cfg), RDS adds the
        # pilot/decoder tap, and analog+digital multi-VFO is the mixed
        # topology the live-UI validation drives
        if "nfm" in modes:
            corpus.append(("nfm+squelch",
                           {"vfo0": _vfo("nfm", squelch=-50.0)}))
        if "wfm" in modes:
            corpus.append(("wfm+rds", {"vfo0": _vfo("wfm", rds=True)}))
        if "nfm" in modes and "meteor" in modes:
            corpus.append(("nfm+meteor",
                           {"vfo0": _vfo("nfm"),
                            "vfo1": _vfo("meteor", bandwidth=140000.0)}))

    src = TestSource(args.samplerate, tones=[(100000.0, -20.0)],
                     noise_dbfs=-90.0)
    engine = ReceiverEngine(src, mode=modes[0], audio_rate=args.audio_rate,
                            fft_size=args.fft_size, fft_rate=args.fft_rate,
                            base_block=args.block_size, realtime=False)
    total = 0.0
    for name, cfgs in corpus:
        block, secs = engine.warm_plan(cfgs)
        total += secs
        print(f"preheat {name:<16} block={block:<8} {secs:6.2f} s",
              flush=True)
    print(f"preheat done: {len(corpus)} configs in {total:.1f} s")


def cmd_scan(argv):
    p = argparse.ArgumentParser(prog="sdrpp_tpu scan")
    _add_source_args(p)
    p.add_argument("--start", type=float, required=True, help="start offset Hz")
    p.add_argument("--stop", type=float, required=True, help="stop offset Hz")
    p.add_argument("--interval", type=float, default=25000.0)
    p.add_argument("--level", type=float, default=-50.0)
    p.add_argument("--mode", default="nfm",
                   choices=["nfm", "am", "usb", "lsb", "cw"])
    p.add_argument("--bandwidth", type=float, default=12500.0)
    p.add_argument("--blocks", type=int, default=20)
    p.add_argument("--block-size", type=int, default=131072)
    p.add_argument("--fft-size", type=int, default=4096)
    _add_backend_args(p)
    args = p.parse_args(argv)
    _apply_backend(args)

    import jax
    import jax.numpy as jnp

    from .misc.meters import vfo_signal_info
    from .misc.scanner import Scanner
    from .signal_path import IQFrontEnd

    src = _make_source(args)
    fs = src.samplerate
    fe = IQFrontEnd(fs, fft_size=args.fft_size,
                    fft_rate=fs / args.block_size * 2,
                    block_size=args.block_size)
    step = jax.jit(fe)
    st = fe.init_state()
    sc = Scanner(args.start, args.stop, args.interval, level_db=args.level)
    now = 0.0
    hits = {}
    for i in range(args.blocks):
        stt, (_iq, fft) = step(st, jnp.asarray(src.read(args.block_size)))
        st = stt
        line = np.asarray(fft)[-1]
        freq = sc.step(line, args.bandwidth, 0.0, fs, now)
        now += args.block_size / fs
        if sc.receiving:
            strength, snr = vfo_signal_info(line, freq, args.bandwidth, fs)
            hits[freq] = max(hits.get(freq, -999), strength)
            log.info(f"RECEIVING {freq/1e3:+.1f} kHz  {strength:.1f} dB "
                     f"(SNR {snr:.1f} dB)")
        else:
            log.info(f"scanning... at {freq/1e3:+.1f} kHz")
    for f, s in sorted(hits.items()):
        print(f"{f:+12.0f} Hz  {s:6.1f} dB")


def _auto_block(fs: float, if_rate: float, block_multiple: int,
                if_target: int = 65536, floor: int = 262144,
                ceil: int = 1 << 22) -> int:
    """Input block size so the post-VFO IF block reaches ``if_target``
    samples — the grain where the chunk-parallel loop kernels (AGC, PLL,
    Costas, MM; ops/scans_pallas._chunk_lanes_for) engage with full
    lanes. cli run processes files as fast as possible (no realtime
    pacing), so bigger blocks trade nothing but memory; clamped to
    [floor, ceil] and rounded to the chain's block multiple."""
    want = int(if_target * fs / max(if_rate, 1.0))
    want = min(max(floor, want), ceil)
    return max(block_multiple, (want // block_multiple) * block_multiple)


def cmd_decode(argv):
    """Digital decoder pipelines (the reference's decoder modules):
    m17 voice, NOAA HRPT imagery, Falcon 9 telemetry, KG-STV frames,
    Meteor M2 LRPT (soft symbols + Viterbi/RS VCDU payloads)."""
    p = argparse.ArgumentParser(prog="sdrpp_tpu decode")
    p.add_argument("mode", choices=["m17", "hrpt", "falcon9", "kgsstv",
                                    "meteor"])
    _add_source_args(p)
    p.add_argument("--offset", type=float, default=0.0, help="VFO offset Hz")
    p.add_argument("--out", default=None,
                   help="output path (default per mode: m17 -> m17.wav, "
                        "hrpt -> avhrr.npy, falcon9 -> falcon9_video.ts, "
                        "kgsstv -> kgsstv_out.bin)")
    p.add_argument("--blocks", type=int, default=0, help="0 = until EOF")
    p.add_argument("--block-size", type=int, default=None,
                   help="input samples per step (default: auto — sized "
                        "so the decoder-rate block engages the chunked "
                        "loop kernels)")
    _add_backend_args(p)
    args = p.parse_args(argv)
    _apply_backend(args)

    import jax.numpy as jnp

    from .models.channel import RxVFO

    rates = {"m17": 48000.0, "hrpt": 3000000.0, "falcon9": 6000000.0,
             "kgsstv": 12000.0, "meteor": 150000.0}
    target = rates[args.mode]
    src = _make_source(args)
    fs = src.samplerate

    from .utils.iq import device_state

    vfo = None
    if fs != target or args.offset:
        vfo = RxVFO(fs, target, bandwidth=target, offset=args.offset)
        vstate = device_state(vfo.init_state)

    if args.mode == "m17":
        from .models.m17_chain import M17Decoder
        dec = M17Decoder(target, on_lsf=lambda l: log.info(
            f"M17 LSF: dst={l.dst} src={l.src}"))
    elif args.mode == "hrpt":
        from .decoders.hrpt import HRPTDecoder
        dec = HRPTDecoder(target)
    elif args.mode == "falcon9":
        from .decoders.falcon9 import Falcon9Decoder
        dec = Falcon9Decoder(target)
    elif args.mode == "meteor":
        from .decoders.meteor_lrpt import MeteorLRPTDecoder
        dec = MeteorLRPTDecoder(target)
    else:
        from .decoders.kg_sstv import KGSSTVDecoder
        dec = KGSSTVDecoder(target)

    out_path = args.out or {"m17": "m17.wav", "hrpt": "avhrr.npy",
                            "falcon9": "falcon9_video.ts",
                            "kgsstv": "kgsstv_out.bin",
                            "meteor": "meteor.s"}[args.mode]
    audio_chunks, avhrr_lines, frames_bin = [], [], b""
    video = open(out_path, "wb") if args.mode == "falcon9" else None

    bm = vfo.block_multiple if vfo else 1
    block = _auto_block(fs, target, bm) if args.block_size is None \
        else max(bm, (args.block_size // bm) * bm)
    cap = getattr(src, "num_frames", None)
    if cap is not None and cap >= bm:
        block = min(block, (cap // bm) * bm)  # short captures: one block
    if vfo is not None:
        # IQ crosses the host<->device boundary as split float32
        import jax

        from .utils.iq import split_iq

        def _vstep(st, x2):
            st, y = vfo(st, jax.lax.complex(x2[0], x2[1]))
            return st, (y.real, y.imag)

        vfo_step = jax.jit(_vstep)

    src_len = getattr(src, "num_frames", None)
    offset = nblocks = 0
    while args.blocks == 0 or nblocks < args.blocks:
        if src_len is not None and offset + block > src_len:
            break
        iq = src.read(block)
        if vfo is not None:
            vstate, (yr, yi) = vfo_step(vstate, jnp.asarray(split_iq(iq)))
            iq = np.asarray(yr) + 1j * np.asarray(yi)
        if args.mode == "m17":
            audio, _ = dec.process(iq)
            audio_chunks.append(audio)
        elif args.mode == "hrpt":
            for f in dec.process(iq):
                log.info(f"HRPT frame: sc={f.spacecraft_id} "
                         f"fn={f.frame_number} syncErr={f.sync_errors}")
                avhrr_lines.append(f.avhrr)
        elif args.mode == "falcon9":
            for kind, body in dec.process(iq):
                if kind == "gps":
                    log.info("GPS: " + body.decode(errors="replace").strip())
                elif kind == "video":
                    video.write(body)
        elif args.mode == "meteor":
            dec.process(iq)
        else:
            for fr in dec.process(iq):
                frames_bin += fr
        offset += block
        nblocks += 1
        if args.blocks == 0 and src_len is None and nblocks >= 100:
            break

    if args.mode == "m17":
        from .io import wav as wav_mod
        audio = (np.concatenate(audio_chunks, axis=0) if audio_chunks
                 else np.zeros((0, 2), np.float32))
        wav_mod.write_wav(out_path, 8000, audio, "i16")
        log.info(f"{audio.shape[0]} voice samples -> {out_path}")
    elif args.mode == "hrpt":
        lines = (np.stack(avhrr_lines) if avhrr_lines
                 else np.zeros((0, 5, 2048), np.int32))
        np.save(out_path, lines)
        log.info(f"{lines.shape[0]} AVHRR lines -> {out_path}")
    elif args.mode == "falcon9":
        video.close()
        log.info(f"video TS -> {out_path}")
    elif args.mode == "meteor":
        # the reference module's surface: s8 x84 soft-symbol file
        # (meteor main.cpp:268-276) + the full LRPT tail this framework
        # adds (Viterbi -> CADU sync -> RS -> VCDU payloads)
        soft, vcdus, info = dec.finalize()
        soft.tofile(out_path)
        from pathlib import Path as _P
        vpath = str(_P(out_path).with_suffix("")) + "_vcdu.bin"
        with open(vpath, "wb") as f:
            f.write(vcdus.tobytes())
        log.info(f"{len(soft)} soft bytes -> {out_path}; "
                 f"{info['vcdus_ok']}/{info['cadus_seen']} CADUs "
                 f"(rotation {info['rotation']}) -> {vpath}")
    else:
        with open(out_path, "wb") as f:
            f.write(frames_bin)
        log.info(f"{len(frames_bin)} frame bytes -> {out_path}")


def cmd_bench(argv):
    import bench

    sys.argv = ["bench.py"] + list(argv)
    return bench.main()


COMMANDS = {
    "run": cmd_run,
    "decode": cmd_decode,
    "bank": cmd_bank,
    "spectrum": cmd_spectrum,
    "serve": cmd_serve,
    "ui": cmd_ui,
    "scan": cmd_scan,
    "preheat": cmd_preheat,
    "bench": cmd_bench,
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help") or argv[0] not in COMMANDS:
        print(__doc__)
        print("commands:", ", ".join(COMMANDS))
        return 0 if argv and argv[0] in ("-h", "--help") else 1
    # warm starts: persist compiled executables across processes so a
    # second `run`/`ui`/`decode` with the same chain config skips XLA
    # compile (utils/compile_cache; opt out with SDRPP_TPU_NO_CACHE=1)
    from .utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main() or 0)
