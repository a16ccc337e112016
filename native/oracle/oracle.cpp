// Reference-oracle harness: compiles the UNMODIFIED header-only DSP core of
// the reference (qrp73/SDRPP, mounted read-only at $REF) against the scalar
// volk/fftw3/threading shims in this directory, and drives individual blocks
// synchronously (block-by-block process() calls, never start()ing worker
// threads) so Python tests can compare sdrpp_tpu output against the actual
// reference implementation within the BASELINE audio bound (0.1 dB).
//
// No reference code is copied into this repository: the headers are included
// from the read-only reference tree at build time, and the resulting binary
// is a test-only artifact (never part of the device compute path).
//
// Usage: oracle <chain> <in.f32> <out.f32> <blockSize> [params...]
//   in/out are raw little-endian float32; complex streams are interleaved
//   I,Q pairs; stereo is interleaved L,R. blockSize is in input samples
//   (complex samples for complex-input chains) and exercises the reference's
//   cross-call state carry the same way sdrpp_tpu carries state across
//   blocks.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <dsp/types.h>
#include <dsp/stream.h>

#include <dsp/channel/frequency_xlator.h>
#include <dsp/channel/rx_vfo.h>
#include <dsp/clock_recovery/mm.h>
#include <dsp/correction/dc_blocker.h>
#include <dsp/demod/am.h>
#include <dsp/demod/broadcast_fm.h>
#include <dsp/demod/cw.h>
#include <dsp/demod/fm.h>
#include <dsp/demod/quadrature.h>
#include <dsp/demod/ssb.h>
#include <dsp/filter/decimating_fir.h>
#include <dsp/filter/deephasis.h>
#include <dsp/filter/fir.h>
#include <dsp/loop/agc.h>
#include <dsp/loop/costas.h>
#include <dsp/loop/fast_agc.h>
#include <dsp/loop/pll.h>
#include <dsp/multirate/power_decimator.h>
#include <dsp/multirate/rational_resampler.h>
#include <dsp/noise_reduction/fm_if.h>
#include <dsp/noise_reduction/noise_blanker.h>
#include <dsp/noise_reduction/squelch.h>
#include <dsp/taps/band_pass.h>
#include <dsp/taps/low_pass.h>
#include <dsp/taps/root_raised_cosine.h>
#include <dsp/window/window.h>

using dsp::complex_t;
using dsp::stereo_t;

static std::vector<float> readAll(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) { fprintf(stderr, "cannot open %s\n", path); exit(2); }
    fseek(f, 0, SEEK_END);
    long bytes = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<float> v(bytes / sizeof(float));
    if (fread(v.data(), 1, v.size() * sizeof(float), f) != v.size() * sizeof(float)) {
        fprintf(stderr, "short read on %s\n", path); exit(2);
    }
    fclose(f);
    return v;
}

static void writeAll(const char* path, const float* data, size_t count) {
    FILE* f = fopen(path, "wb");
    if (!f) { fprintf(stderr, "cannot open %s\n", path); exit(2); }
    fwrite(data, sizeof(float), count, f);
    fclose(f);
}

// Drive `fn(count, in, out) -> outCount` over the input in blockSize chunks.
// InT/OutT are complex_t, stereo_t or float; expand = max output growth
// factor per input sample (resamplers can expand).
template <class InT, class OutT, class Fn>
static void runChunks(const std::vector<float>& inF, const char* outPath, int blockSize,
                      Fn fn, double expand = 1.0) {
    size_t inCount = inF.size() * sizeof(float) / sizeof(InT);
    const InT* in = (const InT*)inF.data();
    std::vector<OutT> outChunk((size_t)(blockSize * expand) + 4096);
    std::vector<float> out;
    for (size_t pos = 0; pos < inCount; pos += blockSize) {
        int n = (int)std::min((size_t)blockSize, inCount - pos);
        int m = fn(n, in + pos, outChunk.data());
        const float* of = (const float*)outChunk.data();
        out.insert(out.end(), of, of + (size_t)m * sizeof(OutT) / sizeof(float));
    }
    writeAll(outPath, out.data(), out.size());
}

int main(int argc, char** argv) {
    if (argc < 5) {
        fprintf(stderr, "usage: %s <chain> <in.f32> <out.f32> <blockSize> [params...]\n", argv[0]);
        return 2;
    }
    std::string chain = argv[1];
    const char* inPath = argv[2];
    const char* outPath = argv[3];
    int blockSize = atoi(argv[4]);
    double p[8] = {0};
    for (int i = 5; i < argc && i < 13; i++) p[i - 5] = atof(argv[i]);

    std::vector<float> inF = readAll(inPath);
    dsp::stream<complex_t> sc;
    dsp::stream<float> sf;
    dsp::stream<stereo_t> ss;

    if (chain == "xlator") {
        dsp::channel::FrequencyXlator blk;
        blk.init(&sc, p[0], p[1]);
        runChunks<complex_t, complex_t>(inF, outPath, blockSize,
            [&](int n, const complex_t* in, complex_t* out) { return blk.process(n, in, out); });
    } else if (chain == "fir") {
        auto taps = dsp::taps::lowPass(p[0], p[1], p[2]);
        dsp::filter::FIR<complex_t, float> blk;
        blk.init(&sc, taps);
        runChunks<complex_t, complex_t>(inF, outPath, blockSize,
            [&](int n, const complex_t* in, complex_t* out) { return blk.process(n, in, out); });
    } else if (chain == "decim_fir") {
        auto taps = dsp::taps::lowPass(p[1], p[2], p[3]);
        dsp::filter::DecimatingFIR<complex_t, float> blk;
        blk.init(&sc, taps, (int)p[0]);
        runChunks<complex_t, complex_t>(inF, outPath, blockSize,
            [&](int n, const complex_t* in, complex_t* out) { return blk.process(n, in, out); });
    } else if (chain == "power_decim") {
        dsp::multirate::PowerDecimator<complex_t> blk;
        blk.init(&sc, (unsigned)p[0]);
        runChunks<complex_t, complex_t>(inF, outPath, blockSize,
            [&](int n, const complex_t* in, complex_t* out) { return blk.process(n, (complex_t*)in, out); });
    } else if (chain == "resamp") {
        dsp::multirate::RationalResampler<complex_t> blk;
        blk.init(&sc, p[0], p[1]);
        runChunks<complex_t, complex_t>(inF, outPath, blockSize,
            [&](int n, const complex_t* in, complex_t* out) { return blk.process(n, in, out); },
            std::max(1.0, p[1] / p[0]) * 2.0);
    } else if (chain == "resamp_f32") {
        dsp::multirate::RationalResampler<float> blk;
        blk.init(&sf, p[0], p[1]);
        runChunks<float, float>(inF, outPath, blockSize,
            [&](int n, const float* in, float* out) { return blk.process(n, in, out); },
            std::max(1.0, p[1] / p[0]) * 2.0);
    } else if (chain == "quadrature") {
        dsp::demod::Quadrature blk;
        blk.init(&sc, p[0], p[1]);
        runChunks<complex_t, float>(inF, outPath, blockSize,
            [&](int n, const complex_t* in, float* out) { return blk.process(n, (complex_t*)in, out); });
    } else if (chain == "am") {
        dsp::demod::AM<float> blk;
        blk.init(&sc, (dsp::demod::AM<float>::AGCMode)(int)p[0], p[1], p[2], p[3], p[4], p[5]);
        runChunks<complex_t, float>(inF, outPath, blockSize,
            [&](int n, const complex_t* in, float* out) { return blk.process(n, (complex_t*)in, out); });
    } else if (chain == "ssb") {
        dsp::demod::SSB<float> blk;
        blk.init(&sc, (dsp::demod::SSB<float>::Mode)(int)p[0], p[1], p[2], p[3] != 0.0, p[4], p[5]);
        runChunks<complex_t, float>(inF, outPath, blockSize,
            [&](int n, const complex_t* in, float* out) { return blk.process(n, in, out); });
    } else if (chain == "cw") {
        dsp::demod::CW<float> blk;
        blk.init(&sc, p[0], p[1] != 0.0, p[2], p[3], p[4]);
        runChunks<complex_t, float>(inF, outPath, blockSize,
            [&](int n, const complex_t* in, float* out) { return blk.process(n, in, out); });
    } else if (chain == "nfm") {
        dsp::demod::FM<float> blk;
        blk.init(&sc, p[0], p[1], p[2] != 0.0, p[3] != 0.0);
        runChunks<complex_t, float>(inF, outPath, blockSize,
            [&](int n, const complex_t* in, float* out) { return blk.process(n, (complex_t*)in, out); });
    } else if (chain == "wfm") {
        dsp::demod::BroadcastFM blk;
        blk.init(&sc, p[0], p[1], p[2] != 0.0, p[3] != 0.0, false);
        runChunks<complex_t, stereo_t>(inF, outPath, blockSize,
            [&](int n, const complex_t* in, stereo_t* out) {
                int rdsCount = 0;
                return blk.process(n, (complex_t*)in, out, rdsCount, NULL);
            });
    } else if (chain == "wfm_rds") {
        // output = the RDS tap (complex), not the audio
        dsp::demod::BroadcastFM blk;
        blk.init(&sc, p[0], p[1], p[2] != 0.0, p[3] != 0.0, true);
        std::vector<stereo_t> audio(blockSize + 4096);
        runChunks<complex_t, complex_t>(inF, outPath, blockSize,
            [&](int n, const complex_t* in, complex_t* out) {
                int rdsCount = 0;
                blk.process(n, (complex_t*)in, audio.data(), rdsCount, out);
                return rdsCount;
            });
    } else if (chain == "agc") {
        dsp::loop::AGC<float> blk;
        blk.init(&sf, p[0], p[1], p[2], p[3], p[4], p[5]);
        runChunks<float, float>(inF, outPath, blockSize,
            [&](int n, const float* in, float* out) { return blk.process(n, (float*)in, out); });
    } else if (chain == "agc_c64") {
        dsp::loop::AGC<complex_t> blk;
        blk.init(&sc, p[0], p[1], p[2], p[3], p[4], p[5]);
        runChunks<complex_t, complex_t>(inF, outPath, blockSize,
            [&](int n, const complex_t* in, complex_t* out) { return blk.process(n, (complex_t*)in, out); });
    } else if (chain == "fastagc") {
        dsp::loop::FastAGC<complex_t> blk;
        blk.init(&sc, p[0], p[1], p[2], p[3]);
        runChunks<complex_t, complex_t>(inF, outPath, blockSize,
            [&](int n, const complex_t* in, complex_t* out) { return blk.process(n, (complex_t*)in, out); });
    } else if (chain == "pll") {
        dsp::loop::PLL blk;
        blk.init(&sc, p[0], p[1], p[2]);
        runChunks<complex_t, complex_t>(inF, outPath, blockSize,
            [&](int n, const complex_t* in, complex_t* out) { return blk.process(n, (complex_t*)in, out); });
    } else if (chain == "costas2" || chain == "costas4" || chain == "costas8") {
        int order = chain[6] - '0';
        if (order == 2) {
            dsp::loop::Costas<2> blk; blk.init(&sc, p[0]);
            runChunks<complex_t, complex_t>(inF, outPath, blockSize,
                [&](int n, const complex_t* in, complex_t* out) { return blk.process(n, (complex_t*)in, out); });
        } else if (order == 4) {
            dsp::loop::Costas<4> blk; blk.init(&sc, p[0]);
            runChunks<complex_t, complex_t>(inF, outPath, blockSize,
                [&](int n, const complex_t* in, complex_t* out) { return blk.process(n, (complex_t*)in, out); });
        } else {
            dsp::loop::Costas<8> blk; blk.init(&sc, p[0]);
            runChunks<complex_t, complex_t>(inF, outPath, blockSize,
                [&](int n, const complex_t* in, complex_t* out) { return blk.process(n, (complex_t*)in, out); });
        }
    } else if (chain == "squelch") {
        dsp::noise_reduction::Squelch blk;
        blk.init(&sc, p[0]);
        runChunks<complex_t, complex_t>(inF, outPath, blockSize,
            [&](int n, const complex_t* in, complex_t* out) { return blk.process(n, in, out); });
    } else if (chain == "noiseblanker") {
        dsp::noise_reduction::NoiseBlanker blk;
        blk.init(&sc, p[0], p[1]);
        runChunks<complex_t, complex_t>(inF, outPath, blockSize,
            [&](int n, const complex_t* in, complex_t* out) { return blk.process(n, (complex_t*)in, out); });
    } else if (chain == "dcblocker") {
        dsp::correction::DCBlocker<complex_t> blk;
        blk.init(&sc, p[0]);
        runChunks<complex_t, complex_t>(inF, outPath, blockSize,
            [&](int n, const complex_t* in, complex_t* out) { return blk.process(n, (complex_t*)in, out); });
    } else if (chain == "deemphasis") {
        dsp::filter::Deemphasis<float> blk;
        blk.init(&sf, p[0], p[1]);
        runChunks<float, float>(inF, outPath, blockSize,
            [&](int n, const float* in, float* out) { return blk.process(n, in, out); });
    } else if (chain == "deemphasis_stereo") {
        dsp::filter::Deemphasis<stereo_t> blk;
        blk.init(&ss, p[0], p[1]);
        runChunks<stereo_t, stereo_t>(inF, outPath, blockSize,
            [&](int n, const stereo_t* in, stereo_t* out) { return blk.process(n, in, out); });
    } else if (chain == "mm") {
        dsp::clock_recovery::MM<complex_t> blk;
        blk.init(&sc, p[0], p[1], p[2], p[3]);
        runChunks<complex_t, complex_t>(inF, outPath, blockSize,
            [&](int n, const complex_t* in, complex_t* out) { return blk.process(n, in, out); });
    } else if (chain == "mm_f32") {
        dsp::clock_recovery::MM<float> blk;
        blk.init(&sf, p[0], p[1], p[2], p[3]);
        runChunks<float, float>(inF, outPath, blockSize,
            [&](int n, const float* in, float* out) { return blk.process(n, in, out); });
    } else if (chain == "fmif") {
        dsp::noise_reduction::FMIF blk;
        blk.init(&sc, (int)p[0]);
        runChunks<complex_t, complex_t>(inF, outPath, blockSize,
            [&](int n, const complex_t* in, complex_t* out) { return blk.process(n, in, out); });
    } else if (chain == "rx_vfo") {
        dsp::channel::RxVFO blk;
        blk.init(&sc, p[0], p[1], p[2], p[3]);
        runChunks<complex_t, complex_t>(inF, outPath, blockSize,
            [&](int n, const complex_t* in, complex_t* out) { return blk.process(n, in, out); },
            std::max(1.0, p[1] / p[0]) * 2.0);
    } else if (chain == "taps_lowpass") {
        auto taps = dsp::taps::lowPass(p[0], p[1], p[2]);
        writeAll(outPath, taps.taps, taps.size);
    } else if (chain == "taps_bandpass_c64") {
        auto taps = dsp::taps::bandPass<complex_t>(p[0], p[1], p[2], p[3]);
        writeAll(outPath, (const float*)taps.taps, taps.size * 2);
    } else if (chain == "taps_rrc") {
        auto taps = dsp::taps::rootRaisedCosine<float>((int)p[0], p[1], p[2], p[3]);
        writeAll(outPath, taps.taps, taps.size);
    } else if (chain == "window") {
        std::vector<float> buf((int)p[1]);
        dsp::window::createWindow((dsp::window::windowType)(int)p[0], buf.data(), (int)p[1],
                                  p[2] != 0.0);
        writeAll(outPath, buf.data(), buf.size());
    } else {
        fprintf(stderr, "unknown chain %s\n", chain.c_str());
        return 2;
    }
    return 0;
}
