// sdrpp_tpu native host runtime.
//
// The reference's runtime layer is C++ (stream/ring buffers in
// core/src/dsp/buffer/*, the VOLK type-convert hot loops in
// compression/sample_stream_compressor.h and file_source's per-format
// conversion loops, main.cpp:294-436). This build keeps the device
// compute in XLA but the host-side runtime — the ingest ring between
// IO threads and device steps, the wire codec feeding the network path,
// and streaming WAV decode — lives here, compiled -O3 -march=native so the
// conversion loops auto-vectorize. Exposed with a plain C ABI for ctypes.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <cstdlib>
#include <cstdio>

#include <algorithm>
#include <condition_variable>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

// ---------------------------------------------------------------------------
// Persistent fork-join pool for the host conversion loops.
//
// The SURVEY §7 hard-part budget asks for >=1 Gsample/s of host ingest per
// host (8 GB/s of f32 IQ); the scalar loops below saturate one core around
// 0.3 Gsample/s, so the converters self-schedule chunks of large blocks
// across a small worker pool (the reference gets the same effect from its
// one-thread-per-block runtime, block.h:70-76). Workers are lazily created
// once and never torn down (avoids interpreter-shutdown join hangs when the
// library is held by a Python process). SDRPP_HOST_THREADS=1 forces serial.
// ---------------------------------------------------------------------------

namespace {

class WorkPool {
public:
    static WorkPool& instance() {
        static WorkPool* p = new WorkPool();  // intentionally leaked
        return *p;
    }

    size_t threads() const { return workers_.size() + 1; }

    // Run fn(begin, end) over [0, n) in `grain`-sized chunks on the pool
    // plus the calling thread; serial when small or pool disabled.
    // Dispatch is serialized: ctypes releases the GIL, so two Python
    // threads (e.g. a Prefetcher conversion + a wire_quantize on the
    // serve path) can reach here concurrently — the job descriptor is
    // pool-global, so a second concurrent run() must wait its turn.
    void run(size_t n, size_t grain,
             const std::function<void(size_t, size_t)>& fn) {
        if (n == 0) return;
        if (workers_.empty() || n <= grain) {
            fn(0, n);
            return;
        }
        std::lock_guard<std::mutex> dispatch_lk(dispatch_m_);
        {
            std::lock_guard<std::mutex> lk(m_);
            job_ = &fn;
            n_ = n;
            grain_ = grain;
            next_.store(0, std::memory_order_relaxed);
            pending_ = (int)workers_.size();
            epoch_++;
        }
        cv_.notify_all();
        work(&fn, n, grain);  // caller participates
        std::unique_lock<std::mutex> lk(m_);
        done_cv_.wait(lk, [&] { return pending_ == 0; });
        job_ = nullptr;
    }

private:
    WorkPool() {
        unsigned hw = std::thread::hardware_concurrency();
        size_t nw = hw > 1 ? (size_t)std::min(hw, 16u) - 1 : 0;
        if (const char* env = std::getenv("SDRPP_HOST_THREADS")) {
            long v = std::strtol(env, nullptr, 10);
            nw = v > 1 ? (size_t)v - 1 : 0;
        }
        for (size_t i = 0; i < nw; i++) {
            workers_.emplace_back([this]() {
                uint64_t seen = 0;
                for (;;) {
                    const std::function<void(size_t, size_t)>* job;
                    size_t n, grain;
                    {
                        std::unique_lock<std::mutex> lk(m_);
                        cv_.wait(lk, [&] { return epoch_ != seen; });
                        seen = epoch_;
                        job = job_;
                        n = n_;
                        grain = grain_;
                    }
                    work(job, n, grain);
                    std::lock_guard<std::mutex> lk(m_);
                    if (--pending_ == 0) done_cv_.notify_one();
                }
            });
            workers_.back().detach();
        }
    }

    void work(const std::function<void(size_t, size_t)>* job, size_t n,
              size_t grain) {
        for (;;) {
            size_t b = next_.fetch_add(grain, std::memory_order_relaxed);
            if (b >= n) break;
            (*job)(b, std::min(b + grain, n));
        }
    }

    std::vector<std::thread> workers_;
    std::mutex dispatch_m_;  // one run() in flight at a time
    std::mutex m_;
    std::condition_variable cv_, done_cv_;
    const std::function<void(size_t, size_t)>* job_ = nullptr;
    size_t n_ = 0, grain_ = 0;
    std::atomic<size_t> next_{0};
    int pending_ = 0;
    uint64_t epoch_ = 0;
};

inline void parallel_for(size_t n, size_t grain,
                         const std::function<void(size_t, size_t)>& fn) {
    WorkPool::instance().run(n, grain, fn);
}

// Parallel max over floats (for the wire-codec block scaler).
inline float parallel_max(const float* in, size_t count) {
    constexpr size_t kGrain = 1 << 18;
    if (count <= kGrain) {
        float m = in[0];
        for (size_t i = 1; i < count; i++) m = in[i] > m ? in[i] : m;
        return m;
    }
    std::atomic<int> slot{0};
    float partial[64];
    size_t grain = std::max(kGrain, (count + 63) / 64);
    parallel_for(count, grain, [&](size_t b, size_t e) {
        float m = in[b];
        for (size_t i = b + 1; i < e; i++) m = in[i] > m ? in[i] : m;
        partial[slot.fetch_add(1)] = m;
    });
    float m = partial[0];
    for (int i = 1; i < slot.load(); i++) m = partial[i] > m ? partial[i] : m;
    return m;
}

constexpr size_t kFrameGrain = 1 << 16;   // frames per chunk (~0.5 MB out)
constexpr size_t kValueGrain = 1 << 18;   // scalar values per chunk

}  // namespace

extern "C" {

// Number of threads the host conversion pool uses (workers + caller).
size_t host_pool_threads() { return WorkPool::instance().threads(); }

// ---------------------------------------------------------------------------
// SPSC ring buffer of complex64 samples (8 bytes each).
// Replaces dsp::RingBuffer / SampleFrameBuffer (buffer/ring_buffer.h:10-238,
// frame_buffer.h:10-133): decouples a producer IO thread from the consumer
// feeding device steps. Lock-free single-producer single-consumer.
// ---------------------------------------------------------------------------

struct RingBuffer {
    float* data;           // interleaved I/Q
    size_t capacity;       // in samples
    std::atomic<size_t> head;  // write index (samples)
    std::atomic<size_t> tail;  // read index (samples)
};

RingBuffer* ring_create(size_t capacity_samples) {
    RingBuffer* rb = new RingBuffer();
    rb->data = (float*)std::malloc(capacity_samples * 2 * sizeof(float));
    rb->capacity = capacity_samples;
    rb->head.store(0);
    rb->tail.store(0);
    return rb;
}

void ring_destroy(RingBuffer* rb) {
    std::free(rb->data);
    delete rb;
}

size_t ring_available(RingBuffer* rb) {  // samples readable
    return rb->head.load(std::memory_order_acquire) -
           rb->tail.load(std::memory_order_relaxed);
}

size_t ring_space(RingBuffer* rb) {  // samples writable
    return rb->capacity - (rb->head.load(std::memory_order_relaxed) -
                           rb->tail.load(std::memory_order_acquire));
}

// Write up to n samples; returns number written (non-blocking).
size_t ring_write(RingBuffer* rb, const float* iq, size_t n) {
    size_t space = ring_space(rb);
    if (n > space) n = space;
    size_t head = rb->head.load(std::memory_order_relaxed);
    for (size_t i = 0; i < n; i++) {
        size_t idx = (head + i) % rb->capacity;
        rb->data[2 * idx] = iq[2 * i];
        rb->data[2 * idx + 1] = iq[2 * i + 1];
    }
    rb->head.store(head + n, std::memory_order_release);
    return n;
}

// Read up to n samples; returns number read (non-blocking).
size_t ring_read(RingBuffer* rb, float* iq, size_t n) {
    size_t avail = ring_available(rb);
    if (n > avail) n = avail;
    size_t tail = rb->tail.load(std::memory_order_relaxed);
    for (size_t i = 0; i < n; i++) {
        size_t idx = (tail + i) % rb->capacity;
        iq[2 * i] = rb->data[2 * idx];
        iq[2 * i + 1] = rb->data[2 * idx + 1];
    }
    rb->tail.store(tail + n, std::memory_order_release);
    return n;
}

// ---------------------------------------------------------------------------
// Wire codec: float <-> i8/i16 with block-max scaler (the server wire
// format, sample_stream_compressor.h:26-60). count = number of FLOATS
// (2x samples). Returns the scaler used. Signed-max semantics preserved.
// ---------------------------------------------------------------------------

float wire_quantize_i8(const float* in, int8_t* out, size_t count) {
    const float maxv = parallel_max(in, count);
    // All-zero (squelched silence) or non-finite block: 128/maxv would be
    // inf and 0*inf = NaN garbage. Emit zeros with scaler 0 — dequantize
    // of all-zero i8 with scaler 0 round-trips to exact zeros. A negative
    // maxv (all-negative block, signed-max quirk) still round-trips via
    // the negative scaler, so it is NOT guarded — reference parity.
    if (maxv == 0.0f || !std::isfinite(maxv)) {
        std::memset(out, 0, count * sizeof(int8_t));
        return 0.0f;
    }
    const float scale = 128.0f / maxv;
    parallel_for(count, kValueGrain, [&](size_t b, size_t e) {
        for (size_t i = b; i < e; i++) {
            float v = std::nearbyintf(in[i] * scale);
            v = v > 127.f ? 127.f : (v < -128.f ? -128.f : v);
            out[i] = (int8_t)v;
        }
    });
    return maxv;
}

float wire_quantize_i16(const float* in, int16_t* out, size_t count) {
    const float maxv = parallel_max(in, count);
    if (maxv == 0.0f || !std::isfinite(maxv)) {
        std::memset(out, 0, count * sizeof(int16_t));
        return 0.0f;
    }
    const float scale = 32768.0f / maxv;
    parallel_for(count, kValueGrain, [&](size_t b, size_t e) {
        for (size_t i = b; i < e; i++) {
            float v = std::nearbyintf(in[i] * scale);
            v = v > 32767.f ? 32767.f : (v < -32768.f ? -32768.f : v);
            out[i] = (int16_t)v;
        }
    });
    return maxv;
}

void wire_dequantize_i8(const int8_t* in, float* out, size_t count, float scaler) {
    const float scale = scaler / 128.0f;
    parallel_for(count, kValueGrain, [&](size_t b, size_t e) {
        for (size_t i = b; i < e; i++) out[i] = in[i] * scale;
    });
}

void wire_dequantize_i16(const int16_t* in, float* out, size_t count, float scaler) {
    const float scale = scaler / 32768.0f;
    parallel_for(count, kValueGrain, [&](size_t b, size_t e) {
        for (size_t i = b; i < e; i++) out[i] = in[i] * scale;
    });
}

// ---------------------------------------------------------------------------
// WAV sample-format conversion loops (file_source main.cpp:294-436):
// interleaved PCM -> split/interleaved float IQ. count = frames; stereo
// input has 2*count values. Mono duplicates I into Q.
// ---------------------------------------------------------------------------

void conv_pcm8_iq(const uint8_t* in, float* iq, size_t frames, int channels) {
    const float s = 1.0f / 128.0f;
    parallel_for(frames, kFrameGrain, [&](size_t b, size_t e) {
        if (channels >= 2) {
            for (size_t i = b; i < e; i++) {
                iq[2 * i] = ((float)in[channels * i] - 128.0f) * s;
                iq[2 * i + 1] = ((float)in[channels * i + 1] - 128.0f) * s;
            }
        } else {
            for (size_t i = b; i < e; i++) {
                float v = ((float)in[i] - 128.0f) * s;
                iq[2 * i] = v;
                iq[2 * i + 1] = v;
            }
        }
    });
}

void conv_pcm16_iq(const int16_t* in, float* iq, size_t frames, int channels) {
    const float s = 1.0f / 32768.0f;
    parallel_for(frames, kFrameGrain, [&](size_t b, size_t e) {
        if (channels >= 2) {
            for (size_t i = b; i < e; i++) {
                iq[2 * i] = in[channels * i] * s;
                iq[2 * i + 1] = in[channels * i + 1] * s;
            }
        } else {
            for (size_t i = b; i < e; i++) {
                float v = in[i] * s;
                iq[2 * i] = v;
                iq[2 * i + 1] = v;
            }
        }
    });
}

void conv_pcm24_iq(const uint8_t* in, float* iq, size_t frames, int channels) {
    const float s = 1.0f / 8388608.0f;
    parallel_for(frames, kFrameGrain, [&](size_t b, size_t e) {
        for (size_t i = b; i < e; i++) {
            for (int c = 0; c < 2; c++) {
                int cc = channels >= 2 ? c : 0;
                const uint8_t* p = in + 3 * (channels * i + cc);
                int32_t v = (int32_t)p[0] | ((int32_t)p[1] << 8) |
                            ((int32_t)p[2] << 16);
                if (v & 0x800000) v -= 0x1000000;
                iq[2 * i + c] = v * s;
            }
        }
    });
}

void conv_pcm32_iq(const int32_t* in, float* iq, size_t frames, int channels) {
    const float s = 1.0f / 2147483648.0f;
    parallel_for(frames, kFrameGrain, [&](size_t b, size_t e) {
        if (channels >= 2) {
            for (size_t i = b; i < e; i++) {
                iq[2 * i] = in[channels * i] * s;
                iq[2 * i + 1] = in[channels * i + 1] * s;
            }
        } else {
            for (size_t i = b; i < e; i++) {
                float v = in[i] * s;
                iq[2 * i] = v;
                iq[2 * i + 1] = v;
            }
        }
    });
}

void conv_f32_iq(const float* in, float* iq, size_t frames, int channels) {
    parallel_for(frames, kFrameGrain, [&](size_t b, size_t e) {
        if (channels >= 2) {
            for (size_t i = b; i < e; i++) {
                iq[2 * i] = in[channels * i];
                iq[2 * i + 1] = in[channels * i + 1];
            }
        } else {
            for (size_t i = b; i < e; i++) {
                iq[2 * i] = in[i];
                iq[2 * i + 1] = in[i];
            }
        }
    });
}

void conv_f64_iq(const double* in, float* iq, size_t frames, int channels) {
    parallel_for(frames, kFrameGrain, [&](size_t b, size_t e) {
        if (channels >= 2) {
            for (size_t i = b; i < e; i++) {
                iq[2 * i] = (float)in[channels * i];
                iq[2 * i + 1] = (float)in[channels * i + 1];
            }
        } else {
            for (size_t i = b; i < e; i++) {
                float v = (float)in[i];
                iq[2 * i] = v;
                iq[2 * i + 1] = v;
            }
        }
    });
}

// ---------------------------------------------------------------------------
// Viterbi traceback (libcorrect convolutional decode's history walk,
// core/libcorrect/src/convolutional/decode.c). The add-compare-select
// lattice runs on the device (ops/fec.py); the traceback is a strictly
// sequential pointer chase over the [T, S] decision matrix — microseconds
// in C, milliseconds as a device scan. decisions: row-major u8, nonzero =
// "took predecessor p1 = (s>>1)+S/2". Emits T bits (bit t = state&1 when
// walking step t), newest-last. Returns the final (oldest) state.
// ---------------------------------------------------------------------------

uint32_t viterbi_traceback(const uint8_t* decisions, size_t T, size_t S,
                           uint32_t state, uint8_t* bits_out) {
    for (size_t t = T; t-- > 0;) {
        bits_out[t] = (uint8_t)(state & 1);
        const uint8_t took1 = decisions[t * S + state];
        state = (state >> 1) + (took1 ? (uint32_t)(S >> 1) : 0u);
    }
    return state;
}

}  // extern "C"
