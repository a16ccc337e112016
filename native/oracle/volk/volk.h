/* Minimal scalar VOLK-compatible shim for the reference-oracle build.
 *
 * The reference (qrp73/SDRPP) calls ~24 VOLK kernels from its header-only
 * DSP core. This image has no VOLK, so the oracle harness (oracle.cpp)
 * compiles the UNMODIFIED reference headers against this shim, which
 * implements each kernel as the plain scalar loop its VOLK "generic"
 * variant specifies. This file is original code written from the kernels'
 * documented semantics (function signature + elementwise definition); it
 * contains no VOLK or SDRPP code.
 *
 * Only used for tests (tools/oracle); never in the device compute path.
 */
#pragma once

#include <complex>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>

typedef std::complex<float> lv_32fc_t;

static inline lv_32fc_t lv_cmake(float r, float i) { return lv_32fc_t(r, i); }

static inline size_t volk_get_alignment(void) { return 32; }

static inline void* volk_malloc(size_t size, size_t alignment) {
    void* ptr = nullptr;
    if (size == 0) size = alignment;
    /* round size up to a multiple of alignment (posix_memalign does not
       require it, but keep allocations tidy) */
    if (posix_memalign(&ptr, alignment, size) != 0) return nullptr;
    return ptr;
}

static inline void volk_free(void* ptr) { free(ptr); }

/* ---- dot products ---- */

static inline void volk_32f_x2_dot_prod_32f(float* result, const float* input,
                                            const float* taps, unsigned int n) {
    float acc = 0.0f;
    for (unsigned int i = 0; i < n; i++) acc += input[i] * taps[i];
    *result = acc;
}

static inline void volk_32fc_32f_dot_prod_32fc(lv_32fc_t* result, const lv_32fc_t* input,
                                               const float* taps, unsigned int n) {
    float re = 0.0f, im = 0.0f;
    for (unsigned int i = 0; i < n; i++) {
        re += input[i].real() * taps[i];
        im += input[i].imag() * taps[i];
    }
    *result = lv_32fc_t(re, im);
}

static inline void volk_32fc_x2_dot_prod_32fc(lv_32fc_t* result, const lv_32fc_t* input,
                                              const lv_32fc_t* taps, unsigned int n) {
    lv_32fc_t acc(0.0f, 0.0f);
    for (unsigned int i = 0; i < n; i++) acc += input[i] * taps[i];
    *result = acc;
}

/* ---- elementwise ---- */

static inline void volk_32fc_magnitude_32f(float* out, const lv_32fc_t* in, unsigned int n) {
    for (unsigned int i = 0; i < n; i++) out[i] = std::abs(in[i]);
}

static inline void volk_32fc_conjugate_32fc(lv_32fc_t* out, const lv_32fc_t* in, unsigned int n) {
    for (unsigned int i = 0; i < n; i++) out[i] = std::conj(in[i]);
}

static inline void volk_32fc_x2_multiply_32fc(lv_32fc_t* out, const lv_32fc_t* a,
                                              const lv_32fc_t* b, unsigned int n) {
    for (unsigned int i = 0; i < n; i++) out[i] = a[i] * b[i];
}

static inline void volk_32fc_32f_multiply_32fc(lv_32fc_t* out, const lv_32fc_t* a,
                                               const float* b, unsigned int n) {
    for (unsigned int i = 0; i < n; i++) out[i] = a[i] * b[i];
}

static inline void volk_32f_x2_multiply_32f(float* out, const float* a, const float* b,
                                            unsigned int n) {
    for (unsigned int i = 0; i < n; i++) out[i] = a[i] * b[i];
}

static inline void volk_32f_x2_add_32f(float* out, const float* a, const float* b,
                                       unsigned int n) {
    for (unsigned int i = 0; i < n; i++) out[i] = a[i] + b[i];
}

static inline void volk_32f_x2_subtract_32f(float* out, const float* a, const float* b,
                                            unsigned int n) {
    for (unsigned int i = 0; i < n; i++) out[i] = a[i] - b[i];
}

static inline void volk_32f_s32f_multiply_32f(float* out, const float* in, float scalar,
                                              unsigned int n) {
    for (unsigned int i = 0; i < n; i++) out[i] = in[i] * scalar;
}

static inline void volk_32f_x2_interleave_32fc(lv_32fc_t* out, const float* i_buf,
                                               const float* q_buf, unsigned int n) {
    for (unsigned int i = 0; i < n; i++) out[i] = lv_32fc_t(i_buf[i], q_buf[i]);
}

static inline void volk_32fc_deinterleave_real_32f(float* out, const lv_32fc_t* in,
                                                   unsigned int n) {
    for (unsigned int i = 0; i < n; i++) out[i] = in[i].real();
}

/* ---- reductions ---- */

static inline void volk_32f_index_max_32u(uint32_t* target, const float* src, uint32_t n) {
    uint32_t best = 0;
    float mx = n ? src[0] : 0.0f;
    for (uint32_t i = 1; i < n; i++) {
        if (src[i] > mx) { mx = src[i]; best = i; }
    }
    *target = best;
}

static inline void volk_32f_accumulator_s32f(float* result, const float* input,
                                             unsigned int n) {
    float acc = 0.0f;
    for (unsigned int i = 0; i < n; i++) acc += input[i];
    *result = acc;
}

/* ---- rotators (NCO mix): out[i] = in[i]*phase, phase *= inc, with the
 * generic kernel's |phase| renormalization every 512 samples ---- */

static inline void volk_32fc_s32fc_x2_rotator_32fc(lv_32fc_t* out, const lv_32fc_t* in,
                                                   const lv_32fc_t phase_inc,
                                                   lv_32fc_t* phase, unsigned int n) {
    lv_32fc_t ph = *phase;
    for (unsigned int i = 0; i < n; i++) {
        out[i] = in[i] * ph;
        ph *= phase_inc;
        if ((i % 512) == 511) ph /= std::abs(ph);
    }
    *phase = ph / std::abs(ph);
}

static inline void volk_32fc_s32fc_x2_rotator2_32fc(lv_32fc_t* out, const lv_32fc_t* in,
                                                    const lv_32fc_t* phase_inc,
                                                    lv_32fc_t* phase, unsigned int n) {
    volk_32fc_s32fc_x2_rotator_32fc(out, in, *phase_inc, phase, n);
}

/* ---- quantization converts (saturating, round-to-nearest) ---- */

static inline void volk_32f_s32f_convert_8i(int8_t* out, const float* in, float scalar,
                                            unsigned int n) {
    for (unsigned int i = 0; i < n; i++) {
        float r = in[i] * scalar;
        r = fminf(fmaxf(r, -128.0f), 127.0f);
        out[i] = (int8_t)rintf(r);
    }
}

static inline void volk_32f_s32f_convert_16i(int16_t* out, const float* in, float scalar,
                                             unsigned int n) {
    for (unsigned int i = 0; i < n; i++) {
        float r = in[i] * scalar;
        r = fminf(fmaxf(r, -32768.0f), 32767.0f);
        out[i] = (int16_t)rintf(r);
    }
}

static inline void volk_8i_s32f_convert_32f(float* out, const int8_t* in, float scalar,
                                            unsigned int n) {
    for (unsigned int i = 0; i < n; i++) out[i] = (float)in[i] / scalar;
}

static inline void volk_16i_s32f_convert_32f(float* out, const int16_t* in, float scalar,
                                             unsigned int n) {
    for (unsigned int i = 0; i < n; i++) out[i] = (float)in[i] / scalar;
}
