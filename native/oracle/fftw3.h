/* Minimal FFTW3F-compatible shim for the reference-oracle build.
 *
 * Implements the tiny subset of the fftwf_* API that the reference's DSP
 * headers use (core/src/dsp/noise_reduction/fm_if.h): complex 1-D plans,
 * execute, destroy, malloc/free. Transforms are unnormalized in both
 * directions, matching FFTW semantics. Radix-2 iterative Cooley-Tukey for
 * power-of-2 sizes, naive DFT otherwise (test sizes are small).
 *
 * Original code; only used for tests, never in the device compute path.
 */
#pragma once

#include <cmath>
#include <cstdlib>
#include <cstring>

typedef float fftwf_complex[2];

#define FFTW_FORWARD (-1)
#define FFTW_BACKWARD (+1)
#define FFTW_ESTIMATE (1U << 6)
#define FFTW_MEASURE (0U)

struct fftwf_plan_s {
    int n;
    int sign;
    fftwf_complex* in;
    fftwf_complex* out;
    double* tw_re; /* twiddles for radix-2 path (n/2 entries), null for DFT */
    double* tw_im;
};
typedef fftwf_plan_s* fftwf_plan;

static inline void* fftwf_malloc(size_t size) { return malloc(size); }
static inline void fftwf_free(void* p) { free(p); }

static inline fftwf_plan fftwf_plan_dft_1d(int n, fftwf_complex* in, fftwf_complex* out,
                                           int sign, unsigned flags) {
    (void)flags;
    fftwf_plan p = (fftwf_plan)malloc(sizeof(fftwf_plan_s));
    p->n = n;
    p->sign = sign;
    p->in = in;
    p->out = out;
    p->tw_re = nullptr;
    p->tw_im = nullptr;
    if (n > 1 && (n & (n - 1)) == 0) {
        p->tw_re = (double*)malloc(sizeof(double) * (n / 2));
        p->tw_im = (double*)malloc(sizeof(double) * (n / 2));
        for (int k = 0; k < n / 2; k++) {
            double ang = sign * 2.0 * M_PI * k / n;
            p->tw_re[k] = cos(ang);
            p->tw_im[k] = sin(ang);
        }
    }
    return p;
}

static inline void fftwf_execute(fftwf_plan p) {
    int n = p->n;
    if (n <= 0) return;
    /* work in double for accuracy, write back float */
    double* re = (double*)malloc(sizeof(double) * n);
    double* im = (double*)malloc(sizeof(double) * n);

    if (p->tw_re) {
        /* bit-reversal permutation load */
        int log2n = 0;
        while ((1 << log2n) < n) log2n++;
        for (int i = 0; i < n; i++) {
            unsigned r = 0;
            for (int b = 0; b < log2n; b++) r |= ((i >> b) & 1U) << (log2n - 1 - b);
            re[r] = p->in[i][0];
            im[r] = p->in[i][1];
        }
        for (int len = 2; len <= n; len <<= 1) {
            int half = len >> 1;
            int step = n / len;
            for (int base = 0; base < n; base += len) {
                for (int k = 0; k < half; k++) {
                    double wr = p->tw_re[k * step];
                    double wi = p->tw_im[k * step];
                    int a = base + k, b = base + k + half;
                    double tr = re[b] * wr - im[b] * wi;
                    double ti = re[b] * wi + im[b] * wr;
                    re[b] = re[a] - tr;
                    im[b] = im[a] - ti;
                    re[a] += tr;
                    im[a] += ti;
                }
            }
        }
    } else {
        /* naive DFT for non-power-of-2 sizes */
        for (int k = 0; k < n; k++) {
            double accr = 0.0, acci = 0.0;
            for (int t = 0; t < n; t++) {
                double ang = p->sign * 2.0 * M_PI * (double)k * (double)t / n;
                double wr = cos(ang), wi = sin(ang);
                double xr = p->in[t][0], xi = p->in[t][1];
                accr += xr * wr - xi * wi;
                acci += xr * wi + xi * wr;
            }
            re[k] = accr;
            im[k] = acci;
        }
    }
    for (int i = 0; i < n; i++) {
        p->out[i][0] = (float)re[i];
        p->out[i][1] = (float)im[i];
    }
    free(re);
    free(im);
}

static inline void fftwf_destroy_plan(fftwf_plan p) {
    if (!p) return;
    free(p->tw_re);
    free(p->tw_im);
    free(p);
}
