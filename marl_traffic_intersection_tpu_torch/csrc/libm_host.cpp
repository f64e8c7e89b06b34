// Host (CPU) side of ops/libm.py, built with g++ -O2 -ffp-contract=off.
//
//   glibc_*  vectorised calls into the host's own libm: the CPU path of every
//            transcendental in the port (glibc_sincosf: ::sinf and ::cosf of
//            each element).
//   f32_*    the same loops over libm_f32.cuh, the transcription the CUDA
//            kernels run, compiled for the CPU so that it can be held against
//            glibc without a card, and against the card's results with one.
//   *_diff   atan2f(-(ay - by), ax - bx) and hypotf(ax - bx, ay - by), the
//            subtractions in f32 (the glibc_ forms are what the port's CPU
//            path computes with torch's subtractions).
//   f64_sqrt_normal  the header's square root for hypotf, on doubles.
#include <math.h>

#include "libm_f32.cuh"

#define UNARY(name, fn)                                              \
  extern "C" void name(const float* x, float* out, long n) {         \
    for (long i = 0; i < n; ++i) out[i] = fn(x[i]);                 \
  }
#define BINARY(name, fn)                                                    \
  extern "C" void name(const float* a, const float* b, float* out, long n) { \
    for (long i = 0; i < n; ++i) out[i] = fn(a[i], b[i]);                  \
  }
#define QUATERNARY(name, fn)                                                  \
  extern "C" void name(const float* a, const float* b, const float* c, const float* d, \
                       float* out, long n) {                                  \
    for (long i = 0; i < n; ++i) out[i] = fn(a[i], b[i], c[i], d[i]);        \
  }

UNARY(glibc_sinf, ::sinf)
UNARY(glibc_cosf, ::cosf)
UNARY(glibc_tanf, ::tanf)
UNARY(glibc_atanf, ::atanf)
extern "C" void glibc_sincosf(const float* x, float* s, float* c, long n) {
  for (long i = 0; i < n; ++i) {
    s[i] = ::sinf(x[i]);
    c[i] = ::cosf(x[i]);
  }
}
BINARY(glibc_atan2f, ::atan2f)
BINARY(glibc_hypotf, ::hypotf)
static float glibc_atan2f_diff_1(float ay, float by, float ax, float bx) {
  return ::atan2f(-(ay - by), ax - bx);
}
static float glibc_hypotf_diff_1(float ax, float bx, float ay, float by) {
  return ::hypotf(ax - bx, ay - by);
}
QUATERNARY(glibc_atan2f_diff, glibc_atan2f_diff_1)
QUATERNARY(glibc_hypotf_diff, glibc_hypotf_diff_1)

UNARY(f32_sinf, libm_f32::sinf)
UNARY(f32_cosf, libm_f32::cosf)
UNARY(f32_tanf, libm_f32::tanf)
UNARY(f32_atanf, libm_f32::atanf)
extern "C" void f32_sincosf(const float* x, float* s, float* c, long n) {
  for (long i = 0; i < n; ++i) libm_f32::sincosf(x[i], s + i, c + i);
}
BINARY(f32_atan2f, libm_f32::atan2f)
BINARY(f32_hypotf, libm_f32::hypotf)
QUATERNARY(f32_atan2f_diff, libm_f32::atan2f_diff)
QUATERNARY(f32_hypotf_diff, libm_f32::hypotf_diff)

extern "C" void f64_sqrt_normal(const double* s, double* out, long n) {
  for (long i = 0; i < n; ++i) out[i] = libm_f32::sqrt_normal(s[i]);
}
