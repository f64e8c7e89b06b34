// Host (CPU) side of ops/libm.py, built with g++ -O2 -ffp-contract=off.
//
//   glibc_*  vectorised calls into the host's own libm: the CPU path of every
//            transcendental in the port (glibc_sincosf: ::sinf and ::cosf of
//            each element).
//   f32_*    the same loops over libm_f32.cuh, the transcription the CUDA
//            kernels run, compiled for the CPU so that it can be held against
//            glibc without a card, and against the card's results with one.
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

UNARY(glibc_sinf, ::sinf)
UNARY(glibc_cosf, ::cosf)
UNARY(glibc_tanf, ::tanf)
extern "C" void glibc_sincosf(const float* x, float* s, float* c, long n) {
  for (long i = 0; i < n; ++i) {
    s[i] = ::sinf(x[i]);
    c[i] = ::cosf(x[i]);
  }
}
BINARY(glibc_atan2f, ::atan2f)
BINARY(glibc_hypotf, ::hypotf)

UNARY(f32_sinf, libm_f32::sinf)
UNARY(f32_cosf, libm_f32::cosf)
UNARY(f32_tanf, libm_f32::tanf)
extern "C" void f32_sincosf(const float* x, float* s, float* c, long n) {
  for (long i = 0; i < n; ++i) libm_f32::sincosf(x[i], s + i, c + i);
}
BINARY(f32_atan2f, libm_f32::atan2f)
BINARY(f32_hypotf, libm_f32::hypotf)
