// Attribution / licensing: this file is a derived work of the GNU C Library
// (glibc) 2.36 math routines. The algorithms and the polynomial/table
// constants below originate from glibc's sysdeps/ieee754/flt-32
// sinf/cosf/tanf/atan2f/atanf/hypotf implementations (themselves derived
// from Sun's fdlibm, Copyright (C) 1993 by Sun Microsystems, and the ARM
// optimized-routines sincosf), Copyright (C) 1993-2022 Free Software
// Foundation, Inc., licensed under the GNU Lesser General Public License
// v2.1 or later (LGPL-2.1-or-later). The constants and the control flow were
// decoded from a Debian GLIBC 2.36 x86-64 libm.so.6 (the decoding is
// recorded in marl_traffic_intersection_tpu/ops/exact_trig.py and
// ops/exact_libm.py). To the extent this file reproduces glibc's expression
// of those algorithms, it is distributed under the same LGPL-2.1-or-later
// terms. Derived files: this header and csrc/libm.cu.
//
// glibc-faithful f32 libm for host and device.
//
// The reference simulator calls glibc's float sinf/cosf/tanf/atan2f/hypotf;
// CUDA's own sinf & co. differ from glibc by an ulp on a few percent of
// inputs, and one ulp in a pose or a ray direction flips lidar pixels. Every
// function here replays glibc 2.36's x86-64 algorithm step for step:
//
//   sinf/cosf  the FMA sincosf variant: |x| < 2^-12 returns x (cosf: 1),
//              |x| < pi/4 an f64 polynomial, |x| < 120 the integer-quadrant
//              reduction n = ((int)(x * 2/pi * 2^24) + 2^23) >> 24,
//              r = fma(-n, pi/2, x), then the quadrant's f64 polynomial.
//   sincosf    sinf and cosf of one angle from one test and one reduction:
//              the two results are bit-equal to the separate calls.
//   tanf       f64 reduction with a SEPARATE multiply and subtract (glibc
//              builds tanf without FMA), then the all-f32 fdlibm kernel.
//   atan2f     fdlibm f32 (__ieee754_atan2f + atanf).
//   hypotf     (float) sqrt((double) x * x + (double) y * y).
//
// Domain: sinf/cosf/tanf are exact for |x| < 120 (the env wraps angles to
// (-2pi, 2pi)); beyond that they return (float) sin((double) x) etc., which
// is NOT glibc's large-argument reduction. atan2f and hypotf cover all
// inputs.
//
// Compile with contraction off (nvcc --fmad=false -prec-div=true
// -prec-sqrt=true; g++ -ffp-contract=off): every explicit fma() below is
// glibc's, and every other product must round before its add.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define LIBM_HD __host__ __device__ __forceinline__
#define LIBM_COLD static __host__ __device__ __noinline__
#else
#define LIBM_HD static inline
#define LIBM_COLD static __attribute__((noinline))
#endif

namespace libm_f32 {

LIBM_HD uint32_t asuint(float f) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(f);
#else
  uint32_t u;
  memcpy(&u, &f, sizeof u);
  return u;
#endif
}

LIBM_HD float asfloat(uint32_t u) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float f;
  memcpy(&f, &u, sizeof f);
  return f;
#endif
}

LIBM_HD uint32_t abstop12(float x) { return (asuint(x) >> 20) & 0x7ff; }

// ---------------------------------------------------------------- sincosf
// __sincosf_table[0]; table[1] negates c0..c4 (used when n & 2).
#define SC_HPI_INV 0x1.45f306dc9c883p+23
#define SC_HPI 0x1.921fb54442d18p+0
#define SC_C0 0x1p+0
#define SC_C1 -0x1.ffffffd0c621cp-2
#define SC_C2 0x1.55553e1068f19p-5
#define SC_C3 -0x1.6c087e89a359dp-10
#define SC_C4 0x1.99343027bf8c3p-16
#define SC_S1 -0x1.555545995a603p-3
#define SC_S2 0x1.1107605230bc4p-7
#define SC_S3 -0x1.994eb3774cf24p-13

// sinf_poly's two polynomials: the sine of x, and the cosine of x (from
// x2 = x * x), negated when neg_table (glibc's table[1], used when n & 2).
LIBM_HD float sin_poly(double x, double x2) {
  double x3 = x * x2;
  double s1 = fma(SC_S3, x2, SC_S2);
  double x7 = x3 * x2;
  double s = fma(x3, SC_S1, x);
  return (float)fma(x7, s1, s);
}

LIBM_HD float cos_poly(double x2, int neg_table) {
  double g = neg_table ? -1.0 : 1.0;
  double x4 = x2 * x2;
  double c2 = fma(g * SC_C4, x2, g * SC_C3);
  double c1 = fma(g * SC_C1, x2, g * SC_C0);
  double x6 = x4 * x2;
  double c = fma(x4, g * SC_C2, c1);
  return (float)fma(x6, c2, c);
}

// sinf_poly: sine polynomial for even n, cosine for odd n.
LIBM_HD float sincos_poly(double x, double x2, int n, int neg_table) {
  return (n & 1) == 0 ? sin_poly(x, x2) : cos_poly(x2, neg_table);
}

// reduce_fast: x - n*pi/2 as one fused negated multiply-add.
LIBM_HD double reduce_fast(double x, int* np) {
  double r = x * SC_HPI_INV;
  int n = (((int32_t)r) + 0x800000) >> 24;
  *np = n;
  return fma(-(double)n, SC_HPI, x);
}

LIBM_HD float sinf(float y) {
  double x = y;
  uint32_t top = abstop12(y);
  if (top < 0x3f4) {  // |y| < pi/4
    if (top < 0x398) return y;  // |y| < 2^-12
    return sincos_poly(x, x * x, 0, 0);
  }
  if (top < 0x42f) {  // |y| < 120
    int n;
    x = reduce_fast(x, &n);
    double s = ((n & 3) == 1 || (n & 3) == 2) ? -1.0 : 1.0;
    return sincos_poly(x * s, x * x, n, n & 2);
  }
  return (float)sin(x);
}

LIBM_HD float cosf(float y) {
  double x = y;
  uint32_t top = abstop12(y);
  if (top < 0x3f4) {
    if (top < 0x398) return 1.0f;
    return sincos_poly(x, x * x, 1, 0);
  }
  if (top < 0x42f) {
    int n;
    x = reduce_fast(x, &n);
    double s = ((n & 3) == 1 || (n & 3) == 2) ? -1.0 : 1.0;
    return sincos_poly(x * s, x * x, n ^ 1, n & 2);
  }
  return (float)cos(x);
}

// Out of the exact domain (|y| >= 120, inf, NaN), kept out of line so that
// the f64 sin/cos (and their large-argument reduction, with its stack
// frame) stay out of the hot body.
LIBM_COLD void sincosf_cold(float y, float* sinp, float* cosp) {
  *sinp = (float)sin((double)y);
  *cosp = (float)cos((double)y);
}

// sinf(y) and cosf(y) as glibc's sincosf computes them: one test of |y|,
// one reduction, then both polynomials, each output taking the one its
// quadrant asks for (a select, where sinf and cosf alone branch on n & 1).
LIBM_HD void sincosf(float y, float* sinp, float* cosp) {
  double x = y;
  uint32_t top = abstop12(y);
  if (top < 0x3f4) {  // |y| < pi/4
    if (top < 0x398) {  // |y| < 2^-12
      *sinp = y;
      *cosp = 1.0f;
      return;
    }
    double x2 = x * x;
    *sinp = sin_poly(x, x2);
    *cosp = cos_poly(x2, 0);
    return;
  }
  if (top < 0x42f) {  // |y| < 120
    int n;
    x = reduce_fast(x, &n);
    double s = ((n & 3) == 1 || (n & 3) == 2) ? -1.0 : 1.0;
    float ps = sin_poly(x * s, x * x), pc = cos_poly(x * x, n & 2);
    *sinp = (n & 1) ? pc : ps;
    *cosp = (n & 1) ? ps : pc;
    return;
  }
  sincosf_cold(y, sinp, cosp);
}

// ------------------------------------------------------------------- tanf
// glibc's tanf is fdlibm's __kernel_tanf after a reduction. Its branches
// (|x| <= pi/4 or reduced, |x| >= 0.6744 or not, odd quadrant or even) each
// take a fraction of any warp's lanes, so a transcription that follows them
// (two inlined calls of the kernel, two divisions in each) runs the
// polynomial and the divisions once per branch taken. Here every lane runs
// one copy of the kernel: a lane with |x| <= pi/4 skips the reduction and
// enters it as glibc's direct call does, and the two divisions, w*w/(w+v)
// and -1/w, are one division of selected operands, so a warp runs the
// polynomial and one division sequence once. Every operation and every
// rounding is glibc's. The |x| >= 120 fallback is out of line (tanf_cold);
// the |x| < 2^-13 tail is inlined, its division a second sequence.
LIBM_HD float tanf_tiny(float x, int iy) {  // |x| < 2^-13
  if (((asuint(x) & 0x7fffffff) | (uint32_t)(iy + 1)) == 0) return 1.0f / fabsf(x);
  if (iy == 1) return x;
  return -1.0f / x;
}

LIBM_COLD float tanf_cold(float x) { return (float)tan((double)x); }

LIBM_HD float kernel_tanf(float x, float y, int iy) {
  // bit patterns of glibc's .rodata (exact_trig.py _PIO4, _PIO4LO, _T)
  const float pio4 = 0x1.921fb4p-1f;
  const float pio4lo = 0x1.4442d2p-25f;
  const float T0 = 0.3333333432674408f, T1 = 0.13333334028720856f,
              T2 = 0.05396825447678566f, T3 = 0.021869488060474396f,
              T4 = 0.008863239549100399f, T5 = 0.0035920790396630764f,
              T6 = 0.00145620945841074f, T7 = 0.0005880412645637989f,
              T8 = 0.0002464631397742778f, T9 = 7.817944424459711e-05f,
              T10 = 7.14072521077469e-05f, T11 = -1.8558637748355977e-05f,
              T12 = 2.590730582596734e-05f;
  float z, r, v, w, s;
  int32_t hx = (int32_t)asuint(x);
  int32_t ix = hx & 0x7fffffff;
  if (ix < 0x39000000) return tanf_tiny(x, iy);  // |x| < 2^-13: (int)x == 0
  const bool big = ix >= 0x3f2ca140;  // |x| >= 0.6744: tan(pi/4 - x)
  if (big) {
    if (hx < 0) {
      x = -x;
      y = -y;
    }
    z = pio4 - x;
    w = pio4lo - y;
    x = z + w;
    y = 0.0f;
    if (fabsf(x) < 0x1p-13f)
      return (float)((1 - ((hx >> 30) & 2)) * iy) * (1.0f - (float)(2 * iy) * x);
  }
  z = x * x;
  w = z * z;
  r = T1 + w * (T3 + w * (T5 + w * (T7 + w * (T9 + w * T11))));
  v = z * (T2 + w * (T4 + w * (T6 + w * (T8 + w * (T10 + w * T12)))));
  s = z * x;
  r = y + z * (s * (r + v) + y);
  r += T0 * s;
  w = x + r;
  if (!big && iy == 1) return w;
  // big: w*w/(w+v) with v = iy; odd quadrant: a = -1/w
  v = (float)iy;
  float q = (big ? w * w : -1.0f) / (big ? w + v : w);
  if (big) return (float)(1 - ((hx >> 30) & 2)) * (v - 2.0f * (x - (q - r)));
  // -1/(x+r) computed accurately from 12-bit-masked high parts
  float a = q, t;
  z = asfloat(asuint(w) & 0xfffff000u);
  v = r - (z - x);
  t = asfloat(asuint(a) & 0xfffff000u);
  s = 1.0f + t * z;
  return t + a * (s + t * v);
}

LIBM_HD float tanf(float x) {
  float y0 = x, y1 = 0.0f;
  int iy = 1;
  if ((asuint(x) & 0x7fffffff) > 0x3f490fda) {  // |x| > pi/4: reduce
    if (abstop12(x) >= 0x42f) return tanf_cold(x);  // |x| >= 120, inf, NaN
    double dx = x;
    double r = dx * SC_HPI_INV;
    int n = (((int32_t)r) + 0x800000) >> 24;
    double nh = (double)n * SC_HPI;  // mulsd: rounds before the subtract
    dx = dx - nh;
    y0 = (float)dx;
    y1 = (float)(dx - (double)y0);
    iy = 1 - ((n & 1) << 1);
  }
  return kernel_tanf(y0, y1, iy);
}

// ------------------------------------------------------------ atanf/atan2f
LIBM_HD float atanf(float x) {
  const float atanhi[4] = {asfloat(0x3eed6338u), asfloat(0x3f490fdau),
                           asfloat(0x3f7b985eu), asfloat(0x3fc90fdau)};
  const float atanlo[4] = {asfloat(0x31ac3769u), asfloat(0x33222168u),
                           asfloat(0x33140fb4u), asfloat(0x33a22168u)};
  const float aT0 = asfloat(0x3eaaaaabu), aT1 = asfloat(0xbe4ccccdu),
              aT2 = asfloat(0x3e124925u), aT3 = asfloat(0xbde38e38u),
              aT4 = asfloat(0x3dba2e6eu), aT5 = asfloat(0xbd9d8795u),
              aT6 = asfloat(0x3d886b35u), aT7 = asfloat(0xbd6ef16bu),
              aT8 = asfloat(0x3d4bda59u), aT9 = asfloat(0xbd15a221u),
              aT10 = asfloat(0x3c8569d7u);
  float w, s1, s2, z;
  int32_t hx = (int32_t)asuint(x);
  int32_t ix = hx & 0x7fffffff;
  int id;
  if (ix >= 0x4c000000) {  // |x| >= 2^25
    if (ix > 0x7f800000) return x + x;
    if (hx > 0) return atanhi[3] + atanlo[3];
    return -atanhi[3] - atanlo[3];
  }
  if (ix < 0x3ee00000) {  // |x| < 0.4375
    if (ix < 0x31000000) return x;  // |x| < 2^-29
    id = -1;
  } else {
    x = fabsf(x);
    if (ix < 0x3f980000) {
      if (ix < 0x3f300000) {
        id = 0;
        x = (2.0f * x - 1.0f) / (2.0f + x);
      } else {
        id = 1;
        x = (x - 1.0f) / (x + 1.0f);
      }
    } else {
      if (ix < 0x401c0000) {
        id = 2;
        x = (x - 1.5f) / (1.0f + 1.5f * x);
      } else {
        id = 3;
        x = -1.0f / x;
      }
    }
  }
  z = x * x;
  w = z * z;
  s1 = z * (aT0 + w * (aT2 + w * (aT4 + w * (aT6 + w * (aT8 + w * aT10)))));
  s2 = w * (aT1 + w * (aT3 + w * (aT5 + w * (aT7 + w * aT9))));
  if (id < 0) return x - x * (s1 + s2);
  z = atanhi[id] - ((x * (s1 + s2) - atanlo[id]) - x);
  return (hx < 0) ? -z : z;
}

LIBM_HD float atan2f(float y, float x) {
  const float tiny = 1.0e-30f;
  const float pi_o_4 = asfloat(0x3f490fdbu);
  const float pi_o_2 = asfloat(0x3fc90fdbu);
  const float pi = asfloat(0x40490fdbu);
  const float pi_lo = asfloat(0xb3bbbd2eu);
  float z;
  int32_t hx = (int32_t)asuint(x), hy = (int32_t)asuint(y);
  int32_t ix = hx & 0x7fffffff, iy = hy & 0x7fffffff;
  if (ix > 0x7f800000 || iy > 0x7f800000) return x + y;
  if (hx == 0x3f800000) return atanf(y);
  int m = ((hy >> 31) & 1) | ((hx >> 30) & 2);
  if (iy == 0) {
    switch (m) {
      case 0:
      case 1:
        return y;
      case 2:
        return pi + tiny;
      default:
        return -pi - tiny;
    }
  }
  if (ix == 0) return (hy < 0) ? -pi_o_2 - tiny : pi_o_2 + tiny;
  if (ix == 0x7f800000) {
    if (iy == 0x7f800000) {
      switch (m) {
        case 0:
          return pi_o_4 + tiny;
        case 1:
          return -pi_o_4 - tiny;
        case 2:
          return 3.0f * pi_o_4 + tiny;
        default:
          return -3.0f * pi_o_4 - tiny;
      }
    }
    switch (m) {
      case 0:
        return 0.0f;
      case 1:
        return -0.0f;
      case 2:
        return pi + tiny;
      default:
        return -pi - tiny;
    }
  }
  if (iy == 0x7f800000) return (hy < 0) ? -pi_o_2 - tiny : pi_o_2 + tiny;
  int32_t k = (iy - ix) >> 23;
  if (k > 60)
    z = pi_o_2 + 0.5f * pi_lo;
  else if (hx < 0 && k < -60)
    z = 0.0f;
  else
    z = atanf(fabsf(y / x));
  switch (m) {
    case 0:
      return z;
    case 1:
      return asfloat(asuint(z) ^ 0x80000000u);
    case 2:
      return pi - (z - pi_lo);
    default:
      return (z - pi_lo) - pi;
  }
}

// ----------------------------------------------------------------- hypotf
LIBM_HD float hypotf(float x, float y) {
  if (!isfinite(x) || !isfinite(y)) {
    if (isinf(x) || isinf(y)) return INFINITY;
    return x + y;
  }
  double dx = x, dy = y;
  return (float)sqrt(dx * dx + dy * dy);
}

}  // namespace libm_f32
