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
// glibc's atanf (fdlibm) reduces its argument in one of five ranges, four of
// them by a division: (2x-1)/(2+x), (x-1)/(x+1), (x-1.5)/(1+1.5x), -1/x.
// Branching on the range, a warp of mixed operands runs one IEEE division
// sequence (MUFU.RCP, Newton, FCHK and a CALL to its slow path) for each
// range its lanes take. Here every lane forms its range's numerator and
// denominator by selects and divides once (|x| < 0.4375 divides x by 1,
// which is exact), and the range's atanhi/atanlo and the |x| >= 2^25, NaN
// and |x| < 2^-29 results are selects too: one division sequence and one
// polynomial per warp. Each operand is formed as glibc forms it, so every
// operation and rounding is glibc's.
LIBM_HD float atanf(float x) {
  const float aT0 = asfloat(0x3eaaaaabu), aT1 = asfloat(0xbe4ccccdu),
              aT2 = asfloat(0x3e124925u), aT3 = asfloat(0xbde38e38u),
              aT4 = asfloat(0x3dba2e6eu), aT5 = asfloat(0xbd9d8795u),
              aT6 = asfloat(0x3d886b35u), aT7 = asfloat(0xbd6ef16bu),
              aT8 = asfloat(0x3d4bda59u), aT9 = asfloat(0xbd15a221u),
              aT10 = asfloat(0x3c8569d7u);
  const float hi3 = asfloat(0x3fc90fdau), lo3 = asfloat(0x33a22168u);
  const int32_t hx = (int32_t)asuint(x);
  const int32_t ix = hx & 0x7fffffff;
  const float ax = fabsf(x);
  // the range: id -1 (no reduction), then id 0, 1, 2; else id 3
  const bool r_1 = ix < 0x3ee00000, r0 = ix < 0x3f300000, r1 = ix < 0x3f980000,
             r2 = ix < 0x401c0000;
  const float num = r_1 ? x : r0 ? 2.0f * ax - 1.0f : r1 ? ax - 1.0f : r2 ? ax - 1.5f : -1.0f;
  const float den = r_1 ? 1.0f : r0 ? 2.0f + ax : r1 ? ax + 1.0f : r2 ? 1.0f + 1.5f * ax : ax;
  const float hi = r0 ? asfloat(0x3eed6338u) : r1 ? asfloat(0x3f490fdau)
                 : r2 ? asfloat(0x3f7b985eu) : hi3;
  const float lo = r0 ? asfloat(0x31ac3769u) : r1 ? asfloat(0x33222168u)
                 : r2 ? asfloat(0x33140fb4u) : lo3;
  const float t = num / den;
  const float z = t * t;
  const float w = z * z;
  const float s1 = z * (aT0 + w * (aT2 + w * (aT4 + w * (aT6 + w * (aT8 + w * aT10)))));
  const float s2 = w * (aT1 + w * (aT3 + w * (aT5 + w * (aT7 + w * aT9))));
  const float p = t * (s1 + s2);
  const float reduced = hi - ((p - lo) - t);
  float res = r_1 ? t - p : (hx < 0 ? -reduced : reduced);
  if (ix >= 0x4c000000)  // |x| >= 2^25 or NaN: a select, no branch
    res = ix > 0x7f800000 ? x + x : (hx > 0 ? hi3 + lo3 : -hi3 - lo3);
  return ix < 0x31000000 ? x : res;  // |x| < 2^-29
}

// atan2f's zero, infinite and NaN operands (glibc's cases in its order),
// out of line: a warp of finite, nonzero operands never enters it.
LIBM_COLD float atan2f_special(float y, float x) {
  const float tiny = 1.0e-30f;
  const float pi_o_4 = asfloat(0x3f490fdbu);
  const float pi_o_2 = asfloat(0x3fc90fdbu);
  const float pi = asfloat(0x40490fdbu);
  int32_t hx = (int32_t)asuint(x), hy = (int32_t)asuint(y);
  int32_t ix = hx & 0x7fffffff, iy = hy & 0x7fffffff;
  if (ix > 0x7f800000 || iy > 0x7f800000) return x + y;
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
  return (hy < 0) ? -pi_o_2 - tiny : pi_o_2 + tiny;  // y infinite
}

// glibc's atan2f (fdlibm). Its x == 1.0f shortcut, atanf(y), is not taken:
// the generic path gives the same bits there (y / 1.0f is y, atanf is odd,
// the k > 60 constant rounds to atanf's 0x3fc90fdb for |y| >= 2^25, and the
// zero and infinite cases agree; held against glibc on the host), so every
// lane runs one atanf and, with y / x, two division sequences. The rare
// operands go out of line behind one test, and the quadrant fix-up and the
// |y/x| > 2^60 and x < 0, |y/x| < 2^-60 clamps are selects.
LIBM_HD float atan2f(float y, float x) {
  const float pi_o_2 = asfloat(0x3fc90fdbu);
  const float pi = asfloat(0x40490fdbu);
  const float pi_lo = asfloat(0xb3bbbd2eu);
  const int32_t hx = (int32_t)asuint(x), hy = (int32_t)asuint(y);
  const int32_t ix = hx & 0x7fffffff, iy = hy & 0x7fffffff;
  // finite and nonzero: 1 <= ix, iy <= 0x7f7fffff
  if ((uint32_t)(ix - 1) >= 0x7f7fffffu || (uint32_t)(iy - 1) >= 0x7f7fffffu)
    return atan2f_special(y, x);
  const int32_t k = (iy - ix) >> 23;
  float z = atanf(fabsf(y / x));
  z = k > 60 ? pi_o_2 + 0.5f * pi_lo : z;
  z = (hx < 0 && k < -60) ? 0.0f : z;
  const float zl = z - pi_lo;
  const float neg = hx < 0 ? (hy < 0 ? zl - pi : pi - zl) : -z;
  return (hx >= 0 && hy >= 0) ? z : neg;
}

// atan2f(-(ay - by), ax - bx): the heading toward (ax, ay) from (bx, by) with
// the screen's y axis down. The difference is negated, not swapped: where
// ay == by, -(ay - by) is -0.0 and by - ay is +0.0, and atan2f tells them
// apart for ax < bx (-pi and pi).
LIBM_HD float atan2f_diff(float ay, float by, float ax, float bx) {
  return atan2f(-(ay - by), ax - bx);
}

// ----------------------------------------------------------------- hypotf
LIBM_COLD float hypotf_special(float x, float y) {
  if (isinf(x) || isinf(y)) return INFINITY;
  return x + y;
}

// sqrt(s), correctly rounded, for a positive normal double s whose square
// root is normal too (all that hypotf passes: 2^-298 <= s < 2^257). A
// reciprocal square root estimate, two Newton steps (each doubles its
// bits: 2^-20 -> 2^-40 -> 2^-80, then double's roundings), one Markstein
// step to a faithful g, and the rounding decided exactly: r = s - g*g is
// exact for a faithful g, and with u = ulp(g) (u' below g: u/2 at a power
// of two), sqrt(s) > g + u/2 iff r > g*u, and sqrt(s) < g - u'/2 iff
// r <= -g*u' (r, g*u and g*u' are multiples of u'*u', and no square root
// of a double lies on a midpoint). The library's sqrt takes a CALL to a slow
// path for zero, subnormal, negative and infinite operands; this one has
// none.
LIBM_HD double sqrt_normal(double s) {
#ifdef __CUDA_ARCH__
  double y;
  asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(s));
#else  // the host's estimate, cut to 20 bits: the steps below need no more
  double y = 1.0 / sqrt(s);
  uint64_t yb;
  memcpy(&yb, &y, sizeof yb);
  yb &= 0xffffffff00000000ull;
  memcpy(&y, &yb, sizeof y);
#endif
  double g = s * y, h = 0.5 * y;
  double r = fma(-g, h, 0.5);
  g = fma(g, r, g);
  h = fma(h, r, h);
  r = fma(-g, h, 0.5);
  g = fma(g, r, g);
  h = fma(h, r, h);
  g = fma(fma(-g, g, s), h, g);  // Markstein: faithful
  r = fma(-g, g, s);              // exact
  uint64_t gb;
#ifdef __CUDA_ARCH__
  gb = (uint64_t)__double_as_longlong(g);
#else
  memcpy(&gb, &g, sizeof gb);
#endif
  const uint64_t eb = gb & 0x7ff0000000000000ull;
  const uint64_t ub = eb - (52ull << 52);                         // ulp(g)
  const uint64_t db = (gb & 0x000fffffffffffffull) ? ub : ub - (1ull << 52);  // below g
  double u, ud;
#ifdef __CUDA_ARCH__
  u = __longlong_as_double((long long)ub);
  ud = __longlong_as_double((long long)db);
#else
  memcpy(&u, &ub, sizeof u);
  memcpy(&ud, &db, sizeof ud);
#endif
  return r > g * u ? g + u : (r <= -(g * ud) ? g - ud : g);
}

// glibc's hypotf, (float) sqrt((double) x * x + (double) y * y). A float's
// 24-bit significand squared fits in 48 of double's 53 bits and a float
// squared (2^-298 to 2^256) stays in double's normal range, so both products
// are exact and fma(dx, dx, dy * dy) rounds the same single sum. Non-finite
// operands go out of line; s == 0 is a select.
LIBM_HD float hypotf(float x, float y) {
  if ((asuint(x) & 0x7fffffff) >= 0x7f800000u || (asuint(y) & 0x7fffffff) >= 0x7f800000u)
    return hypotf_special(x, y);
  const double dx = x, dy = y;
  const double s = fma(dx, dx, dy * dy);
  return (float)(s == 0.0 ? 0.0 : sqrt_normal(s));
}

// hypotf(ax - bx, ay - by): the distance from (bx, by) to (ax, ay).
LIBM_HD float hypotf_diff(float ax, float bx, float ay, float by) {
  return hypotf(ax - bx, ay - by);
}

}  // namespace libm_f32
