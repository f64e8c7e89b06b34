// The per-ray body of K1, the beam-lidar ray march, for the card
// (csrc/lidar.cu) and for the CPU (csrc/lidar_host.cpp, which the tests hold
// bit for bit against core/lidar.py::lidar_scan_ref).
//
// A ray of a scanner at (px0, py0) with direction (dx, dy) samples
//   x_k = trunc(fl(px0 + fl(dx * 4k))),  y_k likewise,  k = 0..62,
// and stops at the first event: x_k or y_k off the screen ends it with no
// hit; at k > 0, a sample off the road or inside the AABB of an obstacle the
// scanner sees is a hit at distance 4k. With no event the reading is 250.
//
// The exact per-ray obstacle cull. For finite samples, x_k is monotone in k:
// 4k is exact and increasing; for a fixed dx the exact product dx * 4k is
// monotone in k (up for dx > 0, down for dx < 0, zero for dx = +-0), and so
// are the exact sum px0 + fl(dx * 4k), round-to-nearest and trunc, each of
// which is monotone non-decreasing in its argument. Signed zeros compare
// equal, so -0.0 does not break the order. Hence every sample of a ray lies
// in the box spanned by samples 0 and 62, and an obstacle AABB that does not
// meet that box can never be hit by the ray: `cull` drops it with four
// compares, once per ray, and the march tests only the survivors. With a NaN
// bound the compares are false and the box is dropped; the per-sample test
// could never hit it either. A ray whose end samples are not finite (a NaN or
// infinite pose or direction) keeps every box and takes the full per-sample
// walk, so the cull never has to reason about it.
//
// Every product and sum rounds on its own (__fmul_rn/__fadd_rn on the card;
// g++ -ffp-contract=off and nvcc --fmad=false for everything else), the ray
// directions come from libm_f32.cuh's glibc-faithful cosf/sinf, and the
// screen test is the reference's four compares (Lidar.cpp:38-40), not a
// min/max fold: fminf drops a NaN that the compares keep.
#pragma once

#include <math.h>
#include <stdint.h>

#include "libm_f32.cuh"

#ifdef __CUDACC__
#define LIDAR_HD __host__ __device__ __forceinline__
#else
#define LIDAR_HD static inline
#endif

namespace lidar {

constexpr int kRays = 96;
constexpr int kSamples = 63;
constexpr float kStep = 4.0f;
constexpr float kLastDist = 248.0f;   // (kSamples - 1) * kStep
constexpr float kMaxDist = 250.0f;
constexpr float kWidth = 750.0f;
constexpr float kHeight = 750.0f;
constexpr float kHalfLength = 27.0f;  // CAR_LENGTH / 2
constexpr float kHalfWidth = 12.0f;   // CAR_WIDTH / 2
constexpr float kCornerRadius = 84.0f;
constexpr float kLaneWidth = 42.0f;
constexpr int kMaxObstacles = 64;     // one bit each in a ray's mask

LIDAR_HD float mul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

LIDAR_HD float add(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

LIDAR_HD float sub(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}

LIDAR_HD int lowest_bit(uint64_t m) {
#ifdef __CUDA_ARCH__
  return __ffsll((long long)m) - 1;
#else
  return __builtin_ctzll(m);
#endif
}

struct alignas(16) Box {
  float lox, hix, loy, hiy;
};

struct Ray {
  float px0, py0, dx, dy;
};

// The AABB of an obstacle's rotated car rectangle.
LIDAR_HD Box obstacle_box(float x, float y, float h) {
  const float c = fabsf(libm_f32::cosf(h));
  const float s = fabsf(libm_f32::sinf(h));
  const float ex = add(mul(c, kHalfLength), mul(s, kHalfWidth));
  const float ey = add(mul(s, kHalfLength), mul(c, kHalfWidth));
  return Box{sub(x, ex), add(x, ex), sub(y, ey), add(y, ey)};
}

// Whether the scanner at (sx, sy, sh) sees the obstacle: it is present and
// its pose is not within 1e-3 of the scanner's own (Lidar.cpp:55-63).
LIDAR_HD bool sees(float sx, float sy, float sh, float ox, float oy, float oh, bool present) {
  const bool same = fabsf(sub(ox, sx)) < 1e-3f && fabsf(sub(oy, sy)) < 1e-3f &&
                    fabsf(sub(oh, sh)) < 1e-3f;
  return present && !same;
}

LIDAR_HD Ray make_ray(float sx, float sy, float sh, float rel) {
  const float ang = add(sh, rel);
  return Ray{sx, sy, libm_f32::cosf(ang), -libm_f32::sinf(ang)};
}

// One sample coordinate: trunc(p0 + d * dist), the product rounded first.
LIDAR_HD float sample(float p0, float d, float dist) { return truncf(add(p0, mul(d, dist))); }

LIDAR_HD bool off_screen(float x, float y) {
  return x < 0.0f || x >= kWidth || y < 0.0f || y >= kHeight;
}

// ~is_on_road for integer-valued coordinates (geometry.py off_road_grid_fast):
// exact in f32, the four grass circles folded by symmetry.
LIDAR_HD bool off_road(float x, float y, float rw, float d, float r2) {
  const float ax = fabsf(sub(x, 0.5f * kWidth));
  const float ay = fabsf(sub(y, 0.5f * kHeight));
  const float gx = sub(ax, d);
  const float gy = sub(ay, d);
  const bool in_grass = add(mul(gx, gx), mul(gy, gy)) <= r2;
  const bool on_rect = (ax <= rw) || (ay <= rw) || ((ax <= d) && (ay <= d));
  return in_grass || !on_rect;
}

LIDAR_HD bool in_box(float x, float y, const Box& b) {
  return x >= b.lox && x <= b.hix && y >= b.loy && y <= b.hiy;
}

// The boxes of `seen` that the ray's sample box meets (see the note above).
LIDAR_HD uint64_t cull(const Ray& ray, uint64_t seen, const Box* boxes) {
  const float x0 = sample(ray.px0, ray.dx, 0.0f), x1 = sample(ray.px0, ray.dx, kLastDist);
  const float y0 = sample(ray.py0, ray.dy, 0.0f), y1 = sample(ray.py0, ray.dy, kLastDist);
  if (!(isfinite(x0) && isfinite(x1) && isfinite(y0) && isfinite(y1))) return seen;
  const float xlo = x0 < x1 ? x0 : x1, xhi = x0 < x1 ? x1 : x0;
  const float ylo = y0 < y1 ? y0 : y1, yhi = y0 < y1 ? y1 : y0;
  uint64_t keep = 0;
  for (uint64_t rest = seen; rest; rest &= rest - 1) {
    const int m = lowest_bit(rest);
    const Box b = boxes[m];
    if (b.lox <= xhi && b.hix >= xlo && b.loy <= yhi && b.hiy >= ylo) keep |= 1ull << m;
  }
  return keep;
}

// The ray's reading: 4k for the first hit at sample k, else kMaxDist. Only
// the boxes of `mask` are tested.
LIDAR_HD float march(const Ray& ray, uint64_t mask, const Box* boxes, int num_lanes) {
  const float rw = (float)num_lanes * kLaneWidth;
  const float d = rw + kCornerRadius;
  const float r2 = kCornerRadius * kCornerRadius;
  if (off_screen(sample(ray.px0, ray.dx, 0.0f), sample(ray.py0, ray.dy, 0.0f))) return kMaxDist;
  float dist = 0.0f;
  for (int k = 1; k < kSamples; ++k) {
    dist = add(dist, kStep);  // 4k, exact
    const float x = sample(ray.px0, ray.dx, dist);
    const float y = sample(ray.py0, ray.dy, dist);
    if (off_screen(x, y)) break;
    bool hit = off_road(x, y, rw, d, r2);
    for (uint64_t rest = mask; !hit && rest; rest &= rest - 1)
      hit = in_box(x, y, boxes[lowest_bit(rest)]);
    if (hit) return dist;
  }
  return kMaxDist;
}

}  // namespace lidar
