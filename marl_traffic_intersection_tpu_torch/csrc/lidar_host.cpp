// K1's per-ray body (lidar_march.cuh) built for the CPU with g++
// -ffp-contract=off, so that the tests can hold the card's algorithm, the
// exact obstacle cull included, bit for bit against
// core/lidar.py::lidar_scan_ref without a card. The port's CPU path is
// lidar_scan_ref itself; nothing but the tests calls this library.
#include <stdint.h>

#include "lidar_march.cuh"

extern "C" {

// The same contract as lidar.cu's lidar_scan_launch, on host pointers; om is
// one byte per obstacle. `survivors`, if not null, receives per ray the
// number of boxes left after the cull.
int lidar_scan_host(const float* sx, const float* sy, const float* sh, const float* ox,
                    const float* oy, const float* oh, const uint8_t* om, const float* rel,
                    float* out, int32_t* survivors, int B, int N, int M, int num_lanes) {
  if (M < 0 || M > lidar::kMaxObstacles) return 1;
  lidar::Box boxes[lidar::kMaxObstacles];
  for (int b = 0; b < B; ++b) {
    for (int m = 0; m < M; ++m)
      boxes[m] = lidar::obstacle_box(ox[b * M + m], oy[b * M + m], oh[b * M + m]);
    for (int a = 0; a < N; ++a) {
      const int i = b * N + a;
      uint64_t seen = 0;
      for (int m = 0; m < M; ++m)
        if (lidar::sees(sx[i], sy[i], sh[i], ox[b * M + m], oy[b * M + m], oh[b * M + m],
                        om[b * M + m] != 0))
          seen |= 1ull << m;
      for (int r = 0; r < lidar::kRays; ++r) {
        const lidar::Ray ray = lidar::make_ray(sx[i], sy[i], sh[i], rel[r]);
        const uint64_t mask = lidar::cull(ray, seen, boxes);
        if (survivors) survivors[i * lidar::kRays + r] = __builtin_popcountll(mask);
        out[i * lidar::kRays + r] = lidar::march(ray, mask, boxes, num_lanes);
      }
    }
  }
  return 0;
}

// x_k = sample(p0[i], d[i], 4k) for k = 0..62 into out (n, 63): the sequence
// whose monotonicity the cull rests on.
void lidar_samples_host(const float* p0, const float* d, long n, float* out) {
  for (long i = 0; i < n; ++i) {
    float dist = 0.0f;
    for (int k = 0; k < lidar::kSamples; ++k) {
      out[i * lidar::kSamples + k] = lidar::sample(p0[i], d[i], dist);
      dist = lidar::add(dist, lidar::kStep);
    }
  }
}

}  // extern "C"
