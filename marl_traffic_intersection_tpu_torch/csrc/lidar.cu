// K1: the beam-lidar ray march, by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel marl_traffic_intersection_tpu/ops/lidar_pallas.py
// (lidar_scan_pallas, body _kernel; pallas_call at :155) and computes what
// the current marl_traffic_intersection_tpu/core/lidar.py::lidar_scan
// computes: for B envs x N agents, 96 rays x 63 samples 4 px apart; sample
// coordinates truncated to int; the first event wins: off the screen ends the
// ray with no hit, and at dist > 0 off the road, or inside the AABB of a
// present obstacle not within 1e-3 of the agent's own pose, is a hit.
// Output: 4*k for a hit at sample k, else 250. The plain PyTorch version is
// core/lidar.py::lidar_scan_ref.
//
// Bound. Bytes: 4096*4*96*4 B of output plus ~0.5 MB of inputs, ~6.8 MB at
// the main path's shapes, ~2 us at 3.35 TB/s. Operations: the samples the
// rays actually march (up to and including the first event) times
// ~(20 + 4*M) f32 operations each, counted with lidar_scan_ref's
// marched-sample count (chip_smoke.py does so for each run). At B=4096 and
// N=M=4 there are 1.57M rays, so at most 1.57M * 63 * 36 = 3.6 G operations,
// at most ~53 us at 67 TFLOP/s f32: the operations, and the sequential
// dependence along each ray, bound the march, not the bytes.
//
// Design. The TPU resolved the sequential break with a dense (samples x
// rays) grid and a parity-code min-reduce; a GPU thread can simply march and
// stop, so nothing of the grid is built or stored:
//   * one block per env, one thread per (agent, ray) (384 threads at N=4);
//   * the env's obstacles are read once per block into shared memory, their
//     AABBs computed once there (cosf/sinf of the obstacle heading);
//   * each thread tests its own agent against the obstacles once (the eps
//     self/duplicate test) into a bit mask, then marches with early exit;
//   * ray directions use the glibc-faithful cosf/sinf of libm_f32.cuh, and
//     every product rounds before its add (__fmul_rn/__fadd_rn, and the
//     whole file is built with --fmad=false);
//   * the screen test is the reference's four compares (Lidar.cpp:38-40),
//     not a min/max fold: fminf drops a NaN that jnp.minimum propagates.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
//        -prec-div=true -prec-sqrt=true -shared -Xcompiler -fPIC
#include <cuda_runtime.h>
#include <stdint.h>

#include "libm_f32.cuh"

namespace {

constexpr int kRays = 96;
constexpr int kSamples = 63;
constexpr float kStep = 4.0f;
constexpr float kMaxDist = 250.0f;
constexpr float kWidth = 750.0f;
constexpr float kHeight = 750.0f;
constexpr float kHalfLength = 27.0f;  // CAR_LENGTH / 2
constexpr float kHalfWidth = 12.0f;   // CAR_WIDTH / 2
constexpr float kCornerRadius = 84.0f;
constexpr float kLaneWidth = 42.0f;
constexpr int kMaxObstacles = 64;     // one bit each in a thread's mask

struct Box {
  float x, y, h, lox, hix, loy, hiy;
  int present;
};

__device__ __forceinline__ bool off_road(float x, float y, float rw, float d, float r2) {
  // ~is_on_road for integer-valued coords (geometry.py off_road_grid_fast):
  // exact in f32, the four grass circles folded by symmetry
  float ax = fabsf(__fsub_rn(x, 0.5f * kWidth));
  float ay = fabsf(__fsub_rn(y, 0.5f * kHeight));
  float gx = __fsub_rn(ax, d);
  float gy = __fsub_rn(ay, d);
  bool in_grass = __fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)) <= r2;
  bool on_rect = (ax <= rw) || (ay <= rw) || ((ax <= d) && (ay <= d));
  return in_grass || !on_rect;
}

__global__ void lidar_kernel(const float* __restrict__ sx, const float* __restrict__ sy,
                             const float* __restrict__ sh, const float* __restrict__ ox,
                             const float* __restrict__ oy, const float* __restrict__ oh,
                             const uint8_t* __restrict__ om, const float* __restrict__ rel,
                             float* __restrict__ out, int N, int M, int num_lanes) {
  extern __shared__ Box boxes[];
  const int b = blockIdx.x;

  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    Box bx;
    bx.x = ox[b * M + m];
    bx.y = oy[b * M + m];
    bx.h = oh[b * M + m];
    bx.present = om[b * M + m] != 0;
    float c = fabsf(libm_f32::cosf(bx.h));
    float s = fabsf(libm_f32::sinf(bx.h));
    float ex = __fadd_rn(__fmul_rn(c, kHalfLength), __fmul_rn(s, kHalfWidth));
    float ey = __fadd_rn(__fmul_rn(s, kHalfLength), __fmul_rn(c, kHalfWidth));
    bx.lox = __fsub_rn(bx.x, ex);
    bx.hix = __fadd_rn(bx.x, ex);
    bx.loy = __fsub_rn(bx.y, ey);
    bx.hiy = __fadd_rn(bx.y, ey);
    boxes[m] = bx;
  }
  __syncthreads();

  const float rw = (float)num_lanes * kLaneWidth;
  const float d = rw + kCornerRadius;
  const float r2 = kCornerRadius * kCornerRadius;

  for (int t = threadIdx.x; t < N * kRays; t += blockDim.x) {
    const int a = t / kRays;
    const int r = t - a * kRays;
    const float px0 = sx[b * N + a];
    const float py0 = sy[b * N + a];
    const float h0 = sh[b * N + a];

    uint64_t mask = 0;
    for (int m = 0; m < M; ++m) {
      const Box& bx = boxes[m];
      bool same = fabsf(__fsub_rn(bx.x, px0)) < 1e-3f && fabsf(__fsub_rn(bx.y, py0)) < 1e-3f &&
                  fabsf(__fsub_rn(bx.h, h0)) < 1e-3f;
      if (bx.present && !same) mask |= 1ull << m;
    }

    const float ang = __fadd_rn(h0, rel[r]);
    const float dx = libm_f32::cosf(ang);
    const float dy = -libm_f32::sinf(ang);
    float result = kMaxDist;
    for (int k = 0; k < kSamples; ++k) {
      const float dist = (float)k * kStep;
      const float x = truncf(__fadd_rn(px0, __fmul_rn(dx, dist)));
      const float y = truncf(__fadd_rn(py0, __fmul_rn(dy, dist)));
      if (x < 0.0f || x >= kWidth || y < 0.0f || y >= kHeight) break;
      if (k == 0) continue;
      bool hit = off_road(x, y, rw, d, r2);
      for (uint64_t rest = mask; !hit && rest; rest &= rest - 1) {
        const Box& bx = boxes[__ffsll((long long)rest) - 1];
        hit = x >= bx.lox && x <= bx.hix && y >= bx.loy && y <= bx.hiy;
      }
      if (hit) {
        result = dist;
        break;
      }
    }
    out[(b * N + a) * kRays + r] = result;
  }
}

}  // namespace

extern "C" {

int lidar_max_obstacles() { return kMaxObstacles; }

// Launch K1 on `stream`. Pointers are device pointers of contiguous tensors:
// sx, sy, sh (B, N) f32; ox, oy, oh (B, M) f32; om (B, M) bool; rel (96,) f32;
// out (B, N, 96) f32. Returns cudaGetLastError() after the launch.
int lidar_scan_launch(const float* sx, const float* sy, const float* sh, const float* ox,
                      const float* oy, const float* oh, const uint8_t* om, const float* rel,
                      float* out, int B, int N, int M, int num_lanes, void* stream) {
  if (B > 0 && N > 0) {
    int agents_per_pass = N < 8 ? N : 8;
    int threads = agents_per_pass * kRays;
    size_t smem = (size_t)(M > 0 ? M : 1) * sizeof(Box);
    lidar_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(sx, sy, sh, ox, oy, oh, om, rel,
                                                             out, N, M, num_lanes);
  }
  return (int)cudaGetLastError();
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
