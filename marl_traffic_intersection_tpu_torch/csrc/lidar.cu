// K1: the beam-lidar ray march, by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel marl_traffic_intersection_tpu/ops/lidar_pallas.py
// (lidar_scan_pallas, body _kernel; pallas_call at :155) and computes what
// the current marl_traffic_intersection_tpu/core/lidar.py::lidar_scan
// computes: for B envs x N agents, 96 rays x 63 samples 4 px apart, the
// first event wins (lidar_march.cuh says which). Output: 4*k for a hit at
// sample k, else 250. The plain PyTorch version is
// core/lidar.py::lidar_scan_ref; the kernel is held against it bit for bit.
//
// Bound: operations. Bytes: 4096*4*96*4 B of output plus ~0.5 MB of inputs,
// ~6.8 MB at the main path's shapes, ~2 us at 3.35 TB/s. Operations: about
// 20 f32 operations for each sample the rays march (sample, screen, road),
// plus 4 compares per ray for each obstacle it sees (the cull); at the main
// path's shapes ~1.06 G operations, ~16 us at 67 TFLOP/s. The march is a
// dependent chain along each ray, so the kernel needs many resident warps.
//
// Design. The TPU resolved the sequential break with a dense (samples x
// rays) grid and a parity-code min-reduce; a GPU thread can march and stop,
// so nothing of the grid is built or stored:
//   * one 96-thread block per (env, agent), one thread per ray: a block's
//     resources free when its own longest ray ends; measured faster than
//     one block per env at both measured shapes (PERF.md, K1 row);
//   * the env's obstacle AABBs are computed per block into shared memory,
//     and the set of obstacles the agent sees (present and not itself) is
//     one ballot per 32 obstacles, so no thread repeats the self test;
//   * before the barrier each thread computes its ray's direction (f64 libm),
//     so that work overlaps the box prologue;
//   * each ray culls the seen set to the boxes its sample box meets (exact,
//     lidar_march.cuh), and the march tests only those: at the main path
//     most rays keep none of the other cars.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
//        -prec-div=true -prec-sqrt=true -shared -Xcompiler -fPIC
#include <cuda_runtime.h>
#include <stdint.h>

#include "lidar_march.cuh"

namespace {

__global__ void __launch_bounds__(lidar::kRays)
    lidar_kernel(const float* __restrict__ sx, const float* __restrict__ sy,
                 const float* __restrict__ sh, const float* __restrict__ ox,
                 const float* __restrict__ oy, const float* __restrict__ oh,
                 const uint8_t* __restrict__ om, const float* __restrict__ rel,
                 float* __restrict__ out, int N, int M, int num_lanes) {
  extern __shared__ lidar::Box boxes[];
  __shared__ uint32_t seen_half[2];  // the 64 obstacle bits the agent sees
  const int i = blockIdx.x;          // (env, agent) = (i / N, i % N)
  const int b = i / N;
  const int t = threadIdx.x;         // the ray

  if (t < M) boxes[t] = lidar::obstacle_box(ox[b * M + t], oy[b * M + t], oh[b * M + t]);
  if (t < 64) {  // two whole warps, one obstacle per lane
    const int j = b * M + t;
    const bool s = t < M && lidar::sees(sx[i], sy[i], sh[i], ox[j], oy[j], oh[j], om[j] != 0);
    const uint32_t bits = __ballot_sync(0xffffffffu, s);
    if ((t & 31) == 0) seen_half[t >> 5] = bits;
  }
  const lidar::Ray ray = lidar::make_ray(sx[i], sy[i], sh[i], rel[t]);
  __syncthreads();

  const uint64_t seen = seen_half[0] | ((uint64_t)seen_half[1] << 32);
  const uint64_t near = lidar::cull(ray, seen, boxes);
  out[i * lidar::kRays + t] = lidar::march(ray, near, boxes, num_lanes);
}

}  // namespace

extern "C" {

int lidar_max_obstacles() { return lidar::kMaxObstacles; }

// How many of the kernel's blocks one SM holds at once with M obstacles.
int lidar_blocks_per_sm(int M, int* blocks_per_sm) {
  const size_t smem = (size_t)(M > 0 ? M : 1) * sizeof(lidar::Box);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, lidar_kernel,
                                                            lidar::kRays, smem);
}

// Launch K1 on `stream`. Pointers are device pointers of contiguous tensors:
// sx, sy, sh (B, N) f32; ox, oy, oh (B, M) f32; om (B, M) bool; rel (96,) f32;
// out (B, N, 96) f32; 0 <= M <= 64. Returns cudaGetLastError() after the
// launch.
int lidar_scan_launch(const float* sx, const float* sy, const float* sh, const float* ox,
                      const float* oy, const float* oh, const uint8_t* om, const float* rel,
                      float* out, int B, int N, int M, int num_lanes, void* stream) {
  if (M < 0 || M > lidar::kMaxObstacles) return (int)cudaErrorInvalidValue;
  if (B > 0 && N > 0) {
    const size_t smem = (size_t)(M > 0 ? M : 1) * sizeof(lidar::Box);
    lidar_kernel<<<B * N, lidar::kRays, smem, (cudaStream_t)stream>>>(
        sx, sy, sh, ox, oy, oh, om, rel, out, N, M, num_lanes);
  }
  return (int)cudaGetLastError();
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
