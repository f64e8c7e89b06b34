// Attribution / licensing: the functions launched here come from
// libm_f32.cuh, a derived work of the GNU C Library (glibc) 2.36 math
// routines (sysdeps/ieee754/flt-32 sinf/cosf/tanf/atan2f/hypotf, derived
// from Sun's fdlibm and the ARM optimized-routines sincosf), Copyright (C)
// 1993-2022 Free Software Foundation, Inc., licensed under the GNU Lesser
// General Public License v2.1 or later (LGPL-2.1-or-later). This file is
// distributed under the same terms.
//
// Elementwise launchers for the glibc-faithful f32 libm (ops/libm.py, CUDA
// side). They replace the emulated-f64 replicas the TPU needed
// (marl_traffic_intersection_tpu/ops/exact_trig.py sinf_emulated,
// cosf_emulated, tanf_emulated; ops/exact_libm.py atan2f_exact,
// hypotf_exact): Hopper has native fp64, so softfloat.py becomes plain
// double arithmetic with explicit fma().
//
// Bound: memory. Each element reads 4 or 8 bytes and writes 4 or 8, against
// ~20-40 f64 and f32 operations; at the env's (4096, 4) shapes a launch is
// far below a microsecond of traffic, so the launch itself and one thread's
// chain of dependent operations set its time. So:
//   * sinf and cosf of one angle are one launch (sincosf_kernel): every call
//     site of the port takes both, and the pair shares glibc's reduction;
//   * tanf's body runs the polynomial and one division once per warp on
//     reduced operands (libm_f32.cuh), its |x| >= 120 fallback out of line;
//   * every launcher keeps 256-thread blocks, one element per thread (64
//     blocks for the main path's 16,384 elements): on an H100, blocks of 64,
//     128, 512 and 1024 threads were all slower for sincosf and tanf at
//     (4096, 4) (PERF.md, kernel table).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
//        -prec-div=true -prec-sqrt=true -shared -Xcompiler -fPIC
#include <cuda_runtime.h>

#include "libm_f32.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void sincosf_kernel(const float* __restrict__ x, float* __restrict__ s,
                               float* __restrict__ c, long n) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x)
    libm_f32::sincosf(x[i], s + i, c + i);
}

template <typename F>
__global__ void unary_kernel(const float* __restrict__ x, float* __restrict__ out,
                             long n, F fn) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x)
    out[i] = fn(x[i]);
}

template <typename F>
__global__ void binary_kernel(const float* __restrict__ a, const float* __restrict__ b,
                              float* __restrict__ out, long n, F fn) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x)
    out[i] = fn(a[i], b[i]);
}

int blocks_for(long n) {
  long b = (n + kThreads - 1) / kThreads;
  return (int)(b < 65536 ? (b > 0 ? b : 1) : 65536);
}

struct TanF { __device__ float operator()(float x) const { return libm_f32::tanf(x); } };
struct Atan2F {
  __device__ float operator()(float y, float x) const { return libm_f32::atan2f(y, x); }
};
struct HypotF {
  __device__ float operator()(float x, float y) const { return libm_f32::hypotf(x, y); }
};

template <typename F>
int launch_unary(const float* x, float* out, long n, void* stream) {
  if (n > 0)
    unary_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(x, out, n, F());
  return (int)cudaGetLastError();
}

template <typename F>
int launch_binary(const float* a, const float* b, float* out, long n, void* stream) {
  if (n > 0)
    binary_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(a, b, out, n, F());
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int libm_sincosf(const float* x, float* s, float* c, long n, void* stream) {
  if (n > 0)
    sincosf_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(x, s, c, n);
  return (int)cudaGetLastError();
}
int libm_tanf(const float* x, float* out, long n, void* stream) {
  return launch_unary<TanF>(x, out, n, stream);
}
int libm_atan2f(const float* y, const float* x, float* out, long n, void* stream) {
  return launch_binary<Atan2F>(y, x, out, n, stream);
}
int libm_hypotf(const float* x, const float* y, float* out, long n, void* stream) {
  return launch_binary<HypotF>(x, y, out, n, stream);
}
const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
