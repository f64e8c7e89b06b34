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
// Bound: memory. Each element reads 4 or 8 bytes and writes 4, against
// ~20 f64 operations; at the env's (4096, 4) shapes a launch is far below
// a microsecond of traffic, so launch latency dominates. The design is the
// simplest that is right: one thread per element, grid-stride loop.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
//        -prec-div=true -prec-sqrt=true -shared -Xcompiler -fPIC
#include <cuda_runtime.h>

#include "libm_f32.cuh"

namespace {

constexpr int kThreads = 256;

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

struct SinF { __device__ float operator()(float x) const { return libm_f32::sinf(x); } };
struct CosF { __device__ float operator()(float x) const { return libm_f32::cosf(x); } };
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

int libm_sinf(const float* x, float* out, long n, void* stream) {
  return launch_unary<SinF>(x, out, n, stream);
}
int libm_cosf(const float* x, float* out, long n, void* stream) {
  return launch_unary<CosF>(x, out, n, stream);
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
