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
// Bound: memory. Each element reads 4 to 16 bytes and writes 4 or 8,
// against ~20-40 f64 and f32 operations; at the env's (4096, 4) shapes a
// launch is far below a microsecond of traffic, so the launch itself and
// one thread's chain of dependent operations set its time. So:
//   * sinf and cosf of one angle are one launch (sincosf_kernel): every call
//     site of the port takes both, and the pair shares glibc's reduction;
//   * tanf's body runs the polynomial and one division once per warp on
//     reduced operands (libm_f32.cuh), its |x| >= 120 fallback out of line;
//     atan2f's runs one atanf and two divisions per warp, hypotf's an f64
//     square root with no slow path, their rare operands out of line;
//   * the port's call sites pass atan2f and hypotf differences of poses and
//     path points, so atan2f_diff and hypotf_diff take the four operands and
//     subtract in the launch: no launch per difference, and no write and
//     read back of a (4096, 8, 160) difference in the NPC plan. They are
//     the only atan2f and hypotf kernels: ops/libm.py launches atan2f(y, x)
//     as atan2f_diff(-0.0, y, x, 0.0) and hypotf(x, y) as hypotf_diff(x,
//     0.0, y, 0.0), whose subtractions are exact, signed zeros included;
//   * they read their operands by strides (broadcast, expanded or
//     interleaved views, up to 4-D after the host has merged the dimensions
//     that are contiguous in every operand), so no operand is copied to a
//     contiguous tensor first; a 1-D launch does no division;
//   * every launcher keeps 256-thread blocks, one element per thread (64
//     blocks for the main path's 16,384 elements): on an H100, blocks of 64,
//     128, 512 and 1024 threads were all slower for sincosf and tanf at
//     (4096, 4); 2 or 4 elements per thread were slower for every kernel at
//     (4096, 4) and (4096, 8), and 4 were 9-10% faster only for hypotf_diff
//     at (4096, 8, 160), where reading an interleaved path's (x, y) pair with
//     one 8-byte load gained nothing (PERF.md, kernel table).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
//        -prec-div=true -prec-sqrt=true -shared -Xcompiler -fPIC
#include <cuda_runtime.h>

#include "libm_f32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kDims = 4;

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

// NIN operands read by strides over a shape of D dimensions (the last D of
// size[]), the output contiguous. Strides are in elements, and every offset
// an operand reaches is below 2^31 (the wrapper checks): 32-bit offsets ran
// 2-9% faster than 64-bit ones on an H100 (PERF.md, kernel table).
template <int NIN>
struct Strided {
  const float* __restrict__ p[NIN];
  unsigned size[kDims];
  unsigned stride[NIN][kDims];
};

template <int D, int NIN>
__device__ __forceinline__ void offsets(const Strided<NIN>& a, unsigned i, unsigned* off) {
  unsigned c[kDims];
#pragma unroll
  for (int d = kDims - 1; d > kDims - D; --d) {
    c[d] = i % a.size[d];
    i /= a.size[d];
  }
  c[kDims - D] = i;
#pragma unroll
  for (int k = 0; k < NIN; ++k) {
    off[k] = 0;
#pragma unroll
    for (int d = kDims - D; d < kDims; ++d) off[k] += c[d] * a.stride[k][d];
  }
}

template <int D, int NIN, typename F>
__global__ void strided_kernel(Strided<NIN> a, float* __restrict__ out, unsigned n, F fn) {
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    unsigned off[NIN];
    offsets<D>(a, i, off);
    float v[NIN];
#pragma unroll
    for (int k = 0; k < NIN; ++k) v[k] = a.p[k][off[k]];
    out[i] = fn(v);
  }
}

int blocks_for(long n) {
  long b = (n + kThreads - 1) / kThreads;
  return (int)(b < 65536 ? (b > 0 ? b : 1) : 65536);
}

struct TanF { __device__ float operator()(float x) const { return libm_f32::tanf(x); } };
struct Atan2FDiff {
  __device__ float operator()(const float* v) const {
    return libm_f32::atan2f_diff(v[0], v[1], v[2], v[3]);
  }
};
struct HypotFDiff {
  __device__ float operator()(const float* v) const {
    return libm_f32::hypotf_diff(v[0], v[1], v[2], v[3]);
  }
};

template <typename F>
int launch_unary(const float* x, float* out, long n, void* stream) {
  if (n > 0)
    unary_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(x, out, n, F());
  return (int)cudaGetLastError();
}

// geom: the D sizes of the shape (outermost first), then each operand's D
// strides; n, the product of the sizes, and every operand's offsets below
// 2^31 (the wrapper checks).
template <typename F, int NIN>
int launch_strided(const float* const* p, float* out, const long* geom, int D, long n,
                   void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (D < 1 || D > kDims) return (int)cudaErrorInvalidValue;
  Strided<NIN> a;
  for (int d = 0; d < kDims; ++d) a.size[d] = 1;
  for (int k = 0; k < NIN; ++k) {
    a.p[k] = p[k];
    for (int d = 0; d < kDims; ++d) a.stride[k][d] = 0;
  }
  for (int d = 0; d < D; ++d) {
    a.size[kDims - D + d] = (unsigned)geom[d];
    for (int k = 0; k < NIN; ++k) a.stride[k][kDims - D + d] = (unsigned)geom[D + k * D + d];
  }
  dim3 grid(blocks_for(n)), block(kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 1: strided_kernel<1, NIN><<<grid, block, 0, s>>>(a, out, (unsigned)n, F()); break;
    case 2: strided_kernel<2, NIN><<<grid, block, 0, s>>>(a, out, (unsigned)n, F()); break;
    case 3: strided_kernel<3, NIN><<<grid, block, 0, s>>>(a, out, (unsigned)n, F()); break;
    default: strided_kernel<4, NIN><<<grid, block, 0, s>>>(a, out, (unsigned)n, F()); break;
  }
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
int libm_atan2f_diff(const float* ay, const float* by, const float* ax, const float* bx,
                     float* out, const long* geom, int ndim, long n, void* stream) {
  const float* p[4] = {ay, by, ax, bx};
  return launch_strided<Atan2FDiff, 4>(p, out, geom, ndim, n, stream);
}
int libm_hypotf_diff(const float* ax, const float* bx, const float* ay, const float* by,
                     float* out, const long* geom, int ndim, long n, void* stream) {
  const float* p[4] = {ax, bx, ay, by};
  return launch_strided<HypotFDiff, 4>(p, out, geom, ndim, n, stream);
}
const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
