// K2: the NPC planner's move, by hand for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package plans its NPCs in XLA
// (marl_traffic_intersection_tpu/core/npc.py::_plan_npc_action, never a
// Pallas kernel). It computes what core/npc.py::move_ref computes for a set
// of planners (B envs x S NPCs, each against the pool's M slots): the plan
// (`_plan`), one physics tick (core/physics.py::car_physics_step) and the
// refreshed path index (update_path_index), bit for bit (npc_move.cuh says
// how). The PyTorch chain it replaces is ~200 launches a call, and at S = M
// it builds (B, S, M, 160) tensors in device memory.
//
// Bound: bytes. A planner reads its 160-point polyline (1,280 B), its pose,
// its row of `others` (M B) and writes 24 B; the env's M poses (20 B each)
// are shared by its S planners. The dense call at B = 4096, S = M = 8 reads
// ~44 MB, ~13 us at 3.35 TB/s; its arithmetic, ~2,200 operations a planner
// (M pair terms with three hypotf and a sincosf each, 120 distances to the
// scan points, the tick), is ~1 us at 67 TFLOP/s. The polylines are read
// once and nothing else touches device memory in between.
//
// Design: one warp per planner, four to a block.
//   * lane l holds path points l + 32i (i < 5): each i is one coalesced
//     256-byte load of (x, y) pairs, and the planner's distance to the
//     points of its scan window is computed once, on the lane that holds it;
//   * the other slots sit on lanes, 32 at a time for any M: each lane
//     computes its slot's pair terms (front-car distance, considered, right
//     of way), and two ballots make the chunk's masks;
//   * for each considered slot (a warp-uniform loop over the mask) its pose
//     is shuffled to every lane, which tests its own points against it;
//   * the first conflicting point is the first nonzero ballot over i and its
//     lowest lane (point order), its distance shuffled from that lane; the
//     front distance is a warp min;
//   * every lane runs the throttle, steer and physics tick (uniform, so no
//     broadcast is needed), then the 50-point path-index window: each lane's
//     (distance, index) minimum, then a butterfly in torch.argmin's order.
// Nothing of size (B, S, M) or (B, S, M, 160) exists; one launch serves
// every shape (S = M, S = 1, any M, any B).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
//        -prec-div=true -prec-sqrt=true -shared -Xcompiler -fPIC
#include <cuda_runtime.h>
#include <stdint.h>

#include "npc_move.cuh"

namespace {

constexpr int kThreads = 128;       // four planners per block
constexpr int kLanes = 32;
constexpr int kPerLane = npc_move::kPathLen / kLanes;
constexpr unsigned kAll = 0xffffffffu;

static_assert(npc_move::kPathLen % kLanes == 0, "whole points per lane");

__global__ void __launch_bounds__(kThreads)
    npc_move_kernel(const float* __restrict__ px, const float* __restrict__ py,
                    const float* __restrict__ pv, const float* __restrict__ ph,
                    const float* __restrict__ ps, const int32_t* __restrict__ pu,
                    const int32_t* __restrict__ pi0, const float2* __restrict__ paths,
                    const uint8_t* __restrict__ others, const float* __restrict__ ox,
                    const float* __restrict__ oy, const float* __restrict__ ov,
                    const float* __restrict__ oh, const int32_t* __restrict__ ou,
                    const float* __restrict__ dt, float* __restrict__ out,
                    int32_t* __restrict__ out_pi, long n, int S, int M) {
  using namespace npc_move;
  const long w = ((long)blockIdx.x * kThreads + threadIdx.x) / kLanes;   // the planner
  const int lane = threadIdx.x % kLanes;
  if (w >= n) return;  // a whole warp
  const long b = w / S;
  const Planner p = planner(px[w], py[w], pv[w], ph[w], pu[w]);
  const int k0 = pi0[w];
  const float2* g = paths + w * kPathLen;

  // this lane's path points, and the planner's distance to those it scans
  float gx[kPerLane], gy[kPerLane], dtc[kPerLane];
  bool scan[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int k = lane + kLanes * i;
    const float2 q = g[k];
    gx[i] = q.x;
    gy[i] = q.y;
    scan[i] = k >= k0 && k < k0 + kScanSteps;
    dtc[i] = scan[i] ? point_distance(p, q.x, q.y) : 0.0f;
  }

  // the other slots, one to a lane, 32 at a time
  float front = kNone;
  bool near_considered[kPerLane] = {}, near_yielding[kPerLane] = {};
  for (int m0 = 0; m0 < M; m0 += kLanes) {
    const int m = m0 + lane;
    float qx = 0.0f, qy = 0.0f;
    Pair t{kNone, false, false};
    if (m < M) {
      const long j = b * M + m;
      qx = ox[j];
      qy = oy[j];
      t = pair(p, qx, qy, ov[j], oh[j], ou[j], others[w * M + m] != 0);
    }
    front = nearer(front, t.front);
    const uint32_t considered = __ballot_sync(kAll, t.considered);
    const uint32_t yields = __ballot_sync(kAll, t.yields);
    for (uint32_t rest = considered; rest; rest &= rest - 1) {
      const int src = __ffs(rest) - 1;
      const float cx = __shfl_sync(kAll, qx, src);
      const float cy = __shfl_sync(kAll, qy, src);
      const bool y = (yields >> src) & 1u;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const bool c = scan[i] && near_point(cx, cy, gx[i], gy[i]);
        near_considered[i] = near_considered[i] || c;
        near_yielding[i] = near_yielding[i] || (c && y);
      }
    }
  }
  for (int o = kLanes / 2; o; o /= 2) front = nearer(front, __shfl_xor_sync(kAll, front, o));

  // the first conflicting point, in point order
  bool conflict = false;
  float first = 0.0f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const uint32_t hit = __ballot_sync(
        kAll, scan[i] && conflicts(dtc[i], near_considered[i], near_yielding[i]));
    const float d = __shfl_sync(kAll, dtc[i], hit ? __ffs(hit) - 1 : 0);
    if (hit && !conflict) {
      conflict = true;
      first = d;
    }
  }

  const int t = min(max(k0 + kLookahead, 0), kPathLen - 1);
  const float2 q = g[t];
  const float th = brake(follow(cruise(p.v), front), conflict, first);
  const Moved o = physics(p.x, p.y, p.v, p.h, ps[w], th, steer(p, q.x, q.y), *dt);

  // the nearest path point of the 50 from the refreshed index
  const int lo = max(k0, 0);
  float best = 0.0f;
  int at = lane;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int k = lane + kLanes * i;
    const float d = (k >= lo && k < lo + kSearch) ? path_distance(gx[i], gy[i], o.x, o.y)
                                                  : INFINITY;
    if (i == 0 || before(d, k, best, at)) {
      best = d;
      at = k;
    }
  }
  for (int s = kLanes / 2; s; s /= 2) {
    const float d = __shfl_xor_sync(kAll, best, s);
    const int k = __shfl_xor_sync(kAll, at, s);
    if (before(d, k, best, at)) {
      best = d;
      at = k;
    }
  }

  if (lane == 0) {
    out[w] = o.x;
    out[n + w] = o.y;
    out[2 * n + w] = o.v;
    out[3 * n + w] = o.h;
    out[4 * n + w] = o.steering;
    out_pi[w] = at;
  }
}

}  // namespace

extern "C" {

// Launch K2 on `stream`. Pointers are device pointers of contiguous tensors:
// the planners' px, py, pv, ph, ps (x, y, speed, heading, steering angle) (B,
// S) f32, pu (uid) and pi0 (refreshed path index) (B, S) int32, paths (B, S,
// 160, 2) f32 (8-byte aligned), others (B, S, M) bool; the pool's ox, oy, ov,
// oh (B, M) f32 and ou (B, M) int32; dt one f32; out (5, B, S) f32 (x, y, v,
// heading, steering angle) and out_pi (B, S) int32, neither overlapping an
// input. Returns cudaGetLastError() after the launch.
int npc_move_launch(const float* px, const float* py, const float* pv, const float* ph,
                    const float* ps, const int32_t* pu, const int32_t* pi0, const float* paths,
                    const uint8_t* others, const float* ox, const float* oy, const float* ov,
                    const float* oh, const int32_t* ou, const float* dt, float* out,
                    int32_t* out_pi, int B, int S, int M, void* stream) {
  if (B < 0 || S < 0 || M < 0) return (int)cudaErrorInvalidValue;
  const long n = (long)B * S;
  if (n > 0) {
    const long blocks = (n * kLanes + kThreads - 1) / kThreads;
    npc_move_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        px, py, pv, ph, ps, pu, pi0, reinterpret_cast<const float2*>(paths), others, ox, oy,
        ov, oh, ou, dt, out, out_pi, n, S, M);
  }
  return (int)cudaGetLastError();
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
