// K3: the ego tick, by hand for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package steps its egos in XLA
// (marl_traffic_intersection_tpu/core/env.py's step, never a Pallas kernel).
// It computes what core/env.py::ego_step_ref computes, sections 2-7 of
// IntersectionEnv.step: the ego physics, the path index, the base reward, the
// per-ego status, the ordered ego-ego and ego-NPC collisions, the terminal
// bonuses and team mix, the respawn and the env's termination and
// truncation, bit for bit (ego_step.cuh says how). The PyTorch chain it
// replaces is ~420 launches a step without NPCs and ~530 with 8 NPC slots,
// and builds (B, N, 160, 2) polylines and (B, N, N, 4, 4) and (B, N, w, 4, 4)
// projections in device memory.
//
// Bound: bytes. An agent reads its 11 state arrays and actions (~50 B) and
// writes ~50 B, an NPC slot 13 B; the path-index window reads 50 points of a
// route table of 184 KB that stays in L2. At 4096 x 8 with w = 8 that is
// ~3.7 MB, ~1.1 us at 3.35 TB/s; the arithmetic, ~1,500 operations an agent
// (a tanf, two sincosf and a hypotf, 50 distances, the status tests, up to N
// + w separating-axis tests of 4 axes x 8 projections), is ~1 us at 67
// TFLOP/s. A launch costs about as much as either.
//
// Design: one thread per agent, whole envs to a block (E = 128 / N envs, fewer
// where the NPC slots would not fit 48 KB of shared memory):
//   * the block's threads compute the NPC slots' boxes (corners, sine and
//     cosine) once per slot into shared memory;
//   * each thread runs its agent's tick (sections 2-3) and writes its box,
//     status and done flag to shared memory; then its row of the ego-ego
//     test (the agents j > i) and its ego-NPC test, as bitmasks;
//   * the env's first thread (its leader) runs the ordered resolution over
//     the bitmasks in the reference's row order, and, with the team reward,
//     the ordered sum of the env's rewards;
//   * each thread adds its bonuses, mixes, respawns and writes its agent; the
//     leader writes the env's counts, termination and truncation.
// The route table is read in place by route id: nothing of size (B, N, 160),
// (B, N, N) or (B, N, w) exists.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
//        -prec-div=true -prec-sqrt=true -shared -Xcompiler -fPIC
#include <cuda_runtime.h>
#include <stdint.h>

#include "ego_step.cuh"

namespace {

using namespace ego_step;

constexpr int kThreads = 128;
constexpr int kSharedBytes = 48 * 1024;

struct AgentSlot {   // one agent's results that its env's other threads read
  Box box;
  float reward;
  int32_t status;
  uint32_t row;      // the agents j > i whose boxes overlap this one's
  uint8_t alive, done, npc_hit;
};

struct NpcSlot {
  Box box;
  uint8_t alive;
};

constexpr int env_bytes(int n, int w) {
  return n * (int)sizeof(AgentSlot) + w * (int)sizeof(NpcSlot) + (int)sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
    ego_step_kernel(const Args a, const Params p, int B, long npc_ld, int E) {
  extern __shared__ float4 shared[];
  const int n = p.n, w = p.w;
  AgentSlot* agents = reinterpret_cast<AgentSlot*>(shared);
  NpcSlot* npcs = reinterpret_cast<NpcSlot*>(agents + E * n);
  float* avg = reinterpret_cast<float*>(npcs + E * w);

  const int t = threadIdx.x, e = t / n, i = t % n;
  const long b = (long)blockIdx.x * E + e;
  const bool valid = b < B;          // threads of a missing env only keep the barriers
  const long ai = b * n + i;
  const long bn = (long)B * n;

  // the NPC slots' boxes, every thread of the block
  for (int k = t; k < E * w; k += blockDim.x) {
    const long bb = (long)blockIdx.x * E + k / w;
    if (bb >= B) break;
    const long j = bb * npc_ld + k % w;
    npcs[k].box = box(a.npc_x[j], a.npc_y[j], a.npc_heading[j]);
    npcs[k].alive = a.npc_alive[j];
  }

  // sections 2-3: this agent's tick
  AgentSlot* me = agents + t;
  AgentSlot* env = agents + e * n;
  Tick tk;
  bool alive = false;
  if (valid) {
    alive = a.alive[ai] != 0;
    const int r = route_row(a.route_id[ai], p.routes);
    tk = tick(p, alive, a.x[ai], a.y[ai], a.v[ai], a.heading[ai], a.steering[ai],
              a.path_index[ai], a.prev_dist[ai], a.prev_acc[ai], a.prev_steer[ai],
              a.actions[2 * ai], a.actions[2 * ai + 1], *a.dt, a.paths + (long)r * kPathLen * 2,
              a.goal_xy[2 * r], a.goal_xy[2 * r + 1], a.goal_prev_xy[2 * r],
              a.goal_prev_xy[2 * r + 1]);
    me->box = tk.box;
    me->alive = alive;
    me->done = tk.done;
  }
  __syncthreads();

  // section 4: this agent's row of the ego-ego test and its ego-NPC test
  if (valid) {
    uint32_t row = 0;
    bool hit = false;
    if (alive) {
      for (int j = i + 1; j < n; ++j)
        if (env[j].alive && overlap(tk.box, env[j].box)) row |= 1u << j;
      const NpcSlot* slots = npcs + e * w;
      for (int m = 0; m < w && !hit; ++m) hit = slots[m].alive && overlap(tk.box, slots[m].box);
    }
    me->row = row;
    me->npc_hit = hit;
  }
  __syncthreads();
  if (valid && i == 0) {
    uint32_t live = 0, done = 0, npc_hit = 0, rows[kMaxAgents];
    for (int j = 0; j < n; ++j) {
      live |= (uint32_t)env[j].alive << j;
      done |= (uint32_t)env[j].done << j;
      npc_hit |= (uint32_t)env[j].npc_hit << j;
      rows[j] = env[j].row;
    }
    const uint32_t car = resolve(n, live, &done, rows, npc_hit);
    for (int j = 0; j < n; ++j) {
      env[j].done = (done >> j) & 1u;
      env[j].status = ((car >> j) & 1u) ? (int32_t)kCar : -1;   // -1: the agent's own
    }
  }
  __syncthreads();

  // section 5: bonuses and the team mix
  bool done = false;
  int32_t status = 0;
  float reward = 0.0f;
  if (valid) {
    done = me->done;
    status = me->status < 0 ? tk.status : me->status;
    me->status = status;
    reward = bonus(p, tk.reward, done, status);
    me->reward = reward;
  }
  if (p.team) {
    __syncthreads();
    if (valid && i == 0) {
      float total = 0.0f;
      for (int j = 0; j < n; ++j) total = total + env[j].reward;
      avg[e] = total / (float)n;
    }
    __syncthreads();
    if (valid) reward = mixed(p, reward, avg[e]);
  } else {
    __syncthreads();   // every status is written before the leader counts them
  }
  if (!valid) return;

  // section 6: respawn
  float x = tk.x, y = tk.y, v = tk.v, h = tk.h, steering = tk.steering;
  float prev_dist = tk.prev_dist, prev_acc = tk.prev_acc, prev_steer = tk.prev_steer;
  int32_t path_index = tk.path_index;
  if (p.respawn && crashed(alive, done, status)) {
    const int r = route_row(a.route_id[ai], p.routes);
    x = a.spawn_xy[2 * r];
    y = a.spawn_xy[2 * r + 1];
    h = a.spawn_heading[r];
    v = steering = prev_dist = prev_acc = prev_steer = 0.0f;
    path_index = 0;
  }
  float* f = a.out_f + ai;
  f[0] = x;
  f[bn] = y;
  f[2 * bn] = v;
  f[3 * bn] = h;
  f[4 * bn] = steering;
  f[5 * bn] = prev_dist;
  f[6 * bn] = prev_acc;
  f[7 * bn] = prev_steer;
  f[8 * bn] = reward;
  a.out_i[ai] = path_index;
  a.out_i[bn + ai] = status;
  a.out_done[ai] = done;

  // sections 6-7: the env's counts, termination and truncation
  if (i == 0) {
    int live = 0, succ = 0;
    bool any_done = false;
    for (int j = 0; j < n; ++j) {
      live += env[j].alive;
      succ += env[j].alive && env[j].done && env[j].status == kSuccess;
      any_done = any_done || env[j].done;
    }
    const int32_t steps = (int32_t)((uint32_t)a.step_count[b] + 1u);
    a.out_env_i[b] = live;
    a.out_env_i[B + b] = steps;
    a.out_env_b[b] = p.respawn ? (succ > 0 && succ == live) : any_done;
    a.out_env_b[B + b] = p.max_steps > 0 && steps >= p.max_steps;
  }
}

}  // namespace

extern "C" {

// The largest number of envs a block takes: 128 threads, and the envs'
// shared memory within 48 KB; 0 if one env does not fit.
int ego_step_envs_per_block(int n, int w) {
  if (n < 1 || n > kMaxAgents || w < 0) return 0;
  const int by_threads = kThreads / n, by_bytes = kSharedBytes / env_bytes(n, w);
  return by_threads < by_bytes ? by_threads : by_bytes;
}

// Launch K3 on `stream`: `ptrs` holds the kPointers device pointers of
// ego_step.cuh's Args (contiguous tensors but the NPC slots, whose rows lie
// `npc_ld` apart), `ip` and `fp` the ints and floats of its Params, all in
// host memory. Returns cudaGetLastError() after the launch.
int ego_step_launch(void* const* ptrs, const int32_t* ip, const float* fp, int B, long npc_ld,
                    void* stream) {
  const Params p = params_of(ip, fp);
  const int E = ego_step_envs_per_block(p.n, p.w);
  if (B < 0 || E < 1 || p.routes < 1) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    const unsigned blocks = (unsigned)((B + E - 1) / E);
    ego_step_kernel<<<blocks, E * p.n, E * env_bytes(p.n, p.w), (cudaStream_t)stream>>>(
        args_of(ptrs), p, B, npc_ld, E);
  }
  return (int)cudaGetLastError();
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
