// K3's pieces (ego_step.cuh) built for the CPU with g++ -ffp-contract=off and
// composed by loops in the plain version's order, so that the tests can hold
// the card's arithmetic bit for bit against core/env.py::ego_step_ref without
// a card. The port's CPU path is ego_step_ref itself; nothing but the tests
// calls this library.
#include <stdint.h>

#include "ego_step.cuh"

namespace {

using namespace ego_step;

void step_env(const Args& a, const Params& p, long b, int B, long npc_ld) {
  const int n = p.n, w = p.w;
  const long bn = (long)B * n;
  Tick tk[kMaxAgents];
  uint32_t live = 0, done = 0, npc_hit = 0, rows[kMaxAgents];
  for (int i = 0; i < n; ++i) {
    const long ai = b * n + i;
    const bool alive = a.alive[ai] != 0;
    const int r = route_row(a.route_id[ai], p.routes);
    tk[i] = tick(p, alive, a.x[ai], a.y[ai], a.v[ai], a.heading[ai], a.steering[ai],
                 a.path_index[ai], a.prev_dist[ai], a.prev_acc[ai], a.prev_steer[ai],
                 a.actions[2 * ai], a.actions[2 * ai + 1], *a.dt, a.paths + (long)r * kPathLen * 2,
                 a.goal_xy[2 * r], a.goal_xy[2 * r + 1], a.goal_prev_xy[2 * r],
                 a.goal_prev_xy[2 * r + 1]);
    live |= (uint32_t)alive << i;
    done |= (uint32_t)tk[i].done << i;
  }
  for (int i = 0; i < n; ++i) {
    rows[i] = 0;
    for (int j = i + 1; j < n; ++j)
      if (overlap(tk[i].box, tk[j].box)) rows[i] |= 1u << j;
    for (int m = 0; m < w; ++m) {
      const long k = b * npc_ld + m;
      if (a.npc_alive[k] && overlap(tk[i].box, box(a.npc_x[k], a.npc_y[k], a.npc_heading[k])))
        npc_hit |= 1u << i;
    }
  }
  const uint32_t car = resolve(n, live, &done, rows, npc_hit);

  float reward[kMaxAgents];
  int32_t status[kMaxAgents];
  float total = 0.0f;
  for (int i = 0; i < n; ++i) {
    status[i] = ((car >> i) & 1u) ? (int32_t)kCar : tk[i].status;
    reward[i] = bonus(p, tk[i].reward, (done >> i) & 1u, status[i]);
    total = total + reward[i];
  }
  const float avg = total / (float)n;
  int succ = 0;
  for (int i = 0; i < n; ++i) {
    const long ai = b * n + i;
    const bool alive = (live >> i) & 1u, d = (done >> i) & 1u;
    Tick t = tk[i];
    if (p.respawn && crashed(alive, d, status[i])) {
      const int r = route_row(a.route_id[ai], p.routes);
      t.x = a.spawn_xy[2 * r];
      t.y = a.spawn_xy[2 * r + 1];
      t.h = a.spawn_heading[r];
      t.v = t.steering = t.prev_dist = t.prev_acc = t.prev_steer = 0.0f;
      t.path_index = 0;
    }
    const float out[9] = {t.x, t.y, t.v, t.h, t.steering, t.prev_dist, t.prev_acc, t.prev_steer,
                          p.team ? mixed(p, reward[i], avg) : reward[i]};
    for (int k = 0; k < 9; ++k) a.out_f[k * bn + ai] = out[k];
    a.out_i[ai] = t.path_index;
    a.out_i[bn + ai] = status[i];
    a.out_done[ai] = d;
    succ += alive && d && status[i] == kSuccess;
  }
  const int alive_count = __builtin_popcount(live);
  const int32_t steps = (int32_t)((uint32_t)a.step_count[b] + 1u);
  a.out_env_i[b] = alive_count;
  a.out_env_i[B + b] = steps;
  a.out_env_b[b] = p.respawn ? (succ > 0 && succ == alive_count) : done != 0;
  a.out_env_b[B + b] = p.max_steps > 0 && steps >= p.max_steps;
}

}  // namespace

extern "C" {

// The same contract as ego_step.cu's ego_step_launch, on host pointers.
int ego_step_host(void* const* ptrs, const int32_t* ip, const float* fp, int B, long npc_ld) {
  const Params p = params_of(ip, fp);
  if (B < 0 || p.n < 1 || p.n > kMaxAgents || p.w < 0 || p.routes < 1) return 1;
  const Args a = args_of(ptrs);
  for (long b = 0; b < B; ++b) step_env(a, p, b, B, npc_ld);
  return 0;
}

}  // extern "C"
