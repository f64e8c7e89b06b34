// The pieces of K3, the ego tick, for the card (csrc/ego_step.cu) and for the
// CPU (csrc/ego_step_host.cpp, which the tests hold bit for bit against
// core/env.py::ego_step_ref).
//
// The ego tick is sections 2-7 of IntersectionEnv.step (IntersectionEnv.cpp:
// 151-366), for one env of N agents among w NPC slots:
//   * `tick`, one agent: the physics tick (npc_move.cuh's `physics`, which is
//     core/physics.py::car_physics_step), the path index (the nearest of 50
//     points, npc_move.cuh's `path_distance` and `before`), the progress,
//     stuck and smoothness reward, and the status from the goal test, the
//     corners' screen, road and yellow-line tests;
//   * `box` and `overlap`: a car's corners and the separating-axis test over
//     the two cars' body axes (core/physics.py::car_corners, sat_overlap);
//   * `resolve`, one env: the ordered car-car resolution over bitmasks, rows
//     in agent order, `done` updated row by row;
//   * `bonus`, `mixed`, `crashed`: the terminal bonuses, the team mix and
//     whether an agent respawns.
// ego_step.cu composes them with one thread per agent and one leader per env,
// ego_step_host.cpp with loops; both in the plain version's order.
//
// The float chain is core/env.py's, as npc_move.cuh's: glibc's sincosf, tanf
// and hypotf from libm_f32.cuh, every product rounded before its add (nvcc
// --fmad=false, g++ -ffp-contract=off), IEEE divisions where the plain
// version calls libm.div, torch's NaN rules (a comparison with a NaN is
// false; amin and amax of a set holding a NaN are NaN), and the geometry's
// constants, all integers in float32. A corner's or a midpoint's float to
// int32 truncation is torch's cast on each device (`to_int32`).
#pragma once

#include <math.h>
#include <stdint.h>

#include "npc_move.cuh"

namespace ego_step {

using npc_move::kPathLen;
using npc_move::kSearch;

// core/constants.py, as float32 (or int)
enum Status : int32_t { kAlive = 0, kDead = 1, kSuccess = 2, kWall = 3, kLine = 4, kCar = 5 };
constexpr float kHalfLength = 27.0f;     // CAR_LENGTH / 2
constexpr float kHalfWidth = 12.0f;      // CAR_WIDTH / 2
constexpr float kScreen = 750.0f;        // WIDTH = HEIGHT
constexpr float kMargin = 100.0f;        // out of screen beyond it
constexpr float kCentre = 375.0f;        // WIDTH / 2 = HEIGHT / 2
constexpr int kCentrePx = 375;           // WIDTH // 2
constexpr int kScreenPx = 750;
constexpr float kLaneWidth = 42.0f;      // LANE_WIDTH_PX
constexpr float kCornerRadius = 84.0f;   // CORNER_RADIUS
constexpr float kFps = 60.0f;
constexpr float kScale = 12.0f;
constexpr float kMaxAcc = npc_move::kMaxAcc;
constexpr float kMaxSteer = npc_move::kMaxSteer;   // radians(35)
constexpr int kMaxAgents = 32;           // the env's agents are one bitmask

// The configuration and the reward's parameters, as the plain version reads
// them: floats are float32 values, `one_minus_alpha` is float32(1 - alpha).
struct Params {
  int32_t n, w, routes, num_lanes, max_steps, team, respawn;
  float k_prog, v_min_ms, k_stuck, k_cv, k_co, k_succ, k_sm, alpha, one_minus_alpha;
  float max_progress;
};

// The tensors of one call, in the order of `kPointers` (ops/ego_step_cuda.py
// passes them so): the ego state (B, N), the actions (B, N, 2), dt, the step
// counter (B,), the route table, the NPC slots (B, w) with rows `npc_ld`
// apart, and the outputs, which overlap no input.
struct Args {
  const int32_t* route_id;
  const float *x, *y, *v, *heading, *steering;
  const int32_t* path_index;
  const float *prev_dist, *prev_acc, *prev_steer;
  const uint8_t* alive;
  const float* actions;
  const float* dt;
  const int32_t* step_count;
  const float *paths, *goal_xy, *goal_prev_xy, *spawn_xy, *spawn_heading;  // (R, 160, 2), (R, 2) x3, (R,)
  const float *npc_x, *npc_y, *npc_heading;
  const uint8_t* npc_alive;
  float* out_f;        // (9, B, N): x, y, v, heading, steering, prev_dist, prev_acc, prev_steer, reward
  int32_t* out_i;      // (2, B, N): path_index, status
  uint8_t* out_done;   // (B, N)
  int32_t* out_env_i;  // (2, B): agents_alive, step_count
  uint8_t* out_env_b;  // (2, B): terminated, truncated
};
constexpr int kPointers = 28;

inline Args args_of(void* const* p) {
  Args a;
  a.route_id = (const int32_t*)p[0];
  a.x = (const float*)p[1];
  a.y = (const float*)p[2];
  a.v = (const float*)p[3];
  a.heading = (const float*)p[4];
  a.steering = (const float*)p[5];
  a.path_index = (const int32_t*)p[6];
  a.prev_dist = (const float*)p[7];
  a.prev_acc = (const float*)p[8];
  a.prev_steer = (const float*)p[9];
  a.alive = (const uint8_t*)p[10];
  a.actions = (const float*)p[11];
  a.dt = (const float*)p[12];
  a.step_count = (const int32_t*)p[13];
  a.paths = (const float*)p[14];
  a.goal_xy = (const float*)p[15];
  a.goal_prev_xy = (const float*)p[16];
  a.spawn_xy = (const float*)p[17];
  a.spawn_heading = (const float*)p[18];
  a.npc_x = (const float*)p[19];
  a.npc_y = (const float*)p[20];
  a.npc_heading = (const float*)p[21];
  a.npc_alive = (const uint8_t*)p[22];
  a.out_f = (float*)p[23];
  a.out_i = (int32_t*)p[24];
  a.out_done = (uint8_t*)p[25];
  a.out_env_i = (int32_t*)p[26];
  a.out_env_b = (uint8_t*)p[27];
  return a;
}

inline Params params_of(const int32_t* ip, const float* fp) {
  return Params{ip[0], ip[1], ip[2], ip[3], ip[4], ip[5], ip[6],
                fp[0], fp[1], fp[2], fp[3], fp[4], fp[5], fp[6], fp[7], fp[8], fp[9]};
}

// A route id as torch's index reads it: a negative one counts from the end.
NPC_HD int route_row(int32_t rid, int routes) { return rid < 0 ? rid + routes : rid; }

// torch's float32 -> int32 cast on each device: on the card cvt.rzi, which
// saturates and takes a NaN to 0; on an x86 CPU cvttss2si, which takes a NaN
// and anything out of range to INT32_MIN.
NPC_HD int32_t to_int32(float f) {
#ifdef __CUDA_ARCH__
  return __float2int_rz(f);
#else
  return (f >= -2147483648.0f && f < 2147483648.0f) ? (int32_t)f : INT32_MIN;
#endif
}

// A car's corners in the reference's order (Car.cpp:86-103) and the sine
// and cosine of its heading, which give its body axes.
struct Box {
  float cx[4], cy[4];
  float s, c;
};

NPC_HD Box box(float x, float y, float h) {
  const float lx[4] = {kHalfLength, kHalfLength, -kHalfLength, -kHalfLength};
  const float ly[4] = {kHalfWidth, -kHalfWidth, -kHalfWidth, kHalfWidth};
  Box b;
  libm_f32::sincosf(h, &b.s, &b.c);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    b.cx[k] = x + lx[k] * b.c - ly[k] * b.s;
    b.cy[k] = y + lx[k] * b.s + ly[k] * b.c;
  }
  return b;
}

// The projections of a box's corners on the axis (ax, ay): their least and
// largest, NaN if any is (torch.amin / amax).
NPC_HD void extent(const Box& b, float ax, float ay, float* lo, float* hi) {
  bool any_nan = false;
  float l = 0.0f, u = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float p = b.cx[k] * ax + b.cy[k] * ay;
    any_nan = any_nan || isnan(p);
    l = (k == 0 || p < l) ? p : l;
    u = (k == 0 || p > u) ? p : u;
  }
  *lo = any_nan ? NAN : l;
  *hi = any_nan ? NAN : u;
}

// core/physics.py::sat_overlap: no separating axis among the four body axes
// (ca, sa), (-sa, ca), (cb, sb), (-sb, cb).
NPC_HD bool overlap(const Box& a, const Box& b) {
  const float ax[4] = {a.c, -a.s, b.c, -b.s};
  const float ay[4] = {a.s, a.c, b.s, b.c};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float lo_a, hi_a, lo_b, hi_b;
    extent(a, ax[k], ay[k], &lo_a, &hi_a);
    extent(b, ax[k], ay[k], &lo_b, &hi_b);
    if (hi_a < lo_b || hi_b < lo_a) return false;
  }
  return true;
}

// core/geometry.py::is_on_road: the strips and the corner squares, minus the
// four grass circles.
NPC_HD bool on_road(float x, float y, int num_lanes) {
  const float rw = (float)num_lanes * kLaneWidth, cr = kCornerRadius, r2 = cr * cr;
  const float inner = kCentre - rw - cr, outer = kCentre + rw + cr;   // the grass centres
  const float gx[4] = {inner, outer, inner, outer}, gy[4] = {inner, inner, outer, outer};
  bool grass = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float dx = x - gx[k], dy = y - gy[k];
    grass = grass || dx * dx + dy * dy <= r2;
  }
  const bool vertical = x >= kCentre - rw && x <= kCentre + rw;
  const bool horizontal = y >= kCentre - rw && y <= kCentre + rw;
  const bool x_band = (x >= inner && x <= kCentre - rw) || (x >= kCentre + rw && x <= outer);
  const bool y_band = (y >= inner && y <= kCentre - rw) || (y >= kCentre + rw && y <= outer);
  return !grass && (vertical || horizontal || (x_band && y_band));
}

// core/geometry.py::hits_yellow_line.
NPC_HD bool yellow_line(float x, float y, int num_lanes) {
  const float rw = (float)num_lanes * kLaneWidth;
  const float ax = fabsf(x - kCentre), ay = fabsf(y - kCentre);
  return (ax <= 2.0f && ay > rw) || (ay <= 2.0f && ax > rw);
}

// core/geometry.py::is_line_pixel on truncated coordinates.
NPC_HD bool line_pixel(int32_t xi, int32_t yi, int num_lanes) {
  const int c = kCentrePx, stop = num_lanes * (int)kLaneWidth + (int)kCornerRadius;
  const bool in_bounds = xi >= 0 && xi < kScreenPx && yi >= 0 && yi < kScreenPx;
  const bool vband = (xi >= c - 3 && xi <= c - 1) || (xi >= c + 1 && xi <= c + 3);
  const bool vspan = yi <= c - stop || yi >= c + stop;
  const bool hband = (yi >= c - 3 && yi <= c - 1) || (yi >= c + 1 && yi <= c + 3);
  const bool hspan = xi <= c - stop || xi >= c + stop;
  return in_bounds && ((vband && vspan) || (hband && hspan));
}

// core/physics.py::update_path_index: the first nearest point of the 50 from
// the index (clamped at 0) in torch.argmin's order; 0 when every one of them
// is +inf or there is none, where argmin's first minimum is point 0.
NPC_HD int32_t nearest_point(const float* path, int32_t index, float x, float y) {
  const int lo = index < 0 ? 0 : index;
  const int hi = lo < kPathLen - kSearch ? lo + kSearch : kPathLen;
  float best = INFINITY;
  int at = 0;
  for (int k = lo; k < hi; ++k) {
    const float d = npc_move::path_distance(path[2 * k], path[2 * k + 1], x, y);
    if (npc_move::before(d, k, best, at)) {
      best = d;
      at = k;
    }
  }
  return at;
}

// One agent's state after sections 2-3, before the collisions.
struct Tick {
  float x, y, v, h, steering, prev_dist, prev_acc, prev_steer, reward;
  int32_t path_index, status;
  bool done;
  Box box;
};

// Sections 2 and 3 for one agent (IntersectionEnv.cpp:151-290): `path` is
// its route's polyline, (gx, gy) and (px, py) its goal and the point before.
NPC_HD Tick tick(const Params& p, bool alive, float x, float y, float v, float h,
                 float steering, int32_t path_index, float prev_dist, float prev_acc,
                 float prev_steer, float throttle, float steer_cmd, float dt, const float* path,
                 float gx, float gy, float px, float py) {
  Tick t;
  const npc_move::Moved o = npc_move::physics(x, y, v, h, steering, throttle, steer_cmd, dt);
  const float acc = throttle * kMaxAcc;
  t.x = alive ? o.x : x;
  t.y = alive ? o.y : y;
  t.v = alive ? o.v : v;
  t.h = alive ? o.h : h;
  t.steering = alive ? o.steering : steering;
  t.path_index = alive ? nearest_point(path, path_index, t.x, t.y) : path_index;

  const float cur = libm_f32::hypotf_diff(t.x, gx, t.y, gy);
  const float r_prog = prev_dist > 0.0f ? (prev_dist - cur) / p.max_progress * p.k_prog : 0.0f;
  const float speed_ms = t.v * kFps / kScale;
  const float acc_norm = acc / kMaxAcc;
  const float steer_norm = t.steering / kMaxSteer;
  const float d0 = acc_norm - prev_acc, d1 = steer_norm - prev_steer;
  const float r_smooth = (d0 * d0 + d1 * d1) * p.k_sm;
  const float r_stuck = speed_ms < p.v_min_ms ? p.k_stuck : 0.0f;
  t.reward = alive ? r_prog + r_stuck + r_smooth : 0.0f;
  t.prev_dist = alive ? cur : prev_dist;
  t.prev_acc = alive ? acc_norm : prev_acc;
  t.prev_steer = alive ? steer_norm : prev_steer;

  const bool horiz = fabsf(gx - px) > fabsf(gy - py);
  const float ex = fabsf(t.x - gx), ey = fabsf(t.y - gy);
  const float lat = horiz ? ey : ex, lon = horiz ? ex : ey;
  const bool succ = lat < 15.0f && lon < 40.0f;

  t.box = box(t.x, t.y, t.h);
  const Box& b = t.box;
  bool wall = false, line = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float cx = b.cx[k], cy = b.cy[k];
    wall = wall || cx < -kMargin || cx > kScreen + kMargin || cy < -kMargin ||
           cy > kScreen + kMargin || !on_road(cx, cy, p.num_lanes);
    const float mx = (cx + b.cx[(k + 1) & 3]) * 0.5f, my = (cy + b.cy[(k + 1) & 3]) * 0.5f;
    line = line || yellow_line(cx, cy, p.num_lanes) ||
           line_pixel(to_int32(mx), to_int32(my), p.num_lanes) ||
           line_pixel(to_int32(cx), to_int32(cy), p.num_lanes);
  }
  const int32_t status = succ ? kSuccess : (wall ? kWall : (line ? kLine : kAlive));
  t.status = alive ? status : kDead;
  t.done = alive ? (succ || wall || line) : true;
  return t;
}

// Section 4's ordered resolution (IntersectionEnv.cpp:293-318) over the env's
// bitmasks: `rows[i]` holds the agents j > i whose boxes overlap i's,
// `npc_hit` the agents that overlap an alive NPC slot. Rows go in agent
// order and `done` is updated row by row; returns the agents set to
// CRASH_CAR.
NPC_HD uint32_t resolve(int n, uint32_t alive, uint32_t* done, const uint32_t* rows,
                        uint32_t npc_hit) {
  uint32_t car = 0;
  for (int i = 0; i < n; ++i) {
    const uint32_t bit = 1u << i;
    if (!(alive & bit) || (*done & bit)) continue;
    const uint32_t jm = rows[i] & alive & ~*done;
    const uint32_t upd = jm | ((jm != 0 || (npc_hit & bit)) ? bit : 0u);
    *done |= upd;
    car |= upd;
  }
  return car;
}

// Section 5's terminal bonuses (IntersectionEnv.cpp:321-327), each added as
// the plain version adds it: 0.0 where it does not apply (-0.0 + 0.0 = +0.0).
NPC_HD float bonus(const Params& p, float r, bool done, int32_t status) {
  r = r + ((done && status == kCar) ? p.k_cv : 0.0f);
  r = r + ((done && (status == kWall || status == kLine)) ? p.k_co : 0.0f);
  r = r + ((done && status == kSuccess) ? p.k_succ : 0.0f);
  return r;
}

// The team mix (IntersectionEnv.cpp:330-336): `avg` is the ordered sum of
// the env's rewards from +0.0 over n, an IEEE division.
NPC_HD float mixed(const Params& p, float r, float avg) {
  return r * p.one_minus_alpha + avg * p.alpha;
}

// Whether section 6 respawns the agent: it crashed this tick.
NPC_HD bool crashed(bool alive, bool done, int32_t status) {
  return alive && done && (status == kCar || status == kWall || status == kLine);
}

}  // namespace ego_step
