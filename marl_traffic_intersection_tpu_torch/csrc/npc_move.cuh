// The per-planner pieces of K2, the NPC planner's move, for the card
// (csrc/npc_move.cu) and for the CPU (csrc/npc_move_host.cpp, which the tests
// hold bit for bit against core/npc.py::move_ref).
//
// A planner is one NPC of one env (TrafficFlow.cpp:50-196, then Car.cpp:9-74):
//   * steer: P-control on the heading error to the path point 12 ahead of its
//     refreshed path index pi0;
//   * throttle: cruise toward 3.2 px/frame, brake for a car ahead (within 80
//     px, cos > 0.8, headings within 45 degrees), and the ghost scan: each of
//     the 120 path points from pi0 conflicts if an other car it considers
//     (not heading its way within 60 degrees, not a stable parallel
//     neighbour) lies within 48 px of it and either the point lies within 15
//     px of the planner or the other car has the right of way (rules 2-4);
//     the first conflicting point's distance sets the brake;
//   * one physics tick, then the nearest path point in the 50 from pi0.
// Pieces here: `planner` (what every pair and point shares), `pair` (one
// other car: its front-car distance and whether it is considered and has the
// right of way), `near_point` and `point_distance` (one path point), and the
// scalar steps `steer`, `cruise`, `follow`, `brake`, `physics`,
// `path_distance`, `before`. The compositions over the other cars and the 160
// points live in npc_move.cu (a warp per planner) and npc_move_host.cpp
// (loops); both keep the plain version's orders: the first conflicting point,
// and the nearest path point with ties to the lower index (torch.argmin's
// LessOrNan: a NaN first).
//
// The float chain is core/npc.py's: glibc's sincosf/tanf/atan2f/hypotf from
// libm_f32.cuh, every product rounded before its add (nvcc --fmad=false, g++
// -ffp-contract=off), IEEE divisions and correctly rounded square roots (the
// plain version's f64 root rounded once is the same number), C fmod
// semantics in `wrap_angle`, and core/npc.py's and core/physics.py's float32
// constants, written out below (npc_move_constants in npc_move_host.cpp
// exports them for the tests). Comparisons with a NaN are false, as torch's;
// clamps and minima keep torch's order of operands, so a NaN or a signed zero
// comes out as torch's does.
#pragma once

#include <math.h>
#include <stdint.h>

#include "libm_f32.cuh"

#ifdef __CUDACC__
#define NPC_HD __host__ __device__ __forceinline__
#else
#define NPC_HD static inline
#endif

namespace npc_move {

constexpr int kPathLen = 160;      // PATH_LEN
constexpr int kLookahead = 12;
constexpr int kScanSteps = 120;    // the ghost scan's window from pi0
constexpr int kSearch = 50;        // update_path_index's window

// core/npc.py and core/physics.py, as float32
constexpr float kPi = 0x1.921fb6p+1f;
constexpr float kTwoPi = 0x1.921fb6p+2f;
constexpr float kDeg30 = 0x1.0c1524p-1f;
constexpr float kDeg45 = 0x1.921fb6p-1f;
constexpr float kDeg60 = 0x1.0c1524p+0f;
constexpr float kDeg150 = 0x1.4f1a6ep+1f;
constexpr float kSafeRadiusSq = 2304.0f;    // (2 car widths)^2
constexpr float kCx = 375.0f;
constexpr float kCy = 375.0f;
constexpr float kTargetSpeed = 0x1.99999ap+1f;     // 3.2
constexpr float kTargetSpeedHi = 0x1.0cccccp+2f;   // 3.2 + 1, rounded
constexpr float kSideways = 63.0f;
constexpr float kNotFar = 108.0f;
constexpr float kStable = 21.0f;
constexpr float kEps = 0x1.4f8b58p-17f;            // 1e-5
constexpr float kDotMin = 0x1.99999ap-1f;          // 0.8
constexpr float kCoast = -0x1.99999ap-4f;          // -0.1
constexpr float kEase = -0x1.99999ap-3f;           // -0.2
constexpr float kSoft = -0x1.99999ap-1f;           // -0.8
constexpr float kHard = -1.0f;
constexpr float kNone = 1e9f;                      // no car ahead
constexpr float kMaxAcc = 15.0f;
constexpr float kMaxSteer = 0x1.38c354p-1f;        // radians(35)
constexpr float kSteerLag = 0x1.99999ap-3f;        // 0.2
constexpr float kDecay = 0x1.e66666p-1f;           // 0.95
constexpr float kMaxSpeed = 8.0f;
constexpr float kWheelbase = 54.0f;
constexpr float kTurnMin = 0x1.99999ap-4f;         // 0.1

NPC_HD float sqrt_rn(float x) {
#ifdef __CUDA_ARCH__
  return __fsqrt_rn(x);
#else
  return sqrtf(x);
#endif
}

// torch.clamp(x, min=lo) / (x, max=hi): a NaN passes, x is kept on a tie
NPC_HD float at_least(float x, float lo) { return x < lo ? lo : x; }
NPC_HD float at_most(float x, float hi) { return hi < x ? hi : x; }

// core/physics.py::wrap_angle: [-pi, pi) with C fmod's truncation
NPC_HD float wrap_angle(float a) {
  float t = fmodf(a + kPi, kTwoPi);
  t = t < 0.0f ? t + kTwoPi : t;
  return t - kPi;
}

struct Planner {
  float x, y, v, h;
  int32_t uid;
  float s, c;       // sinf(h), cosf(h): the heading vector is (c, -s)
  float my_dc;      // distance to the crossing's centre
  float mfx, mfy;   // the point 20 px ahead
};

NPC_HD Planner planner(float x, float y, float v, float h, int32_t uid) {
  Planner p;
  p.x = x;
  p.y = y;
  p.v = v;
  p.h = h;
  p.uid = uid;
  libm_f32::sincosf(h, &p.s, &p.c);
  p.my_dc = libm_f32::hypotf_diff(x, kCx, y, kCy);
  p.mfx = x + p.c * 20.0f;
  p.mfy = y + (-p.s) * 20.0f;
  return p;
}

struct Pair {
  float front;       // the distance to this car if it is one to follow, else kNone
  bool considered;   // the ghost scan tests its distance to the path points
  bool yields;       // considered, and it has the right of way (rules 2-4)
};

// The other car (ox, oy, ov, oh, ouid); `other` is whether the planner
// looks at it (alive and not itself).
NPC_HD Pair pair(const Planner& p, float ox, float oy, float ov, float oh, int32_t ouid,
                 bool other) {
  const float dx = ox - p.x, dy = oy - p.y;
  const float dist = libm_f32::hypotf(dx, dy);
  const float longi = dx * p.c + dy * (-p.s);
  const float dot = longi / (dist + kEps);
  const float ad = fabsf(wrap_angle(p.h - oh));
  const bool ahead = other && dist <= 80.0f && dot > kDotMin && ad < kDeg45;
  const float rev = kTwoPi - ad;
  const float adn = rev < ad ? rev : ad;      // torch.minimum(ad, rev)
  const bool parallel = adn < kDeg30 || adn > kDeg150;
  const float lat = sqrt_rn(at_least(dist * dist - longi * longi, 0.0f));
  float os, oc;
  libm_f32::sincosf(oh, &os, &oc);
  const float fdx = (ox + oc * 20.0f) - p.mfx;
  const float fdy = (oy - os * 20.0f) - p.mfy;
  const float fmag = libm_f32::hypotf(fdx, fdy);
  const float flong = fdx * p.c + fdy * (-p.s);
  const float flat = sqrt_rn(at_least(fmag * fmag - flong * flong, 0.0f));
  const bool skip = dist > kEps && parallel && fabsf(lat) < kSideways &&
                    fabsf(longi) < kNotFar && fmag > kEps && fabsf(flat - lat) < kStable;
  const float odc = libm_f32::hypotf_diff(ox, kCx, oy, kCy);
  const bool rule2 = p.v < 1.0f && ov > 3.0f && odc < p.my_dc + 25.0f;
  const bool rule3 = odc < p.my_dc - 5.0f;
  const bool rule4 = fabsf(odc - p.my_dc) <= 5.0f && p.uid < ouid;
  const bool considered = other && !(ad < kDeg60) && !skip;
  return Pair{ahead ? dist : kNone, considered, considered && (rule2 || rule3 || rule4)};
}

// torch.amin's pick of two front distances (neither is ever a NaN).
NPC_HD float nearer(float a, float b) { return b < a ? b : a; }

// The path point (gx, gy): the planner's distance to it, and whether the
// car at (ox, oy) lies within 48 px of it.
NPC_HD float point_distance(const Planner& p, float gx, float gy) {
  return libm_f32::hypotf_diff(gx, p.x, gy, p.y);
}

NPC_HD bool near_point(float ox, float oy, float gx, float gy) {
  const float ex = ox - gx, ey = oy - gy;
  return ex * ex + ey * ey < kSafeRadiusSq;
}

// Whether a point in the scan window conflicts: near the planner and near a
// considered car, or near a car with the right of way.
NPC_HD bool conflicts(float distance, bool near_considered, bool near_yielding) {
  return (distance < 15.0f && near_considered) || near_yielding;
}

// The steering command toward the lookahead point (tx, ty).
NPC_HD float steer(const Planner& p, float tx, float ty) {
  const float err = wrap_angle(libm_f32::atan2f_diff(ty, p.y, tx, p.x) - p.h);
  return at_most(at_least(err * 3.0f, -1.0f), 1.0f);
}

NPC_HD float cruise(float v) {
  return v < kTargetSpeed ? 0.5f : (v > kTargetSpeedHi ? kCoast : 0.0f);
}

// The cruise throttle after the nearest car ahead, `front` px away.
NPC_HD float follow(float acc, float front) {
  return front < 30.0f ? kHard : (front < 50.0f ? at_most(acc, kEase) : acc);
}

// The throttle, given whether a point conflicts and the planner's distance
// to the first one.
NPC_HD float brake(float acc, bool conflict, float first_distance) {
  const float braked = first_distance < 35.0f ? kHard
                       : (first_distance < 60.0f ? kSoft : at_most(acc, 0.0f));
  return conflict ? braked : acc;
}

struct Moved {
  float x, y, v, h, steering;
};

// core/physics.py::car_physics_step (Car.cpp:9-40).
NPC_HD Moved physics(float x, float y, float v, float h, float steering, float throttle,
                     float steer_cmd, float dt) {
  const float acc = throttle * kMaxAcc;
  const float target = steer_cmd * kMaxSteer;
  steering = steering + (target - steering) * kSteerLag;
  v = throttle == 0.0f ? v * kDecay : v;
  v = v + acc * dt;
  v = at_most(at_least(v, 0.0f), kMaxSpeed);
  const float ang_vel = (v / kWheelbase) * libm_f32::tanf(steering);
  h = wrap_angle(fabsf(v) > kTurnMin ? h + ang_vel : h);
  float s, c;
  libm_f32::sincosf(h, &s, &c);
  return Moved{x + v * c, y - v * s, v, h, steering};
}

// The squared distance update_path_index minimises.
NPC_HD float path_distance(float gx, float gy, float x, float y) {
  const float dx = gx - x, dy = gy - y;
  return dx * dx + dy * dy;
}

// Whether (a, ia) precedes (b, ib) in torch.argmin's order: a NaN first, then
// the smaller value, then the lower index.
NPC_HD bool before(float a, int ia, float b, int ib) {
  if (isnan(a)) return isnan(b) ? ia < ib : true;
  return a == b ? ia < ib : a < b;
}

}  // namespace npc_move
