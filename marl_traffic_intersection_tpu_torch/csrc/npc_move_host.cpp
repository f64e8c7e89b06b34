// K2's per-planner pieces (npc_move.cuh) built for the CPU with g++
// -ffp-contract=off and composed by loops in the plain version's order, so
// that the tests can hold the card's arithmetic bit for bit against
// core/npc.py::move_ref without a card. The port's CPU path is move_ref
// itself; nothing but the tests calls this library.
#include <math.h>
#include <stdint.h>

#include "npc_move.cuh"

namespace {

using namespace npc_move;

bool in_scan(int k, int k0) { return k >= k0 && k < k0 + kScanSteps; }

void move_one(long w, int b, const float* px, const float* py, const float* pv,
              const float* ph, const float* ps, const int32_t* pu, const int32_t* pi0,
              const float* paths, const uint8_t* others, const float* ox, const float* oy,
              const float* ov, const float* oh, const int32_t* ou, float dt, float* out,
              int32_t* out_pi, long n, int M) {
  const Planner p = planner(px[w], py[w], pv[w], ph[w], pu[w]);
  const float* g = paths + w * kPathLen * 2;
  const int k0 = pi0[w];

  // the other cars: the nearest one ahead, and which points each considered
  // car lies near
  float front = kNone;
  bool near_considered[kPathLen] = {}, near_yielding[kPathLen] = {};
  for (int m = 0; m < M; ++m) {
    const long j = (long)b * M + m;
    const Pair t = pair(p, ox[j], oy[j], ov[j], oh[j], ou[j], others[w * M + m] != 0);
    front = nearer(front, t.front);
    if (!t.considered) continue;
    for (int k = 0; k < kPathLen; ++k) {
      if (!in_scan(k, k0)) continue;
      const bool c = near_point(ox[j], oy[j], g[2 * k], g[2 * k + 1]);
      near_considered[k] = near_considered[k] || c;
      near_yielding[k] = near_yielding[k] || (c && t.yields);
    }
  }

  // the first conflicting point of the scan window
  bool conflict = false;
  float first = 0.0f;
  for (int k = 0; k < kPathLen && !conflict; ++k) {
    if (!in_scan(k, k0)) continue;
    const float d = point_distance(p, g[2 * k], g[2 * k + 1]);
    if (conflicts(d, near_considered[k], near_yielding[k])) {
      conflict = true;
      first = d;
    }
  }

  int t = k0 + kLookahead;
  t = t < 0 ? 0 : (t > kPathLen - 1 ? kPathLen - 1 : t);
  const float th = brake(follow(cruise(p.v), front), conflict, first);
  const Moved o = physics(p.x, p.y, p.v, p.h, ps[w], th, steer(p, g[2 * t], g[2 * t + 1]), dt);

  // the nearest path point of the 50 from the refreshed index
  const int lo = k0 < 0 ? 0 : k0;
  float best = 0.0f;
  int at = -1;
  for (int k = 0; k < kPathLen; ++k) {
    const float d = (k >= lo && k < lo + kSearch) ? path_distance(g[2 * k], g[2 * k + 1], o.x, o.y)
                                                  : INFINITY;
    if (at < 0 || before(d, k, best, at)) {
      best = d;
      at = k;
    }
  }
  out[w] = o.x;
  out[n + w] = o.y;
  out[2 * n + w] = o.v;
  out[3 * n + w] = o.h;
  out[4 * n + w] = o.steering;
  out_pi[w] = at;
}

}  // namespace

extern "C" {

// The same contract as npc_move.cu's npc_move_launch, on host pointers.
int npc_move_host(const float* px, const float* py, const float* pv, const float* ph,
                  const float* ps, const int32_t* pu, const int32_t* pi0, const float* paths,
                  const uint8_t* others, const float* ox, const float* oy, const float* ov,
                  const float* oh, const int32_t* ou, const float* dt, float* out,
                  int32_t* out_pi, int B, int S, int M) {
  if (B < 0 || S < 0 || M < 0) return 1;
  const long n = (long)B * S;
  for (long w = 0; w < n; ++w)
    move_one(w, (int)(w / S), px, py, pv, ph, ps, pu, pi0, paths, others, ox, oy, ov, oh, ou,
             *dt, out, out_pi, n, M);
  return 0;
}

// The header's float32 constants, in this order, for the tests to compare
// with core/npc.py's and core/physics.py's.
int npc_move_constants(float* out) {
  const float c[] = {kPi, kTwoPi, kDeg30, kDeg45, kDeg60, kDeg150, kSafeRadiusSq, kCx, kCy,
                     kTargetSpeed, kTargetSpeedHi, kSideways, kNotFar, kStable, kEps, kDotMin,
                     kCoast, kEase, kSoft, kHard, kNone, kMaxAcc, kMaxSteer, kSteerLag, kDecay,
                     kMaxSpeed, kWheelbase, kTurnMin, (float)kPathLen, (float)kLookahead,
                     (float)kScanSteps, (float)kSearch};
  const int n = (int)(sizeof c / sizeof c[0]);
  for (int i = 0; i < n; ++i) out[i] = c[i];
  return n;
}

}  // extern "C"
