// mti native host engine — single-instance, data-oriented C++ runtime.
//
// This is the host-side twin of the TPU (JAX) engine in core/: same route
// tables, same fixed-slot NPC pool, same step pipeline and observation
// contract. It exists for (a) microsecond-latency single-instance stepping
// (interactive play, CPU-only deployment, MCTS-style snapshot rollouts) where
// a device round-trip per step would dominate, and (b) a second native
// implementation for cross-validation in tests.
//
// Design notes (deliberately different from the reference OO engine):
//  - struct-of-arrays state, fixed capacities, no per-car heap objects;
//  - all route polylines precomputed once into a flat (R, 160, 2) table,
//    cars address routes by int id (mirrors core/routes.py);
//  - NPC pool is MAX_NPCS fixed slots with an alive mask and monotonically
//    increasing uids; iteration in uid order reproduces the reference's
//    vector-order semantics (see core/npc.py docstring);
//  - analytic road/line tests (no pixel grids);
//  - seeded splitmix64 RNG, and injectable spawn decisions for lockstep
//    testing against the JAX engine.
//
// Behavior contract (incl. quirks) cited from the reference:
//   physics       cpp/Car.cpp:9-40        status pipeline IntersectionEnv.cpp:166-290
//   path index    cpp/Car.cpp:47-74       collisions      IntersectionEnv.cpp:293-318
//   SAT           cpp/Car.cpp:105-141     rewards/team    IntersectionEnv.cpp:15-46,321-336
//   routes        cpp/RouteGen.cpp        respawn/term    IntersectionEnv.cpp:339-370
//   road shape    cpp/RoadGeometry.h      lidar           cpp/Lidar.cpp:22-90
//   line mask     cpp/LineMask.cpp        NPC flow        cpp/TrafficFlow.cpp
//   observations  cpp/IntersectionEnv.cpp:418-520

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace mti {

// ---------------------------------------------------------------- constants
constexpr int   W = 750, H = 750;
constexpr float SCALE_PX = 12.0f, FPS_HZ = 60.0f;
constexpr float CAR_LEN = 54.0f, CAR_WID = 24.0f, WHEEL_BASE = CAR_LEN;
constexpr float LANE_W = 42.0f, CORNER_R = 84.0f;
constexpr float ACC_MAX = 15.0f, STEER_MAX = 0.6108652381980153f, V_MAX = 8.0f;
constexpr int   RAYS = 96, SAMPLES = 63;
constexpr float RAY_STEP = 4.0f, RAY_MAX = 250.0f;
constexpr int   PATH_N = 160, NEIGHBORS = 5, OBS_N = 127;
constexpr float PI_F = 3.14159265358979323846f;

enum Status { ST_ALIVE = 0, ST_DEAD = 1, ST_SUCCESS = 2, ST_CRASH_WALL = 3,
              ST_CRASH_LINE = 4, ST_CRASH_CAR = 5 };
enum Intent { GO_STRAIGHT = 0, GO_LEFT = 1, GO_RIGHT = 2 };

struct RewardCfg {
    float k_prog = 10.0f, v_min_ms = 1.0f, k_stuck = -0.01f, k_cv = -10.0f,
          k_co = -5.0f, k_succ = 10.0f, k_sm = -0.02f, alpha = 0.2f;
};

static inline float wrap_pi(float a) {
    a = std::fmod(a + PI_F, 2.0f * PI_F);
    if (a < 0.0f) a += 2.0f * PI_F;
    return a - PI_F;
}

// ------------------------------------------------------------------- routes
// Flat route table over all IN->OUT pairs; id = in_global * 4L + out_global.
struct RouteTable {
    int lanes = 3;
    int n_points = 12;   // 4 * lanes
    int n_routes = 144;
    std::vector<float> pts;       // n_routes * PATH_N * 2
    std::vector<float> sx, sy, sh;  // spawn pose per route
    std::vector<int>   intent;
    std::vector<int>   traffic;   // NPC spawn route ids (straight+left per in-lane)

    const float* path(int rid) const { return &pts[size_t(rid) * PATH_N * 2]; }
};

struct V2 { float x, y; };

static V2 lane_point(int lanes, bool is_in, int global_idx) {
    // global_idx in [0, 4*lanes): direction d = idx / lanes (N,E,S,W), lane j.
    const float cx = W * 0.5f, cy = H * 0.5f, margin = 30.0f;
    int d = global_idx / lanes, j = global_idx % lanes;
    float off = LANE_W * (0.5f + float(j));
    switch (d) {
        case 0: return is_in ? V2{cx - off, margin} : V2{cx + off, margin};           // N
        case 1: return is_in ? V2{W - margin, cy - off} : V2{W - margin, cy + off};   // E
        case 2: return is_in ? V2{cx + off, H - margin} : V2{cx - off, H - margin};   // S
        default: return is_in ? V2{margin, cy + off} : V2{margin, cy - off};          // W
    }
}

static int classify_intent(int lanes, int in_idx, int out_idx) {
    int din = in_idx / lanes, dout = out_idx / lanes;  // 0=N 1=E 2=S 3=W
    static const int opp[4] = {2, 3, 0, 1};
    static const int left[4] = {1, 2, 3, 0};   // N->E, E->S, S->W, W->N
    static const int right[4] = {3, 0, 1, 2};  // N->W, W->S ... (inverse of left)
    if (dout == opp[din]) return GO_STRAIGHT;
    if (dout == left[din]) return GO_LEFT;
    if (dout == right[din]) return GO_RIGHT;
    return GO_LEFT;  // same-direction fallback (RouteGen.cpp:86)
}

static V2 clamp_to_box(V2 p, int lanes) {
    const float cx = W * 0.5f, cy = H * 0.5f, tb = lanes * LANE_W;
    if (p.y < cy - tb) return {p.x, cy - tb};
    if (p.y > cy + tb) return {p.x, cy + tb};
    if (p.x < cx - tb) return {cx - tb, p.y};
    return {cx + tb, p.y};
}

static void emit_route(int lanes, int in_idx, int out_idx, float* out /*PATH_N*2*/) {
    const float cx = W * 0.5f, cy = H * 0.5f;
    V2 a = lane_point(lanes, true, in_idx);
    V2 b = lane_point(lanes, false, out_idx);
    int intent = classify_intent(lanes, in_idx, out_idx);
    int k = 0;
    auto put = [&](float x, float y) { out[k * 2] = x; out[k * 2 + 1] = y; ++k; };
    auto seg50 = [&](V2 p, V2 q) {
        for (int i = 0; i < 50; ++i) {
            float t = float(i) / 50.0f;
            put(p.x + (q.x - p.x) * t, p.y + (q.y - p.y) * t);
        }
    };

    if (intent == GO_STRAIGHT || intent == GO_LEFT) {
        V2 e = clamp_to_box(a, lanes), x = clamp_to_box(b, lanes);
        seg50(a, e);
        if (intent == GO_STRAIGHT) {
            for (int i = 0; i < 60; ++i) {
                float t = float(i) / 60.0f;
                put(e.x + (x.x - e.x) * t, e.y + (x.y - e.y) * t);
            }
        } else {  // quadratic Bezier through the center
            for (int i = 0; i < 60; ++i) {
                float t = float(i) / 60.0f, u = 1.0f - t;
                put(u * u * e.x + 2.0f * u * t * cx + t * t * x.x,
                    u * u * e.y + 2.0f * u * t * cy + t * t * x.y);
            }
        }
        seg50(x, b);
        return;
    }

    // right turn: corner arc around the quadrant the in-direction wraps
    int din = in_idx / lanes;
    float rhw = lanes * LANE_W;
    float ccx, ccy, t0, t1;
    switch (din) {
        case 0: ccx = cx - rhw - CORNER_R; ccy = cy - rhw - CORNER_R; t0 = 0.0f;      t1 = PI_F / 2; break;
        case 1: ccx = cx + rhw + CORNER_R; ccy = cy - rhw - CORNER_R; t0 = PI_F / 2;  t1 = PI_F;     break;
        case 2: ccx = cx + rhw + CORNER_R; ccy = cy + rhw + CORNER_R; t0 = PI_F;      t1 = 3 * PI_F / 2; break;
        default: ccx = cx - rhw - CORNER_R; ccy = cy + rhw + CORNER_R; t0 = -PI_F / 2; t1 = 0.0f;    break;
    }
    float r = CORNER_R + 0.5f * LANE_W;
    V2 as{ccx + r * std::cos(t0), ccy + r * std::sin(t0)};
    V2 ae{ccx + r * std::cos(t1), ccy + r * std::sin(t1)};
    seg50(a, as);
    for (int i = 0; i < 60; ++i) {
        float t = t0 + (t1 - t0) * (float(i) / 60.0f);
        put(ccx + r * std::cos(t), ccy + r * std::sin(t));
    }
    seg50(ae, b);
}

static RouteTable build_routes(int lanes) {
    RouteTable rt;
    rt.lanes = lanes;
    rt.n_points = 4 * lanes;
    rt.n_routes = rt.n_points * rt.n_points;
    rt.pts.resize(size_t(rt.n_routes) * PATH_N * 2);
    rt.sx.resize(rt.n_routes); rt.sy.resize(rt.n_routes); rt.sh.resize(rt.n_routes);
    rt.intent.resize(rt.n_routes);
    for (int i = 0; i < rt.n_points; ++i) {
        for (int o = 0; o < rt.n_points; ++o) {
            int rid = i * rt.n_points + o;
            float* p = &rt.pts[size_t(rid) * PATH_N * 2];
            emit_route(lanes, i, o, p);
            rt.intent[rid] = classify_intent(lanes, i, o);
            rt.sx[rid] = p[0];
            rt.sy[rid] = p[1];
            rt.sh[rid] = std::atan2(-(p[3] - p[1]), p[2] - p[0]);
        }
    }
    // NPC route list: straight then left per in-lane, direction order N,E,S,W
    static const int opp[4] = {2, 3, 0, 1}, left[4] = {1, 2, 3, 0};
    for (int d = 0; d < 4; ++d) {
        for (int j = 0; j < lanes; ++j) {
            int in_idx = d * lanes + j;
            rt.traffic.push_back(in_idx * rt.n_points + (opp[d] * lanes + j));
            rt.traffic.push_back(in_idx * rt.n_points + (left[d] * lanes + j));
        }
    }
    return rt;
}

// ----------------------------------------------------------------- geometry
static inline bool on_road(int lanes, float x, float y) {
    const float cx = W * 0.5f, cy = H * 0.5f;
    const float rw = lanes * LANE_W, cr = CORNER_R, r2 = cr * cr;
    const float gx[2] = {cx - rw - cr, cx + rw + cr};
    const float gy[2] = {cy - rw - cr, cy + rw + cr};
    for (int a = 0; a < 2; ++a)
        for (int b = 0; b < 2; ++b) {
            float dx = x - gx[a], dy = y - gy[b];
            if (dx * dx + dy * dy <= r2) return false;
        }
    if ((x >= cx - rw && x <= cx + rw) || (y >= cy - rw && y <= cy + rw)) return true;
    bool xb = (x >= cx - rw - cr && x <= cx - rw) || (x >= cx + rw && x <= cx + rw + cr);
    bool yb = (y >= cy - rw - cr && y <= cy - rw) || (y >= cy + rw && y <= cy + rw + cr);
    return xb && yb;
}

static inline bool yellow_line(int lanes, float x, float y) {
    const float cx = W * 0.5f, cy = H * 0.5f, rw = lanes * LANE_W;
    if (std::fabs(x - cx) <= 2.0f && std::fabs(y - cy) > rw) return true;
    if (std::fabs(y - cy) <= 2.0f && std::fabs(x - cx) > rw) return true;
    return false;
}

static inline bool line_px(int lanes, int x, int y) {
    // analytic equivalent of the rasterized thickness-2 line mask
    const int cx = W / 2, cy = H / 2;
    const int stop = lanes * int(LANE_W) + int(CORNER_R);
    if (x < 0 || x >= W || y < 0 || y >= H) return false;
    bool vband = (x >= cx - 3 && x <= cx - 1) || (x >= cx + 1 && x <= cx + 3);
    bool vspan = (y <= cy - stop) || (y >= cy + stop);
    bool hband = (y >= cy - 3 && y <= cy - 1) || (y >= cy + 1 && y <= cy + 3);
    bool hspan = (x <= cx - stop) || (x >= cx + stop);
    return (vband && vspan) || (hband && hspan);
}

// ------------------------------------------------------------------ physics
struct Pose { float x, y, v, h, steer; };

static inline void physics_step(Pose& p, float throttle, float steer_in, float dt) {
    float acc = throttle * ACC_MAX;
    p.steer += (steer_in * STEER_MAX - p.steer) * 0.2f;
    if (throttle == 0.0f) p.v *= 0.95f;
    p.v += acc * dt;
    p.v = std::min(std::max(p.v, 0.0f), V_MAX);
    if (std::fabs(p.v) > 0.1f) p.h += (p.v / WHEEL_BASE) * std::tan(p.steer);
    p.h = wrap_pi(p.h);
    p.x += p.v * std::cos(p.h);
    p.y -= p.v * std::sin(p.h);
}

static inline int advance_path_index(const float* path, int n, int idx,
                                     float x, float y) {
    int start = std::max(idx, 0);
    int end = std::min(start + 50, n);
    float best = 1e30f;
    int bi = start;
    for (int i = start; i < end; ++i) {
        float dx = path[i * 2] - x, dy = path[i * 2 + 1] - y;
        float d = dx * dx + dy * dy;
        if (d < best) { best = d; bi = i; }
    }
    return bi;
}

static inline void obb_corners(float x, float y, float h, float out[4][2]) {
    const float hl = CAR_LEN * 0.5f, hw = CAR_WID * 0.5f;
    const float c = std::cos(h), s = std::sin(h);
    const float lx[4] = {hl, hl, -hl, -hl}, ly[4] = {hw, -hw, -hw, hw};
    for (int i = 0; i < 4; ++i) {
        out[i][0] = x + lx[i] * c - ly[i] * s;
        out[i][1] = y + lx[i] * s + ly[i] * c;
    }
}

static bool obb_overlap(float x1, float y1, float h1, float x2, float y2, float h2) {
    float c1[4][2], c2[4][2];
    obb_corners(x1, y1, h1, c1);
    obb_corners(x2, y2, h2, c2);
    const float ax[4] = {std::cos(h1), -std::sin(h1), std::cos(h2), -std::sin(h2)};
    const float ay[4] = {std::sin(h1), std::cos(h1), std::sin(h2), std::cos(h2)};
    for (int a = 0; a < 4; ++a) {
        float lo1 = 1e30f, hi1 = -1e30f, lo2 = 1e30f, hi2 = -1e30f;
        for (int i = 0; i < 4; ++i) {
            float p1 = c1[i][0] * ax[a] + c1[i][1] * ay[a];
            float p2 = c2[i][0] * ax[a] + c2[i][1] * ay[a];
            lo1 = std::min(lo1, p1); hi1 = std::max(hi1, p1);
            lo2 = std::min(lo2, p2); hi2 = std::max(hi2, p2);
        }
        if (hi1 < lo2 || hi2 < lo1) return false;
    }
    return true;
}

// -------------------------------------------------------------------- engine
struct Engine {
    // ------ config
    int lanes = 3;
    bool team_reward = false, respawn_on = true, traffic_on = false;
    float density = 0.5f;
    int max_steps = 2000;
    int max_npcs = 32;
    RewardCfg rcfg;
    RouteTable rt;

    // ------ ego state (SoA)
    int n = 0;
    std::vector<Pose>  ego;
    std::vector<int>   ego_route, ego_pi;
    std::vector<float> ego_prev_dist, ego_prev_acc, ego_prev_steer;
    std::vector<uint8_t> ego_alive;
    std::vector<float> lidar;  // n * RAYS

    // ------ NPC slots
    std::vector<Pose>  npc;
    std::vector<int>   npc_route, npc_pi, npc_uid;
    std::vector<uint8_t> npc_alive;
    int next_uid = 0;

    int step_count = 0;
    uint64_t rng = 0x9e3779b97f4a7c15ull;

    explicit Engine(int lanes_) : lanes(lanes_), rt(build_routes(lanes_)) {}

    // splitmix64 -> float in [0, 1)
    float rand_uniform() {
        rng += 0x9e3779b97f4a7c15ull;
        uint64_t z = rng;
        z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
        z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
        z ^= z >> 31;
        return float(z >> 40) * (1.0f / float(1ull << 24));
    }

    void reset() {
        n = 0;
        ego.clear(); ego_route.clear(); ego_pi.clear();
        ego_prev_dist.clear(); ego_prev_acc.clear(); ego_prev_steer.clear();
        ego_alive.clear(); lidar.clear();
        npc.assign(max_npcs, Pose{});
        npc_route.assign(max_npcs, 0);
        npc_pi.assign(max_npcs, 0);
        npc_uid.assign(max_npcs, 0);
        npc_alive.assign(max_npcs, 0);
        next_uid = 0;
        step_count = 0;
    }

    void add_ego(int rid) {
        ego.push_back(Pose{rt.sx[rid], rt.sy[rid], 0.0f, rt.sh[rid], 0.0f});
        ego_route.push_back(rid);
        ego_pi.push_back(0);
        ego_prev_dist.push_back(0.0f);
        ego_prev_acc.push_back(0.0f);
        ego_prev_steer.push_back(0.0f);
        ego_alive.push_back(1);
        lidar.insert(lidar.end(), RAYS, RAY_MAX);
        ++n;
    }

    // ---- NPC helpers (semantics: cpp/TrafficFlow.cpp via core/npc.py design)
    int alive_npcs_in_order(int* order) const {
        int m = 0;
        for (int i = 0; i < max_npcs; ++i)
            if (npc_alive[i]) order[m++] = i;
        std::sort(order, order + m, [&](int a, int b) { return npc_uid[a] < npc_uid[b]; });
        return m;
    }

    bool try_spawn(int route_choice) {
        if (rt.traffic.empty()) return false;
        int rid = rt.traffic[size_t(route_choice) % rt.traffic.size()];
        float sx = rt.sx[rid], sy = rt.sy[rid];
        const float d2 = (CAR_LEN * 2.5f) * (CAR_LEN * 2.5f);
        for (int i = 0; i < n; ++i) {
            float dx = ego[i].x - sx, dy = ego[i].y - sy;
            if (dx * dx + dy * dy < d2) return false;
        }
        for (int i = 0; i < max_npcs; ++i) {
            if (!npc_alive[i]) continue;
            float dx = npc[i].x - sx, dy = npc[i].y - sy;
            if (dx * dx + dy * dy < d2) return false;
        }
        int slot = -1;
        for (int i = 0; i < max_npcs; ++i)
            if (!npc_alive[i]) { slot = i; break; }
        if (slot < 0) return false;
        npc[slot] = Pose{sx, sy, 0.0f, rt.sh[rid], 0.0f};
        npc_route[slot] = rid;
        npc_pi[slot] = 0;
        npc_uid[slot] = next_uid++;
        npc_alive[slot] = 1;
        return true;
    }

    void plan_npc(int slot, int pi_now, float& thr_out, float& steer_out) const {
        const Pose& me = npc[slot];
        const float* path = rt.path(npc_route[slot]);

        // lateral P-control on the 12-point lookahead
        int ti = std::min(pi_now + 12, PATH_N - 1);
        float dx = path[ti * 2] - me.x, dy = path[ti * 2 + 1] - me.y;
        float err = wrap_pi(std::atan2(-dy, dx) - me.h);
        steer_out = std::min(1.0f, std::max(-1.0f, err * 3.0f));

        // cruise + front-gap braking
        const float target = V_MAX * 0.4f;
        float thr = 0.0f;
        if (me.v < target) thr = 0.5f;
        else if (me.v > target + 1.0f) thr = -0.1f;

        const float fx = std::cos(me.h), fy = -std::sin(me.h);
        float front = 1e9f;
        for (int o = 0; o < max_npcs; ++o) {
            if (o == slot || !npc_alive[o]) continue;
            float ox = npc[o].x - me.x, oy = npc[o].y - me.y;
            float dist = std::hypot(ox, oy);
            if (dist > 80.0f) continue;
            if ((ox * fx + oy * fy) / (dist + 1e-5f) <= 0.8f) continue;
            if (std::fabs(wrap_pi(me.h - npc[o].h)) >= 45.0f * PI_F / 180.0f) continue;
            front = std::min(front, dist);
        }
        if (front < 30.0f) thr = -1.0f;
        else if (front < 50.0f) thr = std::min(thr, -0.2f);

        // ghost-path conflict scan (first conflicting path point wins)
        const float safe2 = (CAR_WID * 2.0f) * (CAR_WID * 2.0f);
        const float my_dc = std::hypot(me.x - W * 0.5f, me.y - H * 0.5f);
        bool conflict = false;
        float conflict_dist = 1e9f;
        int end = std::min(pi_now + 120, PATH_N);
        for (int i = pi_now; i < end && !conflict; ++i) {
            float gx = path[i * 2], gy = path[i * 2 + 1];
            for (int o = 0; o < max_npcs; ++o) {
                if (o == slot || !npc_alive[o]) continue;
                float dgx = npc[o].x - gx, dgy = npc[o].y - gy;
                if (dgx * dgx + dgy * dgy >= safe2) continue;

                float adiff = std::fabs(wrap_pi(me.h - npc[o].h));
                if (adiff < 60.0f * PI_F / 180.0f) continue;  // ACC handles same-dir

                // side-by-side running exclusion
                float rx = npc[o].x - me.x, ry = npc[o].y - me.y;
                float rd = std::hypot(rx, ry);
                if (rd > 1e-5f) {
                    float adn = std::min(adiff, 2.0f * PI_F - adiff);
                    bool par = adn < 30.0f * PI_F / 180.0f || adn > 150.0f * PI_F / 180.0f;
                    if (par) {
                        float lon = rx * fx + ry * fy;
                        float lat = std::sqrt(std::max(0.0f, rd * rd - lon * lon));
                        if (std::fabs(lat) < LANE_W * 1.5f && std::fabs(lon) < CAR_LEN * 2.0f) {
                            float mfx = me.x + fx * 20.0f, mfy = me.y + fy * 20.0f;
                            float ofx2 = npc[o].x + std::cos(npc[o].h) * 20.0f;
                            float ofy2 = npc[o].y - std::sin(npc[o].h) * 20.0f;
                            float fdx = ofx2 - mfx, fdy = ofy2 - mfy;
                            float fm = std::hypot(fdx, fdy);
                            if (fm > 1e-5f) {
                                float flon = fdx * fx + fdy * fy;
                                float flat = std::sqrt(std::max(0.0f, fm * fm - flon * flon));
                                if (std::fabs(flat - lat) < LANE_W * 0.5f) continue;
                            }
                        }
                    }
                }

                float odc = std::hypot(npc[o].x - W * 0.5f, npc[o].y - H * 0.5f);
                float dtc = std::hypot(gx - me.x, gy - me.y);
                bool yield = false;
                if (dtc < 15.0f) yield = true;
                else if (me.v < 1.0f && npc[o].v > 3.0f && odc < my_dc + 25.0f) yield = true;
                else if (odc < my_dc - 5.0f) yield = true;
                else if (std::fabs(odc - my_dc) <= 5.0f && npc_uid[slot] < npc_uid[o]) yield = true;

                if (yield) { conflict = true; conflict_dist = std::min(conflict_dist, dtc); }
            }
        }
        if (conflict) {
            if (conflict_dist < 35.0f) thr = -1.0f;
            else if (conflict_dist < 60.0f) thr = -0.8f;
            else thr = std::min(thr, 0.0f);
        }
        thr_out = thr;
    }

    void traffic_tick(float dt, int spawn_mode, int forced_route) {
        // spawn_mode: -1 internal RNG draw, 0 skip, 1 forced try on forced_route
        if (spawn_mode == 1) {
            try_spawn(forced_route);
        } else if (spawn_mode < 0) {
            float p = 1.0f - std::exp(-density * dt);
            if (rand_uniform() < p) {
                int choice = int(rand_uniform() * float(rt.traffic.size()));
                try_spawn(std::min<size_t>(choice, rt.traffic.size() - 1));
            }
        }

        std::vector<int> order(max_npcs);
        int m = alive_npcs_in_order(order.data());

        // sequential controller updates: later NPCs see earlier ones moved
        for (int k = 0; k < m; ++k) {
            int i = order[k];
            const float* path = rt.path(npc_route[i]);
            npc_pi[i] = advance_path_index(path, PATH_N, npc_pi[i], npc[i].x, npc[i].y);
            float thr, st;
            plan_npc(i, npc_pi[i], thr, st);
            physics_step(npc[i], thr, st, dt);
            npc_pi[i] = advance_path_index(path, PATH_N, npc_pi[i], npc[i].x, npc[i].y);
        }

        // ordered pairwise removal
        for (int a = 0; a < m; ++a) {
            int i = order[a];
            if (!npc_alive[i]) continue;
            bool row_hit = false;
            for (int b = a + 1; b < m; ++b) {
                int j = order[b];
                if (!npc_alive[j]) continue;
                if (obb_overlap(npc[i].x, npc[i].y, npc[i].h, npc[j].x, npc[j].y, npc[j].h)) {
                    npc_alive[j] = 0;
                    row_hit = true;
                }
            }
            if (row_hit) npc_alive[i] = 0;
        }

        // despawn: arrived or far off screen
        for (int i = 0; i < max_npcs; ++i) {
            if (!npc_alive[i]) continue;
            const float* path = rt.path(npc_route[i]);
            float gx = path[(PATH_N - 1) * 2], gy = path[(PATH_N - 1) * 2 + 1];
            bool arrived = std::hypot(npc[i].x - gx, npc[i].y - gy) < 20.0f;
            bool off = npc[i].x < -100.0f || npc[i].x > W + 100.0f ||
                       npc[i].y < -100.0f || npc[i].y > H + 100.0f;
            if (arrived || off) npc_alive[i] = 0;
        }
    }

    // ---- lidar (semantics: cpp/Lidar.cpp:22-90; obstacles = egos + alive NPCs
    //      in traffic mode, egos only otherwise; eps self/duplicate exclusion)
    void scan_lidar(int i) {
        const Pose& me = ego[i];
        float* out = &lidar[size_t(i) * RAYS];
        const float step_deg = 360.0f / float(RAYS - 1);

        struct Box { float x, y, ex, ey; };
        std::vector<Box> boxes;
        auto add_box = [&](float x, float y, float h) {
            if (std::fabs(x - me.x) < 1e-3f && std::fabs(y - me.y) < 1e-3f &&
                std::fabs(h - me.h) < 1e-3f) return;  // self/duplicate
            float c = std::fabs(std::cos(h)), s = std::fabs(std::sin(h));
            boxes.push_back({x, y, c * CAR_LEN * 0.5f + s * CAR_WID * 0.5f,
                             s * CAR_LEN * 0.5f + c * CAR_WID * 0.5f});
        };
        for (int o = 0; o < n; ++o) add_box(ego[o].x, ego[o].y, ego[o].h);
        if (traffic_on)
            for (int o = 0; o < max_npcs; ++o)
                if (npc_alive[o]) add_box(npc[o].x, npc[o].y, npc[o].h);

        for (int r = 0; r < RAYS; ++r) {
            float ang = me.h + (-180.0f + r * step_deg) * PI_F / 180.0f;
            float dx = std::cos(ang), dy = -std::sin(ang);
            float result = RAY_MAX;
            for (int s = 0; s < SAMPLES; ++s) {
                float dist = s * RAY_STEP;
                int px = int(me.x + dx * dist);
                int py = int(me.y + dy * dist);
                if (px < 0 || px >= W || py < 0 || py >= H) break;   // void
                if (dist > 0.0f) {
                    if (!on_road(lanes, float(px), float(py))) { result = dist; break; }
                    bool hit = false;
                    for (const Box& b : boxes)
                        if (float(px) >= b.x - b.ex && float(px) <= b.x + b.ex &&
                            float(py) >= b.y - b.ey && float(py) <= b.y + b.ey) {
                            hit = true;
                            break;
                        }
                    if (hit) { result = dist; break; }
                }
            }
            out[r] = result;
        }
    }

    // ---- observations (contract: IntersectionEnv.cpp:418-520)
    void observe(float* obs) const {
        std::memset(obs, 0, sizeof(float) * size_t(n) * OBS_N);
        for (int i = 0; i < n; ++i) {
            float* o = obs + size_t(i) * OBS_N;
            if (!ego_alive[i]) continue;
            const Pose& me = ego[i];
            o[0] = me.x / float(W);
            o[1] = me.y / float(H);
            o[2] = me.v / V_MAX;
            o[3] = me.h / PI_F;

            const float* path = rt.path(ego_route[i]);
            int ti = std::min(ego_pi[i] + 10, PATH_N - 1);
            float dx = path[ti * 2] - me.x, dy = path[ti * 2 + 1] - me.y;
            o[4] = std::sqrt(dx * dx + dy * dy) / float(W);
            o[5] = wrap_pi(std::atan2(-dy, dx) - me.h) / PI_F;

            // 5 nearest neighbors among other egos (+ alive NPCs in traffic mode)
            struct Nb { float d; float x, y, v, h; int intent; };
            std::vector<Nb> nb;
            for (int j = 0; j < n; ++j) {
                if (j == i || !ego_alive[j]) continue;
                float ddx = ego[j].x - me.x, ddy = ego[j].y - me.y;
                nb.push_back({std::sqrt(ddx * ddx + ddy * ddy), ego[j].x, ego[j].y,
                              ego[j].v, ego[j].h, rt.intent[ego_route[j]]});
            }
            if (traffic_on)
                for (int j = 0; j < max_npcs; ++j) {
                    if (!npc_alive[j]) continue;
                    float ddx = npc[j].x - me.x, ddy = npc[j].y - me.y;
                    nb.push_back({std::sqrt(ddx * ddx + ddy * ddy), npc[j].x, npc[j].y,
                                  npc[j].v, npc[j].h, rt.intent[npc_route[j]]});
                }
            std::sort(nb.begin(), nb.end(), [](const Nb& a, const Nb& b) { return a.d < b.d; });
            int take = std::min<int>(NEIGHBORS, int(nb.size()));
            for (int k = 0; k < take; ++k) {
                float* f = o + 6 + k * 5;
                f[0] = (nb[k].x - me.x) / float(W);
                f[1] = (nb[k].y - me.y) / float(H);
                f[2] = (nb[k].v - me.v) / V_MAX;
                f[3] = wrap_pi(nb[k].h - me.h) / PI_F;
                f[4] = float(nb[k].intent);
            }
            const float* ld = &lidar[size_t(i) * RAYS];
            for (int r = 0; r < RAYS; ++r) o[31 + r] = ld[r] / RAY_MAX;
        }
    }

    // ---- full step (pipeline order: IntersectionEnv.cpp:133-392)
    void step(const float* actions /*n*2*/, float dt, int spawn_mode, int forced_route,
              float* obs, float* rewards, int* done, int* status,
              int* flags /*terminated, truncated, agents_alive, spawned*/) {
        ++step_count;
        int spawned_before = 0;
        for (int i = 0; i < max_npcs; ++i) spawned_before += npc_alive[i];
        if (traffic_on) traffic_tick(dt, spawn_mode, forced_route);
        int spawned_after = 0;
        for (int i = 0; i < max_npcs; ++i) spawned_after += npc_alive[i];

        // physics + base rewards
        for (int i = 0; i < n; ++i) {
            rewards[i] = 0.0f;
            done[i] = 0;
            status[i] = ST_ALIVE;
            if (!ego_alive[i]) continue;
            physics_step(ego[i], actions[i * 2], actions[i * 2 + 1], dt);
            const float* path = rt.path(ego_route[i]);
            ego_pi[i] = advance_path_index(path, PATH_N, ego_pi[i], ego[i].x, ego[i].y);

            float gx = path[(PATH_N - 1) * 2], gy = path[(PATH_N - 1) * 2 + 1];
            float cur = std::hypot(ego[i].x - gx, ego[i].y - gy);
            float r = 0.0f;
            if (ego_prev_dist[i] > 0.0f)
                r += rcfg.k_prog * ((ego_prev_dist[i] - cur) / std::hypot(float(W), float(H)));
            ego_prev_dist[i] = cur;
            if ((ego[i].v * FPS_HZ) / SCALE_PX < rcfg.v_min_ms) r += rcfg.k_stuck;
            float an = (actions[i * 2] * ACC_MAX) / ACC_MAX;  // = throttle
            float sn = ego[i].steer / STEER_MAX;
            float d0 = an - ego_prev_acc[i], d1 = sn - ego_prev_steer[i];
            r += rcfg.k_sm * (d0 * d0 + d1 * d1);
            ego_prev_acc[i] = an;
            ego_prev_steer[i] = sn;
            rewards[i] = r;
        }

        // status: SUCCESS > out-of-screen > off-road > line
        for (int i = 0; i < n; ++i) {
            if (!ego_alive[i]) { done[i] = 1; status[i] = ST_DEAD; continue; }
            const float* path = rt.path(ego_route[i]);
            float gx = path[(PATH_N - 1) * 2], gy = path[(PATH_N - 1) * 2 + 1];
            float px = path[(PATH_N - 2) * 2], py = path[(PATH_N - 2) * 2 + 1];
            bool horiz = std::fabs(gx - px) > std::fabs(gy - py);
            float lat = horiz ? std::fabs(ego[i].y - gy) : std::fabs(ego[i].x - gx);
            float lon = horiz ? std::fabs(ego[i].x - gx) : std::fabs(ego[i].y - gy);
            if (lat < 15.0f && lon < 40.0f) { done[i] = 1; status[i] = ST_SUCCESS; continue; }

            float c[4][2];
            obb_corners(ego[i].x, ego[i].y, ego[i].h, c);
            bool oos = false, off = false, line = false;
            for (int k = 0; k < 4; ++k) {
                if (c[k][0] < -100.0f || c[k][0] > W + 100.0f ||
                    c[k][1] < -100.0f || c[k][1] > H + 100.0f) oos = true;
                if (!on_road(lanes, c[k][0], c[k][1])) off = true;
                if (yellow_line(lanes, c[k][0], c[k][1])) line = true;
                if (line_px(lanes, int(c[k][0]), int(c[k][1]))) line = true;
            }
            for (int k = 0; k < 4 && !line; ++k) {
                float mx = 0.5f * (c[k][0] + c[(k + 1) % 4][0]);
                float my = 0.5f * (c[k][1] + c[(k + 1) % 4][1]);
                if (line_px(lanes, int(mx), int(my))) line = true;
            }
            if (oos) { done[i] = 1; status[i] = ST_CRASH_WALL; }
            else if (off) { done[i] = 1; status[i] = ST_CRASH_WALL; }
            else if (line) { done[i] = 1; status[i] = ST_CRASH_LINE; }
        }

        // ordered collisions: ego-ego rows then ego-NPC
        for (int i = 0; i < n; ++i) {
            if (!ego_alive[i] || done[i]) continue;
            bool hit_i = false;
            for (int j = i + 1; j < n; ++j) {
                if (!ego_alive[j] || done[j]) continue;
                if (obb_overlap(ego[i].x, ego[i].y, ego[i].h, ego[j].x, ego[j].y, ego[j].h)) {
                    done[j] = 1; status[j] = ST_CRASH_CAR; hit_i = true;
                }
            }
            if (traffic_on && !hit_i)
                for (int o = 0; o < max_npcs; ++o)
                    if (npc_alive[o] && obb_overlap(ego[i].x, ego[i].y, ego[i].h,
                                                    npc[o].x, npc[o].y, npc[o].h)) {
                        hit_i = true;
                        break;
                    }
            if (hit_i) { done[i] = 1; status[i] = ST_CRASH_CAR; }
        }

        // bonuses + team mixing
        for (int i = 0; i < n; ++i) {
            if (!done[i]) continue;
            if (status[i] == ST_CRASH_CAR) rewards[i] += rcfg.k_cv;
            else if (status[i] == ST_CRASH_WALL || status[i] == ST_CRASH_LINE) rewards[i] += rcfg.k_co;
            else if (status[i] == ST_SUCCESS) rewards[i] += rcfg.k_succ;
        }
        if (team_reward && n > 0) {
            float avg = 0.0f;
            for (int i = 0; i < n; ++i) avg += rewards[i];
            avg /= float(n);
            for (int i = 0; i < n; ++i)
                rewards[i] = (1.0f - rcfg.alpha) * rewards[i] + rcfg.alpha * avg;
        }

        // respawn / termination
        bool terminated = false;
        if (respawn_on) {
            for (int i = 0; i < n; ++i) {
                if (!ego_alive[i] || !done[i]) continue;
                if (status[i] >= ST_CRASH_WALL) {
                    int rid = ego_route[i];
                    ego[i] = Pose{rt.sx[rid], rt.sy[rid], 0.0f, rt.sh[rid], 0.0f};
                    ego_pi[i] = 0;
                    ego_prev_dist[i] = 0.0f;
                    ego_prev_acc[i] = ego_prev_steer[i] = 0.0f;
                }
            }
            int alive_cnt = 0, succ = 0;
            for (int i = 0; i < n; ++i) {
                if (!ego_alive[i]) continue;
                ++alive_cnt;
                if (done[i] && status[i] == ST_SUCCESS) ++succ;
            }
            terminated = succ > 0 && succ == alive_cnt;
            flags[2] = alive_cnt;
        } else {
            for (int i = 0; i < n; ++i) if (done[i]) terminated = true;
            int alive_cnt = 0;
            for (int i = 0; i < n; ++i) if (ego_alive[i]) ++alive_cnt;
            flags[2] = alive_cnt;
        }
        flags[0] = terminated ? 1 : 0;
        flags[1] = (max_steps > 0 && step_count >= max_steps) ? 1 : 0;
        flags[3] = spawned_after > spawned_before ? 1 : 0;

        for (int i = 0; i < n; ++i)
            if (ego_alive[i]) scan_lidar(i);
        observe(obs);
    }
};

}  // namespace mti

// ------------------------------------------------------------------- C API
extern "C" {

void* mti_create(int lanes) { return new mti::Engine(lanes); }
void mti_destroy(void* h) { delete static_cast<mti::Engine*>(h); }

void mti_configure(void* h, int team, int respawn, int max_steps, int traffic,
                   float density, int max_npcs, uint64_t seed) {
    auto* e = static_cast<mti::Engine*>(h);
    e->team_reward = team != 0;
    e->respawn_on = respawn != 0;
    e->max_steps = max_steps;
    e->traffic_on = traffic != 0;
    e->density = density;
    e->max_npcs = max_npcs;
    e->rng = seed * 0x9e3779b97f4a7c15ull + 0x2545f4914f6cdd1dull;
}

void mti_set_reward(void* h, const float* k /*8: prog, vmin, stuck, cv, co, succ, sm, alpha*/) {
    auto* e = static_cast<mti::Engine*>(h);
    e->rcfg = {k[0], k[1], k[2], k[3], k[4], k[5], k[6], k[7]};
}

void mti_reset(void* h) { static_cast<mti::Engine*>(h)->reset(); }
void mti_add_ego(void* h, int route_id) { static_cast<mti::Engine*>(h)->add_ego(route_id); }

int mti_num_routes(void* h) { return static_cast<mti::Engine*>(h)->rt.n_routes; }
int mti_num_traffic_routes(void* h) {
    return int(static_cast<mti::Engine*>(h)->rt.traffic.size());
}

void mti_get_route_table(void* h, float* pts /*R*160*2*/) {
    auto* e = static_cast<mti::Engine*>(h);
    std::memcpy(pts, e->rt.pts.data(), e->rt.pts.size() * sizeof(float));
}

void mti_step(void* h, const float* actions, float dt, int spawn_mode,
              int forced_route, float* obs, float* rewards, int* done,
              int* status, int* flags) {
    static_cast<mti::Engine*>(h)->step(actions, dt, spawn_mode, forced_route,
                                       obs, rewards, done, status, flags);
}

int mti_step_count(void* h) { return static_cast<mti::Engine*>(h)->step_count; }

// Reset-time (or any-time) observation snapshot without stepping — the
// reference returns get_observations() right after reset (env.py:158), with
// the lidar still at its init all-max ranges (IntersectionEnv.cpp:117).
void mti_get_obs(void* h, float* obs /*n*127*/) {
    static_cast<mti::Engine*>(h)->observe(obs);
}

void mti_get_egos(void* h, float* out /*n*7: x,y,v,h,steer,pi,alive*/) {
    auto* e = static_cast<mti::Engine*>(h);
    for (int i = 0; i < e->n; ++i) {
        out[i * 7 + 0] = e->ego[i].x;
        out[i * 7 + 1] = e->ego[i].y;
        out[i * 7 + 2] = e->ego[i].v;
        out[i * 7 + 3] = e->ego[i].h;
        out[i * 7 + 4] = e->ego[i].steer;
        out[i * 7 + 5] = float(e->ego_pi[i]);
        out[i * 7 + 6] = e->ego_alive[i] ? 1.0f : 0.0f;
    }
}

int mti_num_npcs(void* h) {
    auto* e = static_cast<mti::Engine*>(h);
    int m = 0;
    for (int i = 0; i < e->max_npcs; ++i) m += e->npc_alive[i];
    return m;
}

void mti_get_npcs(void* h, float* out /*m*6: x,y,v,h,pi,uid — uid order*/) {
    auto* e = static_cast<mti::Engine*>(h);
    std::vector<int> order(e->max_npcs);
    int m = e->alive_npcs_in_order(order.data());
    for (int k = 0; k < m; ++k) {
        int i = order[k];
        out[k * 6 + 0] = e->npc[i].x;
        out[k * 6 + 1] = e->npc[i].y;
        out[k * 6 + 2] = e->npc[i].v;
        out[k * 6 + 3] = e->npc[i].h;
        out[k * 6 + 4] = float(e->npc_pi[i]);
        out[k * 6 + 5] = float(e->npc_uid[i]);
    }
}

void mti_get_lidar(void* h, int agent, float* out96) {
    auto* e = static_cast<mti::Engine*>(h);
    std::memcpy(out96, &e->lidar[size_t(agent) * mti::RAYS],
                mti::RAYS * sizeof(float));
}

}  // extern "C"
