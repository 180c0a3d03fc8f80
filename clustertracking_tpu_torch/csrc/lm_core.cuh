// The Levenberg–Marquardt core shared by the port's LM kernels
// (fused_lm_2d.cu, pixel_lm.cu): one warp solves one cluster.
//
// Counterpart of the LM body every Pallas kernel of
// clustertracking_tpu/ops/pallas_lm.py shares (`kernel_impl`,
// pallas_lm.py:446-1141): per-feature parameters staged once per sweep,
// the model (every built-in radial profile) and its analytic Jacobian per
// pixel, cost, g = Jᵀr and the upper triangle of H = JᵀJ summed over the
// pixels, the damped Cholesky step, the projected trial point and the
// accept / λ / ftol / xtol / plateau / stuck rules of ops/lm.py::lm_solve.
//
// What differs between the kernels is only where a pixel comes from.  A
// kernel hands the sweep a `Pixels` object with
//     int count() const;                 // pixels of the sweep
//     void load(int k, float* off, float& val, float& wc) const;
// giving pixel k's window offsets (D floats, outermost axis first), its
// value and its weight (fit mask · 1/norm).  Pixels are visited in order
// k = 0, 1, ..., 32 at a time.
//
// Two template tags select the model, so that each instantiation carries
// only its own arithmetic and shared memory (the gauss, unconstrained one
// is the code of the kernels before the tags existed):
//   * Prof, the radial profile of models/registry.py (:102-243): gauss,
//     ring (thickness), hat (disc_size), disc, inv_series (k coefficients,
//     k ≤ kMaxSeries at run time).  Each feature's extra parameters are
//     staged beside the standard ones; their Jacobian rows are
//     registry.py's dfun_dextra, in closed form.
//   * Pose, the rigid-pose kind of a constrained bucket
//     (pallas_lm.py:570-814): none, 2D n-gon (center, angle), 3D dimer
//     axis (center, polar, azimuth), 3D rotation vector (center,
//     Rodrigues).  The kernel then solves the compact vector [pose (qt
//     rows, a fitted distance last), non-position slots]; positions come
//     from the pose, computed with the per-sweep pose constants once per
//     sweep into per-warp shared memory, and the position Jacobian is
//     chained into the pose rows.  Only the rigid instantiations reserve
//     that staging.
//
// Work split inside the warp (what bounds the sweep is per-pixel
// arithmetic: one expf and ~8·D FLOPs per feature per pixel, then
// V(V+3)/2+1 products per pixel for cost, g and H):
//   * the 32 lanes take 32 consecutive pixels; each lane writes its
//     pixel's residual and Jacobian row into a per-warp shared tile
//     [32 pixels][V+1];
//   * lane l then owns sums l, l+32, ... of the V(V+3)/2+1 (cost, g, H)
//     and adds its products over the tile's 32 rows, in row order;
//   * the V×V damped Cholesky is serial on lane 0 in shared memory;
//   * a cluster leaves its LM loop on its own when it converges or sticks
//     (the reference freezes converged lanes of a lockstep tile, so
//     per-lane results are the same).
//
// Numerics: the libraries are built with -fmad=false (ops/_build.py), so
// every product and sum rounds as the plain PyTorch version's elementwise
// ops do; the Cholesky pivot is clamped at 1e-20 and divides, as
// ops/lm.py does.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace lmcore {

constexpr int kMaxSlots = 20;                        // V cap (V < 20 routed)
constexpr int kMaxFeatures = 32;                     // n cap
constexpr int kJStride = kMaxSlots + 1;              // J row + residual
constexpr int kMaxItems = 1 + kMaxSlots + kMaxSlots * (kMaxSlots + 1) / 2;
constexpr int kItemsPerLane = (kMaxItems + 31) / 32;
constexpr int kMaxSeries = 8;                        // inv_series k cap

// Profile tags (models/registry.py) and rigid-pose kinds (constraints.py);
// ops/pixel_lm.py holds the same numbers.
enum Profile { kGauss = 0, kRing = 1, kHat = 2, kDisc = 3, kInvSeries = 4 };
enum PoseKind { kNoPose = 0, kNgon2D = 1, kAxis3D = 2, kRotvec3D = 3 };

// Extra parameters staged per feature: thickness (ring), disc_size (hat),
// coeff_1..k (inv_series, k at run time).
template <int Prof>
struct ProfileExtras {
  static constexpr int N =
      (Prof == kRing || Prof == kHat) ? 1 : (Prof == kInvSeries ? kMaxSeries : 0);
};

// Per-feature staging for a rank-D window.  Floats: signal·fvalid,
// rel[D] (position − window corner), size[D] (isotropic: the one size
// repeated), fvalid, extras[NX].  Ints: slots of signal, position[D],
// size[D] (isotropic: the size slot first, the others −1), extras[NX].
// Parameters are in param_names_for order: background, signal,
// position[D], size[1|D], extras.
template <int D, int NX = 0>
struct Feat {
  static constexpr int F = 2 + 2 * D + NX;
  static constexpr int I = 1 + 2 * D + NX;
};

// Pose constants staged once per sweep (rigid instantiations only): Rc =
// circ·dist first, then the 2D n-gon's (sin, cos)(θ + αᵢ) per feature, the
// 3D axis u, ∂u/∂θ, ∂u/∂φ, or the rotation vector's R·bᵢ and
// Mᵢ = −R[bᵢ]×J_r (row-major) per feature.
template <int Pose>
struct PoseStage {
  static constexpr int W = Pose == kNgon2D ? 1 + 2 * kMaxFeatures
                         : Pose == kAxis3D ? 10
                         : Pose == kRotvec3D ? 1 + 12 * kMaxFeatures : 0;
};

// The core's per-warp shared memory, in 4-byte words, placed after the
// `base` words a kernel keeps for its own pixels.
struct CoreLayout {
  int jbuf, acc, xs, xt, dl, fp, fs, chol, pose, total;
};

template <int D, int Prof = kGauss, int Pose = kNoPose>
__host__ __device__ inline CoreLayout core_layout(int base) {
  using FT = Feat<D, ProfileExtras<Prof>::N>;
  CoreLayout L;
  int o = base;
  L.jbuf = o; o += 32 * kJStride;                       // [32][V+1] J + r
  L.acc = o;  o += 2 * kMaxItems;                       // two sweep sums
  L.xs = o;   o += kMaxSlots;                           // current x
  L.xt = o;   o += kMaxSlots;                           // trial x
  L.dl = o;   o += kMaxSlots;                           // step
  L.fp = o;   o += kMaxFeatures * FT::F + 1;            // params + bg
  L.fs = o;   o += kMaxFeatures * FT::I;                // slots (int)
  L.chol = o; o += kMaxSlots * kMaxSlots;               // Cholesky factor
  L.pose = o; o += PoseStage<Pose>::W;                  // pose constants
  L.total = o;
  return L;
}

// One cluster's problem, as the sweep reads it.  In a rigid bucket the
// slot indices are the compact ones (positions −1; they come from the
// pose in x[0 .. qt−1]).
struct Cluster {
  const float* cp;       // [n, P] this cluster's const parameters
  const float* fvalid;   // [n]
  const int* slot_idx;   // [n, P], −1 = const
  float org[3];          // window corner, outermost axis first
  int n, P, V, iso;
  int nx;                // extra parameters per feature
  // rigid buckets only
  const float* base;     // 2D: angles αᵢ [n]; 3D rotation: vertices [n][3]
  float circ;            // circumradius per unit distance
  float rc_fixed;        // circ · fixed distance (fit_dist = 0)
  int fit_dist;          // the distance is x[qt − 1]
  float xn;              // max |inert position slot| (the xtol norm)
};

// What a launch adds to a gauss, unconstrained problem.
struct ModelArgs {
  int nx;                // extras per feature
  const float* base;     // rigid: Cluster::base
  float circ, rc_fixed;  // rigid: Cluster::circ, Cluster::rc_fixed
  int fit_dist;          // rigid: Cluster::fit_dist
  const float* xn;       // rigid: [B] Cluster::xn per cluster
};

__device__ inline Cluster make_cluster(const float* cp, const float* fvalid,
                                       const int* slot_idx, float o0,
                                       float o1, float o2, int n, int P,
                                       int V, int iso, const ModelArgs& ma,
                                       int b) {
  Cluster c;
  c.cp = cp;
  c.fvalid = fvalid;
  c.slot_idx = slot_idx;
  c.org[0] = o0; c.org[1] = o1; c.org[2] = o2;
  c.n = n; c.P = P; c.V = V; c.iso = iso;
  c.nx = ma.nx;
  c.base = ma.base;
  c.circ = ma.circ;
  c.rc_fixed = ma.rc_fixed;
  c.fit_dist = ma.fit_dist;
  c.xn = ma.xn != nullptr ? ma.xn[b] : 0.f;
  return c;
}

// The LM's bounds and schedule (ops/lm.py::lm_solve's arguments).
struct LMConf {
  const float* lo;       // [V]
  const float* hi;       // [V]
  int max_iter;
  float ftol, xtol, lam0, lam_up, lam_down, lam_max, plateau;
};

struct LMOut {
  float cost;
  int iters;
  bool conv;
};

__device__ inline float clip(float v, float lo, float hi) {
  v = v < lo ? lo : v;   // NaN passes through, as torch.maximum/minimum
  return v > hi ? hi : v;
}

__device__ inline int tri_index(int u, int v, int V) {
  // upper-triangle (u <= v) position, row-major
  return u * V - u * (u - 1) / 2 + (v - u);
}

// Item k of a sweep -> the pair of J-tile columns whose products it sums
// (column V holds the residual): k = 0 cost, 1..V gradient, then H.
__device__ inline void item_pair(int k, int V, int* u, int* v) {
  if (k == 0) { *u = V; *v = V; return; }
  if (k <= V) { *u = k - 1; *v = V; return; }
  int t = k - 1 - V;
  int a = 0;
  while (t >= V - a) { t -= V - a; ++a; }
  *u = a;
  *v = a + t;
}

// Pose slots before a fitted distance: 2D center + angle, 3D center +
// polar + azimuth, 3D center + rotation vector (constraints.py::pose_dim).
template <int Pose>
struct PoseDim {
  static constexpr int Q = Pose == kNgon2D ? 3 : Pose == kAxis3D ? 5 : 6;
};

// Feature slots, staged once per solve (lanes < n).
template <int D, int Prof = kGauss>
__device__ inline void stage_slots(const Cluster& c, int* fs, int lane) {
  using FT = Feat<D, ProfileExtras<Prof>::N>;
  if (lane < c.n) {
    const int* si = c.slot_idx + lane * c.P;
    int* f = fs + lane * FT::I;
    f[0] = si[1];
#pragma unroll
    for (int d = 0; d < D; ++d) f[1 + d] = si[2 + d];
#pragma unroll
    for (int d = 0; d < D; ++d)
      f[1 + D + d] = c.iso ? (d == 0 ? si[2 + D] : -1) : si[2 + D + d];
    const int ex = 2 + D + (c.iso ? 1 : D);
    for (int k = 0; k < ProfileExtras<Prof>::N && k < c.nx; ++k)
      f[1 + 2 * D + k] = si[ex + k];
  }
}

// Lane i's feature position from the pose x (rigid), written as
// rel = position − window corner, with the pose constants pixel_row reads
// (pallas_lm.py:570-701, constraints.py::pose_to_positions inlined).
template <int D, int Pose>
__device__ inline void stage_pose(const Cluster& c, const float* x, int i,
                                  float* rel, float* ps) {
  const float Rc = c.fit_dist ? c.circ * x[PoseDim<Pose>::Q] : c.rc_fixed;
  if (i == 0) ps[0] = Rc;
  if constexpr (Pose == kNgon2D) {
    const float a = x[2] + c.base[i];
    const float si = sinf(a), ci = cosf(a);
    ps[1 + 2 * i] = si;
    ps[2 + 2 * i] = ci;
    rel[0] = (x[0] + Rc * si) - c.org[0];
    rel[1] = (x[1] + Rc * ci) - c.org[1];
  } else if constexpr (Pose == kAxis3D) {
    const float sth = sinf(x[3]), cth = cosf(x[3]);
    const float sph = sinf(x[4]), cph = cosf(x[4]);
    const float u[3] = {cth, sth * sph, sth * cph};
    if (i == 0) {
      ps[1] = u[0]; ps[2] = u[1]; ps[3] = u[2];
      ps[4] = -sth; ps[5] = cth * sph; ps[6] = cth * cph;   // ∂u/∂θ
      ps[7] = 0.f;  ps[8] = sth * cph; ps[9] = -sth * sph;  // ∂u/∂φ
    }
    const float sgnRc = i == 0 ? Rc : -Rc;
#pragma unroll
    for (int d = 0; d < 3; ++d) rel[d] = (x[d] + sgnRc * u[d]) - c.org[d];
  } else if constexpr (Pose == kRotvec3D) {
    // R = I + A[v]× + B[v]×², J_r = I − B[v]× + C[v]×², with the
    // small-angle series below θ = 1e-3 (the reference's switch).
    const float v0 = x[3], v1 = x[4], v2 = x[5];
    const float th2 = v0 * v0 + v1 * v1 + v2 * v2;
    const float theta = sqrtf(fmaxf(th2, 1e-24f));
    const bool small = theta < 1e-3f;
    const float sA = small ? 1.f - th2 / 6.f : sinf(theta) / theta;
    const float sB = small ? 0.5f - th2 / 24.f
                           : (1.f - cosf(theta)) / fmaxf(th2, 1e-24f);
    const float sC = small ? 1.f / 6.f - th2 / 120.f
                           : (theta - sinf(theta)) / fmaxf(th2 * theta, 1e-30f);
    const float K[3][3] = {{0.f, -v2, v1}, {v2, 0.f, -v0}, {-v1, v0, 0.f}};
    float R[3][3], J[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const float k2 = K[a][0] * K[0][b] + K[a][1] * K[1][b] + K[a][2] * K[2][b];
        const float e = a == b ? 1.f : 0.f;
        R[a][b] = e + sA * K[a][b] + sB * k2;
        J[a][b] = e - sB * K[a][b] + sC * k2;
      }
    }
    const float* bi = c.base + 3 * i;
    const float hb[3][3] = {{0.f, -bi[2], bi[1]}, {bi[2], 0.f, -bi[0]},
                            {-bi[1], bi[0], 0.f}};
    float T[3][3];
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int q = 0; q < 3; ++q)
        T[p][q] = hb[p][0] * J[0][q] + hb[p][1] * J[1][q] + hb[p][2] * J[2][q];
    float* out = ps + 1 + 12 * i;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float rb = R[a][0] * bi[0] + R[a][1] * bi[1] + R[a][2] * bi[2];
      out[a] = rb;
      rel[a] = (x[a] + Rc * rb) - c.org[a];
#pragma unroll
      for (int q = 0; q < 3; ++q)
        out[3 + 3 * a + q] =
            -(R[a][0] * T[0][q] + R[a][1] * T[1][q] + R[a][2] * T[2][q]);
    }
  }
}

// Feature parameters at x, staged once per sweep (lanes < n); in a rigid
// bucket also the pose constants (ps) and the positions they give.
template <int D, int Prof = kGauss, int Pose = kNoPose>
__device__ inline void stage_features(const Cluster& c, const float* x,
                                      float* fp, float* ps, int lane) {
  using FT = Feat<D, ProfileExtras<Prof>::N>;
  if (lane < c.n) {
    const int i = lane;
    const float* cpi = c.cp + i * c.P;
    const int* si = c.slot_idx + i * c.P;
    auto prow = [&](int q) { return si[q] >= 0 ? x[si[q]] : cpi[q]; };
    const float fv = c.fvalid[i];
    float* f = fp + i * FT::F;
    f[0] = prow(1) * fv;
    if constexpr (Pose == kNoPose) {
#pragma unroll
      for (int d = 0; d < D; ++d) f[1 + d] = prow(2 + d) - c.org[d];
    } else {
      stage_pose<D, Pose>(c, x, i, f + 1, ps);
    }
#pragma unroll
    for (int d = 0; d < D; ++d) f[1 + D + d] = prow(2 + D + (c.iso ? 0 : d));
    f[1 + 2 * D] = fv;
    const int ex = 2 + D + (c.iso ? 1 : D);
    for (int k = 0; k < ProfileExtras<Prof>::N && k < c.nx; ++k)
      f[2 + 2 * D + k] = prow(ex + k);
    if (i == 0) fp[kMaxFeatures * FT::F] = prow(0);
  }
}

// The profile at r2 and its derivative through the value (registry.py's
// fun and dfun_f; ex = the feature's extras).
template <int Prof>
__device__ inline void profile(float r2, const float* ex, int nx, float* fe,
                               float* dfe) {
  if constexpr (Prof == kGauss) {
    *fe = expf(-0.5f * r2);
    *dfe = -0.5f * *fe;
  } else if constexpr (Prof == kRing) {
    const float r = sqrtf(r2 + 1e-12f);
    const float u = (r - 1.f) / ex[0];
    *fe = expf(-0.5f * (u * u));
    *dfe = *fe * (1.f - r) / (ex[0] * ex[0]) * 0.5f / r;
  } else if constexpr (Prof == kHat) {
    const float r = sqrtf(r2 + 1e-12f);
    const float edge = fmaxf(r - ex[0], 0.f);
    const float sigma = fmaxf(1.f - ex[0], 1e-3f);
    const float e = edge / sigma;
    *fe = expf(-0.5f * (e * e));
    *dfe = *fe * (-edge) / (sigma * sigma) * 0.5f / r;
  } else if constexpr (Prof == kDisc) {
    const float r = sqrtf(r2 + 1e-12f);
    *fe = 1.f / (1.f + expf(-((1.f - r) / 0.1f)));
    *dfe = *fe * (1.f - *fe) * (-10.f) * 0.5f / r;
  } else {
    float acc = 1.f, p = r2;
    for (int k = 0; k < nx; ++k) { acc = acc + ex[k] * p; p = p * r2; }
    *fe = 1.f / acc;
    float dacc = 0.f, dp = 1.f;
    p = r2;
    for (int k = 0; k < nx; ++k) {
      dacc = dacc + ex[k] * (float)(k + 1) * dp;
      dp = p;
      p = p * r2;
    }
    *dfe = -dacc * *fe * *fe;
  }
}

// ∂profile/∂extra k at r2 (registry.py's dfun_dextra, in closed form).
template <int Prof>
__device__ inline float profile_dextra(int k, float r2, const float* ex,
                                       float fe) {
  if constexpr (Prof == kRing) {          // ∂/∂t e^{−u²/2}, u = (r − 1)/t
    const float r = sqrtf(r2 + 1e-12f);
    const float u = (r - 1.f) / ex[0];
    return fe * (u * u) / ex[0];
  } else if constexpr (Prof == kHat) {    // edge, sigma both move with it
    const float r = sqrtf(r2 + 1e-12f);
    const float edge = fmaxf(r - ex[0], 0.f);
    const float live = 1.f - ex[0] > 1e-3f ? 1.f : 0.f;
    const float sigma = fmaxf(1.f - ex[0], 1e-3f);
    const float e = edge / sigma;
    return fe * e / sigma * (1.f - live * e);
  } else if constexpr (Prof == kInvSeries) {  // −r2^(k+1) · f²
    float p = r2;
    for (int j = 0; j < k; ++j) p = p * r2;
    return -p * fe * fe;
  } else {
    return 0.f;
  }
}

// One pixel's weighted residual and Jacobian row, added into jrow[0..V]
// (zeroed by the caller).  The profile is evaluated here and nowhere
// else; dI/dr² reuses the profile's value (gauss: −f/2).  A rigid
// bucket's position gradient g is chained into the pose rows.
template <int D, int Prof = kGauss, int Pose = kNoPose>
__device__ inline void pixel_row(const float* off, float val, float wc,
                                 const float* fp, const int* fs,
                                 const float* ps, const Cluster& c,
                                 int s_bg, float* jrow) {
  using FT = Feat<D, ProfileExtras<Prof>::N>;
  const int n = c.n, V = c.V;
  if (s_bg >= 0) jrow[s_bg] += wc;
  float model = 0.f;  // Σ signal·f, then + background (the plain order)
  for (int i = 0; i < n; ++i) {
    const float* f = fp + i * FT::F;
    const int* s = fs + i * FT::I;
    const float sig = f[0], fv = f[1 + 2 * D];
    float dd[D];
    float r2 = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dd[d] = (off[d] - f[1 + d]) / f[1 + D + d];
      r2 = r2 + dd[d] * dd[d];
    }
    float fe, dfe;
    profile<Prof>(r2, f + 2 + 2 * D, c.nx, &fe, &dfe);
    model = model + sig * fe;
    const float sig_df = sig * dfe;
    if (s[0] >= 0) jrow[s[0]] += fe * wc * fv;
    if constexpr (Pose == kNoPose) {
#pragma unroll
      for (int d = 0; d < D; ++d)
        if (s[1 + d] >= 0)
          jrow[s[1 + d]] += sig_df * (-2.f) * dd[d] / f[1 + D + d] * wc;
    } else {
      float g[D];
#pragma unroll
      for (int d = 0; d < D; ++d)
        g[d] = sig_df * (-2.f) * dd[d] / f[1 + D + d] * wc;
#pragma unroll
      for (int d = 0; d < D; ++d) jrow[d] += g[d];  // ∂pos/∂center = I
      const float Rc = ps[0];
      constexpr int Q = PoseDim<Pose>::Q;
      if constexpr (Pose == kNgon2D) {
        const float si = ps[1 + 2 * i], ci = ps[2 + 2 * i];
        jrow[2] += Rc * (ci * g[0] - si * g[1]);
        if (c.fit_dist) jrow[Q] += c.circ * (si * g[0] + ci * g[1]);
      } else if constexpr (Pose == kAxis3D) {
        const float sRc = i == 0 ? Rc : -Rc;
        jrow[3] += sRc * (ps[4] * g[0] + ps[5] * g[1] + ps[6] * g[2]);
        jrow[4] += sRc * (ps[8] * g[1] + ps[9] * g[2]);
        if (c.fit_dist) {
          const float sc = i == 0 ? c.circ : -c.circ;
          jrow[Q] += sc * (ps[1] * g[0] + ps[2] * g[1] + ps[3] * g[2]);
        }
      } else {
        const float* rb = ps + 1 + 12 * i;
        const float* M = rb + 3;
#pragma unroll
        for (int q = 0; q < 3; ++q)
          jrow[3 + q] += Rc * (M[q] * g[0] + M[3 + q] * g[1] + M[6 + q] * g[2]);
        if (c.fit_dist)
          jrow[Q] += c.circ * (rb[0] * g[0] + rb[1] * g[1] + rb[2] * g[2]);
      }
    }
    if (c.iso) {
      if (s[1 + D] >= 0)
        jrow[s[1 + D]] += sig_df * (-2.f) * r2 / f[1 + D] * wc;
    } else {
#pragma unroll
      for (int d = 0; d < D; ++d)
        if (s[1 + D + d] >= 0)
          jrow[s[1 + D + d]] +=
              sig_df * (-2.f) * dd[d] * dd[d] / f[1 + D + d] * wc;
    }
    for (int k = 0; k < ProfileExtras<Prof>::N && k < c.nx; ++k)
      if (s[1 + 2 * D + k] >= 0)
        jrow[s[1 + 2 * D + k]] +=
            sig * profile_dextra<Prof>(k, r2, f + 2 + 2 * D, fe) * wc;
  }
  jrow[V] = ((fp[kMaxFeatures * FT::F] + model) - val) * wc;
}

// One residual + Jacobian sweep at x (shared, length V): writes cost, g
// and the upper triangle of H into acc (shared).
template <int D, int Prof, int Pose, class Pixels>
__device__ void sweep(const Cluster& c, const float* x, float* sm,
                      const CoreLayout& L, float* acc, int lane,
                      const int* iu, const int* iv, int n_items,
                      const Pixels& px) {
  const int V = c.V;
  float* fp = sm + L.fp;
  const int* fs = reinterpret_cast<const int*>(sm + L.fs);
  float* ps = sm + L.pose;
  __syncwarp();
  stage_features<D, Prof, Pose>(c, x, fp, ps, lane);
  __syncwarp();
  const int s_bg = c.slot_idx[0];
  float* jrow = sm + L.jbuf + lane * kJStride;
  const float* jb = sm + L.jbuf;
  const int count = px.count();

  float a[kItemsPerLane];
#pragma unroll
  for (int j = 0; j < kItemsPerLane; ++j) a[j] = 0.f;

  for (int c0 = 0; c0 < count; c0 += 32) {
    const int k = c0 + lane;
    for (int s = 0; s <= V; ++s) jrow[s] = 0.f;
    if (k < count) {
      float off[D], val, wc;
      px.load(k, off, val, wc);
      pixel_row<D, Prof, Pose>(off, val, wc, fp, fs, ps, c, s_bg, jrow);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kItemsPerLane; ++j) {
      if (lane + 32 * j < n_items) {
        const int u = iu[j], v = iv[j];
        float s = 0.f;
        for (int r = 0; r < 32; ++r) s += jb[r * kJStride + u] * jb[r * kJStride + v];
        a[j] += s;
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int j = 0; j < kItemsPerLane; ++j)
    if (lane + 32 * j < n_items) acc[lane + 32 * j] = a[j];
  __syncwarp();
}

// (H + λ·max(diag H, 1e-12) + 1e-10·I) δ = −g by Cholesky, serial (lane 0).
__device__ inline void damped_solve(const float* acc, float lam, int V,
                                    float* Lm, float* delta) {
  const float* g = acc + 1;
  const float* Hu = acc + 1 + V;
  for (int j = 0; j < V; ++j) {
    const float hjj = Hu[tri_index(j, j, V)];
    const float d = hjj > 1e-12f ? hjj : 1e-12f;
    float s = hjj + lam * d + 1e-10f;
    for (int k = 0; k < j; ++k) s = s - Lm[j * kMaxSlots + k] * Lm[j * kMaxSlots + k];
    const float dj = sqrtf(s < 1e-20f ? 1e-20f : s);
    Lm[j * kMaxSlots + j] = dj;
    for (int i = j + 1; i < V; ++i) {  // divide, as ops/lm.py does
      float t = Hu[tri_index(j, i, V)];
      for (int k = 0; k < j; ++k) t = t - Lm[i * kMaxSlots + k] * Lm[j * kMaxSlots + k];
      Lm[i * kMaxSlots + j] = t / dj;
    }
  }
  for (int i = 0; i < V; ++i) {              // forward: L y = −g
    float s = -g[i];
    for (int k = 0; k < i; ++k) s = s - Lm[i * kMaxSlots + k] * delta[k];
    delta[i] = s / Lm[i * kMaxSlots + i];
  }
  for (int i = V - 1; i >= 0; --i) {          // back: Lᵀ δ = y
    float s = delta[i];
    for (int k = i + 1; k < V; ++k) s = s - Lm[k * kMaxSlots + i] * delta[k];
    delta[i] = s / Lm[i * kMaxSlots + i];
  }
}

// The whole LM solve of one cluster.  On entry xs (shared) holds the
// clipped start and the feature slots are staged (stage_slots); on exit
// xs holds the solution.  Every lane returns the same LMOut.
template <int D, int Prof, int Pose, class Pixels>
__device__ LMOut lm_run(const Cluster& c, const LMConf& m, float* sm,
                        const CoreLayout& L, int lane, const Pixels& px) {
  const int V = c.V;
  float* xs = sm + L.xs;
  float* xt = sm + L.xt;
  float* dl = sm + L.dl;
  const int n_items = 1 + V + V * (V + 1) / 2;
  int iu[kItemsPerLane], iv[kItemsPerLane];
#pragma unroll
  for (int j = 0; j < kItemsPerLane; ++j) {
    iu[j] = 0; iv[j] = 0;
    if (lane + 32 * j < n_items) item_pair(lane + 32 * j, V, &iu[j], &iv[j]);
  }

  float* acc[2] = {sm + L.acc, sm + L.acc + kMaxItems};
  int cur = 0;
  sweep<D, Prof, Pose>(c, xs, sm, L, acc[cur], lane, iu, iv, n_items, px);
  float cost = acc[cur][0];
  float lam = m.lam0;
  int iters = 0;
  bool conv = false;

  for (int it = 0; it < m.max_iter; ++it) {
    if (lane == 0) damped_solve(acc[cur], lam, V, sm + L.chol, dl);
    __syncwarp();
    if (lane < V) xt[lane] = clip(xs[lane] + dl[lane], m.lo[lane], m.hi[lane]);
    sweep<D, Prof, Pose>(c, xt, sm, L, acc[1 - cur], lane, iu, iv, n_items, px);
    const float c_trial = acc[1 - cur][0];
    const bool accept = c_trial < cost;
    // a rigid bucket's xtol norm includes its inert position slots
    float xnorm = Pose == kNoPose ? 0.f : c.xn, snorm = 0.f;
    for (int v = 0; v < V; ++v) {
      xnorm = fmaxf(xnorm, fabsf(xs[v]));
      snorm = fmaxf(snorm, fabsf(xt[v] - xs[v]));
    }
    __syncwarp();
    float cost_new = cost, lam_new;
    if (accept) {
      if (lane < V) xs[lane] = xt[lane];
      cur = 1 - cur;
      cost_new = c_trial;
      lam_new = lam * m.lam_down;
    } else {
      lam_new = fminf(lam * m.lam_up, m.lam_max);
    }
    const bool conv_x = accept && (snorm <= m.xtol * (m.xtol + xnorm));
    const bool conv_f = accept && ((cost - c_trial) <= m.ftol * fmaxf(cost, 1e-30f));
    const bool plateau = (lam_new >= m.plateau) && isfinite(cost_new);
    const bool stuck = lam_new >= m.lam_max;
    const bool conv_now = conv_x || conv_f || plateau;
    ++iters;
    conv = conv || conv_now;
    cost = cost_new;
    lam = lam_new;
    __syncwarp();
    if (conv_now || stuck) break;
  }
  return LMOut{cost, iters, conv};
}

}  // namespace lmcore
