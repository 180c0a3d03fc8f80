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
// What bounds a solve on the H100, and the work split inside the warp.
// A solve is a chain of sweeps and damped solves, and a warp runs its own
// chain: nothing is read from device memory in the loop (streamed
// pixel_lm: from L2), so the time is instruction count and latency, not
// bytes.  Per pixel a sweep needs one expf and ~8·D FLOPs per feature,
// then (V+1)(V+2)/2 products for cost, g and H; the design keeps those
// products in the FP32 pipe instead of the load/store unit:
//   * the 32 lanes take pixels lane, lane+32, ...; each lane scatters its
//     pixel's residual and Jacobian row by slot into a private row of
//     shared memory (odd stride: no bank conflict, and no lane reads
//     another's row, so the pixel loop has no warp barrier), two to four
//     pixels at a time, whose chains of divisions and expf interleave;
//   * register instantiations (VM = a slot-count ceiling, 8, 10 or 14): the
//     lane loads its row back into registers once and adds the pixel's
//     products into its own register accumulators; after the last pixel
//     the warp sums the accumulators with a transposed shuffle reduction
//     (31 shuffles per 32 sums, against 5 per sum for a butterfly) that
//     leaves sums m·l .. m·l+m−1 on lane l;
//   * pixel_lm's high ceiling (sweep_mma) sums instead on the FP64 tensor
//     cores, from the rows in the J tile, which frees those accumulators'
//     registers for more warps an SM;
//   * the tile instantiation (VM = 0: any V up to kMaxSlots, and the
//     non-gauss profiles): lane l owns sums l, l+32, ... and adds its
//     products over the 32 rows of each chunk, reading other lanes' rows;
//   * the damped Cholesky runs across the warp: lane i owns row i of the
//     factor (a private shared row), pivots and columns travel by shuffle,
//     and every element is summed over k in ascending order, so each
//     rounds exactly as a serial factorization and substitution does;
//   * what is left is one warp's dependent chain (divisions, an expf,
//     shared round trips, shuffles), so the code a warp walks per
//     iteration is kept small (one sweep call site, rolled solve loops)
//     and every loop makes the same number of trips on all lanes;
//   * a cluster leaves its LM loop on its own when it converges or sticks
//     (the reference freezes converged lanes of a lockstep tile, so
//     per-lane results are the same).
// Items of a sweep are the products z_u·z_v, u <= v, of the augmented row
// z = [residual, J_0 .. J_{V-1}], stored at v(v+1)/2 + u: item 0 is the
// cost, column v = i+1 holds g_i first and then H[0..i][i], and the items
// of V slots are a prefix of those of any larger V.
//
// Numerics: the libraries are built with -fmad=false (ops/_build.py), so
// every product and sum rounds as the plain PyTorch version's elementwise
// ops do; the Cholesky pivot is clamped at 1e-20 and divides, as
// ops/lm.py does.  Sums over pixels run per lane and then across lanes
// (sweep_mma: in FP64, by a fixed order of MMAs), in one order for every
// pixel source, so resident and streamed pixel_lm agree bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace lmcore {

constexpr int kMaxSlots = 20;                        // V cap; V >= 20: block_lm.cu
constexpr int kMaxFeatures = 32;                     // n cap
constexpr int kJStride = kMaxSlots + 1;              // J row + residual; odd
constexpr int kJTileWords = 1152;                    // the J tile (RowLayout)
constexpr int kMaxItems = (kMaxSlots + 1) * (kMaxSlots + 2) / 2;
constexpr int kItemsPerLane = (kMaxItems + 31) / 32;
constexpr unsigned kFullWarp = 0xffffffffu;
// Slot-count ceilings of the register instantiations (8: configs 1, 3,
// 3b; 10: config 3c, free trimers; 14: config 4); V above the last one
// takes the tile instantiation (VM = 0).
constexpr int kRegSlotsLow = 8;
constexpr int kRegSlotsMid = 10;
constexpr int kRegSlotsHigh = 14;
// Blocks (of one warp) per SM that each instantiation's registers are
// held to, for __launch_bounds__: the most that needs no spill.  A block
// lives in one of the SM's four register partitions, so what counts is
// blocks per partition: 2 allow 255 registers, 3 allow 168, 4 allow 128.
template <int VM>
struct MinBlocks {
  static constexpr int N = VM == kRegSlotsHigh ? 8 : VM == 0 ? 16 : 12;
};
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
  int jbuf, acc, xs, xt, fp, fs, pose, total;
};

template <int D, int Prof = kGauss, int Pose = kNoPose>
__host__ __device__ inline CoreLayout core_layout(int base) {
  using FT = Feat<D, ProfileExtras<Prof>::N>;
  CoreLayout L;
  int o = base;
  L.jbuf = o; o += kJTileWords;       // J rows + r; the solve's factor
  L.acc = o;  o += 2 * kMaxItems;                       // two sweep sums
  L.xs = o;   o += kMaxSlots;                           // current x
  L.xt = o;   o += kMaxSlots;                           // trial x
  L.fp = o;   o += kMaxFeatures * FT::F + 1;            // params + bg
  L.fs = o;   o += kMaxFeatures * FT::I;                // slots (int)
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

// Item k of a sweep -> the pair of J-tile columns whose products it sums
// (column V of the tile holds the residual, entry 0 of the augmented row).
__device__ inline void item_pair(int k, int V, int* cu, int* cv) {
  int v = 0;
  while ((v + 1) * (v + 2) / 2 <= k) ++v;
  const int u = k - v * (v + 1) / 2;
  *cu = u == 0 ? V : u - 1;
  *cv = v == 0 ? V : v - 1;
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
// rel = position − window corner, with the pose constants pixel_rows reads
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

// The weighted residuals and Jacobian rows of NPX pixels of one lane,
// added into jrow[t·PITCH + 0..V] for pixel t (zeroed by the caller).
// Every statement runs over the NPX pixels before the next one starts, so
// their chains of divisions and expf, which do not depend on each other,
// are in flight together: one pixel's chain alone leaves the warp waiting
// ~2,000 cycles per pixel.  Per pixel the arithmetic and its order are
// those of a single-pixel row.  The profile is evaluated here and nowhere
// else; dI/dr² reuses the profile's value (gauss: −f/2).  A rigid bucket's
// position gradient g is chained into the pose rows.
template <int D, int Prof, int Pose, int NPX, int PITCH>
__device__ inline void pixel_rows(const float (&off)[NPX][D],
                                  const float (&val)[NPX],
                                  const float (&wc)[NPX], const float* fp,
                                  const int* fs, const float* ps,
                                  const Cluster& c, int s_bg, float* jrow) {
  using FT = Feat<D, ProfileExtras<Prof>::N>;
  const int n = c.n, V = c.V;
  auto put = [&](int at, float term) { jrow[at] += term; };
#define LM_EACH_PIXEL _Pragma("unroll") for (int t = 0; t < NPX; ++t)
  if (s_bg >= 0) LM_EACH_PIXEL put(t * PITCH + s_bg, wc[t]);
  float model[NPX];  // Σ signal·f, then + background (the plain order)
  LM_EACH_PIXEL model[t] = 0.f;
  for (int i = 0; i < n; ++i) {
    const float* f = fp + i * FT::F;
    const int* s = fs + i * FT::I;
    const float sig = f[0], fv = f[1 + 2 * D];
    float dd[NPX][D], r2[NPX], fe[NPX], dfe[NPX], sig_df[NPX];
    LM_EACH_PIXEL {
      r2[t] = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dd[t][d] = (off[t][d] - f[1 + d]) / f[1 + D + d];
        r2[t] = r2[t] + dd[t][d] * dd[t][d];
      }
    }
    LM_EACH_PIXEL profile<Prof>(r2[t], f + 2 + 2 * D, c.nx, &fe[t], &dfe[t]);
    LM_EACH_PIXEL {
      model[t] = model[t] + sig * fe[t];
      sig_df[t] = sig * dfe[t];
    }
    if (s[0] >= 0) LM_EACH_PIXEL put(t * PITCH + s[0], fe[t] * wc[t] * fv);
    if constexpr (Pose == kNoPose) {
#pragma unroll
      for (int d = 0; d < D; ++d)
        if (s[1 + d] >= 0)
          LM_EACH_PIXEL put(
              t * PITCH + s[1 + d],
              sig_df[t] * (-2.f) * dd[t][d] / f[1 + D + d] * wc[t]);
    } else {
      float g[NPX][D];
      LM_EACH_PIXEL {
#pragma unroll
        for (int d = 0; d < D; ++d)
          g[t][d] = sig_df[t] * (-2.f) * dd[t][d] / f[1 + D + d] * wc[t];
      }
#pragma unroll
      for (int d = 0; d < D; ++d)   // ∂pos/∂center = I
        LM_EACH_PIXEL put(t * PITCH + d, g[t][d]);
      const float Rc = ps[0];
      constexpr int Q = PoseDim<Pose>::Q;
      if constexpr (Pose == kNgon2D) {
        const float si = ps[1 + 2 * i], ci = ps[2 + 2 * i];
        LM_EACH_PIXEL put(t * PITCH + 2, Rc * (ci * g[t][0] - si * g[t][1]));
        if (c.fit_dist)
          LM_EACH_PIXEL put(t * PITCH + Q,
                            c.circ * (si * g[t][0] + ci * g[t][1]));
      } else if constexpr (Pose == kAxis3D) {
        const float sRc = i == 0 ? Rc : -Rc;
        LM_EACH_PIXEL put(
            t * PITCH + 3,
            sRc * (ps[4] * g[t][0] + ps[5] * g[t][1] + ps[6] * g[t][2]));
        LM_EACH_PIXEL put(t * PITCH + 4,
                          sRc * (ps[8] * g[t][1] + ps[9] * g[t][2]));
        if (c.fit_dist) {
          const float sc = i == 0 ? c.circ : -c.circ;
          LM_EACH_PIXEL put(
              t * PITCH + Q,
              sc * (ps[1] * g[t][0] + ps[2] * g[t][1] + ps[3] * g[t][2]));
        }
      } else {
        const float* rb = ps + 1 + 12 * i;
        const float* M = rb + 3;
#pragma unroll
        for (int q = 0; q < 3; ++q)
          LM_EACH_PIXEL put(
              t * PITCH + 3 + q,
              Rc * (M[q] * g[t][0] + M[3 + q] * g[t][1] + M[6 + q] * g[t][2]));
        if (c.fit_dist)
          LM_EACH_PIXEL put(
              t * PITCH + Q,
              c.circ * (rb[0] * g[t][0] + rb[1] * g[t][1] + rb[2] * g[t][2]));
      }
    }
    if (c.iso) {
      if (s[1 + D] >= 0)
        LM_EACH_PIXEL put(t * PITCH + s[1 + D],
                          sig_df[t] * (-2.f) * r2[t] / f[1 + D] * wc[t]);
    } else {
#pragma unroll
      for (int d = 0; d < D; ++d)
        if (s[1 + D + d] >= 0)
          LM_EACH_PIXEL put(t * PITCH + s[1 + D + d],
                            sig_df[t] * (-2.f) * dd[t][d] * dd[t][d] /
                                f[1 + D + d] * wc[t]);
    }
    for (int k = 0; k < ProfileExtras<Prof>::N && k < c.nx; ++k)
      if (s[1 + 2 * D + k] >= 0)
        LM_EACH_PIXEL put(
            t * PITCH + s[1 + 2 * D + k],
            sig * profile_dextra<Prof>(k, r2[t], f + 2 + 2 * D, fe[t]) * wc[t]);
  }
  LM_EACH_PIXEL jrow[t * PITCH + V] =
      ((fp[kMaxFeatures * FT::F] + model[t]) - val[t]) * wc[t];
#undef LM_EACH_PIXEL
}

// A register instantiation's row layout in the J tile: rows of VM+1 words
// (odd, as kJStride is), and NPX tiles of 32 rows, one per pixel a lane
// has in flight; kJTileWords holds the widest (4·32·9, 3·32·11, 2·32·15
// and the tile instantiation's 32·21).  NPX is what each ceiling's
// registers hold beside its accumulators without a spill (four at the
// high ceiling measured slower than two: PERF.md).
template <int VM>
struct RowLayout {
  static constexpr int NPX = VM == kRegSlotsLow ? 4 : VM == kRegSlotsMid ? 3 : 2;
  static constexpr int Stride = VM + 1;
  static constexpr int Pitch = 32 * Stride;
  static_assert(NPX * Pitch <= kJTileWords, "the J tile is too small");
};

// D (8×8, two per lane) += A (8×4, one per lane) · B (4×8, one per lane)
// on the FP64 tensor cores.  Lane l holds A[l/4][l%4], B[l%4][l/4] and
// D[l/4][2(l%4) + {0, 1}].
__device__ __forceinline__ void dmma(double (&c)[2], double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1}, {%2}, {%3}, {%0, %1};"
      : "+d"(c[0]), "+d"(c[1])
      : "d"(a), "d"(b));
}

// Register accumulators of a ceiling VM: the (VM+1)(VM+2)/2 items, padded
// to whole groups of 32 for the warp reduction.
template <int VM>
struct RegItems {
  static constexpr int N = (VM + 1) * (VM + 2) / 2;
  static constexpr int M = (N + 31) / 32;     // items per lane, reduced
  static constexpr int NP = 32 * M;
};

// One step of the transposed warp sum: lanes whose bit O is set keep the
// upper HALF of their values, the others the lower, and each adds its
// partner's copy of the half it keeps.
template <int O, int HALF, int NP>
__device__ inline void fold(float (&a)[NP], int lane) {
  const bool up = (lane & O) != 0;
#pragma unroll
  for (int k = 0; k < HALF; ++k) {
    const float send = up ? a[k] : a[k + HALF];
    const float keep = up ? a[k + HALF] : a[k];
    a[k] = keep + __shfl_xor_sync(kFullWarp, send, O);
  }
}

// Sums a[0 .. 32·M) over the warp; lane l ends with the sums of items
// M·l .. M·l + M − 1 in a[0 .. M).
template <int M, int NP>
__device__ inline void warp_sum_transposed(float (&a)[NP], int lane) {
  static_assert(32 * M <= NP, "more items than accumulators");
  fold<16, 16 * M>(a, lane);
  fold<8, 8 * M>(a, lane);
  fold<4, 4 * M>(a, lane);
  fold<2, 2 * M>(a, lane);
  fold<1, M>(a, lane);
}

// Reduces the first n_items accumulators over the warp, in the fewest
// groups of 32 that hold them, and writes them to acc (shared).
template <int M, int MMAX, int NP>
__device__ inline void reduce_items(float (&a)[NP], int lane, int n_items,
                                    float* acc) {
  if (M == MMAX || n_items <= 32 * M) {
    warp_sum_transposed<M>(a, lane);
#pragma unroll
    for (int k = 0; k < M; ++k)
      if (M * lane + k < n_items) acc[M * lane + k] = a[k];
  } else if constexpr (M < MMAX) {
    reduce_items<M + 1, MMAX>(a, lane, n_items, acc);
  }
}

// One trip of a register sweep (sweep, sweep_mma): the NPX rows z = [J_0 ..
// J_{V-1}, r] of pixels c0 + lane, c0 + lane + 32, ... into the lane's rows
// of the J tile, from the caller's c0, count, lane, px, V, jrow, fp, fs,
// ps, c and s_bg.  A pixel past the list's end reads the last one; its row
// is built and left for the caller to skip or zero.  A macro, not an inline
// function: as a function the same statements moved the register
// allocation of the register sweeps (cuobjdump: fused_lm_2d and
// pixel_lm), which keep the code they had.
#define LMCORE_TRIP_ROWS(D, Prof, Pose, NPX, Pitch)                        \
  float off[NPX][D], val[NPX], wc[NPX];                                     \
  _Pragma("unroll") for (int t = 0; t < NPX; ++t) {                         \
    const int k = c0 + 32 * t + lane;                                       \
    px.load(k < count ? k : count - 1, off[t], val[t], wc[t]);              \
  }                                                                         \
  for (int s = 0; s <= V; ++s) {                                            \
    _Pragma("unroll") for (int t = 0; t < NPX; ++t)                         \
        jrow[t * Pitch + s] = 0.f;                                          \
  }                                                                         \
  pixel_rows<D, Prof, Pose, NPX, Pitch>(off, val, wc, fp, fs, ps, c, s_bg,  \
                                        jrow);

// One residual + Jacobian sweep at x (shared, length V): writes the items
// (cost, g, the upper triangle of H) into acc (shared).  VM > 0: register
// accumulators; VM = 0: the shared tile, lanes owning items (iu, iv).
// Fma: each product is added by a fused multiply-add (the product exact,
// one rounding an add), as the plain version's einsum (a cuBLAS GEMM)
// forms cost, g and H; otherwise a rounded product, then the add.
template <int D, int Prof, int Pose, int VM, class Pixels, bool Fma = false>
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
  const int count = px.count();

  if constexpr (VM > 0) {
    using RI = RegItems<VM>;
    using RL = RowLayout<VM>;
    constexpr int NPX = RL::NPX;
    float* jrow = sm + L.jbuf + lane * RL::Stride;
    float a[RI::NP];
#pragma unroll
    for (int j = 0; j < RI::NP; ++j) a[j] = 0.f;
    // A trip takes 32·NPX pixels, NPX per lane (lane, lane + 32, ... of the
    // trip, so a lane meets its pixels in list order).  Every lane makes
    // the same number of trips, so the warp is whole again after each one:
    // shuffles executed by a warp that a lane-dependent trip count has split
    // take a path ~100 cycles long each.  A pixel past the list's end
    // reads the last one and is not added.
    for (int c0 = 0; c0 < count; c0 += 32 * NPX) {
      LMCORE_TRIP_ROWS(D, Prof, Pose, NPX, RL::Pitch)
#pragma unroll
      for (int t = 0; t < NPX; ++t) {
        if (c0 + 32 * t + lane < count) {
          const float* row = jrow + t * RL::Pitch;
          float z[VM + 1];
          z[0] = row[V];
#pragma unroll
          for (int v = 0; v < VM; ++v) z[1 + v] = v < V ? row[v] : 0.f;
#pragma unroll
          for (int v = 0; v <= VM; ++v) {
            if (v <= V) {
#pragma unroll
              for (int u = 0; u <= v; ++u) {
                float& s = a[v * (v + 1) / 2 + u];
                s = Fma ? __fmaf_rn(z[u], z[v], s) : s + z[u] * z[v];
              }
            }
          }
        }
      }
    }
    reduce_items<1, RI::M>(a, lane, n_items, acc);
  } else {
    float* jrow = sm + L.jbuf + lane * kJStride;
    const float* jb = sm + L.jbuf;
    float a[kItemsPerLane];
#pragma unroll
    for (int j = 0; j < kItemsPerLane; ++j) a[j] = 0.f;
    for (int c0 = 0; c0 < count; c0 += 32) {
      const int k = c0 + lane;
      for (int s = 0; s <= V; ++s) jrow[s] = 0.f;
      if (k < count) {
        float off[1][D], val[1], wc[1];
        px.load(k, off[0], val[0], wc[0]);
        pixel_rows<D, Prof, Pose, 1, 0>(off, val, wc, fp, fs, ps, c, s_bg,
                                        jrow);
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < kItemsPerLane; ++j) {
        if (lane + 32 * j < n_items) {
          const int u = iu[j], v = iv[j];
          float s = 0.f;
          for (int r = 0; r < 32; ++r) {
            const float zu = jb[r * kJStride + u], zv = jb[r * kJStride + v];
            s = Fma ? __fmaf_rn(zu, zv, s) : s + zu * zv;
          }
          a[j] += s;
        }
      }
      __syncwarp();
    }
#pragma unroll
    for (int j = 0; j < kItemsPerLane; ++j)
      if (lane + 32 * j < n_items) acc[lane + 32 * j] = a[j];
  }
  __syncwarp();
}

// The sweep of a register instantiation with its sums on the FP64 tensor
// cores (pixel_lm.cu at the high ceiling): the rows as sweep builds them
// (LMCORE_TRIP_ROWS), then zᵀz by mma.sync m8n8k4 f64 with the trip's
// pixels as k.  The J tile's columns 0 .. 15 are two 8-column blocks
// (column V holds the residual, columns past V are not read), so a k-step
// loads and converts one fragment of each block, which serves as both A
// and B, and runs the three MMAs of the upper-triangle tiles (0,0), (0,1)
// and (1,1).  An FP64 MMA of FP32 values forms exact products and adds
// them in FP64; each item is rounded to FP32 once, at the end of the
// sweep, into acc at v(v+1)/2 + u as sweep writes it.  A lane's fragment
// element of k-step ks is row 8·(l%4) + ks%8 + 32·(ks/8) of the trip,
// column 8b + l/4: the four rows of a k-step lie 8 rows apart, which at
// the odd row stride 15 puts the warp's 32 loads in 32 banks.  Rows past the list's end are
// zeroed; a trip skips the k-steps of a 32-row half that holds none.
template <int D, int Prof, int Pose, int VM, class Pixels>
__device__ void sweep_mma(const Cluster& c, const float* x, float* sm,
                          const CoreLayout& L, float* acc, int lane,
                          const Pixels& px) {
  using RL = RowLayout<VM>;
  constexpr int NPX = RL::NPX;
  static_assert(VM + 1 > 8 && VM + 1 <= 16, "two 8-column blocks");
  static_assert(RL::Stride % 2 == 1, "the fragment loads need an odd stride");
  const int V = c.V;
  float* fp = sm + L.fp;
  const int* fs = reinterpret_cast<const int*>(sm + L.fs);
  float* ps = sm + L.pose;
  __syncwarp();
  stage_features<D, Prof, Pose>(c, x, fp, ps, lane);
  __syncwarp();
  const int s_bg = c.slot_idx[0];
  const int count = px.count();
  float* jrow = sm + L.jbuf + lane * RL::Stride;
  const float* zl = sm + L.jbuf + 8 * (lane & 3) * RL::Stride + (lane >> 2);
  double d[3][2] = {};   // tiles (0,0), (0,1), (1,1)
  for (int c0 = 0; c0 < count; c0 += 32 * NPX) {
    LMCORE_TRIP_ROWS(D, Prof, Pose, NPX, RL::Pitch)
#pragma unroll
    for (int t = 0; t < NPX; ++t)
      if (c0 + 32 * t + lane >= count)
        for (int s = 0; s <= V; ++s) jrow[t * RL::Pitch + s] = 0.f;
    __syncwarp();
    const int halves = min(NPX, (count - c0 + 31) / 32);
    for (int t = 0; t < halves; ++t) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float* z = zl + (32 * t + k) * RL::Stride;
        const double f0 = z[0], f1 = z[8];
        dmma(d[0], f0, f0);
        dmma(d[1], f0, f1);
        dmma(d[2], f1, f1);
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cu = 8 * (q == 2) + (lane >> 2);
      const int cv = 8 * (q > 0) + 2 * (lane & 3) + e;
      if (cu <= V && cv <= V && (q == 1 || cu <= cv)) {
        const int zu = cu == V ? 0 : cu + 1, zv = cv == V ? 0 : cv + 1;
        const int lo = min(zu, zv), hi = max(zu, zv);
        acc[hi * (hi + 1) / 2 + lo] = __double2float_rn(d[q][e]);
      }
    }
  }
  __syncwarp();
}

#undef LMCORE_TRIP_ROWS

// (H + λ·max(diag H, 1e-12) + 1e-10·I) δ = −g by Cholesky across the warp;
// returns δ_lane (0 on lanes >= V).  Lane i < V owns row i of the factor,
// a private row of `scratch` (shared, (V+1)·kJStride words; the stride is
// odd, so rows and columns are both free of bank conflicts), and lane V
// the row −g, which the factorization turns into y = L⁻¹(−g): the forward
// solve is the factor's recurrence on one more row.  Right-looking: at
// step j the pivot comes from lane j and L[m][j] from lane m by shuffle,
// and lane i subtracts L[i][j]·L[m][j] from its element (i, m), so every
// element takes its subtractions over k = 0, 1, ... as a serial
// factorization and forward solve do.  In the back substitution row r
// subtracts its products L[k][r]·δ_k over k = r+1, r+2, ... once δ_{r+1}
// is known (δ travels through `dl`, shared): the serial order again, so
// the step equals a serial solve bit for bit.  The loops are rolled on
// purpose: fully unrolled over register rows the solve alone was 16-80 KB
// of code, and having every lane prepare its products for the back
// substitution measured no faster than this.
__device__ inline float damped_solve(const float* acc, float lam, int V,
                                     int lane, float* scratch, float* dl) {
  const int i = lane;
  const bool row = i < V;
  const bool mine = i <= V;                  // a factor row, or −g
  float* Li = scratch + i * kJStride;
  const int base = (i + 1) * (i + 2) / 2;    // column i+1 of the items
  if (row) {
    for (int m = 0; m < i; ++m) Li[m] = acc[base + 1 + m];
  } else if (mine) {
    for (int m = 0; m < V; ++m) Li[m] = -acc[(m + 1) * (m + 2) / 2];
  }
  const float hii = row ? acc[base + 1 + i] : 1.f;
  const float d = hii > 1e-12f ? hii : 1e-12f;
  float diag = hii + lam * d + 1e-10f;       // element (i, i), then L[i][i]
  for (int j = 0; j < V; ++j) {
    const float s = __shfl_sync(kFullWarp, diag, j);
    const float dj = sqrtf(s < 1e-20f ? 1e-20f : s);
    float lij = 0.f;
    if (mine && i > j) {
      lij = Li[j] / dj;                      // divide, as ops/lm.py does
      Li[j] = lij;
    }
    if (i == j) diag = dj;
#pragma unroll 2
    for (int m = j + 1; m < V; ++m) {
      const float pr = lij * __shfl_sync(kFullWarp, lij, m);
      if (mine && i > m) Li[m] = Li[m] - pr;
      else if (i == m) diag = diag - pr;
    }
  }
  __syncwarp();
  const float y = row ? scratch[V * kJStride + i] : 0.f;
  float delta = 0.f;                          // back: Lᵀ δ = y
  for (int r = V - 1; r >= 0; --r) {
    if (i == r) {
      float t = y;
      for (int k = r + 1; k < V; ++k) t = t - scratch[k * kJStride + r] * dl[k];
      delta = t / diag;
      dl[r] = delta;
    }
    __syncwarp();
  }
  return delta;
}

// The whole LM solve of one cluster.  On entry xs (shared) holds the
// clipped start and the feature slots are staged (stage_slots); on exit
// xs holds the solution.  Every lane returns the same LMOut.  VM: the
// slot-count ceiling of a register instantiation (V <= VM), or 0.  Mma:
// the sweep's sums on the FP64 tensor cores (sweep_mma), for a register
// instantiation.
template <int D, int Prof, int Pose, int VM, bool Mma = false, class Pixels>
__device__ LMOut lm_run(const Cluster& c, const LMConf& m, float* sm,
                        const CoreLayout& L, int lane, const Pixels& px) {
  const int V = c.V;
  float* xs = sm + L.xs;
  float* xt = sm + L.xt;
  const int n_items = (V + 1) * (V + 2) / 2;
  int iu[kItemsPerLane], iv[kItemsPerLane];
  if constexpr (VM == 0) {
#pragma unroll
    for (int j = 0; j < kItemsPerLane; ++j) {
      iu[j] = 0; iv[j] = 0;
      if (lane + 32 * j < n_items) item_pair(lane + 32 * j, V, &iu[j], &iv[j]);
    }
  }

  // the two sweep sums, addressed from sm so that they stay shared-memory
  // accesses (a pointer picked from an array would be a generic one)
  auto acc = [&](int which) { return sm + L.acc + which * kMaxItems; };
  int cur = 0;
  float cost = 0.f;
  float lam = m.lam0;
  int iters = 0;
  bool conv = false;

  // Trip −1 is the sweep at the start; every later trip solves for a step
  // and sweeps the trial point.  One call site: the sweep is the bulk of
  // the kernel's code, and a second inlined copy would double it.
  for (int it = -1; it < m.max_iter; ++it) {
    const bool first = it < 0;
    if (!first) {
      // the trial row doubles as the solve's δ, read back before it is set
      const float delta = damped_solve(acc(cur), lam, V, lane, sm + L.jbuf, xt);
      __syncwarp();
      if (lane < V) xt[lane] = clip(xs[lane] + delta, m.lo[lane], m.hi[lane]);
    }
    float* out = acc(first ? cur : 1 - cur);
    if constexpr (Mma) {
      static_assert(VM > 0, "tensor-core sums need a register instantiation");
      sweep_mma<D, Prof, Pose, VM>(c, first ? xs : xt, sm, L, out, lane, px);
    } else {
      sweep<D, Prof, Pose, VM>(c, first ? xs : xt, sm, L, out, lane, iu, iv,
                               n_items, px);
    }
    if (first) {
      cost = out[0];
      continue;
    }
    const float c_trial = out[0];
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
