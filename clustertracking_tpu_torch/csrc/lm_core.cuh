// The Levenberg–Marquardt core shared by the port's LM kernels
// (fused_lm_2d.cu, pixel_lm.cu): one warp solves one cluster.
//
// Counterpart of the LM body every Pallas kernel of
// clustertracking_tpu/ops/pallas_lm.py shares (`kernel_impl`,
// pallas_lm.py:446-1141): per-feature parameters staged once per sweep,
// the gauss-family model and its analytic Jacobian per pixel, cost, g = Jᵀr
// and the upper triangle of H = JᵀJ summed over the pixels, the damped
// Cholesky step, the projected trial point and the accept / λ / ftol /
// xtol / plateau / stuck rules of ops/lm.py::lm_solve.
//
// What differs between the kernels is only where a pixel comes from.  A
// kernel hands the sweep a `Pixels` object with
//     int count() const;                 // pixels of the sweep
//     void load(int k, float* off, float& val, float& wc) const;
// giving pixel k's window offsets (D floats, outermost axis first), its
// value and its weight (fit mask · 1/norm).  Pixels are visited in order
// k = 0, 1, ..., 32 at a time.
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

// Per-feature staging for a rank-D window.  Floats: signal·fvalid,
// rel[D] (position − window corner), size[D] (isotropic: the one size
// repeated), fvalid.  Ints: slots of signal, position[D], size[D]
// (isotropic: the size slot first, the others −1).  Parameters are in
// param_names_for order: background, signal, position[D], size[1|D].
template <int D>
struct Feat {
  static constexpr int F = 2 + 2 * D;
  static constexpr int I = 1 + 2 * D;
};

// The core's per-warp shared memory, in 4-byte words, placed after the
// `base` words a kernel keeps for its own pixels.
struct CoreLayout {
  int jbuf, acc, xs, xt, dl, fp, fs, chol, total;
};

template <int D>
__host__ __device__ inline CoreLayout core_layout(int base) {
  CoreLayout L;
  int o = base;
  L.jbuf = o; o += 32 * kJStride;                       // [32][V+1] J + r
  L.acc = o;  o += 2 * kMaxItems;                       // two sweep sums
  L.xs = o;   o += kMaxSlots;                           // current x
  L.xt = o;   o += kMaxSlots;                           // trial x
  L.dl = o;   o += kMaxSlots;                           // step
  L.fp = o;   o += kMaxFeatures * Feat<D>::F + 1;       // params + bg
  L.fs = o;   o += kMaxFeatures * Feat<D>::I;           // slots (int)
  L.chol = o; o += kMaxSlots * kMaxSlots;               // Cholesky factor
  L.total = o;
  return L;
}

// One cluster's problem, as the sweep reads it.
struct Cluster {
  const float* cp;       // [n, P] this cluster's const parameters
  const float* fvalid;   // [n]
  const int* slot_idx;   // [n, P], −1 = const
  float org[3];          // window corner, outermost axis first
  int n, P, V, iso;
};

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

// Feature slots, staged once per solve (lanes < n).
template <int D>
__device__ inline void stage_slots(const Cluster& c, int* fs, int lane) {
  if (lane < c.n) {
    const int* si = c.slot_idx + lane * c.P;
    int* f = fs + lane * Feat<D>::I;
    f[0] = si[1];
#pragma unroll
    for (int d = 0; d < D; ++d) f[1 + d] = si[2 + d];
#pragma unroll
    for (int d = 0; d < D; ++d)
      f[1 + D + d] = c.iso ? (d == 0 ? si[2 + D] : -1) : si[2 + D + d];
  }
}

// Feature parameters at x, staged once per sweep (lanes < n).
template <int D>
__device__ inline void stage_features(const Cluster& c, const float* x,
                                      float* fp, int lane) {
  if (lane < c.n) {
    const int i = lane;
    const float* cpi = c.cp + i * c.P;
    const int* si = c.slot_idx + i * c.P;
    auto prow = [&](int q) { return si[q] >= 0 ? x[si[q]] : cpi[q]; };
    const float fv = c.fvalid[i];
    float* f = fp + i * Feat<D>::F;
    f[0] = prow(1) * fv;
#pragma unroll
    for (int d = 0; d < D; ++d) f[1 + d] = prow(2 + d) - c.org[d];
#pragma unroll
    for (int d = 0; d < D; ++d) f[1 + D + d] = prow(2 + D + (c.iso ? 0 : d));
    f[1 + 2 * D] = fv;
    if (i == 0) fp[kMaxFeatures * Feat<D>::F] = prow(0);
  }
}

// One pixel's weighted residual and Jacobian row, added into jrow[0..V]
// (zeroed by the caller).  The profile is evaluated here and nowhere
// else: the gauss exp(−r²/2), with dI/dr² = −f/2 reusing f.
template <int D>
__device__ inline void pixel_row(const float* off, float val, float wc,
                                 const float* fp, const int* fs, int n,
                                 int iso, int s_bg, int V, float* jrow) {
  if (s_bg >= 0) jrow[s_bg] += wc;
  float model = 0.f;  // Σ signal·f, then + background (the plain order)
  for (int i = 0; i < n; ++i) {
    const float* f = fp + i * Feat<D>::F;
    const int* s = fs + i * Feat<D>::I;
    const float sig = f[0], fv = f[1 + 2 * D];
    float dd[D];
    float r2 = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dd[d] = (off[d] - f[1 + d]) / f[1 + D + d];
      r2 = r2 + dd[d] * dd[d];
    }
    const float fe = expf(-0.5f * r2);
    model = model + sig * fe;
    const float sig_df = sig * (-0.5f * fe);
    if (s[0] >= 0) jrow[s[0]] += fe * wc * fv;
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (s[1 + d] >= 0)
        jrow[s[1 + d]] += sig_df * (-2.f) * dd[d] / f[1 + D + d] * wc;
    if (iso) {
      if (s[1 + D] >= 0)
        jrow[s[1 + D]] += sig_df * (-2.f) * r2 / f[1 + D] * wc;
    } else {
#pragma unroll
      for (int d = 0; d < D; ++d)
        if (s[1 + D + d] >= 0)
          jrow[s[1 + D + d]] +=
              sig_df * (-2.f) * dd[d] * dd[d] / f[1 + D + d] * wc;
    }
  }
  jrow[V] = ((fp[kMaxFeatures * Feat<D>::F] + model) - val) * wc;
}

// One residual + Jacobian sweep at x (shared, length V): writes cost, g
// and the upper triangle of H into acc (shared).
template <int D, class Pixels>
__device__ void sweep(const Cluster& c, const float* x, float* sm,
                      const CoreLayout& L, float* acc, int lane,
                      const int* iu, const int* iv, int n_items,
                      const Pixels& px) {
  const int V = c.V;
  float* fp = sm + L.fp;
  const int* fs = reinterpret_cast<const int*>(sm + L.fs);
  __syncwarp();
  stage_features<D>(c, x, fp, lane);
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
      pixel_row<D>(off, val, wc, fp, fs, c.n, c.iso, s_bg, V, jrow);
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
template <int D, class Pixels>
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
  sweep<D>(c, xs, sm, L, acc[cur], lane, iu, iv, n_items, px);
  float cost = acc[cur][0];
  float lam = m.lam0;
  int iters = 0;
  bool conv = false;

  for (int it = 0; it < m.max_iter; ++it) {
    if (lane == 0) damped_solve(acc[cur], lam, V, sm + L.chol, dl);
    __syncwarp();
    if (lane < V) xt[lane] = clip(xs[lane] + dl[lane], m.lo[lane], m.hi[lane]);
    sweep<D>(c, xt, sm, L, acc[1 - cur], lane, iu, iv, n_items, px);
    const float c_trial = acc[1 - cur][0];
    const bool accept = c_trial < cost;
    float xnorm = 0.f, snorm = 0.f;
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
