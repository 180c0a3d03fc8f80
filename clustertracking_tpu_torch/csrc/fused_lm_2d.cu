// Fused window-gather + Levenberg–Marquardt solve for 2D gauss-model
// cluster buckets, one warp per cluster.
//
// Replaces the TPU kernel ops/pallas_lm.py::make_pallas_lm.kernel_fused
// (clustertracking_tpu/ops/pallas_lm.py:1213, entered by solve_fused),
// which computes the same function in 128-lane tiles: it cuts each
// cluster's window out of the frame stack, builds the within-radius fit
// mask once from the gather-time positions, and runs the whole masked LM
// solve (one Jacobian sweep per iteration, Marquardt damping, projected
// trial point, ftol/xtol/plateau/stuck tests) without leaving the chip.
//
// What bounds it on the H100: nothing is read from device memory inside
// the LM loop — the window (wy·wx floats) and its mask are staged in
// shared memory once per solve, so the kernel is bound by the per-pixel
// arithmetic of the Jacobian sweeps (one expf and ~20 FLOPs per feature
// per pixel, then V(V+3)/2+1 products per pixel for cost, g = Jᵀr and the
// upper triangle of H = JᵀJ).  The design spreads that work over the warp:
//   * the 32 lanes stride over the window's pixels; each lane writes its
//     pixel's residual and Jacobian row into a per-warp shared tile
//     [32 pixels][V+1];
//   * the V(V+3)/2+1 sums (cost, g, H) are then owned by the lanes (lane l
//     owns items l, l+32, ...), each summing its products over the 32
//     pixels of the tile, so no shuffle tree and no per-lane register
//     copy of H is needed and V is a run-time argument below kMaxSlots;
//   * the V×V damped Cholesky is serial on lane 0 in shared memory (V³/6
//     FMAs, small next to a sweep);
//   * each cluster leaves its LM loop on its own when it converges — the
//     reference's lockstep freezes converged lanes, so per-lane results
//     are the same, and no warp waits for another.
// Shared memory per warp is ~2·wy·wx + 1.9k floats, so a 13×13 window
// takes ~9 KB and a block holds up to 4 warps.
//
// Numerics follow the reference kernel: the mask is computed as
// (off − rel)·(1/r) with explicit _rn intrinsics, so npix matches it
// exactly; the weight is mask·(1/norm); the Cholesky pivot is clamped at
// 1e-20.  The library is built with -fmad=false (ops/_build.py), so every
// product and sum rounds as the plain PyTorch version's elementwise ops
// do: near a fit's noise floor the cost is a difference of nearly equal
// float32 numbers, and FMA contraction alone moved it by up to 5.7e-3
// relative.  Sums over pixels run in pixel order, so results agree with
// the plain version to float32 rounding, not bit for bit.  Build without
// --use_fast_math: expf accuracy moves accept decisions.
//
// Lanes with valid == 0 are not solved: x = clip(x0), cost = 0,
// n_iter = 0, converged = 0, npix = 0 (what the reference kernel writes
// for a frozen tile).  A lane whose frame index or window lies outside
// the frame stack is not read: its x and cost are NaN and npix is 0.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxSlots = 20;                        // V cap (V < 20 routed)
constexpr int kMaxFeatures = 32;                     // n cap
constexpr int kJStride = kMaxSlots + 1;              // J row + residual
constexpr int kMaxItems = 1 + kMaxSlots + kMaxSlots * (kMaxSlots + 1) / 2;
constexpr int kItemsPerLane = (kMaxItems + 31) / 32;
constexpr int kFeatF = 6;    // sig·fv, rel_y, rel_x, s_y, s_x, fv
constexpr int kFeatI = 5;    // slots: signal, y, x, size_y, size_x

struct Problem {
  const float* frames;
  int T, H, W;
  const int* frame_idx;      // [B]
  const int* origin;         // [B, 2]
  const float* x0;           // [B, V]
  const float* cp;           // [B, n, P]
  const float* pos_at;       // [B, n, 2]
  const float* norm;         // [B]
  const int* valid;          // [B]
  const float* fvalid;       // [B, n]
  const int* slot_idx;       // [n, P]
  const float* lo;           // [V]
  const float* hi;           // [V]
  int B, n, P, V, iso, wy, wx;
  float inv_ry, inv_rx;
  int max_iter;
  float ftol, xtol, lam0, lam_up, lam_down, lam_max, plateau;
  float* x_out;              // [B, V]
  float* cost;               // [B]
  int* n_iter;               // [B]
  int* converged;            // [B]
  float* npix;               // [B]
};

// Per-warp shared-memory layout, in 4-byte words.
struct Layout {
  int win, w, jbuf, acc, xs, xt, dl, fp, fs, chol, total;
};

__host__ __device__ inline Layout warp_layout(int npix) {
  Layout L;
  int o = 0;
  L.win = o;  o += npix;                      // window pixels
  L.w = o;    o += npix;                      // mask·(1/norm)
  L.jbuf = o; o += 32 * kJStride;             // [32][V+1] J rows + r
  L.acc = o;  o += 2 * kMaxItems;             // two sweep accumulators
  L.xs = o;   o += kMaxSlots;                 // current x
  L.xt = o;   o += kMaxSlots;                 // trial x
  L.dl = o;   o += kMaxSlots;                 // step
  L.fp = o;   o += kMaxFeatures * kFeatF + 1; // per-feature params + bg
  L.fs = o;   o += kMaxFeatures * kFeatI;     // per-feature slots (int)
  L.chol = o; o += kMaxSlots * kMaxSlots;     // Cholesky factor
  L.total = o;
  return L;
}

__device__ inline float clip(float v, float lo, float hi) {
  v = v < lo ? lo : v;   // NaN passes through, as jnp.maximum/minimum
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

// One residual + Jacobian sweep at parameter vector x (shared, length V):
// writes cost, g and the upper triangle of H into acc (shared).
__device__ void sweep(const Problem& p, int b, const float* x, float* sm,
                      const Layout& L, float* acc, int lane,
                      const int* iu, const int* iv, int n_items) {
  const int n = p.n, P = p.P, V = p.V;
  float* fp = sm + L.fp;
  const int* fs = reinterpret_cast<const int*>(sm + L.fs);
  const float oy = (float)p.origin[2 * b], ox = (float)p.origin[2 * b + 1];
  __syncwarp();
  if (lane < n) {
    const int i = lane;
    const float* cpi = p.cp + ((size_t)b * n + i) * P;
    const int* si = p.slot_idx + i * P;
    auto prow = [&](int q) { return si[q] >= 0 ? x[si[q]] : cpi[q]; };
    const float fv = p.fvalid[(size_t)b * n + i];
    fp[i * kFeatF + 0] = prow(1) * fv;
    fp[i * kFeatF + 1] = prow(2) - oy;
    fp[i * kFeatF + 2] = prow(3) - ox;
    fp[i * kFeatF + 3] = prow(4);
    fp[i * kFeatF + 4] = p.iso ? prow(4) : prow(5);
    fp[i * kFeatF + 5] = fv;
    if (i == 0) fp[kMaxFeatures * kFeatF] = prow(0);
  }
  __syncwarp();
  const float bg = fp[kMaxFeatures * kFeatF];
  const int s_bg = p.slot_idx[0];
  const int npx = p.wy * p.wx;
  float* jrow = sm + L.jbuf + lane * kJStride;
  const float* win = sm + L.win;
  const float* wgt = sm + L.w;

  float a[kItemsPerLane];
#pragma unroll
  for (int j = 0; j < kItemsPerLane; ++j) a[j] = 0.f;

  for (int c0 = 0; c0 < npx; c0 += 32) {
    const int q = c0 + lane;
    for (int s = 0; s <= V; ++s) jrow[s] = 0.f;
    if (q < npx) {
      const int qy = q / p.wx;
      const float offy = (float)qy, offx = (float)(q - qy * p.wx);
      const float wc = wgt[q];
      if (s_bg >= 0) jrow[s_bg] += wc;
      float model = 0.f;  // Σ signal·f, then + background (plain order)
      for (int i = 0; i < n; ++i) {
        const float* f6 = fp + i * kFeatF;
        const int* s5 = fs + i * kFeatI;
        const float sig = f6[0], sy = f6[3], sx = f6[4], fv = f6[5];
        const float dy = (offy - f6[1]) / sy;
        const float dx = (offx - f6[2]) / sx;
        const float r2 = dy * dy + dx * dx;
        const float f = expf(-0.5f * r2);
        model = model + sig * f;
        const float sig_df = sig * (-0.5f * f);
        if (s5[0] >= 0) jrow[s5[0]] += f * wc * fv;
        if (s5[1] >= 0) jrow[s5[1]] += sig_df * (-2.f) * dy / sy * wc;
        if (s5[2] >= 0) jrow[s5[2]] += sig_df * (-2.f) * dx / sx * wc;
        if (p.iso) {
          if (s5[3] >= 0) jrow[s5[3]] += sig_df * (-2.f) * r2 / sy * wc;
        } else {
          if (s5[3] >= 0) jrow[s5[3]] += sig_df * (-2.f) * dy * dy / sy * wc;
          if (s5[4] >= 0) jrow[s5[4]] += sig_df * (-2.f) * dx * dx / sx * wc;
        }
      }
      jrow[V] = ((bg + model) - win[q]) * wc;
    }
    __syncwarp();
    const float* jb = sm + L.jbuf;
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
__device__ void damped_solve(const float* acc, float lam, int V, float* Lm,
                             float* delta) {
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

__global__ void fused_lm_2d_kernel(Problem p, int warps_per_block) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * warps_per_block + warp;
  if (b >= p.B) return;
  const int npx = p.wy * p.wx;
  const Layout L = warp_layout(npx);
  float* sm = smem + (size_t)warp * L.total;
  const int V = p.V, n = p.n;
  float* xs = sm + L.xs;
  float* xt = sm + L.xt;
  float* dl = sm + L.dl;

  if (lane < V) xs[lane] = clip(p.x0[(size_t)b * V + lane], p.lo[lane], p.hi[lane]);
  const int fi = p.frame_idx[b];
  const int oy = p.origin[2 * b], ox = p.origin[2 * b + 1];
  const bool inside = fi >= 0 && fi < p.T && oy >= 0 && ox >= 0 &&
                      oy + p.wy <= p.H && ox + p.wx <= p.W;
  __syncwarp();
  if (!p.valid[b] || !inside) {
    const float bad = inside ? 0.f : __int_as_float(0x7fc00000);
    if (lane < V) p.x_out[(size_t)b * V + lane] = inside ? xs[lane] : bad;
    if (lane == 0) {
      p.cost[b] = bad;
      p.n_iter[b] = 0;
      p.converged[b] = 0;
      p.npix[b] = 0.f;
    }
    return;
  }

  // Stage the window and the fit mask (computed once, from the
  // gather-time positions, as the reference kernel does).
  int* fs = reinterpret_cast<int*>(sm + L.fs);
  if (lane < n) {
    const int* si = p.slot_idx + lane * p.P;
    fs[lane * kFeatI + 0] = si[1];
    fs[lane * kFeatI + 1] = si[2];
    fs[lane * kFeatI + 2] = si[3];
    fs[lane * kFeatI + 3] = si[4];
    fs[lane * kFeatI + 4] = p.iso ? -1 : si[5];
  }
  const float inv_norm = 1.f / p.norm[b];
  const float* frame = p.frames + (size_t)fi * p.H * p.W;
  const float orgy = (float)oy, orgx = (float)ox;
  int cnt = 0;
  for (int q = lane; q < npx; q += 32) {
    const int qy = q / p.wx, qx = q - qy * p.wx;
    const float offy = (float)qy, offx = (float)qx;
    bool hit = false;
    for (int i = 0; i < n; ++i) {
      if (!(p.fvalid[(size_t)b * n + i] > 0.5f)) continue;
      const float* pa = p.pos_at + ((size_t)b * n + i) * 2;
      const float dmy = __fmul_rn(__fsub_rn(offy, __fsub_rn(pa[0], orgy)), p.inv_ry);
      const float dmx = __fmul_rn(__fsub_rn(offx, __fsub_rn(pa[1], orgx)), p.inv_rx);
      const float r2m = __fadd_rn(__fmul_rn(dmy, dmy), __fmul_rn(dmx, dmx));
      hit = hit || (r2m <= 1.f);
    }
    sm[L.win + q] = frame[(size_t)(oy + qy) * p.W + (ox + qx)];
    sm[L.w + q] = hit ? inv_norm : 0.f;
    cnt += hit ? 1 : 0;
  }
  for (int off = 16; off > 0; off >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, off);

  const int n_items = 1 + V + V * (V + 1) / 2;
  int iu[kItemsPerLane], iv[kItemsPerLane];
#pragma unroll
  for (int j = 0; j < kItemsPerLane; ++j) {
    iu[j] = 0; iv[j] = 0;
    if (lane + 32 * j < n_items) item_pair(lane + 32 * j, V, &iu[j], &iv[j]);
  }

  float* acc[2] = {sm + L.acc, sm + L.acc + kMaxItems};
  int cur = 0;
  sweep(p, b, xs, sm, L, acc[cur], lane, iu, iv, n_items);
  float cost = acc[cur][0];
  float lam = p.lam0;
  int iters = 0;
  bool conv = false;

  for (int it = 0; it < p.max_iter; ++it) {
    if (lane == 0) damped_solve(acc[cur], lam, V, sm + L.chol, dl);
    __syncwarp();
    if (lane < V) xt[lane] = clip(xs[lane] + dl[lane], p.lo[lane], p.hi[lane]);
    sweep(p, b, xt, sm, L, acc[1 - cur], lane, iu, iv, n_items);
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
      lam_new = lam * p.lam_down;
    } else {
      lam_new = fminf(lam * p.lam_up, p.lam_max);
    }
    const bool conv_x = accept && (snorm <= p.xtol * (p.xtol + xnorm));
    const bool conv_f = accept && ((cost - c_trial) <= p.ftol * fmaxf(cost, 1e-30f));
    const bool plateau = (lam_new >= p.plateau) && isfinite(cost_new);
    const bool stuck = lam_new >= p.lam_max;
    const bool conv_now = conv_x || conv_f || plateau;
    ++iters;
    conv = conv || conv_now;
    cost = cost_new;
    lam = lam_new;
    __syncwarp();
    if (conv_now || stuck) break;
  }

  if (lane < V) p.x_out[(size_t)b * V + lane] = xs[lane];
  if (lane == 0) {
    p.cost[b] = cost;
    p.n_iter[b] = iters;
    p.converged[b] = conv ? 1 : 0;
    p.npix[b] = (float)cnt;
  }
}

}  // namespace

extern "C" int fused_lm_2d_smem_words(int npix) {
  return warp_layout(npix).total;
}

// Launches the solve on `stream`.  Returns the cudaGetLastError() code of
// the launch (0 = cudaSuccess), or cudaErrorInvalidValue for a problem the
// kernel does not take.
extern "C" int fused_lm_2d_launch(
    const float* frames, int T, int H, int W,
    const int* frame_idx, const int* origin, const float* x0,
    const float* cp, const float* pos_at, const float* norm,
    const int* valid, const float* fvalid, const int* slot_idx,
    const float* lo, const float* hi,
    int B, int n, int P, int V, int iso, int wy, int wx,
    float inv_ry, float inv_rx, int max_iter, float ftol, float xtol,
    float lam0, float lam_up, float lam_down, float lam_max, float plateau,
    float* x_out, float* cost, int* n_iter, int* converged, float* npix,
    void* stream) {
  if (V < 1 || V > kMaxSlots || n < 1 || n > kMaxFeatures ||
      P != (iso ? 5 : 6) || wy < 1 || wx < 1 || B < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return 0;
  const size_t warp_bytes = sizeof(float) * (size_t)warp_layout(wy * wx).total;
  constexpr size_t kBlockBudget = 200 * 1024;
  int wpb = (int)(kBlockBudget / warp_bytes);
  if (wpb > 4) wpb = 4;
  if (wpb < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = warp_bytes * wpb;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_lm_2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  Problem p{frames, T, H, W, frame_idx, origin, x0, cp, pos_at, norm, valid,
            fvalid, slot_idx, lo, hi, B, n, P, V, iso, wy, wx, inv_ry, inv_rx,
            max_iter, ftol, xtol, lam0, lam_up, lam_down, lam_max, plateau,
            x_out, cost, n_iter, converged, npix};
  const int blocks = (B + wpb - 1) / wpb;
  fused_lm_2d_kernel<<<blocks, 32 * wpb, smem, (cudaStream_t)stream>>>(p, wpb);
  return (int)cudaGetLastError();
}
