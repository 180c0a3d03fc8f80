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
// the LM loop — the window (wy·wx floats) and its mask weights are staged
// in shared memory once per solve, so the kernel is bound by the
// per-pixel arithmetic of the Jacobian sweeps.  The sweeps, the damped
// Cholesky and the LM rules are the shared core in lm_core.cuh (one warp
// per cluster, lanes over pixels, lanes own the cost/g/H sums); this file
// only stages the window and hands the core every window pixel in raster
// order, out-of-mask pixels with weight 0.  Shared memory per warp is
// 2·wy·wx + 1,947 words, so a 13×13 window takes ~9 KB and a block holds
// up to 4 warps.
//
// Numerics follow the reference kernel: the mask is computed as
// (off − rel)·(1/r) with explicit _rn intrinsics, so npix matches it
// exactly; the weight is mask·(1/norm).  Sums over pixels run in pixel
// order, so results agree with the plain version to float32 rounding, not
// bit for bit (lm_core.cuh says why the build has -fmad=false).  Build
// without --use_fast_math: expf accuracy moves accept decisions.
//
// Lanes with valid == 0 are not solved: x = clip(x0), cost = 0,
// n_iter = 0, converged = 0, npix = 0 (what the reference kernel writes
// for a frozen tile).  A lane whose frame index or window lies outside
// the frame stack is not read: its x and cost are NaN and npix is 0.

#include "lm_core.cuh"

namespace {

using namespace lmcore;

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
  int B, n, P, V, iso, wy, wx;
  float inv_ry, inv_rx;
  LMConf lm;
  float* x_out;              // [B, V]
  float* cost;               // [B]
  int* n_iter;               // [B]
  int* converged;            // [B]
  float* npix;               // [B]
};

// The whole staged window in raster order; out-of-mask pixels weigh 0.
struct WindowPixels {
  const float* win;
  const float* w;
  int npx, wx;
  __device__ int count() const { return npx; }
  __device__ void load(int q, float* off, float& val, float& wc) const {
    const int qy = q / wx;
    off[0] = (float)qy;
    off[1] = (float)(q - qy * wx);
    val = win[q];
    wc = w[q];
  }
};

// Per-warp shared memory: the window, its weights, then the LM core.
__host__ __device__ inline CoreLayout warp_layout(int npix) {
  return core_layout<2>(2 * npix);
}

__global__ void fused_lm_2d_kernel(Problem p, int warps_per_block) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * warps_per_block + warp;
  if (b >= p.B) return;
  const int npx = p.wy * p.wx;
  const CoreLayout L = warp_layout(npx);
  float* sm = smem + (size_t)warp * L.total;
  float* win = sm;
  float* wgt = sm + npx;
  const int V = p.V, n = p.n;
  float* xs = sm + L.xs;

  if (lane < V) xs[lane] = clip(p.x0[(size_t)b * V + lane], p.lm.lo[lane], p.lm.hi[lane]);
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

  const Cluster c{p.cp + (size_t)b * n * p.P, p.fvalid + (size_t)b * n,
                  p.slot_idx, {(float)oy, (float)ox, 0.f}, n, p.P, V, p.iso};
  stage_slots<2>(c, reinterpret_cast<int*>(sm + L.fs), lane);

  // Stage the window and the fit mask (computed once, from the
  // gather-time positions, as the reference kernel does).
  const float inv_norm = 1.f / p.norm[b];
  const float* frame = p.frames + (size_t)fi * p.H * p.W;
  const float orgy = (float)oy, orgx = (float)ox;
  int cnt = 0;
  for (int q = lane; q < npx; q += 32) {
    const int qy = q / p.wx, qx = q - qy * p.wx;
    const float offy = (float)qy, offx = (float)qx;
    bool hit = false;
    for (int i = 0; i < n; ++i) {
      if (!(c.fvalid[i] > 0.5f)) continue;
      const float* pa = p.pos_at + ((size_t)b * n + i) * 2;
      const float dmy = __fmul_rn(__fsub_rn(offy, __fsub_rn(pa[0], orgy)), p.inv_ry);
      const float dmx = __fmul_rn(__fsub_rn(offx, __fsub_rn(pa[1], orgx)), p.inv_rx);
      const float r2m = __fadd_rn(__fmul_rn(dmy, dmy), __fmul_rn(dmx, dmx));
      hit = hit || (r2m <= 1.f);
    }
    win[q] = frame[(size_t)(oy + qy) * p.W + (ox + qx)];
    wgt[q] = hit ? inv_norm : 0.f;
    cnt += hit ? 1 : 0;
  }
  for (int off = 16; off > 0; off >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, off);

  const LMOut r = lm_run<2>(c, p.lm, sm, L, lane, WindowPixels{win, wgt, npx, p.wx});

  if (lane < V) p.x_out[(size_t)b * V + lane] = xs[lane];
  if (lane == 0) {
    p.cost[b] = r.cost;
    p.n_iter[b] = r.iters;
    p.converged[b] = r.conv ? 1 : 0;
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
  const LMConf lm{lo, hi, max_iter, ftol, xtol, lam0, lam_up, lam_down,
                  lam_max, plateau};
  Problem p{frames, T, H, W, frame_idx, origin, x0, cp, pos_at, norm, valid,
            fvalid, slot_idx, B, n, P, V, iso, wy, wx, inv_ry, inv_rx, lm,
            x_out, cost, n_iter, converged, npix};
  const int blocks = (B + wpb - 1) / wpb;
  fused_lm_2d_kernel<<<blocks, 32 * wpb, smem, (cudaStream_t)stream>>>(p, wpb);
  return (int)cudaGetLastError();
}
