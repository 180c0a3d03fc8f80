// The LM solve of one bucket of large clusters: one thread block per
// cluster, the whole Levenberg–Marquardt loop on the device.
//
// Counterpart of the reference's XLA route for unconstrained buckets of 20
// slots or more: clustertracking_tpu/refine.py:553-558 calls
// ops/lm.py::lm_solve (:158) with the closures of
// ops/residual.py::make_model_fns (:67).  No Pallas kernel exists for
// them: the reference sends every bucket at or past its MXU crossover
// (pallas_lm.py:225-236) to XLA.  The plain PyTorch version is
// ops/block_lm.py::block_lm_reference, the same lm_solve call.
//
// What it computes, per cluster (block b): the masked, weighted residual
// r = (model − pixel)·(mask / norm) and its analytic Jacobian over the
// window's in-mask pixels, the sums cost = Σr², g = Jᵀr and H = JᵀJ, the
// Marquardt-damped Cholesky step, the projected trial point and the
// accept / λ / ftol / xtol / plateau / stuck rules of ops/lm.py::lm_solve,
// until the cluster converges or sticks (the reference freezes such lanes
// of its lockstep loop, so per-lane results are the same).  A lane with
// valid 0 gets its clipped start, the cost there, 0 iterations.
//
// What bounds it on an H100.  A sweep costs (V+1)(V+2)/2 products and sums
// per in-mask pixel for cost, g and H, against n·O(20) for the model and
// its Jacobian row: at config 5's chains (V = 24–60) the sums are most of
// the arithmetic, and nothing but the window's pixels comes from device
// memory (once a sweep, from L2).  The damped Cholesky is V³/6 products
// an iteration, a chain of V dependent steps.  The design:
//   * a sweep takes the in-mask pixels 256 at a time (their list is built
//     once a launch, in ascending order, into a global scratch row); each
//     thread writes one pixel's augmented row z = [r, J_0 .. J_{V-1}] into
//     a shared tile, the model's chain rule as make_model_fns has it;
//   * the sums are a per-block SYRK on the SIMT pipes: each thread owns up
//     to three 4×4 blocks of the upper triangle of zᵀz and adds the
//     chunk's rows into registers in ascending pixel order, two 16-byte
//     shared loads for 16 products.  It adds in FP64 (DFMA: the product
//     of two floats is exact) and rounds each sum to FP32 once.  A
//     sequential FP32 sum over a few hundred pixels strays further from
//     the exact sum than the plain version's blocked sums do, and on a
//     flat minimum that decides which trial steps are
//     accepted: with FP32 sums, lanes of config 5's chains ended more
//     than 1e-3 px from the plain version's point;
//   * the Cholesky is right-looking in shared memory, the threads over the
//     rows for a column's division and over the trailing triangle for its
//     update, so each element takes its subtractions over k = 0, 1, ... as
//     a serial factorization does; −g rides along as one more row, which
//     the factorization turns into y = L⁻¹(−g); one warp substitutes back;
//   * no tensor cores (TF32 would move accept decisions) and no TMA: the
//     simple design first.
//
// Numerics, because they decide accepts: the library is built with
// -fmad=false and without fast math (ops/_build.py), so each product and
// sum of a pixel's row rounds as the plain version's separate ops do, and
// the sums over pixels are FP64 (above); the weight is mask / norm,
// formed before it multiplies; the damping is
// (H_ii + λ·max(H_ii, 1e-12)) + 1e-10 on the diagonal.  At V ≤ 20 the
// pivot is clamped, sqrt(max(s, 1e-20)), as ops/lm.py::_chol_solve_unrolled
// does; above, a pivot that is not positive rejects the step (no trial
// sweep; the plain version's cholesky_ex gives NaN and a NaN trial cost).
// Sums run in another order than the plain version's einsum, so the two
// agree to rounding, not bit for bit.
#include <cuda_runtime.h>

#include "lm_core.cuh"

namespace {

using lmcore::Feat;
using lmcore::ProfileExtras;

constexpr int kThreads = 256;           // threads a block; pixel rows a chunk
constexpr int kWarps = kThreads / 32;
constexpr int kBlockMaxSlots = 128;     // V cap
constexpr int kBlockMaxFeatures = 64;   // n cap
constexpr int kUnrollMaxSlots = 20;     // ops/lm.py::_UNROLL_MAX_V
constexpr int kMaxBlocksPerThread = 3;  // 4×4 blocks of zᵀz a thread owns
constexpr int kMisc = 4 + kWarps;       // background, count, ok, warp counts

// Shared memory of one block, in 4-byte words, for V slots, n features.
struct Layout {
  int kp;      // tile row stride: V+1 rounded up to whole 4×4 blocks
  int nb;      // 4-column blocks of a row
  int ni;      // items (V+1)(V+2)/2
  int tile, acc0, acc1, xs, xt, dl, piv, fp, fs, misc, total;
};

template <int D, int Prof>
__host__ __device__ inline Layout block_layout(int V, int n) {
  using FT = Feat<D, ProfileExtras<Prof>::N>;
  Layout L;
  const int K = V + 1;
  L.nb = (K + 3) / 4;
  L.kp = 4 * L.nb;
  L.ni = K * (K + 1) / 2;
  int o = 0;
  L.tile = o; o += kThreads * L.kp;   // the rows; the solve's factor
  L.acc0 = o; o += L.ni;              // the two sweep sums
  L.acc1 = o; o += L.ni;
  L.xs = o;   o += L.kp;              // current x
  L.xt = o;   o += L.kp;              // trial x
  L.dl = o;   o += L.kp;              // y, then the step δ
  L.piv = o;  o += L.kp;              // the factor's diagonal
  L.fp = o;   o += n * FT::F;         // feature parameters at x
  L.fs = o;   o += n * (FT::I + 1);   // feature slots (int), background first
  L.misc = o; o += kMisc;
  L.total = o;
  return L;
}

struct Problem {
  const float* pixels;   // [B, Npix]
  const float* mask;     // [B, Npix]
  const int* origin;     // [B, D]
  const float* x0;       // [B, V]
  const float* cp;       // [B, n, P]
  const float* norm;     // [B]
  const int* valid;      // [B]
  const float* fvalid;   // [B, n]
  const int* slot_idx;   // [n, P]
  const float* lo;       // [V]
  const float* hi;       // [V]
  int* scratch;          // [B, Npix]: the in-mask pixel list
  int n, P, V, iso, nx, npix;
  int wz, wy, wx;
  int max_iter;
  float ftol, xtol, lam0, lam_up, lam_down, lam_max, plateau;
  float* x_out;          // [B, V]
  float* cost;           // [B]
  int* n_iter;           // [B]
  int* conv;             // [B]
};

// Builds the block's in-mask pixel list (ascending window index) in its
// scratch row; returns its length on every thread.
__device__ int compact_mask(const Problem& p, int b, float* misc) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int* wcount = reinterpret_cast<int*>(misc + 4);
  int* list = p.scratch + (size_t)b * p.npix;
  const float* mask = p.mask + (size_t)b * p.npix;
  int count = 0;
  for (int base = 0; base < p.npix; base += kThreads) {
    const int k = base + t;
    const bool in = k < p.npix && mask[k] != 0.f;
    const unsigned ballot = __ballot_sync(lmcore::kFullWarp, in);
    if (lane == 0) wcount[warp] = __popc(ballot);
    __syncthreads();
    int before = count, total = count;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) before += wcount[w];
      total += wcount[w];
    }
    if (in) list[before + __popc(ballot & ((1u << lane) - 1u))] = k;
    count = total;
    __syncthreads();
  }
  return count;
}

// The feature parameters at x (threads < n) and the background.
template <int D, int Prof>
__device__ void stage_features(const Problem& p, int b, const float* x,
                               float* fp, float* misc) {
  using FT = Feat<D, ProfileExtras<Prof>::N>;
  const int i = threadIdx.x;
  if (i >= p.n) return;
  const float* cpi = p.cp + ((size_t)b * p.n + i) * p.P;
  const int* si = p.slot_idx + i * p.P;
  auto prow = [&](int q) { return si[q] >= 0 ? x[si[q]] : cpi[q]; };
  const float fv = p.fvalid[(size_t)b * p.n + i];
  float* f = fp + i * FT::F;
  f[0] = prow(1) * fv;
#pragma unroll
  for (int d = 0; d < D; ++d)
    f[1 + d] = prow(2 + d) - (float)p.origin[b * D + d];
#pragma unroll
  for (int d = 0; d < D; ++d) f[1 + D + d] = prow(2 + D + (p.iso ? 0 : d));
  f[1 + 2 * D] = fv;
  const int ex = 2 + D + (p.iso ? 1 : D);
  for (int k = 0; k < ProfileExtras<Prof>::N && k < p.nx; ++k)
    f[2 + 2 * D + k] = prow(ex + k);
  if (i == 0) misc[0] = prow(0);
}

// The feature slots (threads < n), once a launch: background, signal,
// position[D], size[D] (isotropic: the size slot first, the others −1),
// extras.
template <int D, int Prof>
__device__ void stage_slots(const Problem& p, int* fs) {
  using FT = Feat<D, ProfileExtras<Prof>::N>;
  const int i = threadIdx.x;
  if (i >= p.n) return;
  const int* si = p.slot_idx + i * p.P;
  int* s = fs + i * (FT::I + 1);
  s[0] = si[0];
  s[1] = si[1];
#pragma unroll
  for (int d = 0; d < D; ++d) s[2 + d] = si[2 + d];
#pragma unroll
  for (int d = 0; d < D; ++d)
    s[2 + D + d] = p.iso ? (d == 0 ? si[2 + D] : -1) : si[2 + D + d];
  const int ex = 2 + D + (p.iso ? 1 : D);
  for (int k = 0; k < ProfileExtras<Prof>::N && k < p.nx; ++k)
    s[2 + 2 * D + k] = si[ex + k];
}

// Pixel k of the window's augmented row z into `z` (kp words): z[0] the
// weighted residual, z[1 + s] the Jacobian of slot s.  Each element is
// make_model_fns's expression in its order; a slot that several features
// share (background, 'cluster' modes) sums them in feature order.
template <int D, int Prof>
__device__ void pixel_row(const Problem& p, const Layout& L, int b, int k,
                          const float* fp, const int* fs, float bg,
                          float* z) {
  using FT = Feat<D, ProfileExtras<Prof>::N>;
  float off[D];
  if constexpr (D == 2) {
    const int y = k / p.wx;
    off[0] = (float)y;
    off[1] = (float)(k - y * p.wx);
  } else {
    const int plane = p.wy * p.wx;
    const int zz = k / plane, rem = k - zz * plane;
    const int y = rem / p.wx;
    off[0] = (float)zz;
    off[1] = (float)y;
    off[2] = (float)(rem - y * p.wx);
  }
  const size_t at = (size_t)b * p.npix + k;
  const float val = p.pixels[at];
  const float w = p.mask[at] / p.norm[b];
  const float wn = w / (float)p.n;
  for (int c = 0; c < L.kp; ++c) z[c] = 0.f;
  auto put = [&](int slot, float term) {
    if (slot >= 0) z[1 + slot] += term;
  };
  float model = 0.f;
  for (int i = 0; i < p.n; ++i) {
    const float* f = fp + i * FT::F;
    const int* s = fs + i * (FT::I + 1);
    const float sig = f[0], fv = f[1 + 2 * D];
    float dd[D];
    float r2 = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dd[d] = (off[d] - f[1 + d]) / f[1 + D + d];
      r2 = r2 + dd[d] * dd[d];
    }
    float fe, dfe;
    lmcore::profile<Prof>(r2, f + 2 + 2 * D, p.nx, &fe, &dfe);
    model = model + sig * fe;
    const float sig_df = sig * dfe;
    put(s[0], wn);
    put(s[1], fe * fv * w);
#pragma unroll
    for (int d = 0; d < D; ++d)
      put(s[2 + d], sig_df * (-2.f) * dd[d] / f[1 + D + d] * w);
    if (p.iso) {
      put(s[2 + D], sig_df * (-2.f) * r2 / f[1 + D] * w);
    } else {
#pragma unroll
      for (int d = 0; d < D; ++d)
        put(s[2 + D + d], sig_df * (-2.f) * (dd[d] * dd[d]) / f[1 + D + d] * w);
    }
    for (int e = 0; e < ProfileExtras<Prof>::N && e < p.nx; ++e)
      put(s[2 + 2 * D + e],
          sig * lmcore::profile_dextra<Prof>(e, r2, f + 2 + 2 * D, fe) * w);
  }
  z[0] = ((bg + model) - val) * w;
}

// This thread's 4×4 blocks (bu ≤ bv) of the upper triangle of zᵀz.
struct Blocks {
  int nq;
  int ou[kMaxBlocksPerThread], ov[kMaxBlocksPerThread];
};

__device__ inline Blocks my_blocks(const Layout& L) {
  Blocks bl;
  bl.nq = 0;
  const int nbl = L.nb * (L.nb + 1) / 2;
#pragma unroll
  for (int q = 0; q < kMaxBlocksPerThread; ++q) {
    bl.ou[q] = bl.ov[q] = 0;
    const int e = threadIdx.x + kThreads * q;
    if (e < nbl) {
      int bv = 0;
      while ((bv + 1) * (bv + 2) / 2 <= e) ++bv;
      bl.ou[q] = 4 * (e - bv * (bv + 1) / 2);
      bl.ov[q] = 4 * bv;
      bl.nq = q + 1;
    }
  }
  return bl;
}

// One residual + Jacobian sweep at x (shared, length V): writes the items
// of zᵀz — item v(v+1)/2 + u holds Σ z_u·z_v, u ≤ v: item 0 is the cost,
// column v = i+1 holds g_i and then H[0..i][i] — into out (shared).
template <int D, int Prof>
__device__ void sweep(const Problem& p, const Layout& L, int b, int m,
                      const Blocks& bl, const float* x, float* sm,
                      float* out) {
  using FT = Feat<D, ProfileExtras<Prof>::N>;
  float* tile = sm + L.tile;
  float* fp = sm + L.fp;
  const int* fs = reinterpret_cast<const int*>(sm + L.fs);
  float* misc = sm + L.misc;
  const int t = threadIdx.x;
  const int* list = p.scratch + (size_t)b * p.npix;
  stage_features<D, Prof>(p, b, x, fp, misc);
  __syncthreads();
  const float bg = misc[0];
  double acc[kMaxBlocksPerThread][16];
#pragma unroll
  for (int q = 0; q < kMaxBlocksPerThread; ++q)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[q][e] = 0.0;
  for (int c0 = 0; c0 < m; c0 += kThreads) {
    const int rows = min(kThreads, m - c0);
    if (t < rows)
      pixel_row<D, Prof>(p, L, b, list[c0 + t], fp, fs, bg,
                         tile + t * L.kp);
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      const float* zr = tile + r * L.kp;
#pragma unroll
      for (int q = 0; q < kMaxBlocksPerThread; ++q) {
        if (q < bl.nq) {
          const float4 a4 = *reinterpret_cast<const float4*>(zr + bl.ou[q]);
          const float4 b4 = *reinterpret_cast<const float4*>(zr + bl.ov[q]);
          const double a[4] = {a4.x, a4.y, a4.z, a4.w};
          const double c[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[q][4 * i + j] = fma(a[i], c[j], acc[q][4 * i + j]);
        }
      }
    }
    __syncthreads();
  }
  const int K = p.V + 1;
#pragma unroll
  for (int q = 0; q < kMaxBlocksPerThread; ++q) {
    if (q < bl.nq) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int u = bl.ou[q] + i, v = bl.ov[q] + j;
          if (u <= v && v < K)
            out[v * (v + 1) / 2 + u] = (float)acc[q][4 * i + j];
        }
      }
    }
  }
  __syncthreads();
}

// (H + λ·max(diag H, 1e-12) + 1e-10·I) δ = −g from the items `acc`; δ lands
// in dl[0 .. V).  Returns false (on every thread) when a pivot of a
// rejecting factorization (V > 20) is not positive.  The factor lives in
// the tile, rows 0 .. V at an odd stride: row V is −g, which the
// factorization turns into y = L⁻¹(−g).
__device__ bool damped_solve(const Layout& L, int V, const float* acc,
                             float lam, float* sm) {
  const int t = threadIdx.x;
  const int S = (V + 1) | 1;
  float* F = sm + L.tile;
  float* dl = sm + L.dl;
  float* piv = sm + L.piv;
  const bool clamp = V <= kUnrollMaxSlots;
  // the lower triangle and the row −g; (ti, tm) walk a 16×16 grid
  const int ti = t >> 4, tm = t & 15;
  for (int i = ti; i <= V; i += 16) {
    for (int m = tm; m <= i && m < V; m += 16) {
      float a;
      if (i == V) {
        a = -acc[(m + 1) * (m + 2) / 2];
      } else {
        const float h = acc[(i + 1) * (i + 2) / 2 + 1 + m];
        if (m == i) {
          const float d = h > 1e-12f ? h : 1e-12f;
          a = h + lam * d + 1e-10f;
        } else {
          a = h;
        }
      }
      F[i * S + m] = a;
    }
  }
  __syncthreads();
  for (int j = 0; j < V; ++j) {
    const float s = F[j * S + j];
    float d;
    if (clamp) {
      d = sqrtf(s < 1e-20f ? 1e-20f : s);   // NaN passes, as torch.clamp
    } else {
      if (!(s > 0.f)) return false;         // every thread read the same s
      d = sqrtf(s);
    }
    if (t == 0) piv[j] = d;
    const int i = j + 1 + t;
    if (i <= V) F[i * S + j] = F[i * S + j] / d;   // divide, as lm.py does
    __syncthreads();
    for (int r = j + 1 + ti; r <= V; r += 16) {
      const float lrj = F[r * S + j];
      for (int m = j + 1 + tm; m <= r && m < V; m += 16)
        F[r * S + m] = F[r * S + m] - lrj * F[m * S + j];
    }
    __syncthreads();
  }
  // back substitution Lᵀ δ = y on warp 0: at step r every lane takes δ_r
  // and subtracts L[r][i]·δ_r from its rows i < r
  if (t < 32) {
    for (int i = t; i < V; i += 32) dl[i] = F[V * S + i];
    __syncwarp();
    for (int r = V - 1; r >= 0; --r) {
      const float x = dl[r] / piv[r];
      __syncwarp();
      for (int i = t; i < r; i += 32) dl[i] = dl[i] - F[r * S + i] * x;
      if (t == 0) dl[r] = x;
      __syncwarp();
    }
  }
  __syncthreads();
  return true;
}

template <int D, int Prof>
__global__ void __launch_bounds__(kThreads, 1) block_lm_kernel(Problem p) {
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int V = p.V;
  const Layout L = block_layout<D, Prof>(V, p.n);
  float* xs = sm + L.xs;
  float* xt = sm + L.xt;
  float* dl = sm + L.dl;
  float* misc = sm + L.misc;
  if (t < V) xs[t] = lmcore::clip(p.x0[(size_t)b * V + t], p.lo[t], p.hi[t]);
  stage_slots<D, Prof>(p, reinterpret_cast<int*>(sm + L.fs));
  const int m = compact_mask(p, b, misc);
  const Blocks bl = my_blocks(L);
  auto acc = [&](int which) { return sm + (which ? L.acc1 : L.acc0); };

  int cur = 0;
  sweep<D, Prof>(p, L, b, m, bl, xs, sm, acc(cur));
  float cost = acc(cur)[0];
  float lam = p.lam0;
  int iters = 0;
  bool conv = false;
  const bool valid = p.valid[b] != 0;
  for (int it = 0; valid && it < p.max_iter; ++it) {
    const bool ok = damped_solve(L, V, acc(cur), lam, sm);
    float c_trial = __int_as_float(0x7fc00000);   // NaN: the step rejected
    if (ok) {
      if (t < V) xt[t] = lmcore::clip(xs[t] + dl[t], p.lo[t], p.hi[t]);
      __syncthreads();
      sweep<D, Prof>(p, L, b, m, bl, xt, sm, acc(1 - cur));
      c_trial = acc(1 - cur)[0];
    }
    const bool accept = c_trial < cost;
    float xnorm = 0.f, snorm = 0.f;
    if (accept) {
      for (int v = 0; v < V; ++v) {
        xnorm = fmaxf(xnorm, fabsf(xs[v]));
        snorm = fmaxf(snorm, fabsf(xt[v] - xs[v]));
      }
    }
    __syncthreads();
    float cost_new = cost, lam_new;
    if (accept) {
      if (t < V) xs[t] = xt[t];
      cur = 1 - cur;
      cost_new = c_trial;
      lam_new = lam * p.lam_down;
    } else {
      lam_new = fminf(lam * p.lam_up, p.lam_max);
    }
    const bool conv_x = accept && (snorm <= p.xtol * (p.xtol + xnorm));
    const bool conv_f =
        accept && ((cost - c_trial) <= p.ftol * fmaxf(cost, 1e-30f));
    const bool plateau = (lam_new >= p.plateau) && isfinite(cost_new);
    const bool stuck = lam_new >= p.lam_max;
    const bool conv_now = conv_x || conv_f || plateau;
    ++iters;
    conv = conv || conv_now;
    cost = cost_new;
    lam = lam_new;
    __syncthreads();
    if (conv_now || stuck) break;
  }
  if (t < V) p.x_out[(size_t)b * V + t] = xs[t];
  if (t == 0) {
    p.cost[b] = cost;
    p.n_iter[b] = iters;
    p.conv[b] = conv ? 1 : 0;
  }
}

template <int D, int Prof>
cudaError_t launch(const Problem& p, int B, cudaStream_t stream) {
  const Layout L = block_layout<D, Prof>(p.V, p.n);
  const size_t bytes = sizeof(float) * (size_t)L.total;
  cudaError_t err = cudaFuncSetAttribute(
      block_lm_kernel<D, Prof>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  block_lm_kernel<D, Prof><<<B, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_profile(const Problem& p, int B, int prof,
                           cudaStream_t stream) {
  switch (prof) {
    case lmcore::kGauss: return launch<D, lmcore::kGauss>(p, B, stream);
    case lmcore::kRing: return launch<D, lmcore::kRing>(p, B, stream);
    case lmcore::kHat: return launch<D, lmcore::kHat>(p, B, stream);
    case lmcore::kDisc: return launch<D, lmcore::kDisc>(p, B, stream);
    case lmcore::kInvSeries:
      return launch<D, lmcore::kInvSeries>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int D>
int smem_words_profile(int prof, int V, int n) {
  switch (prof) {
    case lmcore::kGauss: return block_layout<D, lmcore::kGauss>(V, n).total;
    case lmcore::kRing: return block_layout<D, lmcore::kRing>(V, n).total;
    case lmcore::kHat: return block_layout<D, lmcore::kHat>(V, n).total;
    case lmcore::kDisc: return block_layout<D, lmcore::kDisc>(V, n).total;
    default: return block_layout<D, lmcore::kInvSeries>(V, n).total;
  }
}

}  // namespace

extern "C" {

// Shared memory of one block, in 4-byte words (ops/block_lm.py::smem_words
// holds the same arithmetic).
int block_lm_smem_words(int D, int prof, int V, int n) {
  return D == 2 ? smem_words_profile<2>(prof, V, n)
                : smem_words_profile<3>(prof, V, n);
}

int block_lm_launch(const float* pixels, const float* mask, const int* origin,
                    const float* x0, const float* cp, const float* norm,
                    const int* valid, const float* fvalid,
                    const int* slot_idx, const float* lo, const float* hi,
                    int* scratch, int B, int n, int P, int V, int iso, int D,
                    int wz, int wy, int wx, int max_iter, float ftol,
                    float xtol, float lam0, float lam_up, float lam_down,
                    float lam_max, float plateau, int prof, int nx,
                    float* x_out, float* cost, int* n_iter, int* conv,
                    void* stream) {
  if (B <= 0) return 0;
  if (V < 1 || V > kBlockMaxSlots || n < 1 || n > kBlockMaxFeatures ||
      nx > lmcore::kMaxSeries || (D != 2 && D != 3))
    return (int)cudaErrorInvalidValue;
  Problem p;
  p.pixels = pixels; p.mask = mask; p.origin = origin; p.x0 = x0; p.cp = cp;
  p.norm = norm; p.valid = valid; p.fvalid = fvalid; p.slot_idx = slot_idx;
  p.lo = lo; p.hi = hi; p.scratch = scratch;
  p.n = n; p.P = P; p.V = V; p.iso = iso; p.nx = nx;
  p.npix = wz * wy * wx;
  p.wz = wz; p.wy = wy; p.wx = wx;
  p.max_iter = max_iter;
  p.ftol = ftol; p.xtol = xtol; p.lam0 = lam0; p.lam_up = lam_up;
  p.lam_down = lam_down; p.lam_max = lam_max; p.plateau = plateau;
  p.x_out = x_out; p.cost = cost; p.n_iter = n_iter; p.conv = conv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = D == 2 ? launch_profile<2>(p, B, prof, s)
                                 : launch_profile<3>(p, B, prof, s);
  return (int)err;
}

}  // extern "C"
