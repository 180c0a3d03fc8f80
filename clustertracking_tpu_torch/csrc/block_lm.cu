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
// per in-mask pixel for cost, g and H, against n·O(50) operations for the
// model and its Jacobian row; the damped Cholesky is a chain of V
// dependent steps an iteration.  Nothing but the window's pixels comes
// from device memory: a block reads 16 bytes a pixel a sweep, 5.4 KB at
// config 5's first chain launch (335–342 in-mask pixels), from L2, so no
// TMA.  The sums must be FP64 (FP32 sums moved accept decisions: lanes of
// config 5's chains ended more than 1e-3 px from the plain version), so
// the design keeps them off the FP64 SIMT pipe and on every warp:
//   * the in-mask pixels are listed once a launch, in ascending order, as
//     float4 (value, weight mask/norm, weight/n, packed offsets) in a
//     global scratch row: a sweep makes one coalesced 16-byte load a
//     pixel, and no division or integer division for it;
//   * a sweep takes them R at a time (R = 256 up to V+1 = 32 columns,
//     192 up to 72, 128 past that, so that two blocks fit an SM up to
//     V = 64); each thread builds one pixel's augmented row z = [r, J_0 ..
//     J_{V-1}], the model's chain rule in make_model_fns's order, into a
//     column-major FP32 tile whose stride R+4 keeps both the row's stores
//     (consecutive threads, consecutive words) and the MMA fragment loads
//     free of bank conflicts.  A slot that one feature term writes is
//     stored once; only shared slots (background, 'cluster' modes) add in
//     place.  Every division of the row is by a feature size, so it is a
//     product with that size's FP64 reciprocal, formed once a sweep and
//     rounded to the same float the division gives (over());
//   * the sums are zᵀz on the FP64 tensor cores: mma.sync m8n8k4 f64 with
//     pixels as k, K = V+1 padded to whole 8-column blocks.  An FP64 MMA
//     of FP32 values forms exact products and adds in FP64, as the sums
//     need.  The upper-triangle 8×8 tiles go into jobs (a diagonal panel
//     of up to 4×4 column blocks, or half of an off-diagonal panel pair,
//     2×4 blocks); when there are fewer jobs than warps, warps also split
//     the chunk's pixels into S slices (S = 8 up to V = 31).  A warp
//     loads and converts each fragment of its job once a k-step.  Each
//     (slice, tile) sum lives in shared memory as FP64 between chunks; at
//     the end of the sweep the slices are added in slice order in FP64 and
//     each item is rounded to FP32 once: results do not depend on timing;
//   * at ≤ 128 registers and, up to V = 64 with n ≤ 32, under half the
//     SM's shared memory, two blocks run on an SM (256 blocks, config 5's
//     first chain launch, in one wave over 132 SMs);
//   * the Cholesky is right-looking in shared memory, the threads over the
//     rows for a column's division and over the trailing triangle for its
//     update, so each element takes its subtractions over k = 0, 1, ... as
//     a serial factorization does; −g rides along as one more row, which
//     the factorization turns into y = L⁻¹(−g); one warp substitutes back.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py
// --block-kernels, kernel alone with L2 flushed; PERF.md section 6): 0.70–
// 0.74 ms for 256 chains of 8 features (V = 24; this kernel's first
// design 3.20 ms), 1.76 ms for 128 of 16 (4.0), 12.2 ms for 32 of 40
// (18.8), every lane bit-equal to the first design's.  By thread 0's SM
// clocks, at V = 24 the Cholesky takes 46% of the cycles, the pixel rows
// 26% and the sums 17%; at V = 120, 29%, 37% and 32%.  m16n8k8 MMAs made
// the sums at V = 120 a third faster but needed more registers than two
// blocks an SM allow.
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

using lmcore::dmma;
using lmcore::Feat;
using lmcore::ProfileExtras;

constexpr int kThreads = 256;           // threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kBlockMaxSlots = 128;     // V cap
constexpr int kBlockMaxFeatures = 64;   // n cap
constexpr int kUnrollMaxSlots = 20;     // ops/lm.py::_UNROLL_MAX_V
constexpr int kPanel = 4;               // 8-column blocks a panel
constexpr int kMisc = 4 + kWarps;       // background, pixel count, zeroed
                                        // columns, -, warp counts
constexpr int kSummed = 256;            // slot flag: several terms add up

// The thread's and the block's index, read anew at each use, so that the
// compiler does not hoist what depends on them (addresses, loop bounds) out
// of the LM loop: kept live across it, those values outgrew 128 registers.
__device__ __forceinline__ int tid() {
  int r;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(r));
  return r;
}

__device__ __forceinline__ int bid() {
  int r;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(r));
  return r;
}

// Shared memory of one block, in 4-byte words, for V slots, n features.
struct Layout {
  int K;       // V+1 columns of z
  int nb;      // 8-column blocks of z
  int kpad;    // 8·nb
  int np;      // panels of kPanel column blocks
  int jobs;    // np diagonal panels, two halves of each panel pair
  int S;       // pixel slices a chunk
  int R, RS;   // pixel rows a chunk; the tile's column stride R + 4
  int ntile;   // upper-triangle 8×8 tiles nb(nb+1)/2
  int ni;      // items (V+1)(V+2)/2
  int accd, clk, rcp, tile, acc0, acc1, xs, xt, dl, piv, zc, fp, fs, misc,
      total;
};

template <int D, int Prof>
__host__ __device__ inline Layout block_layout(int V, int n) {
  using FT = Feat<D, ProfileExtras<Prof>::N>;
  Layout L;
  L.K = V + 1;
  L.nb = (L.K + 7) / 8;
  L.kpad = 8 * L.nb;
  L.np = (L.nb + kPanel - 1) / kPanel;
  L.jobs = L.np * L.np;
  L.S = L.jobs >= kWarps ? 1 : kWarps / L.jobs;
  L.R = L.kpad <= 32 ? 256 : L.kpad <= 72 ? 192 : 128;
  L.RS = L.R + 4;
  L.ntile = L.nb * (L.nb + 1) / 2;
  L.ni = L.K * (L.K + 1) / 2;
  const int factor = L.K * (L.K | 1);
  int o = 0;
  L.accd = o; o += L.S * L.ntile * 128;   // FP64 (slice, tile) sums
  L.clk = o;  o += 16;                    // thread 0's eight clocks
  L.rcp = o;  o += 2 * D * n;             // FP64 1/size of each feature
  L.tile = o;                             // z, column-major; the factor
  o += L.kpad * L.RS > factor ? L.kpad * L.RS : factor;
  L.acc0 = o; o += L.ni;                  // the two sweeps' items
  L.acc1 = o; o += L.ni;
  L.xs = o;   o += L.kpad;                // current x
  L.xt = o;   o += L.kpad;                // trial x
  L.dl = o;   o += L.kpad;                // y, then the step δ
  L.piv = o;  o += L.kpad;                // the factor's diagonal
  L.zc = o;   o += L.kpad;                // columns a pixel row zeroes first
  L.fp = o;   o += n * FT::F;             // feature parameters at x
  L.fs = o;   o += n * (FT::I + 1);       // feature slots (int), background first
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
  float4* scratch;       // [B, Npix]: the in-mask pixels (value, w, w/n,
                         // offsets): 2D y << 16 | x, 3D z << 20 | y << 10 | x
  int n, P, V, iso, nx, npix;
  int wz, wy, wx;
  int max_iter;
  float ftol, xtol, lam0, lam_up, lam_down, lam_max, plateau;
  float* x_out;          // [B, V]
  float* cost;           // [B]
  int* n_iter;           // [B]
  int* conv;             // [B]
  long long* clocks;     // [B, 6] or null: SM cycles in all, in sweeps, in
                         // solves; of the sweeps', in rows, sums, rounding
  Layout L;              // from the host: read from the parameter bank,
                         // it holds no registers
};

// Lists the block's in-mask pixels (ascending window index) in its scratch
// row as (value, mask / norm, that / n, packed offsets); returns their
// count on every thread.
template <int D>
__device__ int compact_mask(const Problem& p, int b, float* misc) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int* wcount = reinterpret_cast<int*>(misc + 4);
  float4* list = p.scratch + (size_t)b * p.npix;
  const float* mask = p.mask + (size_t)b * p.npix;
  const float* pixels = p.pixels + (size_t)b * p.npix;
  const float norm = p.norm[b];
  int count = 0;
  for (int base = 0; base < p.npix; base += kThreads) {
    const int k = base + t;
    const float mk = k < p.npix ? mask[k] : 0.f;
    const bool in = mk != 0.f;
    const unsigned ballot = __ballot_sync(lmcore::kFullWarp, in);
    if (lane == 0) wcount[warp] = __popc(ballot);
    __syncthreads();
    int before = count, total = count;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) before += wcount[w];
      total += wcount[w];
    }
    if (in) {
      const float w = mk / norm;
      int off;
      if constexpr (D == 2) {
        const int y = k / p.wx;
        off = y << 16 | (k - y * p.wx);
      } else {
        const int plane = p.wy * p.wx;
        const int zz = k / plane, rem = k - zz * plane;
        const int y = rem / p.wx;
        off = zz << 20 | y << 10 | (rem - y * p.wx);
      }
      list[before + __popc(ballot & ((1u << lane) - 1u))] =
          make_float4(pixels[k], w, w / (float)p.n, __int_as_float(off));
    }
    count = total;
    __syncthreads();
  }
  return count;
}

// The feature parameters at x (threads < n), the reciprocals of their
// sizes in FP64 and the background.
template <int D, int Prof>
__device__ void stage_features(const Problem& p, const float* x, float* fp,
                               double* rcp, float* misc) {
  using FT = Feat<D, ProfileExtras<Prof>::N>;
  const int i = tid(), b = bid();
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
#pragma unroll
  for (int d = 0; d < D; ++d) rcp[i * D + d] = 1.0 / (double)f[1 + D + d];
  f[1 + 2 * D] = fv;
  const int ex = 2 + D + (p.iso ? 1 : D);
  for (int k = 0; k < ProfileExtras<Prof>::N && k < p.nx; ++k)
    f[2 + 2 * D + k] = prow(ex + k);
  if (i == 0) misc[0] = prow(0);
}

// The feature slots (threads < n), once a launch: background, signal,
// position[D], size[D] (isotropic: the size slot first, the others −1),
// extras.  A slot that more than one feature term writes (the background,
// 'cluster' modes) is flagged kSummed: pixel_row adds into its column,
// which starts at zero, and stores the others outright.  The columns a row
// zeroes first (summed ones, padding) are listed in zc, their count in
// misc[2].
template <int D, int Prof>
__device__ void stage_slots(const Problem& p, const Layout& L, float* sm) {
  using FT = Feat<D, ProfileExtras<Prof>::N>;
  const int i = threadIdx.x;
  int* refs = reinterpret_cast<int*>(sm + L.zc);   // terms writing a column
  int* s = reinterpret_cast<int*>(sm + L.fs) + i * (FT::I + 1);
  const int terms = 2 + 2 * D + min(ProfileExtras<Prof>::N, p.nx);
  for (int c = i; c < L.kpad; c += kThreads) refs[c] = 0;
  __syncthreads();
  if (i < p.n) {
    const int* si = p.slot_idx + i * p.P;
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
    for (int q = 0; q < terms; ++q)
      if (s[q] >= 0) atomicAdd(&refs[1 + s[q]], 1);
  }
  __syncthreads();
  if (i < p.n)
    for (int q = 0; q < terms; ++q)
      if (s[q] >= 0 && refs[1 + s[q]] > 1) s[q] |= kSummed;
  __syncthreads();
  if (i == 0) {   // in place: entry nz < c is read before it is written
    int nz = 0;
    for (int c = 1; c < L.kpad; ++c)
      if (refs[c] != 1) refs[nz++] = c;
    sm[L.misc + 2] = __int_as_float(nz);
  }
  __syncthreads();
}

// num / size as the float division rounds it, without its special-case
// branch: num times size's FP64 reciprocal r (correctly rounded) is within
// 2⁻⁵² of num/size relatively, and a quotient of two floats that is not a
// rounding midpoint of float is further than 2⁻⁴⁸ from one, while an exact
// midpoint (size a power of two) has an exact r; so rounding that product
// to float gives the float quotient.  Zero, infinite and NaN operands come
// out as the division's.  Every division of a pixel row is by a size.
__device__ __forceinline__ float over(float num, double r) {
  return (float)((double)num * r);
}

// One pixel's augmented row into column c of the tile at z[c·RS]: z[0]
// the weighted residual, z[1 + s] the Jacobian of slot s.  Each element
// is make_model_fns's expression in its order; a slot that several
// features share (background, 'cluster' modes) sums them in feature order.
template <int D, int Prof>
__device__ void pixel_row(const Problem& p, const Layout& L, float4 px,
                          const float* sm, float* z) {
  using FT = Feat<D, ProfileExtras<Prof>::N>;
  // read here, not held in registers through the sweep
  const float* fp = sm + L.fp;
  const int* fs = reinterpret_cast<const int*>(sm + L.fs);
  const int* zc = reinterpret_cast<const int*>(sm + L.zc);
  const double* rcp = reinterpret_cast<const double*>(sm + L.rcp);
  const volatile float* misc = sm + L.misc;
  const int k = __float_as_int(px.w);
  float off[D];
  if constexpr (D == 2) {
    off[0] = (float)(k >> 16);
    off[1] = (float)(k & 0xffff);
  } else {
    off[0] = (float)(k >> 20);
    off[1] = (float)(k >> 10 & 1023);
    off[2] = (float)(k & 1023);
  }
  const float val = px.x, w = px.y, wn = px.z;
  const int RS = L.RS;
  const int nz = __float_as_int(misc[2]);
  for (int c = 0; c < nz; ++c) z[zc[c] * RS] = 0.f;
  // 0 + term, as the column's first term adds to zero
  auto put = [&](int slot, float term) {
    if (slot < 0) return;
    if (slot & kSummed)
      z[(1 + (slot ^ kSummed)) * RS] += term;
    else
      z[(1 + slot) * RS] = 0.f + term;
  };
  float model = 0.f;
#pragma unroll 1
  for (int i = 0; i < p.n; ++i) {
    const float* f = fp + i * FT::F;
    const int* s = fs + i * (FT::I + 1);
    const float sig = f[0], fv = f[1 + 2 * D];
    const double* r = rcp + i * D;
    float dd[D];
    float r2 = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dd[d] = over(off[d] - f[1 + d], r[d]);
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
      put(s[2 + d], over(sig_df * (-2.f) * dd[d], r[d]) * w);
    if (p.iso) {
      put(s[2 + D], over(sig_df * (-2.f) * r2, r[0]) * w);
    } else {
#pragma unroll
      for (int d = 0; d < D; ++d)
        put(s[2 + D + d], over(sig_df * (-2.f) * (dd[d] * dd[d]), r[d]) * w);
    }
#pragma unroll 1
    for (int e = 0; e < ProfileExtras<Prof>::N && e < p.nx; ++e)
      put(s[2 + 2 * D + e],
          sig * lmcore::profile_dextra<Prof>(e, r2, f + 2 + 2 * D, fe) * w);
  }
  z[0] = ((misc[0] + model) - val) * w;
}

// Upper-triangle tile (I ≤ J) of zᵀz → its index among the ntile.
__device__ __forceinline__ int tile_id(int I, int J) {
  return J * (J + 1) / 2 + I;
}

// A job: tiles I ∈ [i0, i0+ni) × J ∈ [j0, j0+nj), I ≤ J on a diagonal one.
struct Job {
  int i0, ni, j0, nj;
  bool diag;
};

// Jobs 0 .. np−1 are the diagonal panels, then each panel pair p < q in
// order, as two jobs of two row blocks each (panel p is whole: p < np−1).
__device__ inline Job job_of(int j, const Layout& L) {
  Job jb;
  if (j < L.np) {
    jb.diag = true;
    jb.i0 = jb.j0 = kPanel * j;
    jb.ni = jb.nj = min(kPanel, L.nb - kPanel * j);
    return jb;
  }
  j -= L.np;
  const int h = j & 1;
  int pair = j >> 1, p = 0;
  while (pair >= L.np - 1 - p) {
    pair -= L.np - 1 - p;
    ++p;
  }
  const int q = p + 1 + pair;
  jb.diag = false;
  jb.i0 = kPanel * p + 2 * h;
  jb.ni = 2;
  jb.j0 = kPanel * q;
  jb.nj = min(kPanel, L.nb - kPanel * q);
  return jb;
}

// The fragment of column block c at k-step ks: z[4ks + l%4][8c + l/4].
__device__ __forceinline__ double frag(const float* zl, int RS, int c,
                                       int ks) {
  return (double)zl[8 * c * RS + 4 * ks];
}

// A diagonal job's sums over k-steps [k0, k1) of the chunk, added to its
// slice's FP64 tiles in `acc` (two doubles a lane a tile).
__device__ void mma_diag(const float* zl, int RS, double* acc, int lane,
                         const Job& jb, int k0, int k1) {
  double c[10][2];
#pragma unroll
  for (int j = 0; j < kPanel; ++j)
#pragma unroll
    for (int i = 0; i <= j; ++i) {
      const int q = j * (j + 1) / 2 + i;
      if (j < jb.nj) {
        const double2 v = reinterpret_cast<const double2*>(
            acc)[tile_id(jb.i0 + i, jb.j0 + j) * 32 + lane];
        c[q][0] = v.x;
        c[q][1] = v.y;
      }
    }
#pragma unroll 1
  for (int ks = k0; ks < k1; ++ks) {
    double f[kPanel];
#pragma unroll
    for (int i = 0; i < kPanel; ++i)
      if (i < jb.nj) f[i] = frag(zl, RS, jb.i0 + i, ks);
#pragma unroll
    for (int j = 0; j < kPanel; ++j)
#pragma unroll
      for (int i = 0; i <= j; ++i)
        if (j < jb.nj) dmma(c[j * (j + 1) / 2 + i], f[i], f[j]);
  }
#pragma unroll
  for (int j = 0; j < kPanel; ++j)
#pragma unroll
    for (int i = 0; i <= j; ++i) {
      const int q = j * (j + 1) / 2 + i;
      if (j < jb.nj)
        reinterpret_cast<double2*>(
            acc)[tile_id(jb.i0 + i, jb.j0 + j) * 32 + lane] =
            make_double2(c[q][0], c[q][1]);
    }
}

// An off-diagonal job (2 row blocks × up to 4 column blocks), as mma_diag.
__device__ void mma_rect(const float* zl, int RS, double* acc, int lane,
                         const Job& jb, int k0, int k1) {
  double c[2][kPanel][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kPanel; ++j)
      if (j < jb.nj) {
        const double2 v = reinterpret_cast<const double2*>(
            acc)[tile_id(jb.i0 + i, jb.j0 + j) * 32 + lane];
        c[i][j][0] = v.x;
        c[i][j][1] = v.y;
      }
#pragma unroll 1
  for (int ks = k0; ks < k1; ++ks) {
    double fr[2], fc[kPanel];
#pragma unroll
    for (int i = 0; i < 2; ++i) fr[i] = frag(zl, RS, jb.i0 + i, ks);
#pragma unroll
    for (int j = 0; j < kPanel; ++j)
      if (j < jb.nj) fc[j] = frag(zl, RS, jb.j0 + j, ks);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kPanel; ++j)
        if (j < jb.nj) dmma(c[i][j], fr[i], fc[j]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kPanel; ++j)
      if (j < jb.nj)
        reinterpret_cast<double2*>(
            acc)[tile_id(jb.i0 + i, jb.j0 + j) * 32 + lane] =
            make_double2(c[i][j][0], c[i][j][1]);
}

// One residual + Jacobian sweep at x (shared, length V): writes the items
// of zᵀz — item v(v+1)/2 + u holds Σ z_u·z_v, u ≤ v: item 0 is the cost,
// column v = i+1 holds g_i and then H[0..i][i] — into out (shared).
template <int D, int Prof>
__device__ void sweep(const Problem& p, const Layout& L, const float* x,
                      float* sm, float* out) {
  float* tile = sm + L.tile;
  double* accd = reinterpret_cast<double*>(sm + L.accd);
  float* misc = sm + L.misc;
  const int t = tid(), lane = t & 31, warp = t >> 5;
  const float4* list = p.scratch + (size_t)bid() * p.npix;
  const bool timed = p.clocks != nullptr && t == 0;
  long long* clk = reinterpret_cast<long long*>(sm + L.clk);
  stage_features<D, Prof>(p, x, sm + L.fp,
                          reinterpret_cast<double*>(sm + L.rcp), misc);
  for (int e = t; e < L.S * L.ntile * 64; e += kThreads) accd[e] = 0.0;
  __syncthreads();
  const int m = __float_as_int(misc[1]);
  // this lane's element of every fragment: row l%4, column l/4 of a block
  const float* zl = tile + (lane >> 2) * L.RS + (lane & 3);
  const int per = (L.R / 4 + L.S - 1) / L.S;   // k-steps a slice
  for (int c0 = 0; c0 < m; c0 += L.R) {
    const int rows = min(L.R, m - c0);
    const int ks = (rows + 3) >> 2;
    if (timed) clk[7] = clock64();
    if (t < rows) {
      pixel_row<D, Prof>(p, L, list[c0 + t], sm, tile + t);
    } else if (t < 4 * ks) {   // the last k-step's rows past the pixels
      for (int c = 0; c < L.kpad; ++c) tile[c * L.RS + t] = 0.f;
    }
    __syncthreads();
    if (timed) {
      const long long now = clock64();
      clk[4] += now - clk[7];
      clk[7] = now;
    }
    // item (slice s, job j) = s·jobs + j goes to warp item % 8
    for (int s = 0, it = 0; s < L.S; ++s) {
      const int k0 = s * per, k1 = min(ks, k0 + per);
      for (int j = 0; j < L.jobs; ++j, ++it) {
        if ((it & (kWarps - 1)) != warp || k0 >= k1) continue;
        const Job jb = job_of(j, L);
        double* acc = accd + (size_t)s * L.ntile * 64;
        if (jb.diag)
          mma_diag(zl, L.RS, acc, lane, jb, k0, k1);
        else
          mma_rect(zl, L.RS, acc, lane, jb, k0, k1);
      }
    }
    __syncthreads();
    if (timed) clk[5] += clock64() - clk[7];
  }
  if (timed) clk[7] = clock64();
  // item (u, v) = element (u%8, v%8) of tile (u/8, v/8), the slices added
  // in slice order, rounded once
  for (int e = t; e < L.ni; e += kThreads) {
    int v = (int)((sqrtf(8.f * e + 1.f) - 1.f) * 0.5f);
    while (v * (v + 1) / 2 > e) --v;
    while ((v + 1) * (v + 2) / 2 <= e) ++v;
    const int u = e - v * (v + 1) / 2;
    const int at = (tile_id(u >> 3, v >> 3) * 32 + (u & 7) * 4
                    + ((v & 7) >> 1)) * 2 + (v & 1);
    double sum = accd[at];
    for (int s = 1; s < L.S; ++s) sum += accd[(size_t)s * L.ntile * 64 + at];
    out[e] = (float)sum;
  }
  __syncthreads();
  if (timed) clk[6] += clock64() - clk[7];
}

// (H + λ·max(diag H, 1e-12) + 1e-10·I) δ = −g from the items `acc`; δ lands
// in dl[0 .. V).  Returns false (on every thread) when a pivot of a
// rejecting factorization (V > 20) is not positive.  The factor lives in
// the tile, rows 0 .. V at an odd stride: row V is −g, which the
// factorization turns into y = L⁻¹(−g).
__device__ bool damped_solve(const Layout& L, int V, const float* acc,
                             float lam, float* sm) {
  const int t = tid();
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
__global__ void __launch_bounds__(kThreads, 2) block_lm_kernel(Problem p) {
  extern __shared__ __align__(16) float sm[];
  const int V = p.V;
  const Layout& L = p.L;
  float* xs = sm + L.xs;
  float* xt = sm + L.xt;
  float* dl = sm + L.dl;
  float* misc = sm + L.misc;
  // thread 0's clocks, in shared memory: start, sweeps, solves, mark,
  // the sweeps' rows, sums, rounding, mark (whether to read them is asked
  // anew each time, not held through the loop)
  auto timed = [&]() { return p.clocks != nullptr && tid() == 0; };
  long long* clk = reinterpret_cast<long long*>(sm + L.clk);
  if (timed()) {
    clk[0] = clock64();
    clk[1] = clk[2] = clk[4] = clk[5] = clk[6] = 0;
  }
  {
    const int t = threadIdx.x;
    if (t < V)
      xs[t] = lmcore::clip(p.x0[(size_t)blockIdx.x * V + t], p.lo[t], p.hi[t]);
  }
  stage_slots<D, Prof>(p, L, sm);
  {
    const int m = compact_mask<D>(p, blockIdx.x, misc);
    if (threadIdx.x == 0) misc[1] = __int_as_float(m);   // the pixel count
  }
  auto acc = [&](int which) { return sm + (which ? L.acc1 : L.acc0); };

  int cur = 0, it = -1;
  float cost = 0.f, lam = p.lam0;
  bool conv = false;   // set where the loop ends: it ends when a lane converges
  // step −1 sweeps the start; each later one solves for the step, sweeps
  // the trial point and applies the LM rules (one sweep in the code); `it`
  // counts the iterations done when the loop ends
  for (;; ++it) {
    bool ok = true;
    if (it >= 0) {
      if (p.valid[bid()] == 0 || it >= p.max_iter) break;
      if (timed()) clk[3] = clock64();
      ok = damped_solve(L, V, acc(cur), lam, sm);
      if (timed()) clk[2] += clock64() - clk[3];
      const int t = tid();
      if (ok) {
        if (t < V) xt[t] = lmcore::clip(xs[t] + dl[t], p.lo[t], p.hi[t]);
      } else if (t == 0) {
        acc(1 - cur)[0] = __int_as_float(0x7fc00000);   // NaN: rejected
      }
      __syncthreads();
    }
    if (ok) {
      if (timed()) clk[3] = clock64();
      sweep<D, Prof>(p, L, it < 0 ? xs : xt, sm,
                     acc(it < 0 ? cur : 1 - cur));
      if (timed()) clk[1] += clock64() - clk[3];
    }
    if (it < 0) {
      cost = acc(cur)[0];
      continue;
    }
    const float c_trial = acc(1 - cur)[0];
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
      const int t = tid();
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
    cost = cost_new;
    lam = lam_new;
    __syncthreads();
    if (conv_now || stuck) {
      conv = conv_now;
      ++it;
      break;
    }
  }
  const int t = threadIdx.x, b = blockIdx.x;
  if (t < V) p.x_out[(size_t)b * V + t] = xs[t];
  if (t == 0) {
    p.cost[b] = cost;
    p.n_iter[b] = it;
    p.conv[b] = conv ? 1 : 0;
  }
  if (timed()) {
    long long* c = p.clocks + 6 * (size_t)b;
    c[0] = clock64() - clk[0];
    for (int k = 1; k < 6; ++k) c[k] = clk[k < 3 ? k : k + 1];
  }
}

template <int D, int Prof>
cudaError_t launch(Problem p, int B, cudaStream_t stream) {
  p.L = block_layout<D, Prof>(p.V, p.n);
  const size_t bytes = sizeof(float) * (size_t)p.L.total;
  cudaError_t err = cudaFuncSetAttribute(
      block_lm_kernel<D, Prof>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  block_lm_kernel<D, Prof><<<B, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

// Blocks of one instantiation an SM holds at once for V slots, n features
// (its registers and shared memory, by the CUDA runtime); < 0: an error.
template <int D, int Prof>
int blocks_per_sm(int V, int n) {
  const size_t bytes = sizeof(float) * (size_t)block_layout<D, Prof>(V, n).total;
  if (cudaFuncSetAttribute(block_lm_kernel<D, Prof>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes) != cudaSuccess)
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, block_lm_kernel<D, Prof>, kThreads, bytes) != cudaSuccess)
    return -1;
  return blocks;
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

template <int D>
int blocks_per_sm_profile(int prof, int V, int n) {
  switch (prof) {
    case lmcore::kGauss: return blocks_per_sm<D, lmcore::kGauss>(V, n);
    case lmcore::kRing: return blocks_per_sm<D, lmcore::kRing>(V, n);
    case lmcore::kHat: return blocks_per_sm<D, lmcore::kHat>(V, n);
    case lmcore::kDisc: return blocks_per_sm<D, lmcore::kDisc>(V, n);
    default: return blocks_per_sm<D, lmcore::kInvSeries>(V, n);
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

// Blocks an SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
int block_lm_blocks_per_sm(int D, int prof, int V, int n) {
  return D == 2 ? blocks_per_sm_profile<2>(prof, V, n)
                : blocks_per_sm_profile<3>(prof, V, n);
}

int block_lm_launch(const float* pixels, const float* mask, const int* origin,
                    const float* x0, const float* cp, const float* norm,
                    const int* valid, const float* fvalid,
                    const int* slot_idx, const float* lo, const float* hi,
                    float* scratch, int B, int n, int P, int V, int iso,
                    int D, int wz, int wy, int wx, int max_iter, float ftol,
                    float xtol, float lam0, float lam_up, float lam_down,
                    float lam_max, float plateau, int prof, int nx,
                    float* x_out, float* cost, int* n_iter, int* conv,
                    long long* clocks, void* stream) {
  if (B <= 0) return 0;
  if (V < 1 || V > kBlockMaxSlots || n < 1 || n > kBlockMaxFeatures ||
      nx > lmcore::kMaxSeries || (D != 2 && D != 3) ||
      (D == 2 ? wy > 32767 || wx > 65535
              : wz > 2047 || wy > 1023 || wx > 1023))   // packed offsets
    return (int)cudaErrorInvalidValue;
  Problem p;
  p.pixels = pixels; p.mask = mask; p.origin = origin; p.x0 = x0; p.cp = cp;
  p.norm = norm; p.valid = valid; p.fvalid = fvalid; p.slot_idx = slot_idx;
  p.lo = lo; p.hi = hi; p.scratch = reinterpret_cast<float4*>(scratch);
  p.n = n; p.P = P; p.V = V; p.iso = iso; p.nx = nx;
  p.npix = wz * wy * wx;
  p.wz = wz; p.wy = wy; p.wx = wx;
  p.max_iter = max_iter;
  p.ftol = ftol; p.xtol = xtol; p.lam0 = lam0; p.lam_up = lam_up;
  p.lam_down = lam_down; p.lam_max = lam_max; p.plateau = plateau;
  p.x_out = x_out; p.cost = cost; p.n_iter = n_iter; p.conv = conv;
  p.clocks = clocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = D == 2 ? launch_profile<2>(p, B, prof, s)
                                 : launch_profile<3>(p, B, prof, s);
  return (int)err;
}

}  // extern "C"
