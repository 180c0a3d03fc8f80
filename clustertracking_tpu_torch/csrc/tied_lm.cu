// The joint (tied) Levenberg–Marquardt solve of one bucket: slots tied
// across the bucket's valid lanes, the whole loop in one launch.
//
// Counterpart of the reference's XLA route for buckets with 'global'
// slots: clustertracking_tpu/ops/lm.py::lm_solve_global (:289), called at
// clustertracking_tpu/refine.py:537 for 'global' parameter modes
// (train_leastsq's shared PSF coefficients) and for a rigid distance
// shared by every cluster (dimer_global()).  No Pallas kernel exists for
// it.  The plain PyTorch version is ops/tied_lm.py::tied_lm_reference,
// which is ops/lm.py::lm_solve_global_shards on one shard.
//
// What it computes.  Per lane (cluster) the masked, weighted residual
// r = (model − pixel)·(mask / norm) over the gathered window and its
// analytic Jacobian (csrc/lm_core.cuh: every built-in profile; a rigid
// pose inlined, its fitted distance a tied slot), weighted by `valid`.
// The G tied slots are one value for every lane: the valid lanes' mean
// after every update, projected into the bounds.  Their g entries and
// their G×G block of H are summed over lanes, divided by nvalid and
// written back into every lane, so each lane solves its own damped
// system with the shared block.  One λ drives every lane; accept,
// ftol / xtol / plateau and the stop are joint, on the summed cost and
// the maxima over every lane.  Per lane, n_iter is the last iteration at
// which its own slots moved past max(xtol·(xtol + |x|), 1e-6·|x|), and the
// reported cost is its own sum of squares at the end (one more sweep).
//
// An iteration, in three phases split by two barriers across the CTAs:
//   phase A  each warp solves its lanes' damped systems (lm_core's warp
//            Cholesky) into the untied trial; the warp, then the CTA, adds
//            the valid lanes' tied slots of the trial;          barrier
//   phase B  every CTA adds the CTAs' partials: the means.  Each warp ties
//            and clips its lanes' trials and sweeps them (lm_core's sweep
//            over the lane's in-mask pixel list); the warp, then the CTA,
//            adds the shared items of its valid lanes and the maxima of
//            the xtol test;                                     barrier
//   phase C  every CTA adds the CTAs' partials, rounds each shared item to
//            FP32 once and takes the joint decision.  All CTAs read the
//            same partials in the same order, so they decide alike: no
//            third barrier and no broadcast.
//
// What bounds it on an H100: latency, never work (NVIDIA H100 80GB HBM3,
// 700 W; chip_smoke.py --tied-kernels, SM cycles of one iteration, thread
// 0 of each CTA; PERF.md).  The first design (blocks of four warps, as
// many as the card held, lanes in global scratch, the tile sweep) took
// 46k cycles an iteration on [train]'s bucket (256 lanes, inv_series_2,
// 14×14, V = 5): the sweep 17k, the damped solve with its
// global reloads 7k, the serial cross-block adds 11k (one thread an item,
// 64 block partials in order, twice), the barrier waits 7k; and 92k on
// [global]'s (1,472 n-gon dimers, 18×18, V = 6), 49k of it the
// cross-block adds of 368 partials.  This design:
//   * the cross-CTA sums: a cooperative grid of one CTA on every SM, its
//     CTAs' partials through global memory.  Every warp of a CTA takes
//     part: an item is a warp's, its lanes load the partials k = lane,
//     lane + 32, ... and add them in that order, then a butterfly (every
//     lane ends with the same sum); a CTA has a warp for each joint sum;
//   * the sweep: lm_core's register instantiations (slot ceilings 8, 10,
//     14) for every profile, 9–15% faster an iteration than the tile at
//     one lane a warp; the tile for V above 14, and where its CTAs of 16
//     warps give a warp fewer lanes (20–27% faster there; launch_plan);
//   * lane state: warp w of CTA c owns lanes gw, gw + NW, ... (gw = w·ctas
//     + c, NW warps in all) for the whole launch: consecutive lanes on
//     consecutive CTAs, so a bucket of a few hundred lanes leaves each SM
//     one or two busy warps.  Their x, trial x and items (current and
//     trial) stay in shared memory when the CTA holds them, and their
//     in-mask pixels, packed (offset, value) pairs, in a pool of the
//     warp's shared memory when they fit (in global scratch otherwise).
// A lane's solve and sweep are one warp's dependent chain: an iteration
// now takes ~30k cycles on both buckets, the solve 6–7k and the sweep
// 11–12k of it (the warp kernels' own iteration, fused_lm_2d on one lane
// an SM, takes ~12.7k), the partials, barriers and cross-CTA adds the
// other ~12k.  One thread-block cluster of 16 CTAs, its barriers
// cluster.sync() and its partials read through distributed shared memory,
// was measured too: within the grid's time while each of its warps held
// one lane (up to 192 lanes), 1.5–6× slower beyond, as on both workflows'
// buckets, so the grid is the one design (PERF.md).
//
// Numerics: built with -fmad=false and no fast math (ops/_build.py), so
// each lane's row and solve round as the plain version's elementwise ops;
// sums over pixels are lm_core's in FP32, another order than torch's, with
// each product added by a fused multiply-add as torch's GEMM adds it.  A
// fit stops when the joint cost's last bit stops falling, so where a
// lane still has a step of ~1e-3 px that moves the joint cost by less
// than that bit, its end point follows which late steps the rounding
// accepts: on [global]'s first tied launch (1,472 dimers), rounded
// products put one lane 1.1e-3 px from the plain version's, fused ones
// every lane within 6.1e-5 (PERF.md).  The joint sums are FP64, rounded
// to FP32 once, in a fixed order with no atomics: a warp adds its lanes
// in the order it owns them, a CTA its warps by a butterfly, every CTA
// the CTAs' partials as above.  Two runs are bit-equal; the order, and so
// the last bit, depends on the number of CTAs.  The mask
// is radius_mask's, 0 or 1: a pixel with mask ≠ 0 weighs 1/norm.

#include <cooperative_groups.h>

#include "lm_core.cuh"
#include "pixel_list.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace lmcore;

constexpr int kSmemMax = 232448;        // a CTA's shared memory on an H100
// SM cycles of each CTA's thread 0, summed over the joint iterations: in
// all, phase A's damped solves, the tie partials, the wait at the first
// barrier, the cross-CTA adds of the means, phase B's sweeps, the sweep
// partials, the wait at the second barrier, phase C's cross-CTA adds and
// decision; then the iterations counted.
constexpr int kClocks = 10;

// The most warps of a CTA, by slot ceiling: one CTA an SM, each warp at
// the registers its sweep needs: 128 for the tile, 168 for the low
// ceiling, up to 255 for the middle and high ones (held to 128, the low
// ceiling spilled 0.2–2.9 KB a thread and [train]'s sweep took 1.3× the
// cycles).
template <int VM>
struct Cta {
  static constexpr int kWarps =
      VM == 0 ? 16 : VM == kRegSlotsLow ? 12 : 8;
  static constexpr int kThreads = 32 * kWarps;
};

// The J tile of a sweep (the register rows, or the tile's 32 rows); the
// damped solve's factor, (V + 1) rows of kJStride, fits in either.
template <int VM>
__host__ __device__ constexpr int jbuf_words() {
  if constexpr (VM == 0) {
    return 32 * kJStride;
  } else {
    return RowLayout<VM>::NPX * RowLayout<VM>::Pitch;
  }
}

// A warp's LM core (relative to its base): the J tile, the items of a
// solve or of the final sweep, the solve's δ, the staged features.
template <int D, int Prof, int Pose, int VM>
__host__ __device__ inline CoreLayout tied_core() {
  using FT = Feat<D, ProfileExtras<Prof>::N>;
  CoreLayout L;
  int o = 0;
  L.jbuf = o; o += jbuf_words<VM>();
  L.acc = o;  o += kMaxItems;
  L.xs = o;   L.xt = o; o += kMaxSlots;
  L.fp = o;   o += kMaxFeatures * FT::F + 1;
  L.fs = o;   o += kMaxFeatures * FT::I;
  L.pose = o; o += PoseStage<Pose>::W;
  L.total = o + (o & 1);
  return L;
}

// A CTA's shared memory, in 4-byte words (ops/tied_lm.py::launch_plan
// computes the same): FP64 first (the clocks, the warps' partials, the
// CTA's partials), then the warps' cores, the joint sums and tables, the
// lane state (when held here) and the warps' pixel pools.
struct SmemLayout {
  int clk, wpart, ctie, csw, core, core_words, wmax, cmax, jcur, jtri, mean,
      misc, sidx, tpos, state, pool, total;
};

template <int D, int Prof, int Pose, int VM>
__host__ __device__ inline SmemLayout smem_layout(int V, int G, int W,
                                                  int lpw, int state_smem,
                                                  int pool) {
  const int K = (V + 1) * (V + 2) / 2;
  const int NS = 1 + G + G * (G + 1) / 2;
  SmemLayout S;
  int o = 0;
  S.clk = o;   o += 2 * (kClocks + 1);
  S.wpart = o; o += 2 * W * NS;
  S.ctie = o;  o += 2 * G;
  S.csw = o;   o += 2 * NS;
  S.core_words = tied_core<D, Prof, Pose, VM>().total;
  S.core = o;  o += W * S.core_words;
  S.wmax = o;  o += 2 * W;
  S.cmax = o;  o += 2;
  S.jcur = o;  o += NS;
  S.jtri = o;  o += NS;
  S.mean = o;  o += G;
  S.misc = o;  o += 4;
  S.sidx = o;  o += NS;
  S.tpos = o;  o += V;
  o += o & 1;
  S.state = o; o += state_smem ? W * lpw * (2 * V + 2 * K + 4) : 0;
  S.pool = o;  o += W * pool;
  S.total = o;
  return S;
}

struct Problem {
  const float* pixels;       // [B, Npix], raster order
  const float* mask;         // [B, Npix], 0 or 1
  const int* origin;         // [B, D]
  const float* x0;           // [B, V]
  const float* cp;           // [B, n, P]
  const float* norm;         // [B]
  const int* valid;          // [B]
  const float* fvalid;       // [B, n]
  const int* slot_idx;       // [n, P]
  const int* tied;           // [G] tied slots, ascending
  int2* list;                // [B, Npix] in-mask (packed offset, value)
  float* gstate;             // [ctas·W·lpw, LS] lane state, by slot, when
                             // shared memory does not hold it
  double* part_tie;          // [ctas, G]  the CTAs' partials
  double* part_sw;           // [ctas, NS]
  float* part_max;           // [ctas, 2]
  int B, n, P, V, G, iso;
  int wz, wy, wx, sy, sz, my, mx;
  int max_iter;
  float ftol, xtol, lam0, lam_up, lam_down, lam_max, plateau;
  const float* lo;           // [V]
  const float* hi;           // [V]
  ModelArgs ma;
  float* x_out;              // [B, V]
  float* cost;               // [B]
  int* n_iter;               // [B]
  int* converged;            // [B]
  int* iterations;           // [1] the joint loop's iterations
  long long* clocks;         // [ctas, kClocks] or null
  int warps;                 // a CTA's (≤ Cta<VM>::kWarps)
  int lpw;                   // lanes a warp owns, at most
  int state_smem;            // lane state in shared memory (else gstate)
  int pool;                  // ints of each warp's pixel pool (even)
};

// A lane's in-mask pixels as (packed offset, value) pairs, in a warp's
// pool or in global scratch.
template <int D>
struct PairPixels {
  const int2* e;
  int cnt, sy, sz, my, mx;
  float wc;
  __device__ int count() const { return cnt; }
  __device__ void load(int k, float* off, float& v, float& w) const {
    const int2 q = e[k];
    int z, y, x;
    unpack<D>(q.x, sy, sz, my, mx, &z, &y, &x);
    offsets<D>(z, y, x, off);
    v = __int_as_float(q.y);
    w = wc;
  }
};

// Item index of g_i and of H[a][b], a ≤ b (lm_core.cuh's item layout).
__host__ __device__ inline int g_item(int i) { return (i + 1) * (i + 2) / 2; }
__host__ __device__ inline int h_item(int a, int b) {
  return (b + 1) * (b + 2) / 2 + a + 1;
}

// FP64 sums of m values src(k, t), k = 0 .. m−1, for items t < nt: item t
// is warp t % W's; lane l adds k = l, l + 32, ... in order, then the warp
// folds by a butterfly (lane l adds lane l ^ o's sum; both get the same
// value), and lane 0 hands the sum to dst(t, s).  The trips over t are
// the same on every warp (the shuffles stay outside any branch).
template <class Src, class Dst>
__device__ inline void sum_items(int nt, int m, int warp, int W, int lane,
                                 Src src, Dst dst) {
  for (int t0 = 0; t0 < nt; t0 += W) {
    const int t = t0 + warp;
    double s = 0.0;
    if (t < nt)
      for (int k = lane; k < m; k += 32) s += src(k, t);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFullWarp, s, o);
    if (t < nt && lane == 0) dst(t, s);
  }
}

// The two maxima of the xtol test, the same way on warps first % W and
// (first + 1) % W (fmaxf: any order is exact).
template <class Src, class Dst>
__device__ inline void max_items(int first, int m, int warp, int W,
                                 int lane, Src src, Dst dst) {
  const int t = (warp - first % W + W) % W;
  float s = 0.f;
  if (t < 2)
    for (int k = lane; k < m; k += 32) s = fmaxf(s, src(k, t));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    s = fmaxf(s, __shfl_xor_sync(kFullWarp, s, o));
  if (t < 2 && lane == 0) dst(t, s);
}

// A shuffle under a branch that the compiler cannot prove warp-uniform
// becomes a collective sequence (a lane's index comes from threadIdx, so
// every per-lane branch is such a branch to it): the loops over a warp's
// lanes branch on warp votes (__any_sync, a uniform predicate), and the
// shuffles of the sums sit outside their per-item branches.
template <int D, int Prof, int Pose, int VM>
__global__ void __launch_bounds__(Cta<VM>::kThreads, 1)
    tied_lm_kernel(Problem p) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int W = blockDim.x >> 5, T = blockDim.x;
  const int B = p.B, V = p.V, G = p.G, n = p.n;
  const int K = (V + 1) * (V + 2) / 2;
  const int NS = 1 + G + G * (G + 1) / 2;
  const int LS = 2 * V + 2 * K + 4;
  const int npx = p.wz * p.wy * p.wx;
  const int ncta = gridDim.x, cta = blockIdx.x;
  const int NW = ncta * W, gw = warp * ncta + cta;   // CTAs fastest
  const SmemLayout S = smem_layout<D, Prof, Pose, VM>(V, G, W, p.lpw,
                                                      p.state_smem, p.pool);
  const CoreLayout L = tied_core<D, Prof, Pose, VM>();
  float* sm = smem + S.core + warp * S.core_words;
  long long* clk = reinterpret_cast<long long*>(smem + S.clk);
  double* wpart = reinterpret_cast<double*>(smem + S.wpart);
  double* ctie = reinterpret_cast<double*>(smem + S.ctie);
  double* csw = reinterpret_cast<double*>(smem + S.csw);
  float* wmax = smem + S.wmax;
  float* cmax = smem + S.cmax;
  float* jcur = smem + S.jcur;
  float* jtri = smem + S.jtri;
  float* mean = smem + S.mean;
  float* misc = smem + S.misc;
  int* nvalid_i = reinterpret_cast<int*>(smem + S.misc + 2);
  int* sidx = reinterpret_cast<int*>(smem + S.sidx);
  int* tpos = reinterpret_cast<int*>(smem + S.tpos);
  int* pool = reinterpret_cast<int*>(smem + S.pool) + warp * p.pool;

  // the tables of the tie, and nvalid (an integer count: exact)
  if (tid == 0) *nvalid_i = 0;
  for (int v = tid; v < V; v += T) tpos[v] = -1;
  __syncthreads();
  for (int t = tid; t < G; t += T) tpos[p.tied[t]] = t;
  for (int t = tid; t < NS; t += T) {
    if (t == 0) {
      sidx[t] = 0;
    } else if (t <= G) {
      sidx[t] = g_item(p.tied[t - 1]);
    } else {
      int q = t - 1 - G, t2 = 0;
      while ((t2 + 1) * (t2 + 2) / 2 <= q) ++t2;
      const int t1 = q - t2 * (t2 + 1) / 2;
      sidx[t] = h_item(p.tied[t1], p.tied[t2]);
    }
  }
  int mine = 0;
  for (int b = tid; b < B; b += T) mine += p.valid[b] != 0;
  atomicAdd(nvalid_i, mine);
  __syncthreads();
  const float nvalid = fmaxf((float)*nvalid_i, 1.f);

  stage_slots<D, Prof>(
      make_cluster(p.cp, p.fvalid, p.slot_idx, 0.f, 0.f, 0.f, n, p.P, V,
                   p.iso, p.ma, 0),
      reinterpret_cast<int*>(sm + L.fs), lane);
  int iu[kItemsPerLane], iv[kItemsPerLane];
#pragma unroll
  for (int j = 0; j < kItemsPerLane; ++j) {
    iu[j] = 0; iv[j] = 0;
    if (VM == 0 && lane + 32 * j < K)
      item_pair(lane + 32 * j, V, &iu[j], &iv[j]);
  }

  // Slot j of this warp is lane b = gw + j·NW (none past B); its state:
  // x (current, trial), items (current, trial), then it_lane, moved, its
  // pixel count and its offset in the warp's pool (−1: its list stays in
  // global scratch).
  auto lane_of = [&](int j) { return gw + j * NW; };
  auto state = [&](int j) -> float* {
    const int slot = warp * p.lpw + j;
    return p.state_smem ? smem + S.state + slot * LS
                        : p.gstate + ((size_t)cta * W * p.lpw + slot) * LS;
  };
  auto ints = [&](float* st) {
    return reinterpret_cast<int*>(st + 2 * V + 2 * K);
  };
  auto is_valid = [&](int b) { return b < B && p.valid[b] != 0; };
  auto cluster_of = [&](int b) {
    Cluster c = make_cluster(p.cp + (size_t)b * n * p.P,
                             p.fvalid + (size_t)b * n, p.slot_idx, 0.f, 0.f,
                             0.f, n, p.P, V, p.iso, p.ma, b);
    const int* org = p.origin + (size_t)b * D;
#pragma unroll
    for (int d = 0; d < D; ++d) c.org[d] = (float)org[d];
    return c;
  };
  auto pixels_of = [&](float* st, int b) {
    const int* si = ints(st);
    const int2* e = si[3] >= 0 ? reinterpret_cast<const int2*>(pool) + si[3]
                               : p.list + (size_t)b * npx;
    return PairPixels<D>{e, si[2], p.sy, p.sz, p.my, p.mx, 1.f / p.norm[b]};
  };
  // one sweep of lane b (state st) at x, its items into out
  auto sweep_at = [&](int b, float* st, const float* x, float* out) {
    sweep<D, Prof, Pose, VM, PairPixels<D>, true>(
        cluster_of(b), x, sm, L, out, lane, iu, iv, K, pixels_of(st, b));
  };
  auto barrier = [&]() { cg::this_grid().sync(); };

  // Setup: each warp lists its lanes' in-mask pixels (raster order) with
  // their values, moves the lists into its pool when they all fit, and
  // hands x0 to phase B as the untied trial (x row 1: cur = 0).
  int total = 0;
#pragma unroll 1
  for (int j = 0; j < p.lpw; ++j) {
    const int b = lane_of(j);
    if (!__any_sync(kFullWarp, b < B)) break;
    float* st = state(j);
    for (int k = lane; k < LS; k += 32) st[k] = 0.f;
    __syncwarp();
    const float* mrow = p.mask + (size_t)b * npx;
    const float* prow = p.pixels + (size_t)b * npx;
    int2* out = p.list + (size_t)b * npx;
    int c = 0;
    for (int k0 = 0; k0 < npx; k0 += 32) {
      const int k = k0 + lane;
      const bool hit = k < npx && mrow[k] != 0.f;
      const unsigned m = __ballot_sync(kFullWarp, hit);
      if (hit) {
        const int z = k / (p.wy * p.wx), r = k - z * p.wy * p.wx;
        const int y = r / p.wx, x = r - y * p.wx;
        out[c + __popc(m & ((1u << lane) - 1u))] = make_int2(
            (D == 3 ? (z << p.sz) : 0) | (y << p.sy) | x,
            __float_as_int(prow[k]));
      }
      c += __popc(m);
    }
    if (lane == 0) ints(st)[2] = c;
    if (lane < V) st[V + lane] = p.x0[(size_t)b * V + lane];
    total += c;
    __syncwarp();
  }
  {
    const bool pooled = 2 * total <= p.pool;
    int off = 0;
#pragma unroll 1
    for (int j = 0; j < p.lpw; ++j) {
      const int b = lane_of(j);
      if (!__any_sync(kFullWarp, b < B)) break;
      float* st = state(j);
      const int c = ints(st)[2];
      if (pooled) {
        const int2* src = p.list + (size_t)b * npx;
        int2* dst = reinterpret_cast<int2*>(pool) + off;
        for (int k = lane; k < c; k += 32) dst[k] = src[k];
      }
      __syncwarp();
      if (lane == 0) ints(st)[3] = pooled ? off : -1;
      off += c;
      __syncwarp();
    }
  }

  float cost = 0.f, lam = p.lam0;
  bool active = true, conv = false;
  int n_run = 0, cur = 0;
  const bool timed = p.clocks != nullptr && tid == 0;
  long long t_mark = 0;
  if (timed) {
    for (int k = 0; k < kClocks; ++k) clk[k] = 0;
    clk[kClocks] = clock64();
  }
  auto lap = [&](int k) {
    if (timed) {
      const long long now = clock64();
      clk[k] += now - t_mark;
      t_mark = now;
    }
  };

  // Trip −1 ties and sweeps the start; every later trip solves, ties,
  // sweeps the trial and decides.
#pragma unroll 1
  for (int it = -1; it < p.max_iter; ++it) {
    if (it >= 0 && !active) break;
    if (timed) t_mark = clock64();
    const int tri = 1 - cur;

    // phase A: the damped step of each valid lane, untied
    if (it >= 0) {
      float* acc = sm + L.acc;
#pragma unroll 1
      for (int j = 0; j < p.lpw; ++j) {
        const int b = lane_of(j);
        if (!__any_sync(kFullWarp, b < B)) break;
        float* st = state(j);
        const float* xc = st + cur * V;
        float* xt = st + tri * V;
        if (__any_sync(kFullWarp, is_valid(b))) {
          const float* ic = st + 2 * V + cur * K;
          for (int k = lane; k < K; k += 32) acc[k] = ic[k];
          __syncwarp();
          for (int t = 1 + lane; t < NS; t += 32)
            acc[sidx[t]] = jcur[t] / nvalid;
          __syncwarp();
          const float delta =
              damped_solve(acc, lam, V, lane, sm + L.jbuf, sm + L.xt);
          __syncwarp();
          if (lane < V) xt[lane] = xc[lane] + delta;
        } else if (lane < V) {
          xt[lane] = xc[lane];
        }
        __syncwarp();
      }
    }
    lap(1);
    // the tie's partials: the warp's valid lanes in order, then the warps
    if (lane < G) {
      double s = 0.0;
      for (int j = 0; j < p.lpw; ++j)
        if (is_valid(lane_of(j)))
          s += (double)state(j)[tri * V + p.tied[lane]];
      wpart[warp * NS + lane] = s;
    }
    __syncthreads();
    sum_items(G, W, warp, W, lane,
              [&](int k, int t) { return wpart[k * NS + t]; },
              [&](int t, double s) {
                ctie[t] = s;
                p.part_tie[(size_t)cta * G + t] = s;
              });
    lap(2);
    barrier();
    lap(3);

    // phase B: the means, then tie, clip and sweep the trial
    sum_items(G, ncta, warp, W, lane,
              [&](int k, int t) { return p.part_tie[(size_t)k * G + t]; },
              [&](int t, double s) { mean[t] = (float)s / nvalid; });
    __syncthreads();
    lap(4);
    float wstep = 0.f, wax = 0.f;   // the warp's maxima over its lanes
#pragma unroll 1
    for (int j = 0; j < p.lpw; ++j) {
      const int b = lane_of(j);
      if (!__any_sync(kFullWarp, b < B)) break;
      float* st = state(j);
      const float* xc = st + cur * V;
      float* xt = st + tri * V;
      float step = 0.f, ax = 0.f, step_own = 0.f, ax_own = 0.f;
      if (lane < V) {
        const int t = tpos[lane];
        float v = t >= 0 ? mean[t] : xt[lane];
        v = clip(v, p.lo[lane], p.hi[lane]);
        xt[lane] = v;
        if (it >= 0) {
          const float x = xc[lane];
          step = fabsf(v - x);
          ax = fabsf(x);
          if (t < 0) { step_own = step; ax_own = ax; }
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        step = fmaxf(step, __shfl_xor_sync(kFullWarp, step, o));
        ax = fmaxf(ax, __shfl_xor_sync(kFullWarp, ax, o));
        step_own = fmaxf(step_own, __shfl_xor_sync(kFullWarp, step_own, o));
        ax_own = fmaxf(ax_own, __shfl_xor_sync(kFullWarp, ax_own, o));
      }
      if (it >= 0) {
        // a rigid bucket's inert position slots: no step, |x| in xn
        const float xn = p.ma.xn != nullptr ? p.ma.xn[b] : 0.f;
        ax = fmaxf(ax, xn);
        ax_own = fmaxf(ax_own, xn);
        const float tol = fmaxf(p.xtol * (p.xtol + ax_own), 1e-6f * ax_own);
        if (lane == 0) ints(st)[1] = step_own > tol;
        wstep = fmaxf(wstep, step);
        wax = fmaxf(wax, ax);
      }
      __syncwarp();
      if (__any_sync(kFullWarp, is_valid(b)))
        sweep_at(b, st, xt, st + 2 * V + tri * K);
      __syncwarp();
    }
    lap(5);
    for (int t = lane; t < NS; t += 32) {
      double s = 0.0;
      for (int j = 0; j < p.lpw; ++j)
        if (is_valid(lane_of(j)))
          s += (double)state(j)[2 * V + tri * K + sidx[t]];
      wpart[warp * NS + t] = s;
    }
    if (lane == 0) {
      wmax[2 * warp] = wstep;
      wmax[2 * warp + 1] = wax;
    }
    __syncthreads();
    sum_items(NS, W, warp, W, lane,
              [&](int k, int t) { return wpart[k * NS + t]; },
              [&](int t, double s) {
                csw[t] = s;
                p.part_sw[(size_t)cta * NS + t] = s;
              });
    max_items(NS, W, warp, W, lane,
              [&](int k, int t) { return wmax[2 * k + t]; },
              [&](int t, float m) {
                cmax[t] = m;
                p.part_max[2 * cta + t] = m;
              });
    lap(6);
    barrier();
    lap(7);

    // phase C: the joint sums and decision, alike in every CTA
    sum_items(NS, ncta, warp, W, lane,
              [&](int k, int t) { return p.part_sw[(size_t)k * NS + t]; },
              [&](int t, double s) { jtri[t] = (float)s; });
    max_items(NS, ncta, warp, W, lane,
              [&](int k, int t) { return p.part_max[2 * k + t]; },
              [&](int t, float m) { misc[t] = m; });
    __syncthreads();
    bool better = true;
    if (it < 0) {
      cost = jtri[0];
    } else {
      const float c_trial = jtri[0];
      better = c_trial < cost;
      const float cost_new = better ? c_trial : cost;
      const float lam_new =
          better ? lam * p.lam_down : fminf(lam * p.lam_up, p.lam_max);
      const bool conv_f = (cost - c_trial) <= p.ftol * fmaxf(cost, 1e-30f);
      const bool conv_x = misc[0] <= p.xtol * (p.xtol + misc[1]);
      const bool plateau = (lam_new >= p.plateau) && isfinite(cost_new);
      const bool conv_now = (better && (conv_f || conv_x)) || plateau;
      const bool done = conv_now || lam_new >= p.lam_max;
      if (better && lane == 0) {
#pragma unroll 1
        for (int j = 0; j < p.lpw; ++j) {
          int* si = ints(state(j));
          if (lane_of(j) < B && si[1]) si[0] = it + 1;
        }
      }
      conv = conv || conv_now;
      active = active && !done;
      cost = cost_new;
      lam = lam_new;
      n_run = it + 1;
    }
    if (better) {
      cur = tri;
      for (int t = tid; t < NS; t += T) jcur[t] = jtri[t];
    }
    __syncthreads();
    lap(8);
    if (timed) ++clk[9];
  }

  // each lane's own cost at the solution: one more sweep, unweighted
#pragma unroll 1
  for (int j = 0; j < p.lpw; ++j) {
    const int b = lane_of(j);
    if (!__any_sync(kFullWarp, b < B)) break;
    float* st = state(j);
    float* xs = st + cur * V;
    if (lane < V) p.x_out[(size_t)b * V + lane] = xs[lane];
    __syncwarp();
    sweep_at(b, st, xs, sm + L.acc);
    if (lane == 0) {
      const bool ok = p.valid[b] != 0;
      const int itl = ints(st)[0];
      p.cost[b] = sm[L.acc];
      p.n_iter[b] = ok ? itl : 0;
      p.converged[b] = ok && (conv || itl < n_run);
    }
    __syncwarp();
  }
  if (cta == 0 && tid == 0) *p.iterations = n_run;
  if (timed) {
    clk[0] = clock64() - clk[kClocks];
    for (int k = 0; k < kClocks; ++k)
      p.clocks[(size_t)cta * kClocks + k] = clk[k];
  }
}

template <int D, int Prof, int Pose, int VM>
int run(Problem* p, int ctas, int smem, cudaStream_t stream) {
  auto kernel = tied_lm_kernel<D, Prof, Pose, VM>;
  const int W = p->warps;
  const SmemLayout S = smem_layout<D, Prof, Pose, VM>(
      p->V, p->G, W, p->lpw, p->state_smem, p->pool);
  if (4 * S.total != smem || smem > kSmemMax || ctas < 1 || W < 1 ||
      W > Cta<VM>::kWarps || (long long)ctas * W * p->lpw < p->B)
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem)) != cudaSuccess ||
      (e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, 32 * W, smem)) != cudaSuccess)
    return (int)e;
  if (ctas > per_sm * sms) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {p};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(ctas),
                                  dim3(32 * W), args, (size_t)smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The instantiation of slot ceiling vm (ops/tied_lm.py::launch_plan): a
// register sweep (kRegSlotsLow, Mid, High) or the tile (0).
template <int D, int Prof, int Pose>
int run_vm(int vm, Problem* p, int c, int s, cudaStream_t st) {
  switch (vm) {
    case kRegSlotsLow: return run<D, Prof, Pose, kRegSlotsLow>(p, c, s, st);
    case kRegSlotsMid: return run<D, Prof, Pose, kRegSlotsMid>(p, c, s, st);
    case kRegSlotsHigh: return run<D, Prof, Pose, kRegSlotsHigh>(p, c, s, st);
    case 0: return run<D, Prof, Pose, 0>(p, c, s, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <int D, int Pose>
int run_prof(int prof, int vm, Problem* p, int c, int s, cudaStream_t st) {
  switch (prof) {
    case kGauss: return run_vm<D, kGauss, Pose>(vm, p, c, s, st);
    case kRing: return run_vm<D, kRing, Pose>(vm, p, c, s, st);
    case kHat: return run_vm<D, kHat, Pose>(vm, p, c, s, st);
    case kDisc: return run_vm<D, kDisc, Pose>(vm, p, c, s, st);
    case kInvSeries: return run_vm<D, kInvSeries, Pose>(vm, p, c, s, st);
  }
  return (int)cudaErrorInvalidValue;
}

int dispatch(int D, int prof, int pose, int vm, Problem* p, int c, int s,
             cudaStream_t st) {
  if (D == 2 && pose == kNoPose)
    return run_prof<2, kNoPose>(prof, vm, p, c, s, st);
  if (D == 2 && pose == kNgon2D)
    return run_prof<2, kNgon2D>(prof, vm, p, c, s, st);
  if (D == 3 && pose == kNoPose)
    return run_prof<3, kNoPose>(prof, vm, p, c, s, st);
  if (D == 3 && pose == kAxis3D)
    return run_prof<3, kAxis3D>(prof, vm, p, c, s, st);
  if (D == 3 && pose == kRotvec3D)
    return run_prof<3, kRotvec3D>(prof, vm, p, c, s, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches the joint solve on `stream` as one cooperative launch of `ctas`
// CTAs of `warps` warps, the sweep of slot ceiling `vm` (8, 10 or 14 with
// V ≤ vm, 0 for the tile), each warp owning up to `lpw` lanes, the lane state
// in shared memory (state_smem = 1) or in `gstate`, each warp's pixel
// pool `pool` ints; `smem` is the CTA's shared memory in bytes
// (ops/tied_lm.py::launch_plan), checked against the kernel's own layout.
// The arguments are lm_core.cuh's (prof, nx, pose, fit_dist, circ,
// rc_fixed, base, xn; for a rigid bucket V is the compact length) plus
// the G tied slots `tied` (ascending, < V) and the scratch: list [2·B·Npix]
// (int), gstate [ctas·warps·lpw·LS] (float, LS = 2V + 2K + 4; unused with
// state_smem),
// part_tie [ctas·G], part_sw [ctas·NS] (double), part_max [2·ctas] (float),
// K = (V+1)(V+2)/2, NS = 1 + G + G(G+1)/2; `iterations` [1] gets the joint
// loop's iteration count, `clocks` [ctas·10] (or null) each CTA's thread
// 0's SM cycles.  Returns the CUDA error code (0 = cudaSuccess);
// cudaErrorInvalidValue for a problem or a plan the kernel does not take.
int tied_lm_launch(
    const float* pixels, const float* mask, const int* origin,
    const float* x0, const float* cp, const float* norm, const int* valid,
    const float* fvalid, const int* slot_idx, const int* tied,
    const float* lo, const float* hi,
    int* list, float* gstate, double* part_tie, double* part_sw,
    float* part_max,
    int B, int n, int P, int V, int G, int iso, int D, int wz, int wy, int wx,
    int max_iter, float ftol, float xtol, float lam0, float lam_up,
    float lam_down, float lam_max, float plateau,
    int prof, int nx, int pose, int fit_dist, float circ, float rc_fixed,
    const float* base, const float* xn,
    float* x_out, float* cost, int* n_iter, int* converged, int* iterations,
    long long* clocks, int vm, int ctas, int warps, int lpw,
    int state_smem, int pool, int smem, void* stream) {
  const int n_ex = prof == kInvSeries ? nx : (prof == kRing || prof == kHat);
  const int q = pose == kNgon2D ? PoseDim<kNgon2D>::Q
              : pose == kAxis3D ? PoseDim<kAxis3D>::Q
              : pose == kRotvec3D ? PoseDim<kRotvec3D>::Q : 0;
  if ((D != 2 && D != 3) || V < 1 || V >= kMaxSlots || G < 1 || G > V ||
      n < 1 || n > kMaxFeatures || P != 2 + D + (iso ? 1 : D) + n_ex ||
      nx != n_ex || nx > kMaxSeries || wz < 1 || wy < 1 || wx < 1 ||
      (D == 2 && wz != 1) || B < 0 || lpw < 1 || pool < 0 || (pool & 1) ||
      (vm != 0 && V > vm) ||
      (pose != kNoPose && (xn == nullptr || V < q + fit_dist ||
                           (pose != kAxis3D && base == nullptr) ||
                           (pose == kAxis3D && n != 2))))
    return (int)cudaErrorInvalidValue;
  const int bx = bits_for(wx), by = bits_for(wy), bz = bits_for(wz);
  if (bx + by + bz > 30) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Problem p{pixels, mask, origin, x0, cp, norm, valid, fvalid, slot_idx,
            tied, reinterpret_cast<int2*>(list), gstate, part_tie, part_sw,
            part_max, B, n, P, V, G, iso, wz, wy, wx,
            bx, bx + by, (1 << by) - 1, (1 << bx) - 1, max_iter, ftol, xtol,
            lam0, lam_up, lam_down, lam_max, plateau, lo, hi,
            ModelArgs{nx, base, circ, rc_fixed, fit_dist, xn},
            x_out, cost, n_iter, converged, iterations, clocks,
            warps, lpw, state_smem, pool};
  return dispatch(D, prof, pose, vm, &p, ctas, smem, (cudaStream_t)stream);
}

}  // extern "C"
