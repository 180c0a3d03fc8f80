// The joint (tied) Levenberg–Marquardt solve of one bucket: slots tied
// across the bucket's valid lanes, the whole loop in one cooperative
// launch.
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
// Why one launch.  The plain version is a host-paced loop of small torch
// ops (two sweeps' worth of einsums, an all-reduce and a host read of
// `active` an iteration); on an H100 the card idled 96% of a [train] round.
// Here every lane's own work stays on one warp, and the two cross-lane
// steps of an iteration are grid-wide barriers of a cooperative launch
// (cooperative_groups::this_grid().sync()), so the loop needs no host:
//   phase A  each warp solves its lanes' damped systems (lm_core's
//            warp Cholesky) and writes the untied trial; its block adds
//            the valid lanes' tied slots of the trial, in lane order, in
//            FP64;                                        grid sync
//   phase B  every block adds the blocks' partials in block order: the
//            means.  Each warp ties and clips its lanes' trials, sweeps
//            them (lm_core's sweep over the lane's in-mask pixel list,
//            pixel_list.cuh, built once a launch from the mask) and
//            writes each lane's items (cost, g, H upper triangle); its
//            block adds the shared items of its valid lanes in lane
//            order, in FP64, and the maxima of the xtol test;  grid sync
//   phase C  every block adds the partials in block order, rounds each
//            shared item to FP32 once and takes the joint decision.  All
//            blocks read the same partials in the same order, so they
//            decide alike: no third barrier and no broadcast.
// The sums are deterministic (a fixed order, no atomics) and in FP64,
// rounded once: in block_lm.cu FP32 sums moved accept decisions where
// FP64 sums rounded once did not (PERF.md).
//
// The grid is as many blocks of kWarps warps as the card holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor × SMs), up to one warp
// per lane; block k takes a contiguous run of lanes and its warps stride
// over it.  A lane's x (current and trial), its items (current and trial)
// and its in-mask pixel list live in global scratch between phases; the
// block's copy of the joint shared sums lives in shared memory.
//
// What bounds it on an H100.  Latency, not work: a [train] bucket (256
// lanes, 14×14 windows, 5 slots, 60 joint iterations) is 2.4 µs of FP32
// work over the card, and the kernel takes 1.37 ms alone (~23 µs an
// iteration: one warp's damped solve and sweep, two grid barriers, the
// serial FP64 adds of 64 block partials), 1.62–1.72 ms a call, against
// 399–564 ms for the plain version (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
// A simple design; a faster one is later work.
//
// Numerics: built with -fmad=false and no fast math (ops/_build.py), so
// each lane's row and solve round as the plain version's elementwise ops;
// sums over pixels are lm_core's (FP32, another order than torch's).  The
// mask is radius_mask's, 0 or 1: a pixel with mask ≠ 0 weighs 1/norm.

#include <cooperative_groups.h>

#include "lm_core.cuh"
#include "pixel_list.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace lmcore;

constexpr int kWarps = 4;                       // warps a block
constexpr int kThreads = 32 * kWarps;
// shared items: the cost, g of each tied slot, H of each tied pair (u ≤ v)
constexpr int kMaxShared = 1 + kMaxSlots + kMaxSlots * (kMaxSlots + 1) / 2;

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
  int* list;                 // [B, Npix] in-mask pixels, packed offsets
  int* cnt;                  // [B] their count
  int* it_lane;              // [B]
  int* moved;                // [B] this iteration's "own slots moved"
  float* xbuf;               // [2, B, V] current / trial x
  float* items;              // [2, B, K] current / trial sweep items
  float* lane_max;           // [B, 2] step and |x| maxima
  double* part_tie;          // [grid, G]
  double* part_sw;           // [grid, NS]
  float* part_max;           // [grid, 2]
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
};

// Item index of g_i and of H[a][b], a ≤ b (lm_core.cuh's item layout).
__host__ __device__ inline int g_item(int i) { return (i + 1) * (i + 2) / 2; }
__host__ __device__ inline int h_item(int a, int b) {
  return (b + 1) * (b + 2) / 2 + a + 1;
}

// Block shared memory after the warps' cores, in 4-byte words.
struct BlockLayout {
  int jcur, jtri, mean, sidx, tpos, misc, total;
};

__host__ __device__ inline BlockLayout block_layout(int base) {
  BlockLayout L;
  int o = base;
  L.jcur = o; o += kMaxShared;   // joint shared sums at the current point
  L.jtri = o; o += kMaxShared;   // ... at the trial point
  L.mean = o; o += kMaxSlots;    // the tie's means
  L.sidx = o; o += kMaxShared;   // shared item t -> lane item index (int)
  L.tpos = o; o += kMaxSlots;    // slot -> its tied index, or -1 (int)
  L.misc = o; o += 4;            // maxima of the xtol test; nvalid (int)
  L.total = o;
  return L;
}

template <int D, int Prof, int Pose>
__host__ __device__ inline int smem_words() {
  return block_layout(kWarps * core_layout<D, Prof, Pose>(0).total).total;
}

template <int D, int Prof, int Pose>
__global__ void __launch_bounds__(kThreads, 4) tied_lm_kernel(Problem p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const CoreLayout L = core_layout<D, Prof, Pose>(0);
  const BlockLayout BL = block_layout(kWarps * L.total);
  float* sm = smem + warp * L.total;
  float* jcur = smem + BL.jcur;
  float* jtri = smem + BL.jtri;
  float* mean = smem + BL.mean;
  int* sidx = reinterpret_cast<int*>(smem + BL.sidx);
  int* tpos = reinterpret_cast<int*>(smem + BL.tpos);
  float* misc = smem + BL.misc;
  int* nvalid_i = reinterpret_cast<int*>(smem + BL.misc + 2);

  const int B = p.B, V = p.V, G = p.G, n = p.n;
  const int K = (V + 1) * (V + 2) / 2;
  const int NS = 1 + G + G * (G + 1) / 2;
  const int npx = p.wz * p.wy * p.wx;
  const int nblk = gridDim.x, blk = blockIdx.x;
  const int per = (B + nblk - 1) / nblk;
  const int b0 = min(blk * per, B), b1 = min(b0 + per, B);

  // the tables of the tie, and nvalid (an integer count: exact)
  if (tid == 0) *nvalid_i = 0;
  for (int v = tid; v < V; v += kThreads) tpos[v] = -1;
  __syncthreads();
  for (int t = tid; t < G; t += kThreads) tpos[p.tied[t]] = t;
  for (int t = tid; t < NS; t += kThreads) {
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
  for (int b = tid; b < B; b += kThreads) mine += p.valid[b] != 0;
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
    if (lane + 32 * j < K) item_pair(lane + 32 * j, V, &iu[j], &iv[j]);
  }

  auto cluster_of = [&](int b) {
    Cluster c = make_cluster(p.cp + (size_t)b * n * p.P,
                             p.fvalid + (size_t)b * n, p.slot_idx, 0.f, 0.f,
                             0.f, n, p.P, V, p.iso, p.ma, b);
    const int* org = p.origin + (size_t)b * D;
#pragma unroll
    for (int d = 0; d < D; ++d) c.org[d] = (float)org[d];
    return c;
  };
  auto pixels_of = [&](int b) {
    return StreamedPixels<D>{p.list + (size_t)b * npx,
                             p.pixels + (size_t)b * npx, p.cnt[b], p.sy,
                             p.sz, p.my, p.mx, p.wy, p.wx, 1.f / p.norm[b]};
  };
  // one sweep of lane b at x (shared xs) into the warp's first item row
  auto sweep_at = [&](int b) {
    sweep<D, Prof, Pose, 0>(cluster_of(b), sm + L.xs, sm, L, sm + L.acc,
                            lane, iu, iv, K, pixels_of(b));
  };

  // Setup: each warp lists its lanes' in-mask pixels (raster order) and
  // hands x0 to phase B as the untied trial.
  int cur = 0;
  for (int b = b0 + warp; b < b1; b += kWarps) {
    const float* mrow = p.mask + (size_t)b * npx;
    int* idx = p.list + (size_t)b * npx;
    int c = 0;
    for (int k0 = 0; k0 < npx; k0 += 32) {
      const int k = k0 + lane;
      const bool hit = k < npx && mrow[k] != 0.f;
      const unsigned m = __ballot_sync(kFullWarp, hit);
      if (hit) {
        const int z = k / (p.wy * p.wx), r = k - z * p.wy * p.wx;
        const int y = r / p.wx, x = r - y * p.wx;
        idx[c + __popc(m & ((1u << lane) - 1u))] =
            (D == 3 ? (z << p.sz) : 0) | (y << p.sy) | x;
      }
      c += __popc(m);
    }
    if (lane == 0) {
      p.cnt[b] = c;
      p.it_lane[b] = 0;
    }
    if (lane < V)
      p.xbuf[((size_t)B + b) * V + lane] = p.x0[(size_t)b * V + lane];
  }

  float cost = 0.f, lam = p.lam0;
  bool active = true, conv = false;
  int n_run = 0;
  // Trip −1 ties and sweeps the start; every later trip solves, ties,
  // sweeps the trial and decides.
  for (int it = -1; it < p.max_iter; ++it) {
    if (it >= 0 && !active) break;
    const int tri = 1 - cur;
    float* xc = p.xbuf + (size_t)cur * B * V;
    float* xt = p.xbuf + (size_t)tri * B * V;
    const float* ic = p.items + (size_t)cur * B * K;
    float* itr = p.items + (size_t)tri * B * K;

    // phase A: the damped step of each valid lane, untied
    if (it >= 0) {
      for (int b = b0 + warp; b < b1; b += kWarps) {
        float* acc = sm + L.acc;
        if (p.valid[b]) {
          for (int k = lane; k < K; k += 32) acc[k] = ic[(size_t)b * K + k];
          __syncwarp();
          for (int t = 1 + lane; t < NS; t += 32)
            acc[sidx[t]] = jcur[t] / nvalid;
          __syncwarp();
          const float delta =
              damped_solve(acc, lam, V, lane, sm + L.jbuf, sm + L.xt);
          __syncwarp();
          if (lane < V)
            xt[(size_t)b * V + lane] = xc[(size_t)b * V + lane] + delta;
        } else if (lane < V) {
          xt[(size_t)b * V + lane] = xc[(size_t)b * V + lane];
        }
        __syncwarp();
      }
    }
    __syncthreads();
    for (int t = tid; t < G; t += kThreads) {
      double s = 0.0;
      for (int b = b0; b < b1; ++b)
        if (p.valid[b]) s += (double)xt[(size_t)b * V + p.tied[t]];
      p.part_tie[(size_t)blk * G + t] = s;
    }
    grid.sync();

    // phase B: tie, clip, sweep the trial
    for (int t = tid; t < G; t += kThreads) {
      double s = 0.0;
      for (int k = 0; k < nblk; ++k) s += p.part_tie[(size_t)k * G + t];
      mean[t] = (float)s / nvalid;
    }
    __syncthreads();
    for (int b = b0 + warp; b < b1; b += kWarps) {
      float* xs = sm + L.xs;
      float step = 0.f, ax = 0.f, step_own = 0.f, ax_own = 0.f;
      if (lane < V) {
        const int t = tpos[lane];
        float v = t >= 0 ? mean[t] : xt[(size_t)b * V + lane];
        v = clip(v, p.lo[lane], p.hi[lane]);
        xs[lane] = v;
        xt[(size_t)b * V + lane] = v;
        if (it >= 0) {
          const float x = xc[(size_t)b * V + lane];
          step = fabsf(v - x);
          ax = fabsf(x);
          if (t < 0) { step_own = step; ax_own = ax; }
        }
      }
      if (it >= 0) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          step = fmaxf(step, __shfl_xor_sync(kFullWarp, step, o));
          ax = fmaxf(ax, __shfl_xor_sync(kFullWarp, ax, o));
          step_own = fmaxf(step_own, __shfl_xor_sync(kFullWarp, step_own, o));
          ax_own = fmaxf(ax_own, __shfl_xor_sync(kFullWarp, ax_own, o));
        }
        // a rigid bucket's inert position slots: no step, |x| in xn
        const float xn = p.ma.xn != nullptr ? p.ma.xn[b] : 0.f;
        ax = fmaxf(ax, xn);
        ax_own = fmaxf(ax_own, xn);
        const float tol = fmaxf(p.xtol * (p.xtol + ax_own), 1e-6f * ax_own);
        if (lane == 0) {
          p.lane_max[2 * b] = step;
          p.lane_max[2 * b + 1] = ax;
          p.moved[b] = step_own > tol;
        }
      }
      __syncwarp();
      if (p.valid[b]) {
        sweep_at(b);
        for (int k = lane; k < K; k += 32)
          itr[(size_t)b * K + k] = sm[L.acc + k];
      }
      __syncwarp();
    }
    __syncthreads();
    for (int t = tid; t < NS + 2; t += kThreads) {
      if (t < NS) {
        double s = 0.0;
        for (int b = b0; b < b1; ++b)
          if (p.valid[b]) s += (double)itr[(size_t)b * K + sidx[t]];
        p.part_sw[(size_t)blk * NS + t] = s;
      } else if (it >= 0) {
        float m = 0.f;
        for (int b = b0; b < b1; ++b)
          m = fmaxf(m, p.lane_max[2 * b + (t - NS)]);
        p.part_max[2 * blk + (t - NS)] = m;
      }
    }
    grid.sync();

    // phase C: the joint sums and decision, alike in every block
    for (int t = tid; t < NS + 2; t += kThreads) {
      if (t < NS) {
        double s = 0.0;
        for (int k = 0; k < nblk; ++k) s += p.part_sw[(size_t)k * NS + t];
        jtri[t] = (float)s;
      } else if (it >= 0) {
        float m = 0.f;
        for (int k = 0; k < nblk; ++k)
          m = fmaxf(m, p.part_max[2 * k + (t - NS)]);
        misc[t - NS] = m;
      }
    }
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
      if (better) {
        for (int b = b0 + warp; b < b1; b += kWarps)
          if (lane == 0 && p.moved[b]) p.it_lane[b] = it + 1;
      }
      conv = conv || conv_now;
      active = active && !done;
      cost = cost_new;
      lam = lam_new;
      n_run = it + 1;
    }
    if (better) {
      cur = tri;
      for (int t = tid; t < NS; t += kThreads) jcur[t] = jtri[t];
    }
    __syncthreads();
  }

  // each lane's own cost at the solution: one more sweep, unweighted
  const float* xc = p.xbuf + (size_t)cur * B * V;
  for (int b = b0 + warp; b < b1; b += kWarps) {
    float* xs = sm + L.xs;
    if (lane < V) {
      xs[lane] = xc[(size_t)b * V + lane];
      p.x_out[(size_t)b * V + lane] = xs[lane];
    }
    __syncwarp();
    sweep_at(b);
    if (lane == 0) {
      const bool ok = p.valid[b] != 0;
      p.cost[b] = sm[L.acc];
      p.n_iter[b] = ok ? p.it_lane[b] : 0;
      p.converged[b] = ok && (conv || p.it_lane[b] < n_run);
    }
    __syncwarp();
  }
  if (blk == 0 && tid == 0) *p.iterations = n_run;
}

template <int D, int Prof, int Pose>
cudaError_t configure(size_t* smem, int* blocks) {
  auto kernel = tied_lm_kernel<D, Prof, Pose>;
  *smem = sizeof(float) * (size_t)smem_words<D, Prof, Pose>();
  cudaError_t e = cudaSuccess;
  if (*smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)*smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, *smem)) != cudaSuccess)
    return e;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

// One instantiation: op 0 launches, op 1 reports the co-resident blocks.
template <int D, int Prof, int Pose>
int run(int op, Problem* p, cudaStream_t stream, int* grid_out) {
  size_t smem = 0;
  int blocks = 0;
  cudaError_t e = configure<D, Prof, Pose>(&smem, &blocks);
  if (e != cudaSuccess) return (int)e;
  if (op == 1) {
    *grid_out = blocks;
    return 0;
  }
  const int want = (p->B + kWarps - 1) / kWarps;
  const int grid = want < blocks ? want : blocks;
  *grid_out = grid;
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {p};
  e = cudaLaunchCooperativeKernel((const void*)tied_lm_kernel<D, Prof, Pose>,
                                  dim3(grid), dim3(kThreads), args, smem,
                                  stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int D, int Pose>
int run_prof(int prof, int op, Problem* p, cudaStream_t s, int* g) {
  switch (prof) {
    case kGauss: return run<D, kGauss, Pose>(op, p, s, g);
    case kRing: return run<D, kRing, Pose>(op, p, s, g);
    case kHat: return run<D, kHat, Pose>(op, p, s, g);
    case kDisc: return run<D, kDisc, Pose>(op, p, s, g);
    case kInvSeries: return run<D, kInvSeries, Pose>(op, p, s, g);
  }
  return (int)cudaErrorInvalidValue;
}

int dispatch(int D, int prof, int pose, int op, Problem* p, cudaStream_t s,
             int* g) {
  if (D == 2 && pose == kNoPose) return run_prof<2, kNoPose>(prof, op, p, s, g);
  if (D == 2 && pose == kNgon2D) return run_prof<2, kNgon2D>(prof, op, p, s, g);
  if (D == 3 && pose == kNoPose) return run_prof<3, kNoPose>(prof, op, p, s, g);
  if (D == 3 && pose == kAxis3D) return run_prof<3, kAxis3D>(prof, op, p, s, g);
  if (D == 3 && pose == kRotvec3D)
    return run_prof<3, kRotvec3D>(prof, op, p, s, g);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Blocks of kWarps warps that the card holds at once for an instantiation
// (the most a launch takes); returns the CUDA error code.
int tied_lm_max_blocks(int D, int prof, int pose, int* blocks) {
  return dispatch(D, prof, pose, 1, nullptr, nullptr, blocks);
}

// Launches the joint solve on `stream` as one cooperative launch of
// min(ceil(B / kWarps), co-resident blocks) blocks (*grid_out).  The
// arguments are lm_core.cuh's (prof, nx, pose, fit_dist, circ, rc_fixed,
// base, xn; for a rigid bucket V is the compact length) plus the G tied
// slots `tied` (ascending, < V) and the scratch: list [B, Npix] and cnt,
// it_lane, moved [B] (int); xbuf [2·B·V], items [2·B·K], lane_max [2·B]
// (float); part_tie [B·G], part_sw [B·NS] (double), part_max [2·B]
// (float), K = (V+1)(V+2)/2, NS = 1 + G + G(G+1)/2; `iterations` [1]
// gets the joint loop's iteration count.  Returns the CUDA
// error code (0 = cudaSuccess); cudaErrorInvalidValue for a problem the
// kernel does not take.
int tied_lm_launch(
    const float* pixels, const float* mask, const int* origin,
    const float* x0, const float* cp, const float* norm, const int* valid,
    const float* fvalid, const int* slot_idx, const int* tied,
    const float* lo, const float* hi,
    int* list, int* cnt, int* it_lane, int* moved, float* xbuf,
    float* items, float* lane_max, double* part_tie, double* part_sw,
    float* part_max,
    int B, int n, int P, int V, int G, int iso, int D, int wz, int wy, int wx,
    int max_iter, float ftol, float xtol, float lam0, float lam_up,
    float lam_down, float lam_max, float plateau,
    int prof, int nx, int pose, int fit_dist, float circ, float rc_fixed,
    const float* base, const float* xn,
    float* x_out, float* cost, int* n_iter, int* converged, int* iterations,
    int* grid_out, void* stream) {
  const int n_ex = prof == kInvSeries ? nx : (prof == kRing || prof == kHat);
  const int q = pose == kNgon2D ? PoseDim<kNgon2D>::Q
              : pose == kAxis3D ? PoseDim<kAxis3D>::Q
              : pose == kRotvec3D ? PoseDim<kRotvec3D>::Q : 0;
  *grid_out = 0;
  if ((D != 2 && D != 3) || V < 1 || V >= kMaxSlots || G < 1 || G > V ||
      n < 1 || n > kMaxFeatures || P != 2 + D + (iso ? 1 : D) + n_ex ||
      nx != n_ex || nx > kMaxSeries || wz < 1 || wy < 1 || wx < 1 ||
      (D == 2 && wz != 1) || B < 0 ||
      (pose != kNoPose && (xn == nullptr || V < q + fit_dist ||
                           (pose != kAxis3D && base == nullptr) ||
                           (pose == kAxis3D && n != 2))))
    return (int)cudaErrorInvalidValue;
  const int bx = bits_for(wx), by = bits_for(wy), bz = bits_for(wz);
  if (bx + by + bz > 30) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Problem p{pixels, mask, origin, x0, cp, norm, valid, fvalid, slot_idx,
            tied, list, cnt, it_lane, moved, xbuf, items, lane_max,
            part_tie, part_sw, part_max, B, n, P, V, G, iso, wz, wy, wx,
            bx, bx + by, (1 << by) - 1, (1 << bx) - 1, max_iter, ftol, xtol,
            lam0, lam_up, lam_down, lam_max, plateau, lo, hi,
            ModelArgs{nx, base, circ, rc_fixed, fit_dist, xn},
            x_out, cost, n_iter, converged, iterations};
  return dispatch(D, prof, pose, 0, &p, (cudaStream_t)stream, grid_out);
}

}  // extern "C"
