// Fused window-gather + Levenberg–Marquardt solve for 2D cluster buckets,
// one warp per cluster: every built-in profile, unconstrained or with a
// rigid 2D n-gon pose.
//
// Replaces the TPU kernel ops/pallas_lm.py::make_pallas_lm.kernel_fused
// (clustertracking_tpu/ops/pallas_lm.py:1213, entered by solve_fused),
// which computes the same function in 128-lane tiles: it cuts each
// cluster's window out of the frame stack, builds the within-radius fit
// mask once from the gather-time positions, and runs the whole masked LM
// solve (one Jacobian sweep per iteration, Marquardt damping, projected
// trial point, ftol/xtol/plateau/stuck tests) without leaving the chip.
// Its rigid-pose variant (pallas_lm.py:330-358, :570-585, :759-770; the
// TPU's config-3 hot path) is the Pose = kNgon2D instantiation here: the
// compact vector [center, angle, (distance), non-position slots], the
// n-gon positions and their chain-rule Jacobian (lm_core.cuh).
//
// With rounds > 0 a launch also runs the bucket solver's refit-on-shift
// loop (refine.py::_shard_solver, the reference's host loop around its
// solve_fused) inside each warp: the warp takes its cluster's positions
// at the current x (its slots, or the rigid pose map), centres and clamps
// the window as ops/gather.py::origins_for does (float32 min and max over
// the features, rint half to even), cuts and solves it, keeps the round
// of least rms = sqrt(cost/npix), and goes round again while a position
// moved more than max_shift, up to `rounds` rounds: each cluster runs the
// rounds the host loop gives it, no more, and no round needs the host.
// Its outputs are the best round's x, rms, converged, cost and npix and
// the iterations of every round; each warp that refits adds its rounds
// past the first to one device counter.
//
// What bounds it on the H100: nothing is read from device memory inside
// the LM loop, so a solve costs what its warp executes and waits for: the
// per-pixel model and Jacobian arithmetic (divisions, an expf), the
// cost/g/H products, and one damped Cholesky per iteration.  A warp's
// solve is one dependent chain, and with 12-16 warps on an SM the time is
// that chain's latency, not the FP32 rate the bound counts.  The shared
// core in lm_core.cuh says what it does about each link (one warp per
// cluster, lanes over pixels, four pixels' chains interleaved per lane,
// products in register accumulators, the Cholesky across the warp).
// This file cuts the window out of the frame and, while it does, compacts
// it to the pixels inside the fit mask, in raster order (a ballot and a
// popcount per 32 pixels): each keeps its value and its (y, x) packed into
// one int, and every sweep visits only those — a third to a half of a
// window lies outside the mask and weighs exactly 0.  Shared memory per
// warp is 2·wy·wx + 153 (the refit loop's) + 2,007 words (gauss,
// unconstrained; a profile's extras and a pose's constants add to the
// core), so a 13×13 window takes ~10.0 KB; a block is one warp.
//
// Numerics follow the reference kernel: the mask is computed as
// (off − rel)·(1/r) with explicit _rn intrinsics, so npix matches it
// exactly; a listed pixel weighs 1/norm.  Sums over pixels run per lane
// and then across lanes, so results agree with the plain version to
// float32 rounding, not bit for bit (lm_core.cuh says why the build has
// -fmad=false).  Build without --use_fast_math: expf accuracy moves accept
// decisions.
//
// Lanes with valid == 0 are not solved: x = clip(x0), cost = 0,
// n_iter = 0, converged = 0, npix = 0 (what the reference kernel writes
// for a frozen tile).  A lane whose frame index or window lies outside
// the frame stack is not read: its x and cost are NaN and npix is 0.
// With rounds > 0 such lanes keep their start (x = x0 unclipped, rms =
// inf, cost, n_iter, converged and npix 0), as the host loop leaves them.

#include "lm_core.cuh"

namespace {

using namespace lmcore;

struct Problem {
  const float* frames;
  int T, H, W;
  const int* frame_idx;      // [B]
  const int* origin;         // [B, 2] (rounds = 0)
  const float* x0;           // [B, V]
  const float* cp;           // [B, n, P]
  const float* pos_at;       // [B, n, 2] (rounds = 0)
  const float* norm;         // [B]
  const int* valid;          // [B]
  const float* fvalid;       // [B, n]
  const int* slot_idx;       // [n, P]
  int B, n, P, V, iso, wy, wx;
  float inv_ry, inv_rx;
  int rounds;                // 0: one solve at pos_at / origin; else the loop
  float max_shift;
  LMConf lm;
  ModelArgs ma;              // profile extras and rigid pose
  float* x_out;              // [B, V]
  float* cost;               // [B]
  int* n_iter;               // [B]
  int* converged;            // [B]
  float* npix;               // [B]
  float* rms;                // [B] (rounds > 0)
  unsigned long long* refits;  // rounds past the first (rounds > 0)
};

// The window's in-mask pixels in raster order: packed (y << 16 | x) and
// value, in shared memory; each weighs 1/norm.
struct ListedPixels {
  const int* idx;
  const float* val;
  int cnt;
  float wc;
  __device__ int count() const { return cnt; }
  __device__ void load(int k, float* off, float& v, float& w) const {
    const int pk = idx[k];
    off[0] = (float)(pk >> 16);
    off[1] = (float)(pk & 0xffff);
    v = val[k];
    w = wc;
  }
};

// The refit loop's words beside the pixel list: the gather-time
// positions [n][2], the positions after the round's solve [n][2], the
// best round's x, and its rms, cost, npix, iterations and converged flag.
constexpr int kLoopWords = 4 * kMaxFeatures + kMaxSlots + 5;

// Per-warp shared memory: the pixel list (2·npix words, the mask's worst
// case), the refit loop's words, then the LM core.
template <int Prof, int Pose>
__host__ __device__ inline CoreLayout warp_layout(int npix) {
  return core_layout<2, Prof, Pose>(2 * npix + kLoopWords);
}

// Feature i's position at x: its slots (a const position: its value), or
// in a rigid bucket the n-gon pose map that stage_pose evaluates.
template <int Pose>
__device__ inline void feature_position(const Cluster& c, const float* x,
                                        int i, float* pos) {
  if constexpr (Pose == kNoPose) {
    const float* cpi = c.cp + i * c.P;
    const int* si = c.slot_idx + i * c.P;
    pos[0] = si[2] >= 0 ? x[si[2]] : cpi[2];
    pos[1] = si[3] >= 0 ? x[si[3]] : cpi[3];
  } else {
    const float Rc = c.fit_dist ? c.circ * x[PoseDim<Pose>::Q] : c.rc_fixed;
    const float a = x[2] + c.base[i];
    pos[0] = x[0] + Rc * sinf(a);
    pos[1] = x[1] + Rc * cosf(a);
  }
}

// min / max that keep a NaN once they meet one, as torch.amin / amax do.
__device__ inline float nan_min(float a, float v) {
  return (v < a || v != v) ? v : a;
}
__device__ inline float nan_max(float a, float v) {
  return (v > a || v != v) ? v : a;
}

// The window corner along one axis for positions spanning [lo, hi]:
// ops/gather.py::origins_for, rounded half to even and clamped so that
// the window lies inside the frame.
__device__ inline int window_corner(float lo, float hi, int w, int extent) {
  const float center = 0.5f * (lo + hi);
  const int o = __float2int_rn(center - 0.5f * (float)(w - 1));
  return min(max(o, 0), extent - w);
}

// One warp, one block, one cluster: a warp that ends frees its place on
// the SM for the next cluster at once (iteration counts spread 3x around
// their mean, and a block of several warps would hold its shared memory
// and registers until its slowest cluster ends).  Looped: the refit loop
// (rounds > 0) or one solve, a template tag: with a run-time flag the one
// kernel took 130 registers and 3,960 instructions against 121 and 3,320
// before the loop, and config 1's bucket ran 1.66 ms a call against 1.35;
// as a tag, 127 and 3,792 in the looped kernel, 1.39 ms (NVIDIA H100).
template <int Prof, int Pose, int VM, bool Looped>
__global__ void __launch_bounds__(32, MinBlocks<VM>::N) fused_lm_2d_kernel(Problem p) {
  extern __shared__ float sm[];
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int npx = p.wy * p.wx;
  const CoreLayout L = warp_layout<Prof, Pose>(npx);
  int* idx = reinterpret_cast<int*>(sm);
  float* val = sm + npx;
  float* pa = sm + 2 * npx;               // gather-time positions [n][2]
  float* pn = pa + 2 * kMaxFeatures;      // positions after the solve
  float* xb = pn + 2 * kMaxFeatures;      // the best round's x
  float* best = xb + kMaxSlots;           // its rms, cost, npix
  int* best_i = reinterpret_cast<int*>(best + 3);   // iterations, converged
  const int V = p.V, n = p.n;
  float* xs = sm + L.xs;

  if (lane < V) {
    const float x0 = p.x0[(size_t)b * V + lane];
    xs[lane] = clip(x0, p.lm.lo[lane], p.lm.hi[lane]);
    xb[lane] = x0;
  }
  if (lane == 0) {
    best[0] = __int_as_float(0x7f800000);   // +inf
    best[1] = 0.f;
    best[2] = 0.f;
    best_i[0] = 0;
    best_i[1] = 0;
  }
  const int fi = p.frame_idx[b];
  __syncwarp();
  Cluster c = make_cluster(p.cp + (size_t)b * n * p.P,
                           p.fvalid + (size_t)b * n, p.slot_idx, 0.f, 0.f,
                           0.f, n, p.P, V, p.iso, p.ma, b);
  int round = 0;
  if (p.valid[b]) {
    stage_slots<2, Prof>(c, reinterpret_cast<int*>(sm + L.fs), lane);
    const float* frame = p.frames + (size_t)fi * p.H * p.W;
    // One trip a refit round (one trip without the loop): a single call
    // site of lm_run, whose inlined sweep is the bulk of the code.
    for (;;) {
      int oy, ox;
      if constexpr (Looped) {
        // the first round centres on the start as given, later ones on
        // the last solve's x
        if (lane < n) feature_position<Pose>(c, round == 0 ? xb : xs, lane,
                                             pa + 2 * lane);
        __syncwarp();
        float lo0 = pa[0], hi0 = pa[0], lo1 = pa[1], hi1 = pa[1];
        for (int i = 1; i < n; ++i) {
          lo0 = nan_min(lo0, pa[2 * i]);
          hi0 = nan_max(hi0, pa[2 * i]);
          lo1 = nan_min(lo1, pa[2 * i + 1]);
          hi1 = nan_max(hi1, pa[2 * i + 1]);
        }
        oy = window_corner(lo0, hi0, p.wy, p.H);
        ox = window_corner(lo1, hi1, p.wx, p.W);
      } else {
        if (lane < n) {
          const float* q = p.pos_at + ((size_t)b * n + lane) * 2;
          pa[2 * lane] = q[0];
          pa[2 * lane + 1] = q[1];
        }
        __syncwarp();
        oy = p.origin[2 * b];
        ox = p.origin[2 * b + 1];
      }
      const bool inside = fi >= 0 && fi < p.T && oy >= 0 && ox >= 0 &&
                          oy + p.wy <= p.H && ox + p.wx <= p.W;
      if (!inside) {
        // not read; with the loop the round fails and the lane keeps its
        // best round (its start, since a window inside the frame never
        // leaves it)
        if constexpr (!Looped) {
          const float nan = __int_as_float(0x7fc00000);
          if (lane < V) p.x_out[(size_t)b * V + lane] = nan;
          if (lane == 0) {
            p.cost[b] = nan;
            p.n_iter[b] = 0;
            p.converged[b] = 0;
            p.npix[b] = 0.f;
          }
          return;
        }
        break;
      }
      c.org[0] = (float)oy;
      c.org[1] = (float)ox;

      // Stage the window's in-mask pixels (the fit mask is computed once a
      // round, from the gather-time positions, as the reference kernel
      // does).
      const float orgy = (float)oy, orgx = (float)ox;
      int cnt = 0;
      for (int q0 = 0; q0 < npx; q0 += 32) {
        const int q = q0 + lane;
        const int qy = q / p.wx, qx = q - qy * p.wx;
        const float offy = (float)qy, offx = (float)qx;
        bool hit = false;
        for (int i = 0; q < npx && i < n; ++i) {
          if (!(c.fvalid[i] > 0.5f)) continue;
          const float* pai = pa + 2 * i;
          const float dmy = __fmul_rn(__fsub_rn(offy, __fsub_rn(pai[0], orgy)), p.inv_ry);
          const float dmx = __fmul_rn(__fsub_rn(offx, __fsub_rn(pai[1], orgx)), p.inv_rx);
          const float r2m = __fadd_rn(__fmul_rn(dmy, dmy), __fmul_rn(dmx, dmx));
          hit = hit || (r2m <= 1.f);
        }
        const unsigned m = __ballot_sync(kFullWarp, hit);
        if (hit) {
          const int k = cnt + __popc(m & ((1u << lane) - 1u));
          idx[k] = (qy << 16) | qx;
          val[k] = frame[(size_t)(oy + qy) * p.W + (ox + qx)];
        }
        cnt += __popc(m);
      }
      __syncwarp();

      const LMOut r = lm_run<2, Prof, Pose, VM>(
          c, p.lm, sm, L, lane, ListedPixels{idx, val, cnt, 1.f / p.norm[b]});

      if constexpr (!Looped) {
        if (lane < V) p.x_out[(size_t)b * V + lane] = xs[lane];
        if (lane == 0) {
          p.cost[b] = r.cost;
          p.n_iter[b] = r.iters;
          p.converged[b] = r.conv ? 1 : 0;
          p.npix[b] = (float)cnt;
        }
        return;
      }
      // the round's rms (an empty mask is a failed fit, not a perfect one)
      // and the host loop's best-round carry
      const float rms = cnt > 0 ? sqrtf(r.cost / (float)cnt)
                                : __int_as_float(0x7f800000);
      const bool improved = rms < best[0];
      if (improved && lane < V) xb[lane] = xs[lane];
      __syncwarp();
      if (lane == 0) {
        best_i[0] += r.iters;
        if (improved) {
          best[0] = rms;
          best[1] = r.cost;
          best[2] = (float)cnt;
          best_i[1] = r.conv ? 1 : 0;
        }
      }
      if (++round >= p.rounds) break;
      // refit while a position moved more than max_shift (NaN: stop)
      if (lane < n) feature_position<Pose>(c, xs, lane, pn + 2 * lane);
      __syncwarp();
      float shift = fabsf(pn[0] - pa[0]);
      for (int k = 1; k < 2 * n; ++k) shift = nan_max(shift, fabsf(pn[k] - pa[k]));
      __syncwarp();
      if (!(shift > p.max_shift)) break;
    }
  } else if constexpr (!Looped) {
    const int oy = p.origin[2 * b], ox = p.origin[2 * b + 1];
    const bool inside = fi >= 0 && fi < p.T && oy >= 0 && ox >= 0 &&
                        oy + p.wy <= p.H && ox + p.wx <= p.W;
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
  __syncwarp();
  if (lane < V) p.x_out[(size_t)b * V + lane] = xb[lane];
  if (lane == 0) {
    p.rms[b] = best[0];
    p.cost[b] = best[1];
    p.npix[b] = best[2];
    p.n_iter[b] = best_i[0];
    p.converged[b] = best_i[1];
    if (round > 1) atomicAdd(p.refits, (unsigned long long)(round - 1));
  }
}

template <class Kernel>
int launch_kernel(Kernel kernel, const Problem& p, size_t smem,
                  cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<p.B, 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int Prof, int Pose, int VM>
int launch_t(Problem p, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (size_t)warp_layout<Prof, Pose>(p.wy * p.wx).total;
  constexpr size_t kBlockBudget = 200 * 1024;
  if (smem > kBlockBudget) return (int)cudaErrorInvalidValue;
  return p.rounds > 0
             ? launch_kernel(fused_lm_2d_kernel<Prof, Pose, VM, true>, p,
                             smem, stream)
             : launch_kernel(fused_lm_2d_kernel<Prof, Pose, VM, false>, p,
                             smem, stream);
}

// The gauss profile has register instantiations at each slot-count
// ceiling; the other profiles, and V past the last ceiling, take the
// tile instantiation.
template <int Pose>
int launch_pose(int prof, Problem p, cudaStream_t s) {
  switch (prof) {
    case kGauss:
      if (p.V <= kRegSlotsLow) return launch_t<kGauss, Pose, kRegSlotsLow>(p, s);
      if (p.V <= kRegSlotsMid) return launch_t<kGauss, Pose, kRegSlotsMid>(p, s);
      if (p.V <= kRegSlotsHigh) return launch_t<kGauss, Pose, kRegSlotsHigh>(p, s);
      return launch_t<kGauss, Pose, 0>(p, s);
    case kRing: return launch_t<kRing, Pose, 0>(p, s);
    case kHat: return launch_t<kHat, Pose, 0>(p, s);
    case kDisc: return launch_t<kDisc, Pose, 0>(p, s);
    case kInvSeries: return launch_t<kInvSeries, Pose, 0>(p, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <int Pose>
int words_pose(int prof, int npix) {
  switch (prof) {
    case kGauss: return warp_layout<kGauss, Pose>(npix).total;
    case kRing: return warp_layout<kRing, Pose>(npix).total;
    case kHat: return warp_layout<kHat, Pose>(npix).total;
    case kDisc: return warp_layout<kDisc, Pose>(npix).total;
    case kInvSeries: return warp_layout<kInvSeries, Pose>(npix).total;
  }
  return -1;
}

}  // namespace

// Per-warp shared memory of a launch, in 4-byte words (−1: no such
// instantiation).
extern "C" int fused_lm_2d_smem_words(int npix, int prof, int pose) {
  if (pose == kNoPose) return words_pose<kNoPose>(prof, npix);
  if (pose == kNgon2D) return words_pose<kNgon2D>(prof, npix);
  return -1;
}

// Launches the solve on `stream`.  rounds = 0: one solve at pos_at and
// origin; rounds > 0: up to that many refit rounds (pos_at and origin
// unused, may be null), refitting while a position moved more than
// max_shift, the rms out in rms [B] and the rounds past the first added
// to *refits.  prof / pose: the profile tag and pose
// kind (lm_core.cuh; pose kNoPose or kNgon2D); nx: extras per feature;
// for a rigid bucket (V = the compact length) fit_dist, circ, rc_fixed =
// circ·distance, base = the n-gon angles [n] and xn [B] = the inert
// position slots' max |x|.  Returns the cudaGetLastError() code of the
// launch (0 = cudaSuccess), or cudaErrorInvalidValue for a problem the
// kernel does not take.
extern "C" int fused_lm_2d_launch(
    const float* frames, int T, int H, int W,
    const int* frame_idx, const int* origin, const float* x0,
    const float* cp, const float* pos_at, const float* norm,
    const int* valid, const float* fvalid, const int* slot_idx,
    const float* lo, const float* hi,
    int B, int n, int P, int V, int iso, int wy, int wx,
    float inv_ry, float inv_rx, int rounds, float max_shift, int max_iter,
    float ftol, float xtol, float lam0, float lam_up, float lam_down,
    float lam_max, float plateau,
    int prof, int nx, int pose, int fit_dist, float circ, float rc_fixed,
    const float* base, const float* xn,
    float* x_out, float* cost, int* n_iter, int* converged, float* npix,
    float* rms, unsigned long long* refits, void* stream) {
  const int n_ex = prof == kInvSeries ? nx : (prof == kRing || prof == kHat);
  if (V < 1 || V > kMaxSlots || n < 1 || n > kMaxFeatures ||
      P != (iso ? 5 : 6) + n_ex || nx != n_ex || nx > kMaxSeries ||
      wy < 1 || wx < 1 || B < 0 || (pose != kNoPose && pose != kNgon2D) ||
      (pose != kNoPose && (base == nullptr || xn == nullptr ||
                           V < PoseDim<kNgon2D>::Q + fit_dist)) ||
      rounds < 0 || (rounds == 0 && (pos_at == nullptr || origin == nullptr)) ||
      (rounds > 0 && (rms == nullptr || refits == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return 0;
  const LMConf lm{lo, hi, max_iter, ftol, xtol, lam0, lam_up, lam_down,
                  lam_max, plateau};
  const ModelArgs ma{nx, base, circ, rc_fixed, fit_dist, xn};
  Problem p{frames, T, H, W, frame_idx, origin, x0, cp, pos_at, norm, valid,
            fvalid, slot_idx, B, n, P, V, iso, wy, wx, inv_ry, inv_rx,
            rounds, max_shift, lm, ma, x_out, cost, n_iter, converged, npix,
            rms, refits};
  cudaStream_t s = (cudaStream_t)stream;
  if (pose == kNgon2D) return launch_pose<kNgon2D>(prof, p, s);
  return launch_pose<kNoPose>(prof, p, s);
}
