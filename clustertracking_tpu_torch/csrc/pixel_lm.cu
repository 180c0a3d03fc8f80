// Levenberg–Marquardt solve of cluster buckets on windows gathered
// beforehand (2D and 3D), one warp per cluster: every built-in profile,
// unconstrained or (3D) with a rigid pose.
//
// Replaces two TPU kernels of ops/pallas_lm.py::make_pallas_lm, both
// entered by its `solve` (clustertracking_tpu/ops/pallas_lm.py:1330):
//   * `kernel` (pallas_lm.py:1143, launched at :1411): the LM on pixels
//     held resident, for 3D windows in a center-out voxel order with the
//     per-chunk dead-mask skip (:389-418, :897-922);
//   * `kernel_stream` (pallas_lm.py:1161, launched at :1379): the same LM
//     with pixel chunks copied from HBM on every sweep, for windows too
//     big to keep resident.
// Both modes are one source here: `Streamed` selects where a sweep reads
// its pixels from.  The rigid-pose variants of both (pallas_lm.py:330-358,
// :586-701, :771-814) are the Pose = kAxis3D (3D dimers: center, polar,
// azimuth) and kRotvec3D (trimers, tetramers: center, rotation vector)
// instantiations (lm_core.cuh); a rigid 2D bucket takes fused_lm_2d.cu.
//
// The GPU form of the center-out order and the dead-chunk skip: the fit
// mask depends only on the gather-time positions, so it is fixed for the
// whole solve.  Each warp builds, once per solve, the list of its window's
// in-mask voxels in raster order (a ballot compaction over the window's
// rows, read along x), and every sweep visits only those.  Out-of-mask
// voxels weigh exactly 0, so skipping them computes the same function,
// and on a 3D box most voxels are out of the mask (config 4: roughly a
// quarter to a third of the 9×13×13 voxels are in it).  The list holds
// each voxel's window coordinates packed into one int (x in the low bits,
// then y, then z), so a sweep decodes them with shifts and masks instead
// of integer division.
//
// What bounds it on the H100: a solve costs what its warp executes and
// waits for, not bytes.  By the SM clock of the design with register sums
// (config 4, B = 16,384, 8 warps an SM; PERF.md section 6), a sweep and
// its damped solve take ~68k cycles a warp: the pixel rows 60% (per pixel
// and feature a dependent chain of divisions, an expf and shared stores),
// the damped Cholesky 22%, the cost/g/H sums 14% and their warp reduction
// 2%.  So latency binds, and warps hide it: the shared core in lm_core.cuh
// interleaves several pixels' chains per lane, keeps no warp barrier in
// the row build and runs the Cholesky across the warp, and the kernel
// keeps as many warps on an SM as registers and shared memory allow.  At
// the high slot ceiling (V = 11..14; config 4's V = 14) the register sums
// held 128 float accumulators a lane, which capped the kernel at 8 warps
// an SM.  There the sums run on the FP64 tensor cores instead
// (lm_core.cuh's sweep_mma: the rows into the shared J tile as before,
// then zᵀz by mma.sync m8n8k4 f64, each item rounded to FP32 once), so
// the instantiation fits 20 warps an SM (Sums below): a launch of
// config 4's 16,384 lanes went from 11.7 ms to 6.0 ms.  Resident mode
// stages the in-mask voxels' values beside their coordinates in shared
// memory (2·Npix words reserved per warp, the mask's worst case), so
// nothing is read from device memory inside the LM loop.  Streamed mode
// keeps only the core's ~2.1k words per warp in shared memory, writes
// the list to a global scratch row, and reads each listed voxel's value
// from the pixel array on every sweep — coalesced along x, mostly from L2
// — so any window up to the routing cap runs, and an SM holds as many
// warps as registers allow.  Both modes sum in one order and agree bit
// for bit; ops/pixel_lm.py picks the mode that holds more warps per SM
// (config 4: 10 resident, 20 streamed).
//
// Weights: every listed voxel weighs 1/norm (the mask·(1/norm) of the plain
// version).  The mask is (off − rel)·(1/r) with explicit _rn intrinsics, as
// fused_lm_2d.cu and the reference kernel compute it, so npix matches the
// plain version exactly.
//
// Lanes with valid == 0 are not solved: x = clip(x0), cost = 0,
// n_iter = 0, converged = 0, npix = 0.  A lane whose in-mask pixels hold
// NaN (window_gather's out-of-stack lanes) ends with cost NaN, as the
// plain version does.

#include "lm_core.cuh"
#include "pixel_list.cuh"

namespace {

using namespace lmcore;

struct Problem {
  const float* pixels;       // [B, Npix], raster order
  const int* origin;         // [B, D]
  const float* x0;           // [B, V]
  const float* cp;           // [B, n, P]
  const float* pos_at;       // [B, n, D]
  const float* norm;         // [B]
  const int* valid;          // [B]
  const float* fvalid;       // [B, n]
  const int* slot_idx;       // [n, P]
  int* scratch;              // [B, Npix] voxel lists (streamed mode)
  int B, n, P, V, iso;
  int wz, wy, wx;            // window (wz = 1 in 2D)
  int sy, sz, my, mx;        // coordinate packing: shifts and masks
  float inv_r[3];            // 1/radius, outermost axis first
  LMConf lm;
  ModelArgs ma;              // profile extras and rigid pose
  float* x_out;              // [B, V]
  float* cost;               // [B]
  int* n_iter;               // [B]
  int* converged;            // [B]
  float* npix;               // [B]
};

// Resident: the listed voxels' packed coordinates and values in shared
// memory.
template <int D>
struct ResidentPixels {
  const int* idx;
  const float* val;
  int cnt, sy, sz, my, mx;
  float wc;
  __device__ int count() const { return cnt; }
  __device__ void load(int k, float* off, float& v, float& w) const {
    int z, y, x;
    unpack<D>(idx[k], sy, sz, my, mx, &z, &y, &x);
    offsets<D>(z, y, x, off);
    v = val[k];
    w = wc;
  }
};

// Per-warp shared memory: (resident) the voxel list and its values, then
// the LM core.
template <int D, int Prof, int Pose>
__host__ __device__ inline CoreLayout warp_layout(int npix, bool streamed) {
  return core_layout<D, Prof, Pose>(streamed ? 0 : 2 * npix);
}

// How an instantiation sums, and the one-warp blocks an SM its registers
// are held to: at the high ceiling on the FP64 tensor cores (lm_core.cuh's
// sweep_mma), which needs none of the register path's 128 accumulators,
// so 20 blocks fit (96 registers a thread: 80–94 used, no spill; 22 and
// 24 spill, and one, three or four pixels a lane measured slower:
// PERF.md); the other ceilings and the tile sum in FP32 registers.  So a
// gauss launch sums on the tensor cores where kRegSlotsMid < V <=
// kRegSlotsHigh (run_prof), the rule that ops/pixel_lm.py's sum_path
// mirrors with _REG_SLOTS_MID and _REG_SLOTS_HIGH.
template <int VM>
struct Sums {
  static constexpr bool kMma = VM == kRegSlotsHigh;
  static constexpr int kBlocks = kMma ? 20 : MinBlocks<VM>::N;
};
static_assert(kRegSlotsMid == 10 && kRegSlotsHigh == 14,
              "ops/pixel_lm.py's _REG_SLOTS_MID, _REG_SLOTS_HIGH");
static_assert(Sums<kRegSlotsHigh>::kMma && !Sums<kRegSlotsMid>::kMma &&
                  !Sums<kRegSlotsLow>::kMma && !Sums<0>::kMma,
              "only the high ceiling sums on the tensor cores");

// One warp, one block, one cluster: a warp that ends frees its place on
// the SM for the next cluster at once (iteration counts spread 3x around
// their mean, and a block of several warps would hold its shared memory
// and registers until its slowest cluster ends).
template <int D, bool Streamed, int Prof, int Pose, int VM>
__global__ void __launch_bounds__(32, Sums<VM>::kBlocks) pixel_lm_kernel(Problem p) {
  extern __shared__ float sm[];
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int npx = p.wz * p.wy * p.wx;
  const CoreLayout L = warp_layout<D, Prof, Pose>(npx, Streamed);
  const int V = p.V, n = p.n;
  float* xs = sm + L.xs;

  if (lane < V) xs[lane] = clip(p.x0[(size_t)b * V + lane], p.lm.lo[lane], p.lm.hi[lane]);
  __syncwarp();
  if (!p.valid[b]) {
    if (lane < V) p.x_out[(size_t)b * V + lane] = xs[lane];
    if (lane == 0) {
      p.cost[b] = 0.f;
      p.n_iter[b] = 0;
      p.converged[b] = 0;
      p.npix[b] = 0.f;
    }
    return;
  }

  const int* org = p.origin + (size_t)b * D;
  Cluster c = make_cluster(p.cp + (size_t)b * n * p.P,
                           p.fvalid + (size_t)b * n, p.slot_idx, 0.f, 0.f,
                           0.f, n, p.P, V, p.iso, p.ma, b);
#pragma unroll
  for (int d = 0; d < D; ++d) c.org[d] = (float)org[d];
  stage_slots<D, Prof>(c, reinterpret_cast<int*>(sm + L.fs), lane);

  // The in-mask voxel list, in raster order: the window's R = wz·wy rows
  // are walked rpi rows per warp step (lane = row-in-step · wx + x) when a
  // row fits the warp, else one row at a time in 32-voxel pieces.
  const float* pix = p.pixels + (size_t)b * npx;
  int* idx = Streamed ? p.scratch + (size_t)b * npx
                      : reinterpret_cast<int*>(sm);
  float* val = sm + npx;  // resident only
  const int R = p.wz * p.wy;
  const int rpi = p.wx <= 32 ? 32 / p.wx : 1;
  const int lr = p.wx <= 32 ? lane / p.wx : 0;
  const int lx = lane - lr * p.wx;
  const float* pa = p.pos_at + (size_t)b * n * D;
  int cnt = 0;
  for (int r0 = 0; r0 < R; r0 += rpi) {
    for (int x0 = 0; x0 < p.wx; x0 += 32) {
      const int r = r0 + lr, x = x0 + lx;
      const bool live = lr < rpi && r < R && x < p.wx;
      const int z = D == 3 ? r / p.wy : 0;
      const int y = r - z * p.wy;
      float off[D];
      offsets<D>(z, y, x, off);
      bool hit = false;
      for (int i = 0; live && i < n; ++i) {
        if (!(c.fvalid[i] > 0.5f)) continue;
        float r2m = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const float rel = __fsub_rn(pa[i * D + d], c.org[d]);
          const float dm = __fmul_rn(__fsub_rn(off[d], rel), p.inv_r[d]);
          r2m = d == 0 ? __fmul_rn(dm, dm) : __fadd_rn(r2m, __fmul_rn(dm, dm));
        }
        hit = hit || (r2m <= 1.f);
      }
      const unsigned m = __ballot_sync(0xffffffffu, live && hit);
      if (live && hit) {
        const int k = cnt + __popc(m & ((1u << lane) - 1u));
        idx[k] = (D == 3 ? (z << p.sz) : 0) | (y << p.sy) | x;
        if (!Streamed) val[k] = pix[r * p.wx + x];
      }
      cnt += __popc(m);
    }
  }
  if (Streamed) __threadfence_block();
  __syncwarp();

  const float wc = 1.f / p.norm[b];
  LMOut res;
  if (Streamed) {
    res = lm_run<D, Prof, Pose, VM, Sums<VM>::kMma>(
        c, p.lm, sm, L, lane,
        StreamedPixels<D>{idx, pix, cnt, p.sy, p.sz, p.my, p.mx, p.wy, p.wx,
                          wc});
  } else {
    res = lm_run<D, Prof, Pose, VM, Sums<VM>::kMma>(
        c, p.lm, sm, L, lane,
        ResidentPixels<D>{idx, val, cnt, p.sy, p.sz, p.my, p.mx, wc});
  }

  if (lane < V) p.x_out[(size_t)b * V + lane] = xs[lane];
  if (lane == 0) {
    p.cost[b] = res.cost;
    p.n_iter[b] = res.iters;
    p.converged[b] = res.conv ? 1 : 0;
    p.npix[b] = (float)cnt;
  }
}

// Dynamic shared memory of a launch (one warp per block); raises the
// kernel's dynamic shared-memory limit when it passes 48 KB.
// cudaErrorInvalidValue: one warp does not fit the device's blocks.
template <int D, bool Streamed, int Prof, int Pose, int VM>
cudaError_t launch_config(int npx, size_t* smem) {
  *smem = sizeof(float) * (size_t)warp_layout<D, Prof, Pose>(npx, Streamed).total;
  int optin = 0, dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  if (*smem > (size_t)optin) return cudaErrorInvalidValue;
  if (*smem > 48 * 1024) {
    e = cudaFuncSetAttribute(pixel_lm_kernel<D, Streamed, Prof, Pose, VM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// One instantiation's launch, occupancy and shared memory (op 0, 1, 2).
template <int D, bool Streamed, int Prof, int Pose, int VM>
int run(int op, Problem* p, cudaStream_t stream, int npx, int* out) {
  if (op == 2) {
    *out = warp_layout<D, Prof, Pose>(npx, Streamed).total;
    return 0;
  }
  size_t smem = 0;
  cudaError_t e = launch_config<D, Streamed, Prof, Pose, VM>(npx, &smem);
  if (op == 1) {  // resident warps per SM (0: one warp does not fit)
    *out = 0;
    if (e == cudaErrorInvalidValue) return 0;
    if (e != cudaSuccess) return (int)e;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, pixel_lm_kernel<D, Streamed, Prof, Pose, VM>, 32, smem);
  }
  if (e != cudaSuccess) return (int)e;
  pixel_lm_kernel<D, Streamed, Prof, Pose, VM><<<p->B, 32, smem, stream>>>(*p);
  return (int)cudaGetLastError();
}

// The gauss profile has register instantiations at each slot-count
// ceiling; the other profiles, and V past the last ceiling, take the
// tile instantiation.  V: the launch's slot count (occupancy and shared
// memory are asked for a V too, since registers differ by instantiation).
template <int D, bool Streamed, int Pose>
int run_prof(int prof, int V, int op, Problem* p, cudaStream_t s, int npx,
             int* out) {
  switch (prof) {
    case kGauss:
      if (V <= kRegSlotsLow)
        return run<D, Streamed, kGauss, Pose, kRegSlotsLow>(op, p, s, npx, out);
      if (V <= kRegSlotsMid)
        return run<D, Streamed, kGauss, Pose, kRegSlotsMid>(op, p, s, npx, out);
      if (V <= kRegSlotsHigh)
        return run<D, Streamed, kGauss, Pose, kRegSlotsHigh>(op, p, s, npx, out);
      return run<D, Streamed, kGauss, Pose, 0>(op, p, s, npx, out);
    case kRing: return run<D, Streamed, kRing, Pose, 0>(op, p, s, npx, out);
    case kHat: return run<D, Streamed, kHat, Pose, 0>(op, p, s, npx, out);
    case kDisc: return run<D, Streamed, kDisc, Pose, 0>(op, p, s, npx, out);
    case kInvSeries: return run<D, Streamed, kInvSeries, Pose, 0>(op, p, s, npx, out);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool Streamed>
int run_pose(int D, int prof, int pose, int V, int op, Problem* p,
             cudaStream_t s, int npx, int* out) {
  if (D == 2 && pose == kNoPose)
    return run_prof<2, Streamed, kNoPose>(prof, V, op, p, s, npx, out);
  if (D == 3 && pose == kNoPose)
    return run_prof<3, Streamed, kNoPose>(prof, V, op, p, s, npx, out);
  if (D == 3 && pose == kAxis3D)
    return run_prof<3, Streamed, kAxis3D>(prof, V, op, p, s, npx, out);
  if (D == 3 && pose == kRotvec3D)
    return run_prof<3, Streamed, kRotvec3D>(prof, V, op, p, s, npx, out);
  return (int)cudaErrorInvalidValue;
}

int dispatch(int D, int streamed, int prof, int pose, int V, int op,
             Problem* p, cudaStream_t s, int npx, int* out) {
  return streamed ? run_pose<true>(D, prof, pose, V, op, p, s, npx, out)
                  : run_pose<false>(D, prof, pose, V, op, p, s, npx, out);
}

}  // namespace

// Per-warp shared memory of an instantiation, in 4-byte words (−1: there
// is no such instantiation).
extern "C" int pixel_lm_smem_words(int D, int npix, int streamed, int prof,
                                   int pose) {
  int words = -1;
  if (dispatch(D, streamed, prof, pose, kMaxSlots, 2, nullptr, nullptr, npix,
               &words) != 0)
    return -1;
  return words;
}

// Resident warps per SM of a launch with V slots, as the occupancy
// calculator gives them (0 when one warp's shared memory exceeds a
// block's); returns the CUDA error code (0 = cudaSuccess).
extern "C" int pixel_lm_occupancy(int D, int npix, int streamed, int prof,
                                  int pose, int V, int* warps_per_sm) {
  return dispatch(D, streamed, prof, pose, V, 1, nullptr, nullptr, npix,
                  warps_per_sm);
}

// Launches the solve on `stream`.  window = (wz, wy, wx) with wz = 1 in 2D;
// inv_r = 1/radius per window axis; prof / pose: the profile tag and pose
// kind (lm_core.cuh; a pose needs D = 3); nx: extras per feature; for a
// rigid bucket (V = the compact length) fit_dist, circ, rc_fixed =
// circ·distance, base = the rotation's base vertices [n][3] and xn [B] =
// the inert position slots' max |x|.  Returns the cudaGetLastError() code
// of the launch (0 = cudaSuccess), or cudaErrorInvalidValue for a problem
// the kernel does not take.
extern "C" int pixel_lm_launch(
    const float* pixels, const int* origin, const float* x0,
    const float* cp, const float* pos_at, const float* norm,
    const int* valid, const float* fvalid, const int* slot_idx,
    const float* lo, const float* hi, int* scratch,
    int B, int n, int P, int V, int iso, int D, int wz, int wy, int wx,
    float inv_rz, float inv_ry, float inv_rx, int streamed,
    int max_iter, float ftol, float xtol, float lam0, float lam_up,
    float lam_down, float lam_max, float plateau,
    int prof, int nx, int pose, int fit_dist, float circ, float rc_fixed,
    const float* base, const float* xn,
    float* x_out, float* cost, int* n_iter, int* converged, float* npix,
    void* stream) {
  const int n_ex = prof == kInvSeries ? nx : (prof == kRing || prof == kHat);
  const int q = pose == kAxis3D ? PoseDim<kAxis3D>::Q
              : pose == kRotvec3D ? PoseDim<kRotvec3D>::Q : 0;
  if ((D != 2 && D != 3) || V < 1 || V > kMaxSlots || n < 1 ||
      n > kMaxFeatures || P != 2 + D + (iso ? 1 : D) + n_ex || nx != n_ex ||
      nx > kMaxSeries || wz < 1 || wy < 1 || wx < 1 ||
      (D == 2 && wz != 1) || B < 0 || (streamed && scratch == nullptr) ||
      (pose != kNoPose && (base == nullptr && pose == kRotvec3D)) ||
      (pose != kNoPose && (xn == nullptr || V < q + fit_dist ||
                           (pose == kAxis3D && n != 2)))) {
    return (int)cudaErrorInvalidValue;
  }
  const int bx = bits_for(wx), by = bits_for(wy), bz = bits_for(wz);
  if (bx + by + bz > 30) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const LMConf lm{lo, hi, max_iter, ftol, xtol, lam0, lam_up, lam_down,
                  lam_max, plateau};
  const ModelArgs ma{nx, base, circ, rc_fixed, fit_dist, xn};
  Problem p{pixels, origin, x0, cp, pos_at, norm, valid, fvalid, slot_idx,
            scratch, B, n, P, V, iso, wz, wy, wx, bx, bx + by,
            (1 << by) - 1, (1 << bx) - 1, {0.f, 0.f, 0.f}, lm, ma,
            x_out, cost, n_iter, converged, npix};
  if (D == 3) {
    p.inv_r[0] = inv_rz; p.inv_r[1] = inv_ry; p.inv_r[2] = inv_rx;
  } else {
    p.inv_r[0] = inv_ry; p.inv_r[1] = inv_rx;
  }
  int unused = 0;
  return dispatch(D, streamed, prof, pose, V, 0, &p, (cudaStream_t)stream,
                  wz * wy * wx, &unused);
}
