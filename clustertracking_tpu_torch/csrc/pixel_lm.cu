// Levenberg–Marquardt solve of gauss-model cluster buckets on windows
// gathered beforehand (2D and 3D), one warp per cluster.
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
// its pixels from.
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
// What bounds it on the H100 is the per-pixel arithmetic of the sweeps
// (the shared core in lm_core.cuh).  Resident mode stages the in-mask
// voxels' values beside their coordinates in shared memory (2·Npix words
// reserved per warp, the mask's worst case), so nothing is read from
// device memory inside the LM loop.  Streamed mode keeps only the core's
// ~2k words per warp in shared memory, writes the list to a global scratch
// row, and reads each listed voxel's value from the pixel array on every
// sweep — coalesced along x, mostly from L2 — so any window up to the
// routing cap runs, and an SM holds as many warps as registers allow.  On
// config 4 that is 16 warps per SM against resident's 8, and streamed is
// the faster mode (ops/pixel_lm.py picks by occupancy).
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
  float* x_out;              // [B, V]
  float* cost;               // [B]
  int* n_iter;               // [B]
  int* converged;            // [B]
  float* npix;               // [B]
};

template <int D>
__device__ inline void unpack(int pk, int sy, int sz, int my, int mx,
                              int* z, int* y, int* x) {
  *x = pk & mx;
  *y = (pk >> sy) & my;
  *z = D == 3 ? (pk >> sz) : 0;
}

template <int D>
__device__ inline void offsets(int z, int y, int x, float* off) {
  if (D == 3) off[0] = (float)z;
  off[D - 2] = (float)y;
  off[D - 1] = (float)x;
}

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

// Streamed: the list in a global scratch row, values read from the
// cluster's pixel row on every sweep.
template <int D>
struct StreamedPixels {
  const int* idx;
  const float* pix;
  int cnt, sy, sz, my, mx, wy, wx;
  float wc;
  __device__ int count() const { return cnt; }
  __device__ void load(int k, float* off, float& v, float& w) const {
    int z, y, x;
    unpack<D>(idx[k], sy, sz, my, mx, &z, &y, &x);
    offsets<D>(z, y, x, off);
    v = pix[(z * wy + y) * wx + x];
    w = wc;
  }
};

// Per-warp shared memory: (resident) the voxel list and its values, then
// the LM core.
template <int D>
__host__ __device__ inline CoreLayout warp_layout(int npix, bool streamed) {
  return core_layout<D>(streamed ? 0 : 2 * npix);
}

template <int D, bool Streamed>
__global__ void pixel_lm_kernel(Problem p, int warps_per_block) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * warps_per_block + warp;
  if (b >= p.B) return;
  const int npx = p.wz * p.wy * p.wx;
  const CoreLayout L = warp_layout<D>(npx, Streamed);
  float* sm = smem + (size_t)warp * L.total;
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
  Cluster c{p.cp + (size_t)b * n * p.P, p.fvalid + (size_t)b * n,
            p.slot_idx, {0.f, 0.f, 0.f}, n, p.P, V, p.iso};
#pragma unroll
  for (int d = 0; d < D; ++d) c.org[d] = (float)org[d];
  stage_slots<D>(c, reinterpret_cast<int*>(sm + L.fs), lane);

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
    res = lm_run<D>(c, p.lm, sm, L, lane,
                    StreamedPixels<D>{idx, pix, cnt, p.sy, p.sz, p.my, p.mx,
                                      p.wy, p.wx, wc});
  } else {
    res = lm_run<D>(c, p.lm, sm, L, lane,
                    ResidentPixels<D>{idx, val, cnt, p.sy, p.sz, p.my, p.mx,
                                      wc});
  }

  if (lane < V) p.x_out[(size_t)b * V + lane] = xs[lane];
  if (lane == 0) {
    p.cost[b] = res.cost;
    p.n_iter[b] = res.iters;
    p.converged[b] = res.conv ? 1 : 0;
    p.npix[b] = (float)cnt;
  }
}

int bits_for(int w) {  // bits that hold 0..w-1
  int k = 0;
  while ((1 << k) < w) ++k;
  return k;
}

// Warps per block (up to 4, as many as the device's opt-in shared memory
// holds) and dynamic shared memory of a launch; raises the kernel's
// dynamic shared-memory limit when it passes 48 KB.
template <int D, bool Streamed>
cudaError_t launch_config(int npx, int* wpb, size_t* smem) {
  const size_t warp_bytes = sizeof(float) * (size_t)warp_layout<D>(npx, Streamed).total;
  int optin = 0, dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  *wpb = (int)((size_t)optin / warp_bytes);
  if (*wpb > 4) *wpb = 4;
  if (*wpb < 1) return cudaErrorInvalidValue;
  *smem = warp_bytes * *wpb;
  if (*smem > 48 * 1024) {
    e = cudaFuncSetAttribute(pixel_lm_kernel<D, Streamed>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

template <int D, bool Streamed>
int launch(Problem p, cudaStream_t stream) {
  int wpb = 0;
  size_t smem = 0;
  const cudaError_t e = launch_config<D, Streamed>(p.wz * p.wy * p.wx, &wpb, &smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (p.B + wpb - 1) / wpb;
  pixel_lm_kernel<D, Streamed><<<blocks, 32 * wpb, smem, stream>>>(p, wpb);
  return (int)cudaGetLastError();
}

template <int D, bool Streamed>
int occupancy(int npx, int* warps_per_sm) {
  int wpb = 0, blocks = 0;
  size_t smem = 0;
  *warps_per_sm = 0;
  cudaError_t e = launch_config<D, Streamed>(npx, &wpb, &smem);
  if (e == cudaErrorInvalidValue) return 0;  // one warp's layout does not fit
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, pixel_lm_kernel<D, Streamed>, 32 * wpb, smem);
  *warps_per_sm = blocks * wpb;
  return (int)e;
}

}  // namespace

// Per-warp shared memory of a mode, in 4-byte words.
extern "C" int pixel_lm_smem_words(int D, int npix, int streamed) {
  return D == 3 ? warp_layout<3>(npix, streamed != 0).total
                : warp_layout<2>(npix, streamed != 0).total;
}

// Resident warps per SM of a launch, as the occupancy calculator gives
// them (0 when one warp's shared memory exceeds a block's); returns the
// CUDA error code (0 = cudaSuccess).
extern "C" int pixel_lm_occupancy(int D, int npix, int streamed, int* warps_per_sm) {
  if (D == 3) return streamed ? occupancy<3, true>(npix, warps_per_sm)
                              : occupancy<3, false>(npix, warps_per_sm);
  return streamed ? occupancy<2, true>(npix, warps_per_sm)
                  : occupancy<2, false>(npix, warps_per_sm);
}

// Launches the solve on `stream`.  window = (wz, wy, wx) with wz = 1 in 2D;
// inv_r = 1/radius per window axis.  Returns the cudaGetLastError() code of
// the launch (0 = cudaSuccess), or cudaErrorInvalidValue for a problem the
// kernel does not take.
extern "C" int pixel_lm_launch(
    const float* pixels, const int* origin, const float* x0,
    const float* cp, const float* pos_at, const float* norm,
    const int* valid, const float* fvalid, const int* slot_idx,
    const float* lo, const float* hi, int* scratch,
    int B, int n, int P, int V, int iso, int D, int wz, int wy, int wx,
    float inv_rz, float inv_ry, float inv_rx, int streamed,
    int max_iter, float ftol, float xtol, float lam0, float lam_up,
    float lam_down, float lam_max, float plateau,
    float* x_out, float* cost, int* n_iter, int* converged, float* npix,
    void* stream) {
  if ((D != 2 && D != 3) || V < 1 || V > kMaxSlots || n < 1 ||
      n > kMaxFeatures || P != 2 + D + (iso ? 1 : D) || wz < 1 || wy < 1 ||
      wx < 1 || (D == 2 && wz != 1) || B < 0 ||
      (streamed && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int bx = bits_for(wx), by = bits_for(wy), bz = bits_for(wz);
  if (bx + by + bz > 30) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const LMConf lm{lo, hi, max_iter, ftol, xtol, lam0, lam_up, lam_down,
                  lam_max, plateau};
  Problem p{pixels, origin, x0, cp, pos_at, norm, valid, fvalid, slot_idx,
            scratch, B, n, P, V, iso, wz, wy, wx, bx, bx + by,
            (1 << by) - 1, (1 << bx) - 1, {0.f, 0.f, 0.f}, lm,
            x_out, cost, n_iter, converged, npix};
  if (D == 3) {
    p.inv_r[0] = inv_rz; p.inv_r[1] = inv_ry; p.inv_r[2] = inv_rx;
  } else {
    p.inv_r[0] = inv_ry; p.inv_r[1] = inv_rx;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 3) return streamed ? launch<3, true>(p, s) : launch<3, false>(p, s);
  return streamed ? launch<2, true>(p, s) : launch<2, false>(p, s);
}
