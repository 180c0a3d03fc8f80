// Per-cluster window gather from a 2D or 3D frame stack, one warp per
// cluster.
//
// Replaces the TPU kernel ops/pallas_gather.py::make_pallas_gather.kernel
// (clustertracking_tpu/ops/pallas_gather.py:144, launched at :287), which
// DMAs an 8/128-aligned superset block per cluster and cuts the exact
// window out of it with one-hot matmuls — work the TPU needs only because
// its DMAs must be tile-aligned.  Here each warp copies its window straight
// from the frame stack at any alignment.
//
// What bounds it on the H100 is device-memory traffic: B·Npix floats read
// and B·Npix written (config 4: 2,048 × 1,521 voxels, 12.5 MB each way).
// The warp walks the window's rows with its lanes along x, so each row's
// read is one contiguous run; when a row is shorter than the warp, one
// warp step covers 32 / wx rows (lane = row-in-step · wx + x), so a 13-wide
// row does not leave 19 lanes idle.  Output rows land contiguously in
// raster (z, y, x) order, the layout of ops/gather.py::gather_stack.  The
// kernel is a copy: it matches gather_stack bit for bit.
//
// Origins arrive clamped (ops/gather.py::origins_for).  A lane whose frame
// index or window lies outside the stack is not read: its row is NaN.

#include <cuda_runtime.h>

namespace {

struct Problem {
  const float* frames;       // [T, Z, H, W] (Z = 1 in 2D)
  int T, Z, H, W;
  const int* frame_idx;      // [B]
  const int* origin;         // [B, D]
  int B, D, wz, wy, wx;
  float* out;                // [B, wz·wy·wx]
};

__global__ void window_gather_kernel(Problem p, int warps_per_block) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * warps_per_block + warp;
  if (b >= p.B) return;
  const int* org = p.origin + (size_t)b * p.D;
  const int fi = p.frame_idx[b];
  const int oz = p.D == 3 ? org[0] : 0;
  const int oy = org[p.D - 2], ox = org[p.D - 1];
  const bool inside = fi >= 0 && fi < p.T && oz >= 0 && oy >= 0 && ox >= 0 &&
                      oz + p.wz <= p.Z && oy + p.wy <= p.H && ox + p.wx <= p.W;
  const int R = p.wz * p.wy;
  float* out = p.out + (size_t)b * R * p.wx;
  const int rpi = p.wx <= 32 ? 32 / p.wx : 1;
  const int lr = p.wx <= 32 ? lane / p.wx : 0;
  const int lx = lane - lr * p.wx;
  if (!inside) {
    for (int q = lane; q < R * p.wx; q += 32) out[q] = __int_as_float(0x7fc00000);
    return;
  }
  const float* base = p.frames + (((size_t)fi * p.Z + oz) * p.H + oy) * p.W + ox;
  for (int r0 = 0; r0 < R; r0 += rpi) {
    const int r = r0 + lr;
    if (lr >= rpi || r >= R) continue;
    const int z = r / p.wy, y = r - z * p.wy;
    const float* src = base + ((size_t)z * p.H + y) * p.W;
    for (int x = lx; x < p.wx; x += 32) out[(size_t)r * p.wx + x] = src[x];
  }
}

}  // namespace

// Launches the gather on `stream`.  frames is [T, Z, H, W] (Z = 1 and
// wz = 1 for a 2D stack), origin [B, D].  Returns the cudaGetLastError()
// code of the launch (0 = cudaSuccess), or cudaErrorInvalidValue for a
// problem the kernel does not take.
extern "C" int window_gather_launch(
    const float* frames, int T, int Z, int H, int W,
    const int* frame_idx, const int* origin, int B, int D,
    int wz, int wy, int wx, float* out, void* stream) {
  if ((D != 2 && D != 3) || (D == 2 && (Z != 1 || wz != 1)) || wz < 1 ||
      wy < 1 || wx < 1 || B < 0 || T < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return 0;
  constexpr int kWarps = 8;
  Problem p{frames, T, Z, H, W, frame_idx, origin, B, D, wz, wy, wx, out};
  const int blocks = (B + kWarps - 1) / kWarps;
  window_gather_kernel<<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(p, kWarps);
  return (int)cudaGetLastError();
}
