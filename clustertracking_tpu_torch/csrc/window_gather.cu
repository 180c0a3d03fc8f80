// Per-cluster window gather from a 2D or 3D frame stack.
//
// Replaces the TPU kernel ops/pallas_gather.py::make_pallas_gather.kernel
// (clustertracking_tpu/ops/pallas_gather.py:144, launched at :287), which
// keeps double-buffered DMAs of an 8/128-aligned superset block per
// cluster in flight and cuts the exact window out of each block with
// one-hot matmuls.  Output: out[b, :] is cluster b's wz·wy·wx window in
// raster (z, y, x) order, the layout of ops/gather.py::gather_stack, and
// the kernel is a copy, so the two agree bit for bit.  A lane whose frame
// index or window lies outside the stack is not read: its row is NaN.
//
// What bounds it on the H100 is device-memory traffic: B·Npix floats read
// and B·Npix written (config 4: 9×13×13 windows, 6,084 B each way per
// cluster).  Rows of 13 floats at arbitrary columns touch 2–3 32-byte
// sectors, so the reads cost ~1.5× the bytes they deliver.
//
// A thread per output element over the flat [B·Npix] output, so a warp
// stores 32 consecutive floats; eight independent elements per thread in
// flight before any store; read-only loads through __restrict__ pointers;
// divisions by multiplication with host-computed constants; a grid-stride
// loop over as many 256-thread blocks as fit the SMs at once.  (A variant
// that loaded each window as one Tensor Memory Accelerator box through a
// shared-memory ring ran 6% slower at config 4 on the H100: PERF.md.)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;       // elements in flight per thread

// n / d for 0 <= n < 2^31 by one 64-bit multiply: m = ceil(2^s / d) with
// s = 32 + ceil(log2 d); the error n·(m·d − 2^s) / 2^s stays below 1.
struct FastDiv {
  unsigned long long m;
  unsigned s;
};

FastDiv make_fastdiv(unsigned d) {
  unsigned l = 0;
  while ((1ull << l) < d) ++l;
  const unsigned s = 32 + l;
  return {((1ull << s) + d - 1) / d, s};
}

__device__ __forceinline__ unsigned fdiv(unsigned n, const FastDiv& f) {
  return (unsigned)(((unsigned long long)n * f.m) >> f.s);
}

struct Problem {
  const float* frames;       // [T, Z, H, W] (Z = 1 in 2D)
  const int* frame_idx;      // [B]
  const int* origin;         // [B, D]
  float* out;                // [B, N]
  int T, Z, H, W, D;
  int wz, wy, wx, N;         // window, N = wz·wy·wx
  int b0;                    // first cluster of this launch
  unsigned total;            // its clusters × N (< 2^31)
  FastDiv div_N, div_wx, div_wy;
};

__global__ void __launch_bounds__(kThreads)
window_gather_kernel(const Problem p) {
  const float* __restrict__ frames = p.frames;
  const int* __restrict__ fidx = p.frame_idx;
  const int* __restrict__ origin = p.origin;
  float* __restrict__ out = p.out + (size_t)p.b0 * p.N;
  const unsigned stride = gridDim.x * kThreads;
  for (unsigned base = blockIdx.x * kThreads + threadIdx.x; base < p.total;
       base += stride * kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned e = base + u * stride;
      v[u] = __int_as_float(0x7fc00000);   // NaN
      if (e < p.total) {
        const unsigned b = fdiv(e, p.div_N);
        const unsigned i = e - b * (unsigned)p.N;
        const unsigned r = fdiv(i, p.div_wx);
        const unsigned x = i - r * (unsigned)p.wx;
        const unsigned z = fdiv(r, p.div_wy);
        const unsigned y = r - z * (unsigned)p.wy;
        const size_t gb = (size_t)p.b0 + b;
        const int* org = origin + gb * p.D;
        const int fi = __ldg(fidx + gb);
        const int oz = p.D == 3 ? __ldg(org) : 0;
        const int oy = __ldg(org + p.D - 2), ox = __ldg(org + p.D - 1);
        if (fi >= 0 && fi < p.T && oz >= 0 && oy >= 0 && ox >= 0 &&
            oz + p.wz <= p.Z && oy + p.wy <= p.H && ox + p.wx <= p.W) {
          v[u] = __ldg(frames + ((((size_t)fi * p.Z + oz + z) * p.H + oy + y)
                                 * p.W + ox + x));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned e = base + u * stride;
      if (e < p.total) out[e] = v[u];
    }
  }
}

// Per device: the blocks that fit it at once (SMs × resident blocks per
// SM), found once.
constexpr int kMaxDevices = 64;
int g_resident[kMaxDevices];

int resident_blocks(int* blocks) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (g_resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return (int)rc;
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, window_gather_kernel, kThreads, 0);
    if (rc != cudaSuccess) return (int)rc;
    g_resident[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *blocks = g_resident[dev];
  return 0;
}

}  // namespace

// Launches the gather on `stream`.  frames is [T, Z, H, W] (Z = 1 and
// wz = 1 for a 2D stack), origin [B, D].  Returns 0, a cudaError_t of the
// launch, or cudaErrorInvalidValue for a problem the kernel does not take.
extern "C" int window_gather_launch(
    const float* frames, int T, int Z, int H, int W,
    const int* frame_idx, const int* origin, int B, int D,
    int wz, int wy, int wx, float* out, void* stream) {
  if ((D != 2 && D != 3) || (D == 2 && (Z != 1 || wz != 1)) || T < 1 ||
      Z < 1 || H < 1 || W < 1 || B < 0 || wz < 1 || wy < 1 || wx < 1 ||
      wz > Z || wy > H || wx > W || (long long)wz * wy * wx >= (1ll << 30)) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return 0;
  int resident = 0;
  const int rc = resident_blocks(&resident);
  if (rc != 0) return rc;
  Problem p;
  p.frames = frames;
  p.frame_idx = frame_idx;
  p.origin = origin;
  p.out = out;
  p.T = T; p.Z = Z; p.H = H; p.W = W; p.D = D;
  p.wz = wz; p.wy = wy; p.wx = wx; p.N = wz * wy * wx;
  p.div_N = make_fastdiv((unsigned)p.N);
  p.div_wx = make_fastdiv((unsigned)wx);
  p.div_wy = make_fastdiv((unsigned)wy);
  // launches of fewer than 2^31 elements each
  const int per_launch = (int)(((1ll << 31) - 1) / p.N);
  for (int b0 = 0; b0 < B; b0 += per_launch) {
    const int n = B - b0 < per_launch ? B - b0 : per_launch;
    p.b0 = b0;
    p.total = (unsigned)n * (unsigned)p.N;
    const long long want =
        ((long long)p.total + kThreads * kUnroll - 1) / (kThreads * kUnroll);
    const int grid = want < resident ? (int)want : resident;
    window_gather_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
