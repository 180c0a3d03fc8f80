// The dense auction linker of a whole video in one launch.
//
// Replaces the frame loop of ops/link.py::_link_torch, the torch version
// of the reference's clustertracking_tpu/ops/link.py::link_on_device (a
// lax.scan over frames around a lax.while_loop of auction rounds).  That
// loop launched ~65 small torch kernels a frame and read "any feature
// unresolved?" on the host at its check points; the arithmetic behind
// them is tiny (config 2: 100 features against 800 track slots, ~1e5
// cost evaluations a round).  What bounds it on the H100 is latency: the
// frames are sequential, the rounds of a frame are sequential, and each
// round needs every bid before any track can pick its winner.  So one
// block of 1,024 threads runs the whole video, and a round costs five
// barriers.
//
// State (one video): per track slot m < M = K·(memory+2) its particle id
// (int64), position (D floats, one row per axis), age in frames since last
// seen, price, owner, the round's highest bid (float bits) and winner; per
// feature k < K its assignment ft (a track, -1 unresolved, -2 new track),
// bid and target track.  It lives in the block's shared memory where it
// fits beside the kernel's static shared memory on the device (config 2:
// ~29 KB), else in a global workspace the caller allocates
// (link_auction_workspace_bytes), which the one block reads through L1 and
// L2: the same code, on another address space.  D = 2 and 3 are template
// arguments, so a feature's coordinates sit in registers; every other D
// takes the instantiation with D read at run time (D = 0 here).
//
// Per frame, in order, each step the same float32 operations in the same
// order as the torch loop, so the particles are bit-identical to it:
//   1. costs on the fly: d2 = Σ_d (pos − track_pos)² in axis order, BIG
//      unless the feature is valid, the track's age ≤ memory and
//      d2 ≤ r2max.  A valid feature with any cost below BIG starts
//      unresolved (-1), every other -2.
//   2. rounds until no feature is unresolved or `auction_rounds` ran (at
//      least one): one warp a feature scans the slots for v = cost + price
//      and keeps the least v with its first index (argmin's rule) and the
//      second-least value, duplicates allowed (topk(2)'s); the warp's
//      lanes merge their triples with shuffles.  v1 > r2max takes the null
//      option; else the bid is (min(v2, r2max) − v1) + eps, ≥ eps > 0, so
//      a track's highest bid is an atomicMax on the float's bits, and its
//      winner the lowest feature index that bid it (atomicMin).  Outbid
//      owners return to the pool, prices rise by the winning bid, winners
//      take their track.  Whether any feature is still unresolved is read
//      after every round by the barrier itself (__syncthreads_or).
//   3. the ring buffer's update: matched slots take the position and age
//      -1; then unmatched valid features take new slots at
//      (ptr + rank) % M, rank a block-wide exclusive scan, with ids
//      next_id + rank; each feature's particle is read after the new ids
//      are written; every age rises by 1; ptr and next_id advance.
//
// Built with -fmad=false (ops/_build.py): `d2 + diff*diff` must round as
// two operations, as torch's separate multiply and add do.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 1e30f;        // ops/link.py's _BIG

// Byte offsets of the state.  The int64 ids come first, so they are
// 8-byte aligned.
struct Layout {
  size_t tid, pos, age, price, owner, maxbid, winner, ft, bid, tgt, total;
};

__host__ __device__ Layout layout(int K, int M, int D) {
  Layout L;
  size_t o = 0;
  L.tid = o;    o += 8 * (size_t)M;
  L.pos = o;    o += 4 * (size_t)M * D;
  L.age = o;    o += 4 * (size_t)M;
  L.price = o;  o += 4 * (size_t)M;
  L.owner = o;  o += 4 * (size_t)M;
  L.maxbid = o; o += 4 * (size_t)M;
  L.winner = o; o += 4 * (size_t)M;
  L.ft = o;     o += 4 * (size_t)K;
  L.bid = o;    o += 4 * (size_t)K;
  L.tgt = o;    o += 4 * (size_t)K;
  L.total = o;
  return L;
}

struct Video {
  const float* positions;        // [T, K, D]
  const unsigned char* valid;    // [T, K] (torch.bool)
  int* particle;                 // [T, K]
  int* rounds;                   // [T]
  unsigned char* workspace;      // the state, where it is not in shared
  int T, K, D, M, memory, auction_rounds;
  float r2max, eps;
};

// A feature's coordinates: in registers for D of 2 and 3, read from the
// (cached) input for D given at run time.
template <int D>
struct Feature {
  float c[D];
  __device__ Feature(const float* p, int k, int) {
#pragma unroll
    for (int d = 0; d < D; ++d) c[d] = __ldg(p + k * D + d);
  }
  __device__ float operator[](int d) const { return c[d]; }
};

template <>
struct Feature<0> {
  const float* c;
  __device__ Feature(const float* p, int k, int nd) : c(p + (size_t)k * nd) {}
  __device__ float operator[](int d) const { return __ldg(c + d); }
};

// Feature f's cost against slot m: its squared distance, BIG where the
// track is dead or farther than the search range (the feature is valid).
template <int D>
__device__ __forceinline__ float cost(const Feature<D>& f, int nd, int m,
                                      const float* tpos, const int* age,
                                      int M, int memory, float r2max) {
  float diff = f[0] - tpos[m];
  float d2 = diff * diff;
#pragma unroll
  for (int d = 1; d < (D ? D : nd); ++d) {
    diff = f[d] - tpos[d * M + m];
    d2 = d2 + diff * diff;
  }
  return (age[m] <= memory && d2 <= r2max) ? d2 : kBig;
}

// D: 2, 3, or 0 for D read at run time.  kShared: the state in dynamic
// shared memory, else in v.workspace.
template <int D, bool kShared>
__global__ void __launch_bounds__(kThreads)
link_auction_kernel(const Video v) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_count[kWarps];
  __shared__ int warp_offset[kWarps];
  __shared__ int chunk_total;
  const int K = v.K, M = v.M, nd = D ? D : v.D;
  const Layout L = layout(K, M, nd);
  unsigned char* base = kShared ? smem : v.workspace;
  long long* tid = reinterpret_cast<long long*>(base + L.tid);
  float* tpos = reinterpret_cast<float*>(base + L.pos);   // [D][M]
  int* age = reinterpret_cast<int*>(base + L.age);
  float* price = reinterpret_cast<float*>(base + L.price);
  int* owner = reinterpret_cast<int*>(base + L.owner);
  unsigned* maxbid = reinterpret_cast<unsigned*>(base + L.maxbid);
  int* winner = reinterpret_cast<int*>(base + L.winner);
  int* ft = reinterpret_cast<int*>(base + L.ft);
  float* bid = reinterpret_cast<float*>(base + L.bid);
  int* tgt = reinterpret_cast<int*>(base + L.tgt);   // also the new ranks

  const int th = threadIdx.x, lane = th & 31, warp = th >> 5;
  for (int m = th; m < M; m += kThreads) {
    for (int d = 0; d < nd; ++d) tpos[d * M + m] = 1e9f;   // far away
    age[m] = v.memory + 2;                                  // dead
    tid[m] = 0;
    maxbid[m] = 0u;
    winner[m] = INT_MAX;
  }
  // the ring buffer's write pointer and the next particle id: every
  // thread holds the same values
  long long ptr = 0, next_id = 0;
  __syncthreads();

  for (int t = 0; t < v.T; ++t) {
    const float* pos = v.positions + (size_t)t * K * nd;
    const unsigned char* ok = v.valid + (size_t)t * K;
    for (int m = th; m < M; m += kThreads) {
      price[m] = 0.f;
      owner[m] = -1;
    }
    // 1. which valid features have a candidate track at all
    for (int k = warp; k < K; k += kWarps) {
      int state = -2;
      if (ok[k]) {
        const Feature<D> f(pos, k, nd);
        bool any = false;
        for (int m = lane; m < M; m += 32)
          any |= cost<D>(f, nd, m, tpos, age, M, v.memory, v.r2max) < kBig;
        if (__any_sync(kFull, any)) state = -1;
      }
      if (lane == 0) {
        ft[k] = state;
        tgt[k] = -1;
      }
    }
    __syncthreads();

    // 2. the auction
    int r = 0;
    while (r < v.auction_rounds) {
      // bids: one warp a feature
      for (int k = warp; k < K; k += kWarps) {
        if (ft[k] != -1) continue;                 // warp-uniform
        const Feature<D> f(pos, k, nd);
        float v1 = __int_as_float(0x7f800000), v2 = v1;   // +inf
        int i1 = INT_MAX;
        for (int m = lane; m < M; m += 32) {
          const float c =
              cost<D>(f, nd, m, tpos, age, M, v.memory, v.r2max) + price[m];
          if (c < v1) {
            v2 = v1;
            v1 = c;
            i1 = m;
          } else if (c < v2) {
            v2 = c;
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const float ov1 = __shfl_xor_sync(kFull, v1, o);
          const float ov2 = __shfl_xor_sync(kFull, v2, o);
          const int oi1 = __shfl_xor_sync(kFull, i1, o);
          if (ov1 < v1 || (ov1 == v1 && oi1 < i1)) {
            v2 = fminf(v1, ov2);
            v1 = ov1;
            i1 = oi1;
          } else {
            v2 = fminf(ov1, v2);
          }
        }
        if (lane == 0) {
          if (v1 > v.r2max) {
            ft[k] = -2;             // the null option: final
          } else if (v1 < kBig) {
            const float b = (fminf(v2, v.r2max) - v1) + v.eps;
            bid[k] = b;
            tgt[k] = i1;
            atomicMax(&maxbid[i1], __float_as_uint(b));
          }
        }
      }
      __syncthreads();
      // each track's winner: the lowest feature index that bid its max
      for (int k = th; k < K; k += kThreads) {
        const int g = tgt[k];
        if (g >= 0 && bid[k] >= __uint_as_float(maxbid[g]))
          atomicMin(&winner[g], k);
      }
      __syncthreads();
      for (int k = th; k < K; k += kThreads) {
        const int g = tgt[k];
        if (g >= 0 && winner[g] != k) tgt[k] = -1;
      }
      __syncthreads();
      // winners take their track; each feature bid on one track and owns
      // at most one, so no two threads write one entry
      for (int k = th; k < K; k += kThreads) {
        const int g = tgt[k];
        if (g >= 0) {
          const int prev = owner[g];
          if (prev >= 0) ft[prev] = -1;
          owner[g] = k;
          price[g] = price[g] + __uint_as_float(maxbid[g]);
          ft[k] = g;
          maxbid[g] = 0u;
          winner[g] = INT_MAX;
          tgt[k] = -1;
        }
      }
      ++r;
      __syncthreads();
      int open = 0;
      for (int k = th; k < K; k += kThreads) open |= ft[k] == -1;
      if (!__syncthreads_or(open)) break;
    }
    if (th == 0) v.rounds[t] = r;

    // 3. the ring buffer: matched tracks first
    for (int k = th; k < K; k += kThreads) {
      const int g = ft[k];
      if (g >= 0) {
        for (int d = 0; d < nd; ++d) tpos[d * M + g] = pos[k * nd + d];
        age[g] = -1;                                 // ages +1 below
      }
    }
    // ranks of the new tracks: an exclusive scan over K, 1,024 at a time
    int carry = 0;
    for (int chunk = 0; chunk < K; chunk += kThreads) {
      const int k = chunk + th;
      const bool is_new = k < K && ok[k] && ft[k] < 0;
      const unsigned b = __ballot_sync(kFull, is_new);
      if (lane == 0) warp_count[warp] = __popc(b);
      __syncthreads();
      if (warp == 0) {
        const int c = warp_count[lane];
        int incl = c;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int up = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += up;
        }
        warp_offset[lane] = incl - c;
        if (lane == 31) chunk_total = incl;
      }
      __syncthreads();
      if (k < K)
        tgt[k] = is_new ? carry + warp_offset[warp] +
                              __popc(b & ((1u << lane) - 1u))
                        : -1;
      carry += chunk_total;
      __syncthreads();
    }
    for (int k = th; k < K; k += kThreads) {
      const int rk = tgt[k];
      if (rk >= 0) {
        const int slot = (int)((ptr + rk) % M);
        for (int d = 0; d < nd; ++d) tpos[d * M + slot] = pos[k * nd + d];
        age[slot] = -1;
        tid[slot] = next_id + rk;
      }
    }
    __syncthreads();
    // particles, read after the new ids are written
    int* out = v.particle + (size_t)t * K;
    for (int k = th; k < K; k += kThreads) {
      const int g = ft[k], rk = tgt[k];
      out[k] = g >= 0 ? (int)tid[g] : rk >= 0 ? (int)(next_id + rk) : -1;
    }
    for (int m = th; m < M; m += kThreads) age[m] += 1;
    ptr = (ptr + carry) % M;
    next_id += carry;
    __syncthreads();
  }
}

template <bool kShared>
const void* kernel_for(int D) {
  switch (D) {
    case 2: return reinterpret_cast<const void*>(
        link_auction_kernel<2, kShared>);
    case 3: return reinterpret_cast<const void*>(
        link_auction_kernel<3, kShared>);
    default: return reinterpret_cast<const void*>(
        link_auction_kernel<0, kShared>);
  }
}

// Whether `bytes` of state fit the shared-memory instantiation's block on
// the current device, beside its static shared memory.
cudaError_t fits_shared(int D, size_t bytes, bool* fits) {
  int dev = 0, optin = 0;
  cudaFuncAttributes a;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, kernel_for<true>(D));
  if (e == cudaSuccess) *fits = bytes + a.sharedSizeBytes <= (size_t)optin;
  return e;
}

bool valid_shape(int T, int K, int D, int memory) {
  return T >= 0 && K >= 1 && D >= 1 && memory >= 0 &&
         (long long)K * (memory + 2) <= INT_MAX;
}

}  // namespace

extern "C" {

// Bytes of global workspace a video of K features, D axes and `memory`
// needs on the current device: 0 where its state fits the block's shared
// memory.  -1 for a shape the kernel does not take or a CUDA error.
long long link_auction_workspace_bytes(int K, int D, int memory) {
  if (!valid_shape(0, K, D, memory)) return -1;
  const int M = K * (memory + 2);
  const size_t bytes = layout(K, M, D).total;
  bool fits = false;
  if (fits_shared(D, bytes, &fits) != cudaSuccess) return -1;
  return fits ? 0 : (long long)bytes;
}

// Links a video on `stream`: positions [T, K, D] float32 and valid [T, K]
// bool in, particle [T, K] int32 and each frame's auction rounds [T] int32
// out, with M = K·(memory+2) track slots.  `workspace` holds the state
// where link_auction_workspace_bytes asks for one (that many bytes,
// 16-byte aligned); else it is null and the state lives in shared memory.
// Returns 0, a cudaError_t of the launch, or cudaErrorInvalidValue for a
// problem the kernel does not take.
int link_auction_launch(const float* positions, const unsigned char* valid,
                        int T, int K, int D, int memory,
                        float r2max, float eps, int auction_rounds,
                        int* particle, int* rounds, void* workspace,
                        void* stream) {
  if (!valid_shape(T, K, D, memory)) return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  const int M = K * (memory + 2);
  Video v;
  v.positions = positions;
  v.valid = valid;
  v.particle = particle;
  v.rounds = rounds;
  v.workspace = static_cast<unsigned char*>(workspace);
  v.T = T; v.K = K; v.D = D; v.M = M; v.memory = memory;
  v.auction_rounds = auction_rounds;
  v.r2max = r2max; v.eps = eps;
  const bool shared = workspace == nullptr;
  size_t bytes = 0;
  if (shared) {
    bytes = layout(K, M, D).total;
    bool fits = false;
    cudaError_t e = fits_shared(D, bytes, &fits);
    if (e != cudaSuccess) return (int)e;
    if (!fits) return (int)cudaErrorInvalidValue;
  }
  const void* fn = shared ? kernel_for<true>(D) : kernel_for<false>(D);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&v};
  e = cudaLaunchKernel(fn, dim3(1), dim3(kThreads), args, bytes,
                       static_cast<cudaStream_t>(stream));
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // extern "C"
