// A window's in-mask pixels as a list of packed window offsets (x in the
// low bits, then y, then z: shifts and masks, no integer division), the
// pixel source of lm_core.cuh's sweep that reads each value from the
// window's pixel row on every sweep: pixel_lm.cu's streamed mode and
// tied_lm.cu.
#pragma once

namespace lmcore {

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

// Bits that hold 0 .. w−1: a window axis's share of the packed offset.
inline int bits_for(int w) {
  int k = 0;
  while ((1 << k) < w) ++k;
  return k;
}

}  // namespace lmcore
