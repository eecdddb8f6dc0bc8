// Shared pieces of the hex-grid step kernels (psi_update.cu, poisson_rhs.cu).
//
// Layout: site planes are row-major (rows, cols); edge planes are
// (3, rows, cols), one slab per direction class k with lattice offsets
// E (0, 1), N (1, 0), NW (1, -1) (tdgl_tpu_torch/device/hexmesh.py).
// A neighbour read wraps around the padded grid exactly like torch.roll;
// zero weights at masked and padded entries kill the wrapped terms.
#pragma once

#include <cuda_runtime.h>

namespace tdgl {

constexpr int kThreads = 256;

__device__ __forceinline__ int off_r(int k) { return k == 0 ? 0 : 1; }
__device__ __forceinline__ int off_c(int k) { return k == 0 ? 1 : (k == 1 ? 0 : -1); }

// v mod n for v in [-n, 2n).
__device__ __forceinline__ int wrap(int v, int n) {
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

__device__ __forceinline__ float dev_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dev_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float dev_cos(float x) { return cosf(x); }
__device__ __forceinline__ double dev_cos(double x) { return cos(x); }
__device__ __forceinline__ float dev_sin(float x) { return sinf(x); }
__device__ __forceinline__ double dev_sin(double x) { return sin(x); }

// Link variables U_k = ur + i ui of class k at site (r, c), flat index i.
// Raw form: read the (3, rows, cols) planes. Factored form: rebuild from
// the row vectors cf, sf (3, rows) and column vectors cg, sg (3, cols) by
// angle addition, as gtdgl_stencil._factored_u_k does.
template <typename T>
struct Links {
  const T* ur;
  const T* ui;
  const T* cf;
  const T* sf;
  const T* cg;
  const T* sg;
};

template <typename T, bool FACTORED>
__device__ __forceinline__ void link_at(const Links<T>& L, int k, int r, int c,
                                        int i, int n, int rows, int cols,
                                        T& ur, T& ui) {
  if (FACTORED) {
    const T cf = L.cf[k * rows + r];
    const T sf = L.sf[k * rows + r];
    const T cg = L.cg[k * cols + c];
    const T sg = L.sg[k * cols + c];
    ur = cf * cg - sf * sg;
    ui = -(sf * cg + cf * sg);
  } else {
    ur = L.ur[k * n + i];
    ui = L.ui[k * n + i];
  }
}

}  // namespace tdgl
