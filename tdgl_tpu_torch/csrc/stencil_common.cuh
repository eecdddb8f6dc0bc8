// Shared pieces of the hex-grid step kernels (psi_update.cu, poisson_rhs.cu).
//
// Layout: site planes are row-major (rows, cols); edge planes are
// (3, rows, cols), one slab per direction class k with lattice offsets
// E (0, 1), N (1, 0), NW (1, -1) (tdgl_tpu_torch/device/hexmesh.py).
//
// Members. A launch may run a batch of B independent runs on the same
// grid (a parameter sweep): blockIdx.z is the member, and each kernel
// moves its operand pointers to the member's planes (a member stride of 0
// for a plane all members share). A single run is B = 1.
//
// Tiling. A block owns a kTileR x kTileC tile of sites and runs one
// thread per site: thread (x, y) owns the tile's site (y, x), so each
// warp covers one 32-site row segment and its loads and stores are
// coalesced. The grid must be a multiple of the tile (the library exports
// it as tdgl_step_tile and the wrapper raises on any other grid; the
// padded grid is a multiple of (32, 128)), so no tile has a ragged edge.
//
// Shared memory holds a haloed tile: local (lr, lc) with lr in
// [-1, kTileR] and lc in [-1, kTileC] sits at hidx(lr, lc). The hex
// offsets reach only one site beyond the tile, so a one-site halo holds
// every neighbour. Halo indices wrap modulo the padded grid exactly like
// torch.roll, so an edge tile sees the wrapped values, not zeros.
//
// Edge quantities (one per class-k edge, stored at its origin j) live in
// the "edge region", rows [-1, kTileR - 1] of the same layout: it holds
// every edge whose origin is a tile site or a site i - offset_k of one.
//
// Latency. The grid gives one wave of blocks, so a kernel's time is set
// by each thread's chain of dependent steps, not by bandwidth. Hence one
// site per thread and 8 x 32 tiles (384 blocks of 256 threads at
// (256, 384), at most 3 per SM; the other shapes tried were slower on the
// H100, see PERF.md), and every global load a thread needs (halo, edge
// planes, its own site's planes) is issued in fully unrolled, predicated
// loops before the first barrier, into registers, before any store to
// shared memory: one round trip to memory instead of one per loop
// iteration.
#pragma once

#include <cuda_runtime.h>

namespace tdgl {

constexpr int kTileR = 8;
constexpr int kTileC = 32;
constexpr int kThreads = kTileR * kTileC;            // 256
constexpr int kHaloR = kTileR + 2;
constexpr int kHaloC = kTileC + 2;
constexpr int kHalo = kHaloR * kHaloC;               // haloed site tile
constexpr int kEdge = (kTileR + 1) * kHaloC;         // edge region, per class
constexpr int kHaloIters = (kHalo + kThreads - 1) / kThreads;
constexpr int kEdgeIters = (3 * kEdge + kThreads - 1) / kThreads;
constexpr int kLinkVec = 3 * (kHaloR + kHaloC);      // factored vectors
constexpr int kLinkIters = (kLinkVec + kThreads - 1) / kThreads;
// Members per launch: blockIdx.z is the member (gridDim.z <= 65535).
constexpr int kMaxMembers = 65535;

__device__ __forceinline__ int off_r(int k) { return k == 0 ? 0 : 1; }
__device__ __forceinline__ int off_c(int k) { return k == 0 ? 1 : (k == 1 ? 0 : -1); }

// v mod n for v in [-n, 2n).
__device__ __forceinline__ int wrap(int v, int n) {
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

__device__ __forceinline__ int hidx(int lr, int lc) {
  return (lr + 1) * kHaloC + lc + 1;
}

__device__ __forceinline__ bool in_tile(int lr, int lc) {
  return lr >= 0 && lr < kTileR && lc >= 0 && lc < kTileC;
}

__device__ __forceinline__ int thread_rank() {
  return threadIdx.y * kTileC + threadIdx.x;
}

// True when the launch configuration's grid covers (rows, cols) exactly.
inline bool tiles_cover(int rows, int cols) {
  return rows > 0 && cols > 0 && rows % kTileR == 0 && cols % kTileC == 0;
}

// One z layer of tiles per member (a single run: members = 1).
inline dim3 tile_grid(int rows, int cols, int members) {
  return dim3(cols / kTileC, rows / kTileR, members);
}

inline dim3 tile_block() { return dim3(kTileC, kTileR); }

__device__ __forceinline__ float dev_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dev_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ void dev_sincos(float x, float* s, float* c) {
  sincosf(x, s, c);
}
__device__ __forceinline__ void dev_sincos(double x, double* s, double* c) {
  sincos(x, s, c);
}

// The tile's origin and the grid it lies on.
struct TileGeom {
  int r0;
  int c0;
  int rows;
  int cols;

  __device__ __forceinline__ int flat(int lr, int lc) const {
    return wrap(r0 + lr, rows) * cols + wrap(c0 + lc, cols);
  }
};

__device__ __forceinline__ TileGeom this_tile(int rows, int cols) {
  return TileGeom{static_cast<int>(blockIdx.y) * kTileR,
                  static_cast<int>(blockIdx.x) * kTileC, rows, cols};
}

// The haloed tile of psi (pr, pi), loaded into registers (slot it of
// this thread: e = rank + it * kThreads) and then stored to shared memory.
template <typename T>
struct HaloRegs {
  T r[kHaloIters];
  T i[kHaloIters];

  __device__ __forceinline__ void load(const T* __restrict__ pr,
                                       const T* __restrict__ pi,
                                       const TileGeom& g) {
#pragma unroll
    for (int it = 0; it < kHaloIters; ++it) {
      const int e = thread_rank() + it * kThreads;
      if (e < kHalo) {
        const int hr = e / kHaloC;
        const int gi = g.flat(hr - 1, e - hr * kHaloC - 1);
        r[it] = __ldg(pr + gi);
        i[it] = __ldg(pi + gi);
      }
    }
  }

  __device__ __forceinline__ void store(T* s_pr, T* s_pi) const {
#pragma unroll
    for (int it = 0; it < kHaloIters; ++it) {
      const int e = thread_rank() + it * kThreads;
      if (e < kHalo) {
        s_pr[e] = r[it];
        s_pi[e] = i[it];
      }
    }
  }
};

// Link variables U_k = ur + i ui of class k. Raw form: the (3, rows, cols)
// planes ur, ui. Factored form: rebuilt from the row vectors cf, sf
// (3, rows) and column vectors cg, sg (3, cols) by angle addition, as
// gtdgl_stencil._factored_u_k does.
template <typename T>
struct Links {
  const T* ur;
  const T* ui;
  const T* cf;
  const T* sf;
  const T* cg;
  const T* sg;
};

// The factored link vectors of a tile's rows and columns, halo included.
template <typename T>
struct LinkTile {
  T cf[3][kHaloR];
  T sf[3][kHaloR];
  T cg[3][kHaloC];
  T sg[3][kHaloC];
};

// The factored link vectors of the tile, loaded into registers and then
// stored to a LinkTile (entry e < kLinkVec: class k = e / (kHaloR +
// kHaloC), then kHaloR row entries and kHaloC column entries).
template <typename T>
struct LinkRegs {
  T c[kLinkIters];
  T s[kLinkIters];

  __device__ __forceinline__ void load(const Links<T>& L, const TileGeom& g) {
#pragma unroll
    for (int it = 0; it < kLinkIters; ++it) {
      const int e = thread_rank() + it * kThreads;
      if (e < kLinkVec) {
        const int k = e / (kHaloR + kHaloC);
        const int j = e - k * (kHaloR + kHaloC);
        if (j < kHaloR) {
          const int r = k * g.rows + wrap(g.r0 + j - 1, g.rows);
          c[it] = __ldg(L.cf + r);
          s[it] = __ldg(L.sf + r);
        } else {
          const int col = k * g.cols + wrap(g.c0 + j - kHaloR - 1, g.cols);
          c[it] = __ldg(L.cg + col);
          s[it] = __ldg(L.sg + col);
        }
      }
    }
  }

  __device__ __forceinline__ void store(LinkTile<T>& t) const {
#pragma unroll
    for (int it = 0; it < kLinkIters; ++it) {
      const int e = thread_rank() + it * kThreads;
      if (e < kLinkVec) {
        const int k = e / (kHaloR + kHaloC);
        const int j = e - k * (kHaloR + kHaloC);
        if (j < kHaloR) {
          t.cf[k][j] = c[it];
          t.sf[k][j] = s[it];
        } else {
          t.cg[k][j - kHaloR] = c[it];
          t.sg[k][j - kHaloR] = s[it];
        }
      }
    }
  }
};

// U_k at local (lr, lc) from the staged factored vectors.
template <typename T>
__device__ __forceinline__ void factored_link(const LinkTile<T>& t, int k,
                                              int lr, int lc, T& ur, T& ui) {
  const T cf = t.cf[k][lr + 1];
  const T sf = t.sf[k][lr + 1];
  const T cg = t.cg[k][lc + 1];
  const T sg = t.sg[k][lc + 1];
  ur = cf * cg - sf * sg;
  ui = -(sf * cg + cf * sg);
}

// Decode an index of the 3 x kEdge edge-region loop into its class and
// local site; the slot in a class's edge array is e - k * kEdge ==
// hidx(lr, lc).
__device__ __forceinline__ void edge_site(int e, int& k, int& lr, int& lc) {
  k = e / kEdge;
  const int h = e - k * kEdge;
  lr = h / kHaloC - 1;
  lc = h - (lr + 1) * kHaloC - 1;
}

}  // namespace tdgl
