// Fused supercurrent + divergence + Neumann term: the mu-Poisson RHS.
//
// Replaces the TPU kernel tdgl_tpu/ops/pallas_step.py: fused_poisson_rhs
// (_rhs_kernel). Same arithmetic as the plain version
// poisson_rhs(supercurrent_on_edges(...)) in
// tdgl_tpu_torch.models.gtdgl_stencil: on each of the 3 edge classes the
// supercurrent Im[conj(psi) (U psi_{+k} - psi)] / len, minus dA/dt, times
// the dual length, divergence onto sites, times the inverse area, minus
// the pre-scattered Neumann term. The (3, rows, cols) edge currents never
// reach device memory.
//
// What bounds it on the card: bytes. Per site it reads pr, pi, inv_area
// and the Neumann plane, plus 3 planes each of inv_len, dual and dA/dt
// (13 planes), plus the 6 raw link planes in the raw form; it writes one
// plane. At (256, 384) float32 that is under 8 MB, resident in the 50 MB
// L2. Design: one thread per site; the flux through the negative edge of
// class k is recomputed at the neighbour site instead of being stored and
// re-read, so the kernel makes one pass and needs no second launch.

#include "stencil_common.cuh"

namespace tdgl {

template <typename T>
struct RhsArgs {
  const T* pr;
  const T* pi;
  Links<T> link;
  const T* inv_len;   // (3, rows, cols)
  const T* dual;      // (3, rows, cols)
  const T* dA_dt;     // (3, rows, cols)
  const T* inv_area;
  const T* neumann;
  T* rhs;
  int rows;
  int cols;
};

// dual * (J_k - dA/dt) on the class-k edge that starts at site (r, c) = i
// and ends at site j = (r, c) + offset_k.
template <typename T, bool FACTORED>
__device__ __forceinline__ T edge_flux(const RhsArgs<T>& a, int k, int r,
                                       int c, int i, int j, int n) {
  T ur, ui;
  link_at<T, FACTORED>(a.link, k, r, c, i, n, a.rows, a.cols, ur, ui);
  const T pr = a.pr[i], pi = a.pi[i];
  const T pr_p = a.pr[j], pi_p = a.pi[j];
  const T grad_r = ur * pr_p - ui * pi_p - pr;
  const T grad_i = ur * pi_p + ui * pr_p - pi;
  const T J = (pr * grad_i - pi * grad_r) * a.inv_len[k * n + i];
  return a.dual[k * n + i] * (J - a.dA_dt[k * n + i]);
}

template <typename T, bool FACTORED>
__global__ void __launch_bounds__(kThreads)
poisson_rhs_kernel(const RhsArgs<T> a) {
  const int n = a.rows * a.cols;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int r = i / a.cols;
  const int c = i - r * a.cols;
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int dr = off_r(k), dc = off_c(k);
    const int ip = wrap(r + dr, a.rows) * a.cols + wrap(c + dc, a.cols);
    const int rm = wrap(r - dr, a.rows), cm = wrap(c - dc, a.cols);
    const int im = rm * a.cols + cm;
    const T dF = edge_flux<T, FACTORED>(a, k, r, c, i, ip, n);
    const T dF_m = edge_flux<T, FACTORED>(a, k, rm, cm, im, i, n);
    acc = acc + dF - dF_m;
  }
  a.rhs[i] = acc * a.inv_area[i] - a.neumann[i];
}

template <typename T>
int launch_poisson_rhs(const T* pr, const T* pi, const T* ur, const T* ui,
                       const T* cf, const T* sf, const T* cg, const T* sg,
                       int factored, const T* inv_len, const T* dual,
                       const T* dA_dt, const T* inv_area, const T* neumann,
                       T* rhs, int rows, int cols, void* stream) {
  RhsArgs<T> a;
  a.pr = pr; a.pi = pi;
  a.link = Links<T>{ur, ui, cf, sf, cg, sg};
  a.inv_len = inv_len; a.dual = dual; a.dA_dt = dA_dt;
  a.inv_area = inv_area; a.neumann = neumann; a.rhs = rhs;
  a.rows = rows; a.cols = cols;
  const int n = rows * cols;
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (factored) {
    poisson_rhs_kernel<T, true><<<blocks, kThreads, 0, s>>>(a);
  } else {
    poisson_rhs_kernel<T, false><<<blocks, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tdgl

#define TDGL_RHS_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const T* pr, const T* pi, const T* ur, const T* ui,     \
                      const T* cf, const T* sf, const T* cg, const T* sg,     \
                      int factored, const T* inv_len, const T* dual,          \
                      const T* dA_dt, const T* inv_area, const T* neumann,    \
                      T* rhs, int rows, int cols, void* stream) {             \
    return tdgl::launch_poisson_rhs<T>(pr, pi, ur, ui, cf, sf, cg, sg,        \
                                       factored, inv_len, dual, dA_dt,        \
                                       inv_area, neumann, rhs, rows, cols,    \
                                       stream);                               \
  }

TDGL_RHS_ENTRY(tdgl_poisson_rhs_f32, float)
TDGL_RHS_ENTRY(tdgl_poisson_rhs_f64, double)
