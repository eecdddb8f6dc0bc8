// Fused covariant Laplacian + implicit-Euler order-parameter update.
//
// Replaces the TPU kernel tdgl_tpu/ops/pallas_step.py: fused_psi_update
// (_psi_kernel). Same arithmetic as the plain version
// tdgl_tpu_torch.models.gtdgl_stencil.implicit_euler_psi, term for term:
// the 6-edge covariant Laplacian of split-complex psi, identity rows at
// fixed sites, then the closed-form implicit-Euler quadratic with the
// cancellation-free discriminant 1 + 4c - 4 Im(conj(w) z)^2. Outputs
// psi_r, psi_i and |psi|^2 masked by `valid`; any valid site with a
// negative (or NaN) discriminant stores 1 into the device flag `bad`,
// which the wrapper zeroes before the launch (ok == (bad == 0)).
//
// What bounds it on the card: bytes. Per site it reads the planes pr, pi,
// mu, eps, sym_diag, inv_area, fixed_mask, valid and the 3 weight planes
// (11 planes), plus the 6 raw link planes in the raw form (17 planes); the
// factored form reads four short row/column vectors instead. It writes 3
// planes. At (256, 384) float32 a plane is 393 KB, so the working set
// (under 7 MB) sits in the 50 MB L2 and neighbour re-reads hit cache.
// Design: one thread per (r, c) site, neighbour indices taken modulo the
// padded grid, and each negative-edge term computed at the neighbour site
// (the shift_m(...) form) so nothing but inputs is read. No shared-memory
// tiling yet.

#include "stencil_common.cuh"

namespace tdgl {

template <typename T>
struct PsiArgs {
  const T* pr;
  const T* pi;
  const T* mu;
  const T* eps;
  const T* w;         // (3, rows, cols)
  const T* sym_diag;
  const T* inv_area;
  const T* fixed;
  const T* valid;
  Links<T> link;
  const T* dt;        // device scalar
  T half_g2;          // 0.5 * gamma^2
  T g2;               // gamma^2
  T u;
  T* out_r;
  T* out_i;
  T* out_sq;
  int* bad;
  int rows;
  int cols;
};

template <typename T, bool FACTORED>
__global__ void __launch_bounds__(kThreads)
psi_update_kernel(const PsiArgs<T> a) {
  const int n = a.rows * a.cols;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int r = i / a.cols;
  const int c = i - r * a.cols;
  const T pr = a.pr[i];
  const T pi = a.pi[i];
  const T old_sq = pr * pr + pi * pi;

  T acc_r = T(0);
  T acc_i = T(0);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int dr = off_r(k), dc = off_c(k);
    const int ip = wrap(r + dr, a.rows) * a.cols + wrap(c + dc, a.cols);
    const int rm = wrap(r - dr, a.rows), cm = wrap(c - dc, a.cols);
    const int im = rm * a.cols + cm;
    T ur, ui, urm, uim;
    link_at<T, FACTORED>(a.link, k, r, c, i, n, a.rows, a.cols, ur, ui);
    link_at<T, FACTORED>(a.link, k, rm, cm, im, n, a.rows, a.cols, urm, uim);
    const T wk = a.w[k * n + i];
    const T wkm = a.w[k * n + im];
    const T pr_p = a.pr[ip], pi_p = a.pi[ip];
    const T pr_m = a.pr[im], pi_m = a.pi[im];
    // positive edge: U_k psi_{+k}
    acc_r = acc_r + wk * (ur * pr_p - ui * pi_p);
    acc_i = acc_i + wk * (ur * pi_p + ui * pr_p);
    // negative edge, evaluated at the neighbour: conj(U_k) psi_{-k}
    acc_r = acc_r + wkm * (urm * pr_m + uim * pi_m);
    acc_i = acc_i + wkm * (urm * pi_m - uim * pr_m);
  }
  const T diag = a.sym_diag[i];
  const T inv_a = a.inv_area[i];
  const T fixed = a.fixed[i];
  T lap_r = (acc_r - pr * diag) * inv_a;
  T lap_i = (acc_i - pi * diag) * inv_a;
  lap_r = (T(1) - fixed) * lap_r + fixed * pr;
  lap_i = (T(1) - fixed) * lap_i + fixed * pi;

  const T dt = *a.dt;
  const T phase = a.mu[i] * dt;
  const T tr = dev_cos(phase);
  const T ti = -dev_sin(phase);
  const T zr = a.half_g2 * (tr * pr - ti * pi);
  const T zi = a.half_g2 * (tr * pi + ti * pr);
  const T eps = a.eps[i];
  const T coeff = (dt / a.u) * dev_sqrt(T(1) + a.g2 * old_sq);
  const T gr = pr + coeff * ((eps - old_sq) * pr + lap_r);
  const T gi = pi + coeff * ((eps - old_sq) * pi + lap_i);
  const T wr = zr * old_sq + tr * gr - ti * gi;
  const T wi = zi * old_sq + tr * gi + ti * gr;
  const T cc = wr * zr + wi * zi;
  const T two_c_1 = T(2) * cc + T(1);
  const T w2 = wr * wr + wi * wi;
  const T im_wz = wr * zi - wi * zr;
  const T disc = T(1) + T(4) * cc - T(4) * (im_wz * im_wz);
  const T valid = a.valid[i];
  if (valid > T(0) && !(disc >= T(0))) *a.bad = 1;
  // max(disc, 0) that keeps a NaN, like torch.clamp.
  const T disc_pos = disc < T(0) ? T(0) : disc;
  const T new_sq = (T(2) * w2) / (two_c_1 + dev_sqrt(disc_pos));
  a.out_r[i] = (wr - zr * new_sq) * valid;
  a.out_i[i] = (wi - zi * new_sq) * valid;
  a.out_sq[i] = new_sq * valid;
}

template <typename T>
int launch_psi_update(const T* pr, const T* pi, const T* mu, const T* eps,
                      const T* w, const T* sym_diag, const T* inv_area,
                      const T* fixed, const T* valid, const T* ur,
                      const T* ui, const T* cf, const T* sf, const T* cg,
                      const T* sg, int factored, const T* dt, double gamma,
                      double u, T* out_r, T* out_i, T* out_sq, int* bad,
                      int rows, int cols, void* stream) {
  PsiArgs<T> a;
  a.pr = pr; a.pi = pi; a.mu = mu; a.eps = eps; a.w = w;
  a.sym_diag = sym_diag; a.inv_area = inv_area; a.fixed = fixed;
  a.valid = valid;
  a.link = Links<T>{ur, ui, cf, sf, cg, sg};
  a.dt = dt;
  a.half_g2 = static_cast<T>(0.5 * (gamma * gamma));
  a.g2 = static_cast<T>(gamma * gamma);
  a.u = static_cast<T>(u);
  a.out_r = out_r; a.out_i = out_i; a.out_sq = out_sq; a.bad = bad;
  a.rows = rows; a.cols = cols;
  const int n = rows * cols;
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (factored) {
    psi_update_kernel<T, true><<<blocks, kThreads, 0, s>>>(a);
  } else {
    psi_update_kernel<T, false><<<blocks, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tdgl

#define TDGL_PSI_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const T* pr, const T* pi, const T* mu, const T* eps,    \
                      const T* w, const T* sym_diag, const T* inv_area,       \
                      const T* fixed, const T* valid, const T* ur,            \
                      const T* ui, const T* cf, const T* sf, const T* cg,     \
                      const T* sg, int factored, const T* dt, double gamma,   \
                      double u, T* out_r, T* out_i, T* out_sq, int* bad,      \
                      int rows, int cols, void* stream) {                     \
    return tdgl::launch_psi_update<T>(pr, pi, mu, eps, w, sym_diag, inv_area, \
                                      fixed, valid, ur, ui, cf, sf, cg, sg,   \
                                      factored, dt, gamma, u, out_r, out_i,   \
                                      out_sq, bad, rows, cols, stream);       \
  }

TDGL_PSI_ENTRY(tdgl_psi_update_f32, float)
TDGL_PSI_ENTRY(tdgl_psi_update_f64, double)
