// Fused supercurrent + divergence + Neumann term: the mu-Poisson RHS.
//
// Replaces the TPU kernel tdgl_tpu/ops/pallas_step.py: fused_poisson_rhs
// (_rhs_kernel). Same arithmetic as the plain version
// poisson_rhs(supercurrent_on_edges(...)) in
// tdgl_tpu_torch.models.gtdgl_stencil: on each of the 3 edge classes the
// supercurrent Im[conj(psi) (U psi_{+k} - psi)] / len, minus dA/dt, times
// the dual length, divergence onto sites, times the inverse area, minus
// the pre-scattered Neumann term. In the first form the (3, rows, cols)
// edge currents never reach device memory; the second form (a non-null
// `js`, the screened step's) also writes them, J_s = Im[conj(psi) (U
// psi_{+k} - psi)] / len per class-k edge at its origin, from the same
// registers: three more plane stores per site, no other change. Its plain
// version is (poisson_rhs(sten, J_s, ...), J_s).
//
// What bounds it on the card: bytes. It reads pr, pi, inv_area, the
// Neumann plane and 3 planes each of inv_len, dual and dA/dt (13 planes),
// plus the link vectors (factored) or 6 link planes (raw), and writes one
// plane (four with J_s). At (256, 384) float32: 14 planes, ~5.5 MB, 1.65 us
// at 3.35 TB/s (factored); 20 planes, ~7.9 MB, 2.35 us (raw); the J_s form
// with raw links, the screened step's, 23 planes, ~9.0 MB, 2.70 us. About 2
// flop per byte. A batch of B members moves 4 planes per member (pr, pi
// and the Neumann plane in, rhs out) and the 10 shared ones (inv_len,
// dual, dA/dt, inv_area) once: at B = 8 factored with per-member links,
// 42 planes and 122,880 B of vectors, 16.6 MB, 4.97 us.
//
// Design (stencil_common.cuh): one block per 8 x 32 tile, 256 threads,
// one site per thread, 384 blocks at (256, 384).
// 1. Every global load of a thread is issued first, into registers (see
//    "Latency" in stencil_common.cuh): pr, pi of the tile plus a wrapped
//    one-site halo and the factored link vectors (then stored to shared
//    memory), the edge planes of the edges below, and its own sites'
//    inv_area and Neumann term.
// 2. Each edge flux dF_k(j) = dual_k (J_k - dA/dt_k) at origin j is
//    computed once, into shared memory, for the edges of the tile's sites
//    and those of the halo on the negative side of each class (j + off_k
//    in the tile): every inv_len, dual and dA/dt entry the block needs is
//    read once, and no flux is computed twice within a block.
// 3. Each site takes the divergence sum_k dF_k(i) - dF_k(i - offset_k)
//    from shared memory, times inv_area, minus the Neumann term.
//
// Members (stencil_common.cuh): blockIdx.z is the member of a batch. pr,
// pi, the links, dA/dt and the Neumann plane move by their member
// strides (0 where all members share one: the links and dA/dt of a
// current sweep, the Neumann plane of a field sweep); inv_len, dual and
// inv_area are always shared; rhs is (B, rows, cols) and J_s (B, 3, rows,
// cols). A single run is B = 1, launched with RhsArgs alone (no strides),
// as before the member axis, and forms no member offsets.
//
// ptxas on the card (-Xptxas -v, sm_90a, CUDA 12.8), registers per thread
// and static shared memory per block, no spills but 8 B in the batched
// double raw form; a single run / its J_s form, then the same two for a
// batch (the single-run counts are those of the kernel before the member
// axis):
//   float  factored 42/46, 46/48 regs, 7,448 B
//   float  raw      48/57, 48/56 regs, 6,392 B
//   double factored 64/62, 58/64 regs, 14,896 B
//   double raw      64/78, 64/76 regs, 12,784 B

#include "stencil_common.cuh"

namespace tdgl {

// Slots of the member-stride array of the RHS kernel (the wrapper fills
// it in this order): pr, pi, the raw link planes (ur and ui), the
// factored row vectors (cf, sf), the factored column vectors (cg, sg),
// dA/dt and the Neumann plane.
enum RhsStride {
  kRPr, kRPi, kRRaw, kRRowVec, kRColVec, kRDa, kRNeumann, kRhsStrides
};

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
  T* js;              // (3, rows, cols), written by the J_s form only
  int rows;
  int cols;
};

// Member strides in elements (0: shared by all members), in the order of
// RhsStride. Only the batched kernel takes them, so a single run's
// argument block is RhsArgs alone.
struct RhsStrides {
  long long s[kRhsStrides];
};

// This block's operands: a single run's as they are (the kernel's own
// argument, not a copy, so its code is that of a kernel without a member
// axis); in a batch, every pointer moved to member z = blockIdx.z.
template <typename T>
__device__ __forceinline__ const RhsArgs<T>& at_member(const RhsArgs<T>& a) {
  return a;
}

template <typename T>
__device__ __forceinline__ RhsArgs<T> at_member(RhsArgs<T> m,
                                                const RhsStrides& st) {
  const long long z = blockIdx.z;
  const long long n = static_cast<long long>(m.rows) * m.cols;
  m.pr += z * st.s[kRPr];
  m.pi += z * st.s[kRPi];
  if (m.link.ur != nullptr) {
    m.link.ur += z * st.s[kRRaw];
    m.link.ui += z * st.s[kRRaw];
  }
  if (m.link.cf != nullptr) {
    m.link.cf += z * st.s[kRRowVec];
    m.link.sf += z * st.s[kRRowVec];
    m.link.cg += z * st.s[kRColVec];
    m.link.sg += z * st.s[kRColVec];
  }
  m.dA_dt += z * st.s[kRDa];
  m.neumann += z * st.s[kRNeumann];
  m.rhs += z * n;
  if (m.js != nullptr) m.js += z * 3 * n;
  return m;
}

// A single run (B = 1) passes no strides, so RhsArgs is its whole
// argument block and no member offsets are formed: a single run pays
// nothing for the member axis. A batch passes RhsStrides, and blockIdx.z
// is the member.
template <typename T, bool FACTORED, bool WRITE_JS, typename... Strides>
__global__ void __launch_bounds__(kThreads)
poisson_rhs_kernel(const RhsArgs<T> args, const Strides... strides) {
  const RhsArgs<T>& a = at_member(args, strides...);
  __shared__ T s_pr[kHalo];
  __shared__ T s_pi[kHalo];
  __shared__ T s_flux[3 * kEdge];
  __shared__ LinkTile<T> s_link;

  const TileGeom g = this_tile(a.rows, a.cols);
  const int n = a.rows * a.cols;

  // 1. Every global load of this thread, before the first barrier.
  HaloRegs<T> halo;
  halo.load(a.pr, a.pi, g);
  LinkRegs<T> links;
  if (FACTORED) links.load(a.link, g);
  // The class-k edges (lr, lc) -> (lr, lc) + off_k that start or end at a
  // tile site: inv_len, dual, dA/dt and, in the raw form, U_k.
  T e_il[kEdgeIters], e_du[kEdgeIters], e_da[kEdgeIters];
  T e_ur[kEdgeIters], e_ui[kEdgeIters];
#pragma unroll
  for (int it = 0; it < kEdgeIters; ++it) {
    const int e = thread_rank() + it * kThreads;
    int k, er, ec;
    edge_site(e, k, er, ec);
    if (e < 3 * kEdge &&
        (in_tile(er, ec) || in_tile(er + off_r(k), ec + off_c(k)))) {
      const int gi = k * n + g.flat(er, ec);
      e_il[it] = __ldg(a.inv_len + gi);
      e_du[it] = __ldg(a.dual + gi);
      e_da[it] = __ldg(a.dA_dt + gi);
      if (!FACTORED) {
        e_ur[it] = __ldg(a.link.ur + gi);
        e_ui[it] = __ldg(a.link.ui + gi);
      }
    }
  }
  // This thread's own site.
  const int lr = threadIdx.y;
  const int lc = threadIdx.x;
  const int i = (g.r0 + lr) * a.cols + g.c0 + lc;
  const T inv_a = __ldg(a.inv_area + i);
  const T neumann = __ldg(a.neumann + i);

  // 2. Stage psi and the link vectors.
  halo.store(s_pr, s_pi);
  if (FACTORED) links.store(s_link);
  __syncthreads();

  // 3. dual * (J_k - dA/dt) on each of those edges, once.
#pragma unroll
  for (int it = 0; it < kEdgeIters; ++it) {
    const int e = thread_rank() + it * kThreads;
    int k, er, ec;
    edge_site(e, k, er, ec);
    const int er_p = er + off_r(k), ec_p = ec + off_c(k);
    if (e < 3 * kEdge && (in_tile(er, ec) || in_tile(er_p, ec_p))) {
      T ur, ui;
      if (FACTORED) {
        factored_link(s_link, k, er, ec, ur, ui);
      } else {
        ur = e_ur[it];
        ui = e_ui[it];
      }
      const int h = hidx(er, ec), hp = hidx(er_p, ec_p);
      const T pr = s_pr[h], pi = s_pi[h];
      const T pr_p = s_pr[hp], pi_p = s_pi[hp];
      const T grad_r = ur * pr_p - ui * pi_p - pr;
      const T grad_i = ur * pi_p + ui * pr_p - pi;
      const T J = (pr * grad_i - pi * grad_r) * e_il[it];
      s_flux[e] = e_du[it] * (J - e_da[it]);
      // Each tile site's own edges: J_s of the class-k edge at (er, ec).
      if (WRITE_JS && in_tile(er, ec)) a.js[k * n + g.flat(er, ec)] = J;
    }
  }
  __syncthreads();

  // 4. Divergence onto this thread's site.
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T dF = s_flux[k * kEdge + hidx(lr, lc)];
    const T dF_m = s_flux[k * kEdge + hidx(lr - off_r(k), lc - off_c(k))];
    acc = acc + dF - dF_m;
  }
  a.rhs[i] = acc * inv_a - neumann;
}

// One of the four link and J_s forms, of a single run (no strides) or of
// a batch.
template <typename T, bool FACTORED, bool WRITE_JS>
void launch_rhs_form(const RhsArgs<T>& a, const RhsStrides* st, dim3 grid,
                     cudaStream_t s) {
  if (st == nullptr) {
    poisson_rhs_kernel<T, FACTORED, WRITE_JS>
        <<<grid, tile_block(), 0, s>>>(a);
  } else {
    poisson_rhs_kernel<T, FACTORED, WRITE_JS>
        <<<grid, tile_block(), 0, s>>>(a, *st);
  }
}

template <typename T>
int launch_poisson_rhs(const T* pr, const T* pi, const T* ur, const T* ui,
                       const T* cf, const T* sf, const T* cg, const T* sg,
                       int factored, const T* inv_len, const T* dual,
                       const T* dA_dt, const T* inv_area, const T* neumann,
                       T* rhs, T* js, int rows, int cols, int members,
                       const long long* strides, void* stream) {
  if (!tiles_cover(rows, cols) || members < 1 || members > kMaxMembers) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RhsArgs<T> a;
  a.pr = pr; a.pi = pi;
  a.link = Links<T>{ur, ui, cf, sf, cg, sg};
  a.inv_len = inv_len; a.dual = dual; a.dA_dt = dA_dt;
  a.inv_area = inv_area; a.neumann = neumann; a.rhs = rhs; a.js = js;
  a.rows = rows; a.cols = cols;
  RhsStrides st;
  for (int k = 0; k < kRhsStrides; ++k) st.s[k] = strides[k];
  const RhsStrides* batch = members > 1 ? &st : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = tile_grid(rows, cols, members);
  if (factored && js != nullptr) {
    launch_rhs_form<T, true, true>(a, batch, grid, s);
  } else if (factored) {
    launch_rhs_form<T, true, false>(a, batch, grid, s);
  } else if (js != nullptr) {
    launch_rhs_form<T, false, true>(a, batch, grid, s);
  } else {
    launch_rhs_form<T, false, false>(a, batch, grid, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tdgl

#define TDGL_RHS_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const T* pr, const T* pi, const T* ur, const T* ui,     \
                      const T* cf, const T* sf, const T* cg, const T* sg,     \
                      int factored, const T* inv_len, const T* dual,          \
                      const T* dA_dt, const T* inv_area, const T* neumann,    \
                      T* rhs, T* js, int rows, int cols, int members,         \
                      const long long* strides, void* stream) {               \
    return tdgl::launch_poisson_rhs<T>(pr, pi, ur, ui, cf, sf, cg, sg,        \
                                       factored, inv_len, dual, dA_dt,        \
                                       inv_area, neumann, rhs, js, rows,      \
                                       cols, members, strides, stream);       \
  }

TDGL_RHS_ENTRY(tdgl_poisson_rhs_f32, float)
TDGL_RHS_ENTRY(tdgl_poisson_rhs_f64, double)
