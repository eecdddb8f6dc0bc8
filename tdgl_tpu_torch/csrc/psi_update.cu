// Fused covariant Laplacian + implicit-Euler order-parameter update.
//
// Replaces the TPU kernel tdgl_tpu/ops/pallas_step.py: fused_psi_update
// (_psi_kernel). Same arithmetic as the plain version
// tdgl_tpu_torch.models.gtdgl_stencil.implicit_euler_psi, term for term:
// the 6-edge covariant Laplacian of split-complex psi, identity rows at
// fixed sites, then the closed-form implicit-Euler quadratic with the
// cancellation-free discriminant 1 + 4c - 4 Im(conj(w) z)^2. Outputs
// psi_r, psi_i and |psi|^2 masked by `valid`, and the 0-d bool `ok`: no
// valid site has a negative (or NaN) discriminant. The update's old |psi|^2
// is pr^2 + pi^2, or the plane `old_sq` where the caller passes one (the
// screening fixed point updates its iterate with the step's starting
// |psi|^2, tdgl_tpu/solver/grid_step.py:287); one extra plane read then.
//
// What bounds it on the card: bytes. It reads 11 site planes (pr, pi, mu,
// eps, sym_diag, inv_area, fixed_mask, valid and the 3 weight planes w),
// plus the link vectors (3, rows) and (3, cols) in the factored form or 6
// more planes in the raw form, and writes 3 planes. At (256, 384) float32
// a plane is 393,216 B: 14 planes, ~5.5 MB, 1.65 us at 3.35 TB/s
// (factored); 20 planes, ~7.9 MB, 2.35 us (raw). About 2 flop per byte,
// far below the ~20 at which float32 arithmetic would bound it. A batch of
// B members with per-member links (a field sweep) moves 6 planes per
// member (pr, pi, mu in; three out) and the 8 shared ones (eps and the
// stencil's 7) once, plus B sets of link vectors: at B = 8 factored,
// 56 planes and 122,880 B of vectors, 22.1 MB, 6.61 us.
//
// Design (stencil_common.cuh): one block per 8 x 32 tile, 256 threads,
// one site per thread, 384 blocks at (256, 384).
// 1. Every global load of a thread is issued first, into registers (see
//    "Latency" in stencil_common.cuh): pr, pi of the tile plus a wrapped
//    one-site halo and the factored link vectors (then stored to shared
//    memory, from where every neighbour read comes), the class planes of
//    the edge region, and the thread's own site planes.
// 2. The negative-edge term w_k(j) conj(U_k(j)) psi(j) is an edge
//    quantity of the edge's origin j = i - offset_k (the plain version's
//    shift_m(w (U* psi)) form). Each block computes it once per edge of
//    its edge region into shared memory, so the w planes' halo is read
//    once, coalesced, and no site reads a neighbour's w or link.
// 3. Each site adds its three positive-edge terms (own w_k, U_k; psi from
//    the shared tile) and the three staged negative-edge terms, then does
//    the update.
// 4. `ok` in the same launch: each block ORs "valid site with
//    !(disc >= 0)" over its threads (__syncthreads_or), then adds itself
//    to its member's flag word with a single atomicAdd: the low 16 bits
//    count the member's blocks (the ticket), the high 16 bits count its
//    failing blocks. The add that returns a ticket of blocks - 1 belongs
//    to the block that counts itself last; the value it returns holds
//    every other block's verdict, so that block writes the member's `ok`
//    and stores 0 for the next launch. One atomic word needs no fence, and
//    the reset does not depend on block order, so the launch also works
//    under CUDA-graph replay. The words belong to one device and assume
//    one stream on it: the wrapper keeps one zeroed buffer of words per
//    device and launches on the current stream only.
//
// Members. A batch of B runs (a parameter sweep) is one launch with
// blockIdx.z the member: every operand pointer moves by z times its
// member stride, in elements, 0 for a plane that all members share
// (the stencil planes always; the links, mu, epsilon or dt where the
// caller passes one for all). Outputs are (B, rows, cols), dt and `ok`
// (B,), and each member has its own flag word, so the 16-bit ticket
// counts one member's blocks and members never see each other's verdict.
// A single run is B = 1, launched with PsiArgs alone (no strides), as
// before the member axis, and forms no member offsets.
//
// ptxas on the card (-Xptxas -v, sm_90a, CUDA 12.8), registers per thread
// of a single run / a batch and static shared memory per block, no spills
// (the 32-40 B stack frame is sincos's slow argument reduction); the
// single-run counts are those of the kernel before the member axis:
//   float  factored 40/40 regs, 11,120 B    float  raw 64/64 regs, 10,064 B
//   double factored 60/60 regs, 22,240 B    double raw 80/80 regs, 20,128 B

#include "stencil_common.cuh"

namespace tdgl {

// Slots of the member-stride array of the psi kernel (the wrapper fills
// it in this order): pr, pi, old_sq, mu, epsilon, the raw link planes
// (ur and ui), the factored row vectors (cf, sf), the factored column
// vectors (cg, sg) and dt.
enum PsiStride {
  kSPr, kSPi, kSOldSq, kSMu, kSEps, kSRaw, kSRowVec, kSColVec, kSDt,
  kPsiStrides
};

template <typename T>
struct PsiArgs {
  const T* pr;
  const T* pi;
  const T* old_sq;    // nullable: |psi|^2 of the update, else pr^2 + pi^2
  const T* mu;
  const T* eps;
  const T* w;         // (3, rows, cols)
  const T* sym_diag;
  const T* inv_area;
  const T* fixed;
  const T* valid;
  Links<T> link;
  const T* dt;        // device scalar (per member: moved by the stride)
  T half_g2;          // 0.5 * gamma^2
  T g2;               // gamma^2
  T u;
  T* out_r;
  T* out_i;
  T* out_sq;
  unsigned int* flag;  // per member: failing blocks << 16 | blocks; 0
                       // between launches
  unsigned char* ok;  // per member torch.bool
  int rows;
  int cols;
};

// Member strides in elements (0: shared by all members), in the order of
// PsiStride. Only the batched kernel takes them, so a single run's
// argument block is PsiArgs alone.
struct PsiStrides {
  long long s[kPsiStrides];
};

// This block's operands: a single run's as they are (the kernel's own
// argument, not a copy, so its code is that of a kernel without a member
// axis); in a batch, every pointer moved to member z = blockIdx.z.
template <typename T>
__device__ __forceinline__ const PsiArgs<T>& at_member(const PsiArgs<T>& a) {
  return a;
}

template <typename T>
__device__ __forceinline__ PsiArgs<T> at_member(PsiArgs<T> m,
                                                const PsiStrides& st) {
  const long long z = blockIdx.z;
  const long long n = static_cast<long long>(m.rows) * m.cols;
  m.pr += z * st.s[kSPr];
  m.pi += z * st.s[kSPi];
  if (m.old_sq != nullptr) m.old_sq += z * st.s[kSOldSq];
  m.mu += z * st.s[kSMu];
  m.eps += z * st.s[kSEps];
  if (m.link.ur != nullptr) {
    m.link.ur += z * st.s[kSRaw];
    m.link.ui += z * st.s[kSRaw];
  }
  if (m.link.cf != nullptr) {
    m.link.cf += z * st.s[kSRowVec];
    m.link.sf += z * st.s[kSRowVec];
    m.link.cg += z * st.s[kSColVec];
    m.link.sg += z * st.s[kSColVec];
  }
  m.dt += z * st.s[kSDt];
  m.out_r += z * n;
  m.out_i += z * n;
  m.out_sq += z * n;
  m.flag += z;
  m.ok += z;
  return m;
}

// A single run (B = 1) passes no strides, so PsiArgs is its whole
// argument block and no member offsets are formed: a single run pays
// nothing for the member axis. A batch passes PsiStrides, and blockIdx.z
// is the member.
template <typename T, bool FACTORED, typename... Strides>
__global__ void __launch_bounds__(kThreads)
psi_update_kernel(const PsiArgs<T> args, const Strides... strides) {
  const PsiArgs<T>& a = at_member(args, strides...);
  __shared__ T s_pr[kHalo];
  __shared__ T s_pi[kHalo];
  __shared__ T s_nr[3 * kEdge];   // negative-edge term, real part
  __shared__ T s_ni[3 * kEdge];   // and imaginary part
  __shared__ LinkTile<T> s_link;

  const TileGeom g = this_tile(a.rows, a.cols);
  const int n = a.rows * a.cols;

  // 1. Every global load of this thread, before the first barrier.
  HaloRegs<T> halo;
  halo.load(a.pr, a.pi, g);
  LinkRegs<T> links;
  if (FACTORED) links.load(a.link, g);
  // The edges whose head i = j + offset_k is a tile site: w_k(j) and, in
  // the raw form, U_k(j).
  T e_w[kEdgeIters], e_ur[kEdgeIters], e_ui[kEdgeIters];
#pragma unroll
  for (int it = 0; it < kEdgeIters; ++it) {
    const int e = thread_rank() + it * kThreads;
    int k, er, ec;
    edge_site(e, k, er, ec);
    if (e < 3 * kEdge && in_tile(er + off_r(k), ec + off_c(k))) {
      const int gi = k * n + g.flat(er, ec);
      e_w[it] = __ldg(a.w + gi);
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
  T w[3], ur[3], ui[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    w[k] = __ldg(a.w + k * n + i);
    if (!FACTORED) {
      ur[k] = __ldg(a.link.ur + k * n + i);
      ui[k] = __ldg(a.link.ui + k * n + i);
    }
  }
  const T mu = __ldg(a.mu + i);
  const T eps = __ldg(a.eps + i);
  const T diag = __ldg(a.sym_diag + i);
  const T inv_a = __ldg(a.inv_area + i);
  const T fixed = __ldg(a.fixed + i);
  const T valid = __ldg(a.valid + i);
  const T sq_in = a.old_sq != nullptr ? __ldg(a.old_sq + i) : T(0);
  const T dt = *a.dt;

  // 2. Stage psi and the link vectors.
  halo.store(s_pr, s_pi);
  if (FACTORED) links.store(s_link);
  __syncthreads();

  // 3. Negative-edge terms w_k(j) conj(U_k(j)) psi(j) of those edges.
#pragma unroll
  for (int it = 0; it < kEdgeIters; ++it) {
    const int e = thread_rank() + it * kThreads;
    int k, er, ec;
    edge_site(e, k, er, ec);
    if (e < 3 * kEdge && in_tile(er + off_r(k), ec + off_c(k))) {
      T eur, eui;
      if (FACTORED) {
        factored_link(s_link, k, er, ec, eur, eui);
      } else {
        eur = e_ur[it];
        eui = e_ui[it];
      }
      const int he = hidx(er, ec);
      const T epr = s_pr[he], epi = s_pi[he];
      s_nr[e] = e_w[it] * (eur * epr + eui * epi);
      s_ni[e] = e_w[it] * (eur * epi - eui * epr);
    }
  }
  __syncthreads();

  // 4. Laplacian and implicit-Euler update of this thread's site.
  const int h = hidx(lr, lc);
  const T pr = s_pr[h];
  const T pi = s_pi[h];
  const T old_sq = a.old_sq != nullptr ? sq_in : pr * pr + pi * pi;

  T acc_r = T(0);
  T acc_i = T(0);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int dr = off_r(k), dc = off_c(k);
    T ukr, uki;
    if (FACTORED) {
      factored_link(s_link, k, lr, lc, ukr, uki);
    } else {
      ukr = ur[k];
      uki = ui[k];
    }
    const int hp = hidx(lr + dr, lc + dc);
    const T pr_p = s_pr[hp], pi_p = s_pi[hp];
    // positive edge: U_k psi_{+k}
    acc_r = acc_r + w[k] * (ukr * pr_p - uki * pi_p);
    acc_i = acc_i + w[k] * (ukr * pi_p + uki * pr_p);
    // negative edge: conj(U_k) psi at i - offset_k, staged above
    const int m = k * kEdge + hidx(lr - dr, lc - dc);
    acc_r = acc_r + s_nr[m];
    acc_i = acc_i + s_ni[m];
  }
  T lap_r = (acc_r - pr * diag) * inv_a;
  T lap_i = (acc_i - pi * diag) * inv_a;
  lap_r = (T(1) - fixed) * lap_r + fixed * pr;
  lap_i = (T(1) - fixed) * lap_i + fixed * pi;

  T sin_p, tr;
  dev_sincos(mu * dt, &sin_p, &tr);
  const T ti = -sin_p;
  const T zr = a.half_g2 * (tr * pr - ti * pi);
  const T zi = a.half_g2 * (tr * pi + ti * pr);
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
  // max(disc, 0) that keeps a NaN, like torch.clamp.
  const T disc_pos = disc < T(0) ? T(0) : disc;
  const T new_sq = (T(2) * w2) / (two_c_1 + dev_sqrt(disc_pos));
  a.out_r[i] = (wr - zr * new_sq) * valid;
  a.out_i[i] = (wi - zi * new_sq) * valid;
  a.out_sq[i] = new_sq * valid;

  // 5. ok: OR over the block, then the block that counts itself last
  //    decides for the launch.
  const int bad = __syncthreads_or(valid > T(0) && !(disc >= T(0)));
  if (thread_rank() == 0) {
    const unsigned int before = atomicAdd(a.flag, bad ? 0x10001u : 1u);
    if ((before & 0xffffu) == gridDim.x * gridDim.y - 1) {
      *a.ok = (before >> 16) == 0 && !bad ? 1 : 0;
      *a.flag = 0u;
    }
  }
}

template <typename T>
int launch_psi_update(const T* pr, const T* pi, const T* old_sq,
                      const T* mu, const T* eps,
                      const T* w, const T* sym_diag, const T* inv_area,
                      const T* fixed, const T* valid, const T* ur,
                      const T* ui, const T* cf, const T* sf, const T* cg,
                      const T* sg, int factored, const T* dt, double gamma,
                      double u, T* out_r, T* out_i, T* out_sq,
                      unsigned int* flag, unsigned char* ok, int rows,
                      int cols, int members, const long long* strides,
                      void* stream) {
  // A flag word counts one member's blocks in 16 bits.
  if (!tiles_cover(rows, cols) ||
      (rows / kTileR) * (cols / kTileC) > 0xffff || members < 1 ||
      members > kMaxMembers) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PsiArgs<T> a;
  a.pr = pr; a.pi = pi; a.old_sq = old_sq; a.mu = mu; a.eps = eps; a.w = w;
  a.sym_diag = sym_diag; a.inv_area = inv_area; a.fixed = fixed;
  a.valid = valid;
  a.link = Links<T>{ur, ui, cf, sf, cg, sg};
  a.dt = dt;
  a.half_g2 = static_cast<T>(0.5 * (gamma * gamma));
  a.g2 = static_cast<T>(gamma * gamma);
  a.u = static_cast<T>(u);
  a.out_r = out_r; a.out_i = out_i; a.out_sq = out_sq;
  a.flag = flag; a.ok = ok;
  a.rows = rows; a.cols = cols;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = tile_grid(rows, cols, members);
  if (members > 1) {
    PsiStrides st;
    for (int k = 0; k < kPsiStrides; ++k) st.s[k] = strides[k];
    if (factored) {
      psi_update_kernel<T, true><<<grid, tile_block(), 0, s>>>(a, st);
    } else {
      psi_update_kernel<T, false><<<grid, tile_block(), 0, s>>>(a, st);
    }
  } else if (factored) {
    psi_update_kernel<T, true><<<grid, tile_block(), 0, s>>>(a);
  } else {
    psi_update_kernel<T, false><<<grid, tile_block(), 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tdgl

#define TDGL_PSI_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const T* pr, const T* pi, const T* old_sq,             \
                      const T* mu, const T* eps,                              \
                      const T* w, const T* sym_diag, const T* inv_area,       \
                      const T* fixed, const T* valid, const T* ur,            \
                      const T* ui, const T* cf, const T* sf, const T* cg,     \
                      const T* sg, int factored, const T* dt, double gamma,   \
                      double u, T* out_r, T* out_i, T* out_sq,                \
                      unsigned int* flag, unsigned char* ok, int rows,        \
                      int cols, int members, const long long* strides,        \
                      void* stream) {                                         \
    return tdgl::launch_psi_update<T>(pr, pi, old_sq, mu, eps, w, sym_diag,   \
                                      inv_area, fixed, valid, ur, ui, cf, sf, \
                                      cg, sg,                                 \
                                      factored, dt, gamma, u, out_r, out_i,   \
                                      out_sq, flag, ok, rows, cols, members,  \
                                      strides, stream);                       \
  }

TDGL_PSI_ENTRY(tdgl_psi_update_f32, float)
TDGL_PSI_ENTRY(tdgl_psi_update_f64, double)

// The (rows, cols) tile of both kernels: the grid must be a multiple of it.
extern "C" void tdgl_step_tile(int* rows, int* cols) {
  *rows = tdgl::kTileR;
  *cols = tdgl::kTileC;
}
