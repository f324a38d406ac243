// Red-black Gauss-Seidel on the cell-centred ABecLaplacian for Hopper
// (sm_90a), bound to PyTorch through a plain C interface (ctypes; see
// iamr_tpu_torch/native.py and the wrapper ops/mg_kernels.py::cell_smooth).
//
// Which TPU kernels this replaces
//   mg_cell_gsrb <- iamr_tpu/ops/pallas_fused.py::cell_smooth_fused (K4:
//                   _cell_core; nsweeps x (red, black) passes plus an
//                   optional residual, diag formed in the kernel)
//                <- iamr_tpu/ops/pallas_mg.py::cell_sweep (K5:
//                   _cell_kernel_3d / _cell_kernel_2d; one colour, or the
//                   residual with update=False)
//
// Computes, per cell, r = rhs - ((a alpha) phi - b div(beta grad phi)) and
// either phi <- phi + r / diag on the cells of one colour ((i+j+k) % 2 ==
// colour, stencil.checkerboard) or res <- r, with the homogeneous ghosts of
// ops/mg.py::_pad_phi (periodic wrap, Dirichlet -2 c0 + c1/3, Neumann c0)
// and diag formed here, as _cell_core does: a alpha + sum_d b (f_lo beta_lo
// + f_hi beta_hi) / dx_d^2, f = 3 on a Dirichlet boundary face, 0 on a
// Neumann one, 1 elsewhere, 0 replaced by 1 (ops/mg.py::_diag). 1 / dx^2
// comes from the host in double, as PyTorch forms the reciprocal of a
// Python float on the card; otherwise the kernel sums in its own order, so
// it agrees with the plain version to rounding, not bit for bit.
//
// Design: one launch per call, reading phi, rhs, the three beta arrays
// (and alpha when a != 0) once from device memory. A block owns a (dim 1,
// dim 2) column tile, 30 or 32 rows of 32 cells (3D; 2D: one row of 128),
// a thread two cells of neighbouring rows, and marches along dim 0; the
// P = passes + want_resid stages (the colour passes, then the residual)
// run as a pipeline behind the march, stage s on plane i - s when plane i
// is loaded. Every stage reads the previous stage's values, as the plain
// checkerboard pass does, so a cell also sees the pre-pass value of a
// same-colour neighbour across an odd periodic extent. When a plane is
// loaded, its cells' weights are formed once with the ghosts folded in
// (S' = (rhs + sum_n w_n phi_n) / diag; a Dirichlet ghost -2 c + c1/3 adds
// w/3 to the inward neighbour and 3 w to diag, a Neumann ghost drops w)
// and kept for the P stages in a shared-memory ring: a colour pass sets
// phi = S' on the one of a thread's two cells that has the pass's colour,
// and the residual is (S' - phi) diag. A stage's output plane goes to
// shared memory for its in-plane neighbours (two planes per stage and one
// barrier a step where the shared memory stays under 196 KB, else one
// plane and two barriers); a cell's planes p - 1, p, p + 1 stay in
// registers. The colour comes from the wrapped global index, so every load
// is a full coalesced row. The block covers its output tile with a halo of
// P cells per side and P planes per chunk of dim 0; stages skip the planes
// and warps that feed no output.
//
// Bound at 256^3 f32, 2 sweeps + residual (a = 0): phi, rhs and the three
// beta arrays read once, out and res written once, 7 x 67 MB = 0.47 GB,
// 0.14 ms at 3.35 TB/s; ~27 operations a cell and evaluation, a colour
// pass evaluating half the cells, 1.6 Gop, 0.02 ms at 67 TFLOP/s. So bytes
// bound it. What keeps the kernel from it: the halo work (32 x 30 cells
// computed for 22 x 20 written at P = 5, 2.2x), and the ring (8 values a
// cell and plane), which caps the tile and leaves one block of 15 warps an
// SM to hide the latency of the stage chain. Left for later: a smaller
// ring (face weights shared between neighbours), clusters sharing halos
// across SMs.

#include <cuda_runtime.h>

namespace {

constexpr int kPeriodic = 0;
constexpr int kDirichlet = 1;
constexpr int kMaxStages = 5;  // 2 sweeps + residual in one launch

template <typename T>
struct CellArgs {
  const T* phi;
  T* out;            // the last pass's output (no pass: unused)
  T* res;            // the residual after the passes, or null
  const T* rhs;
  const T* alpha;    // null when a == 0
  const T* beta[3];  // face coefficients, +1 in their dim
  const T* b_dev;    // b as a device scalar, or null (then b_val)
  T a, b_val;
  T inv_h2[3];       // 1 / dx_d^2, formed in double by the host
  int n[3];          // cells per dim
  int lo[3], hi[3];  // BC kinds per side
  int npass, first_colour, want_resid;
  int tile[2];       // output columns of a block per in-plane dim
  int chunk;         // output planes of a block along dim 0
};

// threads of a block and the tile they cover. 3D: BX threads along the
// last dim, one cell each, and BY along dim 1, two rows each: ROWS = 2 BY
// rows of W = BX cells (30 rows at 5 stages f32, which keeps the shared
// memory under 196 KB, see double_buffered). 2D: BX threads of two cells,
// one row of W = 2 BX.
template <typename T, int DIM, int P>
struct Block {
  static constexpr int BX = DIM == 3 ? 32 : 64;
  static constexpr int BY = DIM == 3 ? (sizeof(T) == 4 ? (P == 5 ? 15 : 16) : 8) : 1;
  static constexpr int ROWS = DIM == 3 ? 2 * BY : 1;
  static constexpr int W = DIM == 3 ? BX : 2 * BX;
};

// cell index g of a dim of n cells: periodic wraps, non-periodic is
// clamped (the kernel zeroes the cells outside)
__device__ __forceinline__ int cell_at(int g, int n, bool per) {
  if (g >= 0 && g < n) return g;
  if (!per) return g < 0 ? 0 : n - 1;
  const int r = g % n;
  return r < 0 ? r + n : r;
}

// per cell and call: the weights of the 2 DIM neighbours (lo, hi per dim)
// and rhs, all over diag, and diag
template <int DIM>
__host__ __device__ constexpr int ring_values() { return 2 * DIM + 2; }

// 1 / x, correctly rounded
__device__ __forceinline__ float reciprocal(float x) { return __frcp_rn(x); }
__device__ __forceinline__ double reciprocal(double x) { return __drcp_rn(x); }

template <typename T, int DIM, int P>
__host__ __device__ constexpr int smem_bytes(int nb) {
  using B = Block<T, DIM, P>;
  return P * (nb * ((B::ROWS + 2) * B::W + 4) + ring_values<DIM>() * B::W * B::ROWS) *
         (int)sizeof(T);
}

// two phi planes per stage (one barrier a step) where that leaves the SM
// at least 60 KB of L1 for the plane loads (at most 196 KB shared), else
// one (two barriers a step)
template <typename T, int DIM, int P>
__host__ __device__ constexpr bool double_buffered() {
  return smem_bytes<T, DIM, P>(2) <= 196 * 1024;
}

// one of a thread's two cell columns
struct Column {
  int col;             // offset within a plane of the cell arrays
  int bcol[2];         // ... of the in-plane beta arrays (in-plane dim e)
  bool at_lo[2], at_hi[2];  // on a non-periodic boundary of in-plane dim e
  bool bnd;            // on a non-periodic boundary of an in-plane dim
  bool inside, out;    // in the domain; in the block's output tile
  int par;             // parity of the wrapped in-plane indices
};

template <typename T, int DIM, int P>
__global__ void __launch_bounds__(Block<T, DIM, P>::BX * Block<T, DIM, P>::BY)
mg_cell_gsrb_kernel(const CellArgs<T> a) {
  constexpr int NI = DIM - 1;
  using B = Block<T, DIM, P>;
  constexpr int W = B::W, ROWS = B::ROWS;
  constexpr int NC = W * ROWS;             // cells of a tile plane
  constexpr int NW = ring_values<DIM>();
  constexpr int SN = (ROWS + 2) * W + 4;   // a shared plane, one pad row per side
  constexpr int PS = DIM == 3 ? W : 1;     // from a thread's cell 0 to its cell 1 (dim 1)
  constexpr int NB = double_buffered<T, DIM, P>() ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  T* S = reinterpret_cast<T*>(smem);  // [stage 0..P-1][NB][SN] phi planes
  T* R = S + P * NB * SN;             // [P][NW][NC] ring of the cells' weights

  const int tx = threadIdx.x, ty = DIM == 3 ? threadIdx.y : 0;
  const int r0 = DIM == 3 ? 2 * ty : 0, k0 = DIM == 3 ? tx : 2 * tx;  // cell 0's row, column
  const int so = 2 + (r0 + 1) * W + k0;
  const int cid = r0 * W + k0;
  for (int k = ty * B::BX + tx; k < (NB * SN + NW * NC) * P; k += B::BX * B::BY) S[k] = T(0);

  Column cc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int wc[NI], nd[NI];
    cc[h].inside = cc[h].out = true;
    cc[h].par = 0;
#pragma unroll
    for (int e = 0; e < NI; ++e) {
      const int d = e + 1, n = a.n[d];
      const bool per = a.lo[d] == kPeriodic;
      const int t = e == 0 ? (DIM == 3 ? r0 : k0) + h : k0;
      const int bt = e == NI - 1 ? blockIdx.x : blockIdx.y;
      const int g = bt * a.tile[e] - P + t;
      wc[e] = cell_at(g, n, per);
      nd[e] = n;
      cc[h].at_lo[e] = !per && g == 0;
      cc[h].at_hi[e] = !per && g == n - 1;
      cc[h].inside = cc[h].inside && (per || (g >= 0 && g < n));
      cc[h].out = cc[h].out && t >= P && t < P + a.tile[e] && g < n;
      cc[h].par += wc[e];
    }
    cc[h].bnd = false;
#pragma unroll
    for (int e = 0; e < NI; ++e) cc[h].bnd = cc[h].bnd || cc[h].at_lo[e] || cc[h].at_hi[e];
    if constexpr (NI == 2) {
      cc[h].col = wc[0] * nd[1] + wc[1];
      cc[h].bcol[0] = cc[h].col;
      cc[h].bcol[1] = wc[0] * (nd[1] + 1) + wc[1];
    } else {
      cc[h].col = cc[h].bcol[0] = wc[0];
    }
  }
  // plane strides of the cell arrays and of the in-plane beta arrays, and
  // a cell's lo-to-hi face step in those
  int pstride, bpstride[NI], bstep[NI];
  if constexpr (NI == 2) {
    pstride = a.n[1] * a.n[2];
    bpstride[0] = (a.n[1] + 1) * a.n[2];
    bstep[0] = a.n[2];
    bpstride[1] = a.n[1] * (a.n[2] + 1);
    bstep[1] = 1;
  } else {
    pstride = a.n[1];
    bpstride[0] = a.n[1] + 1;
    bstep[0] = 1;
  }
  const int n0 = a.n[0];
  const bool per0 = a.lo[0] == kPeriodic;
  const int i0 = blockIdx.z * a.chunk;
  const int i1 = min(i0 + a.chunk, n0);
  const T b = a.b_dev ? *a.b_dev : a.b_val;
  T bh2[DIM];  // b / dx_d^2
#pragma unroll
  for (int d = 0; d < DIM; ++d) bh2[d] = b * a.inv_h2[d];

  // raw values of a plane, loaded a step ahead: phi, rhs, alpha, then beta
  // lo and hi per dim
  constexpr int NV = 3 + 2 * DIM;
  auto fetch = [&](int i, T (*v)[NV]) {
    const int wp = cell_at(i, n0, per0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = wp * pstride + cc[h].col;
      v[h][0] = a.phi[o];
      v[h][1] = a.rhs[o];
      v[h][2] = a.alpha ? a.alpha[o] : T(0);
      v[h][3] = a.beta[0][o];
      v[h][4] = a.beta[0][o + pstride];
#pragma unroll
      for (int e = 0; e < NI; ++e) {
        const int bo = wp * bpstride[e] + cc[h].bcol[e];
        v[h][5 + 2 * e] = a.beta[e + 1][bo];
        v[h][6 + 2 * e] = a.beta[e + 1][bo + bstep[e]];
      }
    }
  };
  T pf[2][NV];
  fetch(i0 - P, pf);

  // per stage s < P and cell: its output at the plane of this step, of the
  // step before and of the one before that
  T last[P][2], prev[P][2], prev2[P][2];
#pragma unroll
  for (int s = 0; s < P; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h) last[s][h] = prev[s][h] = prev2[s][h] = T(0);
  __syncthreads();

  int si = ((i0 - P) % P + P) % P;  // ring slot of plane i
  for (int i = i0 - P; i < i1 + P; ++i, si = si + 1 == P ? 0 : si + 1) {
    const int rd_buf = NB == 2 ? (i & 1) ^ 1 : 0, wr_buf = NB == 2 ? i & 1 : 0;
#pragma unroll
    for (int s = 0; s < P; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        prev2[s][h] = prev[s][h];
        prev[s][h] = last[s][h];
      }
    // stage 0: plane i, and its weights: S' = (rhs + sum_n w_n phi_n) / diag
    // with the ghosts folded into w (a Dirichlet ghost -2 c + c1 / 3 adds
    // w / 3 to the inward neighbour and 3 w to diag, a Neumann ghost c
    // drops w from both), so a pass sets phi = S' and the residual is
    // (S' - phi) diag
    const bool in0 = per0 || (i >= 0 && i < n0);
    const bool bnd0 = !per0 && (i == 0 || i == n0 - 1);
    T w[2][NW];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool in_i = in0 && cc[h].inside;
      last[0][h] = in_i ? pf[h][0] : T(0);
      T dg = a.alpha ? a.a * pf[h][2] : T(0);
      if (!cc[h].bnd && !bnd0) {
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          w[h][2 * d] = bh2[d] * pf[h][3 + 2 * d];
          w[h][2 * d + 1] = bh2[d] * pf[h][4 + 2 * d];
          dg += w[h][2 * d] + w[h][2 * d + 1];
        }
      } else {
        bool blo[DIM], bhi[DIM];
        blo[0] = !per0 && i == 0;
        bhi[0] = !per0 && i == n0 - 1;
#pragma unroll
        for (int e = 0; e < NI; ++e) {
          blo[e + 1] = cc[h].at_lo[e];
          bhi[e + 1] = cc[h].at_hi[e];
        }
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          const T wl = bh2[d] * pf[h][3 + 2 * d], wh = bh2[d] * pf[h][4 + 2 * d];
          const bool dl = blo[d] && a.lo[d] == kDirichlet, dh = bhi[d] && a.hi[d] == kDirichlet;
          dg += (blo[d] ? (dl ? T(3) * wl : T(0)) : wl) + (bhi[d] ? (dh ? T(3) * wh : T(0)) : wh);
          w[h][2 * d] = (blo[d] ? T(0) : wl) + (dh ? wh * T(1.0 / 3.0) : T(0));
          w[h][2 * d + 1] = (bhi[d] ? T(0) : wh) + (dl ? wl * T(1.0 / 3.0) : T(0));
        }
      }
      if (dg == T(0)) dg = T(1);
      const T rd = reciprocal(dg);
#pragma unroll
      for (int k = 0; k < 2 * DIM; ++k) w[h][k] *= rd;
      w[h][2 * DIM] = (in_i ? pf[h][1] : T(0)) * rd;
      w[h][2 * DIM + 1] = dg;
    }
    if (NB == 2) {
      S[wr_buf * SN + so] = last[0][0];
      S[wr_buf * SN + so + PS] = last[0][1];
    }
    fetch(i + 1, pf);
#pragma unroll
    for (int s = 1; s <= P; ++s) {
      const int p = i - s;
      // stage s feeds the output through planes i0 - (P - s) .. i1 - 1 +
      // (P - s) and rows s .. ROWS - 1 - s; a warp (two rows) outside skips
      if (p < i0 - (P - s) || p > i1 - 1 + (P - s)) continue;
      if (DIM == 3 && (r0 + 1 < s || r0 > ROWS - 1 - s)) continue;
      const int wp = cell_at(p, n0, per0);
      const bool in_p = per0 || (p >= 0 && p < n0);
      const T* ring = R + (si - s < 0 ? si - s + P : si - s) * NW * NC + cid;
      // stage s - 1 on plane p: this thread's cells in registers, their
      // in-plane neighbours in shared memory (written the step before)
      const T* in = S + ((s - 1) * NB + rd_buf) * SN + so;
      const T c0 = prev[s - 1][0], c1 = prev[s - 1][1];
      // S' of cell x (0 or 1, at run time): along dim 1 its neighbours are
      // the other cell and a shared-memory value
      auto eval = [&](int x) {
        const T* rw = ring + x * PS;
        T acc = rw[2 * DIM * NC];
        acc += rw[0] * (x ? prev2[s - 1][1] : prev2[s - 1][0]);
        const T far = in[x ? 2 * PS : -PS];
        acc += rw[2 * NC] * (x ? c0 : far);
        acc += rw[3 * NC] * (x ? far : c1);
        if constexpr (DIM == 3) {
          acc += rw[4 * NC] * in[x * PS - 1];
          acc += rw[5 * NC] * in[x * PS + 1];
        }
        // last, the one term of this step's previous stage: the stages'
        // other terms need no wait and overlap
        return acc + rw[NC] * (x ? last[s - 1][1] : last[s - 1][0]);
      };
      const bool write = p >= i0 && p < i1;
      const int o0 = wp * pstride + cc[0].col, o1 = wp * pstride + cc[1].col;
      if (a.want_resid && s == P) {
        if (write && cc[0].out) a.res[o0] = (eval(0) - c0) * ring[(2 * DIM + 1) * NC];
        if (write && cc[1].out) a.res[o1] = (eval(1) - c1) * ring[(2 * DIM + 1) * NC + PS];
      } else {
        // a colour pass evaluates one of the two cells (both only where an
        // odd periodic extent puts two cells of one colour side by side)
        const int colour = (a.first_colour + s - 1) & 1;
        const bool m0 = ((wp + cc[0].par) & 1) == colour, m1 = ((wp + cc[1].par) & 1) == colour;
        const T acc = eval(m0 ? 0 : 1);
        T n0v = m0 ? acc : c0, n1v = m1 && !m0 ? acc : c1;
        if (m0 && m1) n1v = eval(1);
        n0v = in_p && cc[0].inside ? n0v : T(0);
        n1v = in_p && cc[1].inside ? n1v : T(0);
        if (s < P) {
          last[s][0] = n0v;
          last[s][1] = n1v;
          if (NB == 2) {
            S[(s * NB + wr_buf) * SN + so] = n0v;
            S[(s * NB + wr_buf) * SN + so + PS] = n1v;
          }
        }
        if (s == a.npass && write) {
          if (cc[0].out) a.out[o0] = n0v;
          if (cc[1].out) a.out[o1] = n1v;
        }
      }
    }
    // with one plane per stage, every stage's new plane once all have
    // read the old ones; plane i's weights, for the stages of the next P
    // steps (stage P read plane i - P from this slot above)
    if (NB == 1) {
      __syncthreads();
#pragma unroll
      for (int s = 0; s < P; ++s) {
        S[s * SN + so] = last[s][0];
        S[s * SN + so + PS] = last[s][1];
      }
    }
    T* slot = R + si * NW * NC + cid;
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      slot[k * NC] = w[0][k];
      slot[k * NC + PS] = w[1][k];
    }
    __syncthreads();
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
      n = 132;
  }
  return n;
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <typename T, int DIM, int P>
cudaError_t launch(CellArgs<T> a, cudaStream_t stream) {
  using B = Block<T, DIM, P>;
  a.tile[0] = DIM == 3 ? B::ROWS - 2 * P : B::W - 2 * P;
  a.tile[1] = B::W - 2 * P;
  const int gx = ceil_div(a.n[DIM - 1], a.tile[DIM == 3 ? 1 : 0]);
  const int gy = DIM == 3 ? ceil_div(a.n[1], a.tile[0]) : 1;
  // chunks of dim 0: at most 64 planes, at least 4, and about four blocks
  // per SM in all
  const int n0 = a.n[0];
  int nz = ceil_div(4 * sm_count(), gx * gy);
  nz = nz > ceil_div(n0, 4) ? ceil_div(n0, 4) : nz;
  nz = nz < ceil_div(n0, 64) ? ceil_div(n0, 64) : nz;
  a.chunk = ceil_div(n0, nz < 1 ? 1 : nz);
  const int smem = smem_bytes<T, DIM, P>(double_buffered<T, DIM, P>() ? 2 : 1);
  auto kernel = mg_cell_gsrb_kernel<T, DIM, P>;
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  dim3 grid(gx, gy, ceil_div(n0, a.chunk));
  kernel<<<grid, dim3(B::BX, B::BY), smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DIM>
cudaError_t launch_stages(const CellArgs<T>& a, int stages, cudaStream_t st) {
  switch (stages) {
    case 1: return launch<T, DIM, 1>(a, st);
    case 2: return launch<T, DIM, 2>(a, st);
    case 3: return launch<T, DIM, 3>(a, st);
    case 4: return launch<T, DIM, 4>(a, st);
    case 5: return launch<T, DIM, 5>(a, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int DIM>
int mg_cell_gsrb_impl(const int* n, int npasses, int first_colour, int want_resid,
                      const void* phi, void* out, void* tmp, const void* rhs, const void* alpha,
                      double aval, const void* b_dev, double b, const void* const* beta,
                      const double* inv_h2, const int* lo, const int* hi, void* res,
                      cudaStream_t stream) {
  CellArgs<T> a{};
  a.rhs = static_cast<const T*>(rhs);
  a.alpha = static_cast<const T*>(alpha);
  a.b_dev = static_cast<const T*>(b_dev);
  a.res = static_cast<T*>(res);
  a.a = T(aval);
  a.b_val = T(b);
  long long total = 1;
  for (int d = 0; d < 3; ++d) {
    a.n[d] = d < DIM ? n[d] : 1;
    total *= a.n[d] + 1;
    a.inv_h2[d] = T(d < DIM ? inv_h2[d] : 1.0);
    a.beta[d] = d < DIM ? static_cast<const T*>(beta[d]) : nullptr;
    a.lo[d] = d < DIM ? lo[d] : kPeriodic;
    a.hi[d] = d < DIM ? hi[d] : kPeriodic;
  }
  if (total >= (1LL << 31)) return (int)cudaErrorInvalidValue;  // 32-bit offsets
  // up to kMaxStages stages a launch: more passes chain launches,
  // ping-ponging out and tmp so the last pass lands in out; the residual
  // rides on the last pass launch when it has room
  const int nl = ceil_div(npasses, kMaxStages);
  const T* src = static_cast<const T*>(phi);
  for (int l = 0; l < nl; ++l) {
    a.npass = npasses - l * kMaxStages < kMaxStages ? npasses - l * kMaxStages : kMaxStages;
    a.first_colour = (first_colour + l * kMaxStages) & 1;
    a.want_resid = want_resid && l == nl - 1 && a.npass < kMaxStages;
    a.phi = src;
    a.out = static_cast<T*>((nl - 1 - l) % 2 == 0 ? out : tmp);
    cudaError_t err = launch_stages<T, DIM>(a, a.npass + a.want_resid, stream);
    if (err != cudaSuccess) return (int)err;
    src = a.out;
  }
  if (want_resid && (nl == 0 || !a.want_resid)) {
    a.npass = 0;
    a.want_resid = 1;
    a.phi = src;
    cudaError_t err = launch_stages<T, DIM>(a, 1, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dim(int dim, const int* n, int npasses, int first_colour, int want_resid,
                 const void* phi, void* out, void* tmp, const void* rhs, const void* alpha,
                 double a, const void* b_dev, double b, const void* const* beta,
                 const double* inv_h2, const int* lo, const int* hi, void* res, cudaStream_t st) {
  if (dim == 3)
    return mg_cell_gsrb_impl<T, 3>(n, npasses, first_colour, want_resid, phi, out, tmp, rhs,
                                   alpha, a, b_dev, b, beta, inv_h2, lo, hi, res, st);
  return mg_cell_gsrb_impl<T, 2>(n, npasses, first_colour, want_resid, phi, out, tmp, rhs,
                                 alpha, a, b_dev, b, beta, inv_h2, lo, hi, res, st);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 float64. n: dim ints. npasses colour passes from
// phi, starting with first_colour and alternating, the last landing in out;
// then the residual into res when want_resid. One launch for up to 5
// stages (passes + residual); more chain launches through tmp (null when
// at most one launch makes passes). alpha: null when a == 0. b: b_dev
// (device scalar of the dtype) when not null, else the double b. beta: dim
// device pointers; inv_h2: dim doubles 1 / dx^2; lo/hi: dim BC kinds.
// Returns cudaGetLastError().
int mg_cell_gsrb(int dtype, int dim, const int* n, int npasses, int first_colour,
                 int want_resid, const void* phi, void* out, void* tmp, const void* rhs,
                 const void* alpha, double a, const void* b_dev, double b,
                 const void* const* beta, const double* inv_h2, const int* lo, const int* hi,
                 void* res, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dim != 2 && dim != 3) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_dim<float>(dim, n, npasses, first_colour, want_resid, phi, out, tmp, rhs,
                               alpha, a, b_dev, b, beta, inv_h2, lo, hi, res, st);
  if (dtype == 1)
    return dispatch_dim<double>(dim, n, npasses, first_colour, want_resid, phi, out, tmp, rhs,
                                alpha, a, b_dev, b, beta, inv_h2, lo, hi, res, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
