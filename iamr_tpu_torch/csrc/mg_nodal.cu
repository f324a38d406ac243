// Weighted Jacobi on the sigma-weighted FEM nodal Laplacian for Hopper
// (sm_90a), bound to PyTorch through a plain C interface (ctypes; see
// iamr_tpu_torch/native.py and the wrapper ops/mg_kernels.py::nodal_jacobi).
//
// Which TPU kernels this replaces
//   mg_nodal_jacobi <- iamr_tpu/ops/pallas_mg.py::nodal_sweep (K6:
//                      _nodal_kernel; one sweep phi + upd (rhs - L phi), or
//                      the masked residual with update=False)
//                   <- iamr_tpu/ops/pallas_fused.py::nodal_smooth_fused (K7:
//                      _nodal_core via _nodal_whole_kernel /
//                      _nodal_slab_kernel; nsweeps sweeps plus the residual,
//                      omega * mask / diag formed in the kernel)
//                   <- iamr_tpu/ops/pallas_fused.py::nodal_smooth_sr (K8:
//                      _nodal_sr_kernel; the same with upd and mask given as
//                      arrays)
//
// L(phi)_n = -(1/V) sum over neighbour offsets o in {-1,0,1}^dim of
// coef_o phi_{n+o}, coef_o = sum of sigma(cell) K[a][b] over the cells
// adjacent to both nodes (27-point 3D, 9-point 2D), K the element stiffness
// table of ops/mg_nodal.py::_fem_element_matrix, passed in as kernel
// arguments. The sums run in the plain path's order (apply_nodal: per o the
// coef sum, then out -= coef phi_o / V, the division a reciprocal multiply
// as PyTorch makes it on the card, the reciprocal formed in double by the
// host and rounded to the kernel's type), so with -fmad=false the kernel
// equals its plain version bit for bit. Ghosts follow _pad_nodes / _pad_cells:
// periodic dims wrap with the duplicated-DOF convention (node -1 is nn-2,
// node nn is 1; cell -1 is n-1, cell n is 0); other sides have phi = 0
// ghosts and sigma = 0 outside (the zero still enters the sums, as it does
// in the plain path).
//
// Modes: a sweep writes phi + omega * mask * r / diag (or phi + upd * r when
// upd is given) out of place, the host ping-ponging two buffers so the last
// sweep lands in `out`; the residual writes mask * r. One launch per sweep
// and one for the residual, on the caller's stream.
//
// Design: one thread per node, the dimension a template parameter so the 27
// (9) offsets and the corner products unroll at compile time. Each thread
// forms the wrapped index of its neighbours once per dim, loads the sigma
// of its 2^dim adjacent cells once (every cell adjacent to both n and n+o
// is one of them) and the 27 phi values; the grid is (last dim in blocks,
// second-to-last, first), so no thread divides an index.
//
// Bound: a sweep at 257^3 nodes f32 reads phi, sigma, rhs, mask and diag
// and writes phi: ~68 MB a stream, ~0.12 ms at 3.35 TB/s; its ~210
// operations per node (64 sigma * K products and sums, 27 coefficient
// products) take about as long at the f32 rate. Left on the table:
// shared-memory tiles of phi and sigma (each value is read by 27 / 8
// threads through L1), the coefficients formed once per cell instead of
// per node and neighbour, and several sweeps per launch on a tile with a
// halo.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxBlock = 128;

template <typename T>
struct NodalArgs {
  const T* src;      // phi read by the launch
  T* dst;            // sweep output
  const T* sigma;    // cells, nn - 1 per dim
  const T* rhs;
  const T* upd;      // null: omega * mask / diag
  const T* mask;
  const T* diag;
  T* res;
  T K[64];           // K[a * 2^dim + b]
  double omega, inv_vol;  // inv_vol: 1 / cell volume, in double
  int nn[3];         // nodes per dim
  int per[3];        // 1 on periodic dims
};

// row-major offset of index x in an array of extents n
template <int DIM>
__device__ __forceinline__ long long lin(const int* n, const int* x) {
  long long o = x[0];
#pragma unroll
  for (int d = 1; d < DIM; ++d) o = o * n[d] + x[d];
  return o;
}

template <typename T, int DIM, bool SWEEP>
__global__ void nodal_kernel(NodalArgs<T> a) {
  int x[DIM];
  x[DIM - 1] = blockIdx.x * blockDim.x + threadIdx.x;
  if (x[DIM - 1] >= a.nn[DIM - 1]) return;
  x[DIM - 2] = blockIdx.y;
  if constexpr (DIM == 3) x[0] = blockIdx.z;

  // per dim: the node indices of x-1, x, x+1 and the cell indices of x-1, x
  // after the wrap (-1: outside a non-periodic side)
  int nidx[DIM][3], cidx[DIM][2], nc[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    const int n = a.nn[d], xd = x[d];
    const bool per = a.per[d] != 0;
    nc[d] = n - 1;
    nidx[d][0] = xd > 0 ? xd - 1 : (per ? n - 2 : -1);
    nidx[d][1] = xd;
    nidx[d][2] = xd + 1 < n ? xd + 1 : (per ? 1 : -1);
    cidx[d][0] = xd > 0 ? xd - 1 : (per ? n - 2 : -1);
    cidx[d][1] = xd < n - 1 ? xd : (per ? 0 : -1);
  }

  // sigma of the adjacent cells x - 1 + t, t's bits with dim 0 the most
  // significant
  constexpr int NC = 1 << DIM;
  T sig[NC];
#pragma unroll
  for (int t = 0; t < NC; ++t) {
    int c[DIM];
    bool inside = true;
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      c[d] = cidx[d][(t >> (DIM - 1 - d)) & 1];
      inside = inside && c[d] >= 0;
    }
    sig[t] = inside ? a.sigma[lin<DIM>(nc, c)] : T(0);
  }

  const T inv_vol = T(a.inv_vol);
  T out = T(0);
  constexpr int NOFF = DIM == 3 ? 27 : 9;
#pragma unroll
  for (int s = 0; s < NOFF; ++s) {
    // offsets in itertools.product((-1, 0, 1), repeat=dim) order
    int off[DIM];
    int rem = s;
#pragma unroll
    for (int d = DIM - 1; d >= 0; --d) {
      off[d] = rem % 3 - 1;
      rem /= 3;
    }
    int q[DIM];
    bool inside = true;
    int nz = 0;
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      q[d] = nidx[d][off[d] + 1];
      inside = inside && q[d] >= 0;
      nz += off[d] == 0;
    }
    const T phi_o = inside ? a.src[lin<DIM>(a.nn, q)] : T(0);
    T coef = T(0);
#pragma unroll
    for (int m = 0; m < (1 << nz); ++m) {
      // cells adjacent to both nodes: per dim (t, a_d, b_d) = o=-1: (0,1,0);
      // o=+1: (1,0,1); o=0: (0,1,1) or (1,0,0), the first zero dim's choice
      // varying slowest (itertools.product)
      int zi = 0, t = 0, ai = 0, bi = 0;
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        int td, ad, bd;
        if (off[d] == -1) {
          td = 0; ad = 1; bd = 0;
        } else if (off[d] == 1) {
          td = 1; ad = 0; bd = 1;
        } else {
          const int bit = (m >> (nz - 1 - zi)) & 1;
          ++zi;
          td = bit; ad = 1 - bit; bd = 1 - bit;
        }
        t = 2 * t + td;
        ai = 2 * ai + ad;
        bi = 2 * bi + bd;
      }
      coef = coef + sig[t] * a.K[ai * NC + bi];
    }
    out = out - (coef * phi_o) * inv_vol;
  }

  const long long o = lin<DIM>(a.nn, x);
  const T r = a.rhs[o] - out;
  if constexpr (SWEEP) {
    if (a.upd)
      a.dst[o] = a.src[o] + a.upd[o] * r;
    else
      a.dst[o] = a.src[o] + ((T(a.omega) * a.mask[o]) * r) / a.diag[o];
  } else {
    a.res[o] = a.mask[o] * r;
  }
}

// threads per block along the last dim: whole warps, at most kMaxBlock,
// spread evenly over the blocks of a row
inline int block_x(int n) {
  const int nblk = (n + kMaxBlock - 1) / kMaxBlock;
  const int per = (n + nblk - 1) / nblk;
  return (per + 31) / 32 * 32;
}

template <typename T, int DIM, bool SWEEP>
cudaError_t launch(const NodalArgs<T>& a, cudaStream_t stream) {
  const int bx = block_x(a.nn[DIM - 1]);
  dim3 grid((a.nn[DIM - 1] + bx - 1) / bx, a.nn[DIM - 2], DIM == 3 ? a.nn[0] : 1);
  nodal_kernel<T, DIM, SWEEP><<<grid, bx, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DIM>
int mg_nodal_jacobi_impl(const int* nn, int nsweeps, const void* phi, void* out, void* tmp,
                         const void* sigma, const void* rhs, const void* upd, const void* mask,
                         const void* diag, double omega, const double* K, double inv_vol,
                         const int* per, void* res, cudaStream_t stream) {
  NodalArgs<T> a;
  a.sigma = static_cast<const T*>(sigma);
  a.rhs = static_cast<const T*>(rhs);
  a.upd = static_cast<const T*>(upd);
  a.mask = static_cast<const T*>(mask);
  a.diag = static_cast<const T*>(diag);
  a.res = static_cast<T*>(res);
  a.omega = omega;
  a.inv_vol = inv_vol;
  for (int i = 0; i < 64; ++i) a.K[i] = T(K[i]);
  for (int d = 0; d < 3; ++d) {
    a.nn[d] = d < DIM ? nn[d] : 1;
    a.per[d] = d < DIM ? per[d] : 0;
  }
  const T* src = static_cast<const T*>(phi);
  for (int s = 0; s < nsweeps; ++s) {
    T* dst = static_cast<T*>((nsweeps - 1 - s) % 2 == 0 ? out : tmp);
    a.src = src;
    a.dst = dst;
    cudaError_t err = launch<T, DIM, true>(a, stream);
    if (err != cudaSuccess) return (int)err;
    src = dst;
  }
  if (res) {
    a.src = src;
    cudaError_t err = launch<T, DIM, false>(a, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dim(int dim, const int* nn, int nsweeps, const void* phi, void* out, void* tmp,
                 const void* sigma, const void* rhs, const void* upd, const void* mask,
                 const void* diag, double omega, const double* K, double inv_vol,
                 const int* per, void* res, cudaStream_t st) {
  if (dim == 3)
    return mg_nodal_jacobi_impl<T, 3>(nn, nsweeps, phi, out, tmp, sigma, rhs, upd, mask, diag,
                                      omega, K, inv_vol, per, res, st);
  return mg_nodal_jacobi_impl<T, 2>(nn, nsweeps, phi, out, tmp, sigma, rhs, upd, mask, diag,
                                    omega, K, inv_vol, per, res, st);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 float64. nn: dim ints (nodes per dim). nsweeps
// sweeps from phi, ping-ponging out and tmp (tmp may be null for one
// sweep) so the last lands in out; then mask * (rhs - L phi) into res when
// res is not null. upd: null for omega * mask / diag. K: 64 doubles
// (K[a * 2^dim + b]); inv_vol: 1 / the cell volume; per: dim ints, 1 on
// periodic dims. Returns cudaGetLastError().
int mg_nodal_jacobi(int dtype, int dim, const int* nn, int nsweeps, const void* phi, void* out,
                    void* tmp, const void* sigma, const void* rhs, const void* upd,
                    const void* mask, const void* diag, double omega, const double* K,
                    double inv_vol, const int* per, void* res, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dim != 2 && dim != 3) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_dim<float>(dim, nn, nsweeps, phi, out, tmp, sigma, rhs, upd, mask, diag,
                               omega, K, inv_vol, per, res, st);
  if (dtype == 1)
    return dispatch_dim<double>(dim, nn, nsweeps, phi, out, tmp, sigma, rhs, upd, mask, diag,
                                omega, K, inv_vol, per, res, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
