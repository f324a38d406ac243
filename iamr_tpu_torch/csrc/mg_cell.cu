// Red-black Gauss-Seidel on the cell-centred ABecLaplacian for Hopper
// (sm_90a), bound to PyTorch through a plain C interface (ctypes; see
// iamr_tpu_torch/native.py and the wrapper ops/mg_kernels.py::cell_smooth).
//
// Which TPU kernels this replaces
//   mg_cell_gsrb <- iamr_tpu/ops/pallas_fused.py::cell_smooth_fused (K4:
//                   _cell_core via _cell_whole_kernel / _cell_slab_kernel;
//                   nsweeps x (red, black) passes plus an optional residual)
//                <- iamr_tpu/ops/pallas_mg.py::cell_sweep (K5:
//                   _cell_kernel_3d / _cell_kernel_2d; one colour, or the
//                   residual with update=False)
//
// Computes, per cell, r = rhs - ((a alpha) phi - b div(beta grad phi)) and
// either phi <- phi + r / diag on the cells of one colour ((i+j+k) % 2 ==
// colour, stencil.checkerboard) or res <- r. The ghost value of a boundary
// neighbour is formed here from the per-side BC kind, with the formulas of
// ops/mg.py::_pad_phi: periodic wrap, Dirichlet -2 c0 + c1/3, Neumann c0.
// The arithmetic follows the plain CUDA path op for op (ops/mg.py::apply_op,
// then phi + mask * r / diag): a, b and the Dirichlet weights are rounded
// to the kernel's type first, and the division by dx^2 is the reciprocal
// multiply PyTorch makes of a division by a Python float on the card (the
// reciprocal formed in double by the host, rounded to the kernel's type).
// Built with -fmad=false, so the kernel equals its plain version bit for
// bit.
//
// A colour pass updates phi in place: a cell reads only itself and cells
// of the other colour (for an even periodic extent; the host passes a copy
// to read from when a periodic extent is odd). The host loops the passes
// (nsweeps x (red, black)) and then launches the residual: one launch per
// pass, all on the caller's stream.
//
// Design: one thread per cell updated, the dimension a template parameter
// (the per-dim loops unroll); a colour pass launches threads for the cells
// of its colour only (every other cell along the last dim), and the grid is
// (last dim in blocks, second-to-last, first), so no thread divides an
// index.
//
// Bound: device-memory bytes. A colour pass at 256^3 f32 reads phi, rhs,
// diag and the three face-coefficient arrays (and alpha when a != 0) and
// writes half of phi: 6-7 streams of 67 MB, ~0.13 ms at 3.35 TB/s; one call
// of the V-cycle (2 sweeps + residual) reads each input once at best,
// ~0.16 ms. Left on the table: keeping phi in shared memory across the
// passes of a call (the TPU kernel's fused sweeps read every stream once
// per call, this design once per pass), and the stride-2 access of a colour
// pass, which fetches the other colour's sectors too.

#include <cuda_runtime.h>

namespace {

constexpr int kPeriodic = 0;
constexpr int kDirichlet = 1;
constexpr int kMaxBlock = 128;

template <typename T>
struct CellArgs {
  T* phi;            // updated in place (colour pass)
  const T* src;      // phi as read by the pass (phi, or a copy of it)
  const T* rhs;
  const T* alpha;    // null when a == 0
  const T* beta[3];  // face coefficients, +1 in their dim
  const T* diag;
  const T* b_dev;    // b as a device scalar, or null (then b_val)
  T* res;
  double a, b_val;
  double inv_h2[3];  // 1 / dx_d^2, in double
  int n[3];          // cells per dim
  int colour;
  int lo[3], hi[3];  // BC kinds per side
};

// row-major offset of index x in an array of extents n
template <int DIM>
__device__ __forceinline__ long long lin(const int* n, const int* x) {
  long long o = x[0];
#pragma unroll
  for (int d = 1; d < DIM; ++d) o = o * n[d] + x[d];
  return o;
}

// phi at the neighbour of cell c at offset side (-1 or +1) in d, with the
// homogeneous ghost formula at a domain side
template <typename T, int DIM>
__device__ __forceinline__ T neighbour(const CellArgs<T>& a, const int* c, int d, int side) {
  int q[DIM];
#pragma unroll
  for (int e = 0; e < DIM; ++e) q[e] = c[e];
  const int m = c[d] + side;
  const int nd = a.n[d];
  if (m >= 0 && m < nd) {
    q[d] = m;
    return a.src[lin<DIM>(a.n, q)];
  }
  if (a.lo[d] == kPeriodic) {
    q[d] = side < 0 ? nd - 1 : 0;
    return a.src[lin<DIM>(a.n, q)];
  }
  // c0: the boundary cell itself; c1: the next one inward
  q[d] = side < 0 ? 0 : nd - 1;
  const T c0 = a.src[lin<DIM>(a.n, q)];
  const int kind = side < 0 ? a.lo[d] : a.hi[d];
  if (kind != kDirichlet) return c0;
  q[d] = side < 0 ? 1 : nd - 2;
  const T c1 = a.src[lin<DIM>(a.n, q)];
  return T(-2.0) * c0 + T(1.0 / 3.0) * c1;
}

template <typename T, int DIM>
__device__ __forceinline__ T residual_at(const CellArgs<T>& a, const int* c, long long o) {
  const T ctr = a.src[o];
  const T b = a.b_dev ? *a.b_dev : T(a.b_val);
  T out = a.alpha ? (T(a.a) * a.alpha[o]) * ctr : T(0);
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    int fn[DIM], f[DIM];
#pragma unroll
    for (int e = 0; e < DIM; ++e) {
      fn[e] = a.n[e] + (e == d ? 1 : 0);
      f[e] = c[e];
    }
    const T bl = a.beta[d][lin<DIM>(fn, f)];
    f[d] += 1;
    const T bh = a.beta[d][lin<DIM>(fn, f)];
    const T lo_n = neighbour<T, DIM>(a, c, d, -1);
    const T hi_n = neighbour<T, DIM>(a, c, d, 1);
    const T inv_h2 = T(a.inv_h2[d]);
    const T lap = (bh * (hi_n - ctr) - bl * (ctr - lo_n)) * inv_h2;
    out = out - b * lap;
  }
  return a.rhs[o] - out;
}

// PASS: update the cells of a.colour in place; else the residual of every
// cell into a.res
template <typename T, int DIM, bool PASS>
__global__ void cell_kernel(CellArgs<T> a) {
  int c[DIM];
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  c[DIM - 2] = blockIdx.y;
  if constexpr (DIM == 3) c[0] = blockIdx.z;
  if constexpr (PASS) {
    int s = 0;
#pragma unroll
    for (int d = 0; d < DIM - 1; ++d) s += c[d];
    // the cells of this colour along the last dim: every other one
    c[DIM - 1] = 2 * t + ((a.colour + s) & 1);
  } else {
    c[DIM - 1] = t;
  }
  if (c[DIM - 1] >= a.n[DIM - 1]) return;
  const long long o = lin<DIM>(a.n, c);
  const T r = residual_at<T, DIM>(a, c, o);
  if constexpr (PASS)
    a.phi[o] = a.src[o] + r / a.diag[o];
  else
    a.res[o] = r;
}

// threads per block along the last dim: whole warps, at most kMaxBlock,
// spread evenly over the blocks of a row
inline int block_x(int n) {
  const int nblk = (n + kMaxBlock - 1) / kMaxBlock;
  const int per = (n + nblk - 1) / nblk;
  return (per + 31) / 32 * 32;
}

template <typename T, int DIM, bool PASS>
cudaError_t launch(const CellArgs<T>& a, cudaStream_t stream) {
  const int nx = PASS ? (a.n[DIM - 1] + 1) / 2 : a.n[DIM - 1];
  const int bx = block_x(nx);
  dim3 grid((nx + bx - 1) / bx, a.n[DIM - 2], DIM == 3 ? a.n[0] : 1);
  cell_kernel<T, DIM, PASS><<<grid, bx, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DIM>
int mg_cell_gsrb_impl(const int* n, int npasses, int first_colour, void* phi, void* copy,
                      const void* rhs, const void* alpha, double aval, const void* b_dev,
                      double b, const void* const* beta, const void* diag,
                      const double* inv_h2, const int* lo, const int* hi, void* res,
                      cudaStream_t stream) {
  CellArgs<T> a;
  a.phi = static_cast<T*>(phi);
  a.src = a.phi;
  a.rhs = static_cast<const T*>(rhs);
  a.alpha = static_cast<const T*>(alpha);
  a.diag = static_cast<const T*>(diag);
  a.b_dev = static_cast<const T*>(b_dev);
  a.res = static_cast<T*>(res);
  a.a = aval;
  a.b_val = b;
  a.colour = 0;
  long long total = 1;
  for (int d = 0; d < 3; ++d) {
    a.n[d] = d < DIM ? n[d] : 1;
    a.inv_h2[d] = d < DIM ? inv_h2[d] : 1.0;
    a.beta[d] = d < DIM ? static_cast<const T*>(beta[d]) : nullptr;
    a.lo[d] = d < DIM ? lo[d] : kPeriodic;
    a.hi[d] = d < DIM ? hi[d] : kPeriodic;
    total *= a.n[d];
  }
  for (int p = 0; p < npasses; ++p) {
    if (copy) {
      cudaMemcpyAsync(copy, phi, total * sizeof(T), cudaMemcpyDeviceToDevice, stream);
      a.src = static_cast<const T*>(copy);
    }
    a.colour = (first_colour + p) & 1;
    cudaError_t err = launch<T, DIM, true>(a, stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (res) {
    a.src = a.phi;
    cudaError_t err = launch<T, DIM, false>(a, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dim(int dim, const int* n, int npasses, int first_colour, void* phi, void* copy,
                 const void* rhs, const void* alpha, double a, const void* b_dev, double b,
                 const void* const* beta, const void* diag, const double* inv_h2,
                 const int* lo, const int* hi, void* res, cudaStream_t st) {
  if (dim == 3)
    return mg_cell_gsrb_impl<T, 3>(n, npasses, first_colour, phi, copy, rhs, alpha, a, b_dev,
                                   b, beta, diag, inv_h2, lo, hi, res, st);
  return mg_cell_gsrb_impl<T, 2>(n, npasses, first_colour, phi, copy, rhs, alpha, a, b_dev, b,
                                 beta, diag, inv_h2, lo, hi, res, st);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 float64. n: dim ints. npasses colour passes starting
// with first_colour and alternating, on phi in place (copy: a device buffer
// of phi's size to read from, or null); then the residual into res when res
// is not null. alpha: null when a == 0. b: b_dev (device scalar of the
// dtype) when not null, else the double b. beta: dim device pointers;
// inv_h2: dim doubles 1 / dx^2; lo/hi: dim BC kinds. Returns
// cudaGetLastError().
int mg_cell_gsrb(int dtype, int dim, const int* n, int npasses, int first_colour, void* phi,
                 void* copy, const void* rhs, const void* alpha, double a, const void* b_dev,
                 double b, const void* const* beta, const void* diag, const double* inv_h2,
                 const int* lo, const int* hi, void* res, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dim != 2 && dim != 3) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_dim<float>(dim, n, npasses, first_colour, phi, copy, rhs, alpha, a, b_dev,
                               b, beta, diag, inv_h2, lo, hi, res, st);
  if (dtype == 1)
    return dispatch_dim<double>(dim, n, npasses, first_colour, phi, copy, rhs, alpha, a, b_dev,
                                b, beta, diag, inv_h2, lo, hi, res, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
