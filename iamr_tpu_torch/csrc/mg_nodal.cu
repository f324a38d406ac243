// Weighted Jacobi on the sigma-weighted FEM nodal Laplacian for Hopper
// (sm_90a), bound to PyTorch through a plain C interface (ctypes; see
// iamr_tpu_torch/native.py and the wrapper ops/mg_kernels.py::nodal_jacobi).
//
// Which TPU kernels this replaces
//   mg_nodal_jacobi <- iamr_tpu/ops/pallas_mg.py::nodal_sweep (K6:
//                      _nodal_kernel; one sweep phi + upd (rhs - L phi), or
//                      the masked residual with update=False)
//                   <- iamr_tpu/ops/pallas_fused.py::nodal_smooth_fused (K7:
//                      _nodal_core; nsweeps sweeps plus the residual, omega *
//                      mask / diag formed in the kernel)
//                   <- iamr_tpu/ops/pallas_fused.py::nodal_smooth_sr (K8:
//                      _nodal_sr_kernel; the same with upd and mask given as
//                      arrays)
//
// L(phi)_n = -(1/V) sum over the cells c around node n of sigma_c (K
// phi_c)[corner of n in c], K the element matrix of
// ops/mg_nodal.py::_fem_element_matrix. K = sum_d S_d (x) prod M_e with
// every 2x2 factor of the form [[p, q], [q, p]], so K[a][b] depends on a
// xor b only and is diagonal in the Walsh-Hadamard basis of the cell's
// 2^dim corners: K = H diag(lambda) H / 2^dim (H_wa = (-1)^popcount(w & a),
// corners and w numbered with dim 0 the most significant bit). The host
// passes coef_w = -lambda_w / (2^dim V) in double (ops/mg_kernels.py::
// nodal_coefs); the kernel rounds them to its type. Per cell: psi = H phi_c
// (dim x 2^dim adds, shared between the planes of a column), z = sigma_c
// coef (x) psi (2 x 2^dim multiplies), y = H z (dim x 2^dim adds), and each
// node sums the y of its 2^dim cells: about 60 operations a node, where
// forming the 27 stencil coefficients per node took about 210.
//
// mask and diag are formed here, as _nodal_core does: mask = 0 on the nodes
// of Dirichlet (outflow) sides (ops/mg_nodal.py::_dirichlet_mask), diag =
// -(sum of the adjacent sigma) kap, pinned to -kap where that sum is 0
// (ops/mg_nodal.py::nodal_diag; the sum in the same order). With upd given
// (K8) the update is phi + upd r and the residual mask * r with the given
// mask. Ghosts follow _pad_nodes / _pad_cells: periodic dims wrap with the
// duplicated-DOF convention (node -1 is nn-2, node nn is 1; cell -1 is
// nn-2, cell nn-1 is 0); other sides have phi = 0 outside and sigma = 0
// outside. Both copies of a periodic dim's duplicated node (node 0 and node
// nn - 1) are updated from their own values, as mg_nodal._jacobi does, and
// a solve does leave them apart: by roundoff in a residual, and by more
// where the right-hand side itself differs (a hydrostatic outflow strip
// across a periodic dim). A tile's or a chunk's halo that crosses the seam
// can stand for only one of the two copies, so past the first stage its
// values would be those of another lattice: with a periodic dim, each
// launch runs one stage and reads the stored values (more stages chain
// launches); without one, up to kMaxStages stages share a launch.
//
// Design: one launch per call (without a periodic dim), reading phi,
// sigma and rhs (and upd, mask) once. A block owns a (dim 1, dim 2) column tile of BY x BX nodes (32 x
// 32 up to 3 stages f32, else 16 x 32; 2D: 128 nodes of dim 1), one thread
// a column, and marches along dim 0; the stages (the sweeps, then the
// residual) run as a pipeline behind the march, stage s on plane i - s
// when plane i is loaded, so a block covers its output tile with a halo
// of P = nsweeps + want_resid columns per side and P planes per chunk of
// dim 0. When a plane is loaded the thread forms its node's upd (omega
// mask / diag, the adjacent sigma summed through shared memory) and keeps
// sigma, rhs, upd and mask in a shared-memory ring for the P stages. Per
// step and stage it forms the in-plane Hadamard transform of its cell's
// upper plane from the shared phi plane of the previous stage (the lower
// plane's is kept in registers), finishes its cell, and hands its
// 2^(dim-1) corner sums to the nodes through shared memory: 2P + 1
// barriers a step. Redundant work at P = 3: 32 x 32 columns computed for
// 26 x 26 written (1.5x), and 2P planes per chunk of dim 0.
//
// Bound at 257^3 nodes f32, 2 sweeps + residual: phi, sigma and rhs read
// once, out and res written once, 5 x 68 MB = 0.34 GB, 0.10 ms at 3.35
// TB/s; the factored form's ~60 operations a node and stage, 3 stages,
// 3.1 Gop, 0.05 ms at 67 TFLOP/s. So bytes bound it. What keeps the kernel
// from it: the barriers of the stage chain (two a stage, with one block
// of 32 warps an SM) and the halo work. Left for later: lagging the
// stages by two planes so that a step needs one barrier, and a
// 4-sweep tile that keeps 1024 threads.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxStages = 4;  // sweeps + residual in one launch

template <typename T>
struct NodalArgs {
  const T* phi;
  T* out;            // the last sweep's output (no sweep: unused)
  T* res;            // mask * (rhs - L phi) after the sweeps, or null
  const T* sigma;    // cells, nn - 1 per dim
  const T* rhs;
  const T* upd;      // null: omega * mask / diag formed here
  const T* mask;     // with upd
  T coef[8];         // -lambda_w / (2^dim V), rounded by the host
  T kap, omega;
  int nn[3];         // nodes per dim
  int per[3];        // 1 on periodic dims
  int dlo[3], dhi[3];  // 1 on Dirichlet sides
  int nsweeps, want_resid;
  int tile[2];       // output columns of a block per in-plane dim
  int chunk;         // output planes of a block along dim 0
};

// threads of a block: BX along the last dim, BY along dim 1 (3D); the
// tallest tile the registers allow at 1024 threads
template <typename T, int DIM, int P>
struct Block {
  static constexpr int BX = DIM == 3 ? 32 : 128;
  static constexpr int BY = DIM == 3 ? (sizeof(T) == 4 && P <= 3 ? 32 : 16) : 1;
};

// node index g of a dim of n nodes as stored: periodic wraps with period
// n - 1 outside [0, n); a non-periodic index is clamped (the caller zeroes
// what lies outside)
__device__ __forceinline__ int node_at(int g, int n, bool per) {
  if (g >= 0 && g < n) return g;
  if (!per) return g < 0 ? 0 : n - 1;
  const int m = n - 1;
  const int r = g % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ int cell_at(int g, int nc, bool per) {
  if (per) {
    const int r = g % nc;
    return r < 0 ? r + nc : r;
  }
  return g < 0 ? 0 : (g >= nc ? nc - 1 : g);
}

// shared-plane offset of in-plane corner m (bit NI - 1 - e: in-plane dim e)
template <int NI, int SX>
__device__ __forceinline__ int corner_off(int m) {
  return NI == 2 ? ((m >> 1) & 1) * SX + (m & 1) : (m & 1);
}

// 1 / x, correctly rounded
__device__ __forceinline__ float reciprocal(float x) { return __frcp_rn(x); }
__device__ __forceinline__ double reciprocal(double x) { return __drcp_rn(x); }

// in-place Walsh-Hadamard transform of N values
template <typename T, int N>
__device__ __forceinline__ void wht(T* v) {
#pragma unroll
  for (int h = 1; h < N; h <<= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (!(i & h)) {
        const T x = v[i], y = v[i | h];
        v[i] = x + y;
        v[i | h] = x - y;
      }
    }
  }
}

// per plane and column, what the stages read of it: sigma of the cell
// plane, rhs, upd and mask of the node plane
constexpr int kRing = 4;

template <typename T, int DIM, int P>
__global__ void __launch_bounds__(Block<T, DIM, P>::BX * Block<T, DIM, P>::BY)
mg_nodal_jacobi_kernel(const NodalArgs<T> a) {
  constexpr int NI = DIM - 1;      // in-plane dims
  constexpr int NC2 = 1 << NI;     // in-plane corners
  constexpr int BX = Block<T, DIM, P>::BX, BY = Block<T, DIM, P>::BY, NT = BX * BY;
  constexpr int SX = BX + 2;       // shared planes: one pad column / row per side
  constexpr int SN = (BY + 2) * SX;
  extern __shared__ __align__(16) unsigned char smem[];
  T* F = reinterpret_cast<T*>(smem);  // the phi plane the next stage reads
  T* Q = F + SN;                      // [NC2][SN] per column, its cells' sums to its corners
  T* U = Q + NC2 * SN;                // per column, sigma of its two cells at the node plane
  T* R = U + SN;                      // [P][kRing][NT] own-column ring of plane values

  const int tx = threadIdx.x, ty = NI == 2 ? threadIdx.y : 0;
  const int so = (ty + 1) * SX + tx + 1;
  const int tid = ty * BX + tx;
  for (int k = tid; k < (2 + NC2) * SN + P * kRing * NT; k += NT) F[k] = T(0);  // pads stay 0

  // this thread's node column (and the cell column above it) per in-plane dim
  bool node_in = true, cell_in = true, out_in = true, dir_in = false;
  int colN = 0, colC = 0, NP = 1, CP = 1;
#pragma unroll
  for (int e = 0; e < NI; ++e) {
    const int d = e + 1, n = a.nn[d];
    const bool per = a.per[d] != 0;
    const int t = e == NI - 1 ? tx : ty;
    const int bt = e == NI - 1 ? blockIdx.x : blockIdx.y;
    const int g = bt * a.tile[e] - P + t;
    node_in = node_in && (per || (g >= 0 && g < n));
    cell_in = cell_in && (per || (g >= 0 && g < n - 1));
    out_in = out_in && t >= P && t < P + a.tile[e] && g < n;
    dir_in = dir_in || (!per && ((g == 0 && a.dlo[d]) || (g == n - 1 && a.dhi[d])));
    colN = colN * n + node_at(g, n, per);
    NP *= n;
    colC = colC * (n - 1) + cell_at(g, n - 1, per);
    CP *= n - 1;
  }
  const int n0 = a.nn[0];
  const bool per0 = a.per[0] != 0;
  const int i0 = blockIdx.z * a.chunk;
  const int i1 = min(i0 + a.chunk, n0);
  const bool given = a.upd != nullptr;

  // raw values of the next plane, loaded a step ahead
  auto fetch = [&](int i, T* v) {
    const int on = node_at(i, n0, per0) * NP + colN;
    v[0] = a.phi[on];
    v[1] = a.sigma[cell_at(i, n0 - 1, per0) * CP + colC];
    v[2] = a.rhs[on];
    if (given) {
      v[3] = a.upd[on];
      v[4] = a.mask[on];
    }
  };
  T pf[5] = {T(0), T(0), T(0), T(0), T(0)};
  fetch(i0 - P, pf);

  // per stage s (index s - 1): the in-plane transform of node plane p and
  // the lower cell's half of the corner sums (cell plane p - 1)
  T hold[P][NC2], zp[P][NC2];
  // per stage s < P (index s): its output on this thread's column at the
  // plane of this step and of the step before
  T last[P], prev[P];
  T sig_prev = T(0);
#pragma unroll
  for (int s = 0; s < P; ++s) {
    last[s] = prev[s] = T(0);
#pragma unroll
    for (int m = 0; m < NC2; ++m) hold[s][m] = zp[s][m] = T(0);
  }
  __syncthreads();

  int si = ((i0 - P) % P + P) % P;  // ring slot of plane i
  for (int i = i0 - P; i < i1 + P; ++i, si = si + 1 == P ? 0 : si + 1) {
#pragma unroll
    for (int s = 0; s < P; ++s) prev[s] = last[s];
    // stage 0: node plane i and cell plane i
    const bool ex_i = node_in && (per0 || (i >= 0 && i < n0));
    const T sig_i = cell_in && (per0 || (i >= 0 && i < n0 - 1)) ? pf[1] : T(0);
    last[0] = ex_i ? pf[0] : T(0);
    F[so] = last[0];
    U[so] = sig_i + sig_prev;  // _adjacent_cell_sum's order: dim 0 first
    sig_prev = sig_i;
    const T rhs_i = ex_i ? pf[2] : T(0);
    T upd_i = given && ex_i ? pf[3] : T(0), mask_i = given && ex_i ? pf[4] : T(0);
    fetch(i + 1, pf);
    __syncthreads();
    if (!given) {  // omega * mask / diag of node plane i
      T adj;
      if constexpr (NI == 2)
        adj = (U[so] + U[so - SX]) + (U[so - 1] + U[so - SX - 1]);
      else
        adj = U[so] + U[so - 1];
      T dg = -adj * a.kap;
      if (dg == T(0)) dg = -a.kap;
      const bool dir = dir_in || (!per0 && ((i == 0 && a.dlo[0]) || (i == n0 - 1 && a.dhi[0])));
      mask_i = dir ? T(0) : T(1);
      upd_i = (a.omega * mask_i) * reciprocal(dg);
    }
#pragma unroll
    for (int s = 1; s <= P; ++s) {
      const int p = i - s;
      const T* ring = R + (si - s < 0 ? si - s + P : si - s) * kRing * NT + tid;
      // cell plane p from node planes p (hold) and p + 1 (F: stage s - 1)
      T h[NC2];
#pragma unroll
      for (int m = 0; m < NC2; ++m) h[m] = F[so + corner_off<NI, SX>(m)];
      wht<T, NC2>(h);
      const T sig = ring[0];
      T q[NC2];
#pragma unroll
      for (int m = 0; m < NC2; ++m) {
        const T z0 = a.coef[m] * (hold[s - 1][m] + h[m]);        // w0 = 0
        const T z1 = a.coef[NC2 + m] * (hold[s - 1][m] - h[m]);  // w0 = 1
        q[m] = zp[s - 1][m] + sig * (z0 + z1);  // corner a0 = 0 of cell p
        zp[s - 1][m] = sig * (z0 - z1);          // a0 = 1, for node plane p + 1
        hold[s - 1][m] = h[m];
      }
      wht<T, NC2>(q);
#pragma unroll
      for (int m = 0; m < NC2; ++m) Q[m * SN + so] = q[m];
      __syncthreads();

      // node plane p: gather the corner sums of the 2^(dim-1) columns
      T lphi = T(0);
#pragma unroll
      for (int m = 0; m < NC2; ++m) lphi += Q[m * SN + so - corner_off<NI, SX>(m)];
      const T r = ring[NT] - lphi;
      const bool write = out_in && p >= i0 && p < i1;
      const int o = node_at(p, n0, per0) * NP + colN;
      if (a.want_resid && s == P) {
        if (write) a.res[o] = ring[3 * NT] * r;
      } else {
        const bool ex = node_in && (per0 || (p >= 0 && p < n0));
        const T nv = ex ? prev[s - 1] + ring[2 * NT] * r : T(0);
        if (s < P) {
          last[s] = nv;
          F[so] = nv;
        }
        if (s == a.nsweeps && write) a.out[o] = nv;
      }
      if (s < P) __syncthreads();
    }
    // plane i's values, for the stages of the next P steps (stage P read
    // plane i - P from this slot above)
    T* slot = R + si * kRing * NT + tid;
    slot[0] = sig_i;
    slot[NT] = rhs_i;
    slot[2 * NT] = upd_i;
    slot[3 * NT] = mask_i;
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
cudaError_t launch(NodalArgs<T> a, cudaStream_t stream) {
  constexpr int BX = Block<T, DIM, P>::BX, BY = Block<T, DIM, P>::BY;
  a.tile[0] = DIM == 3 ? BY - 2 * P : BX - 2 * P;
  a.tile[1] = BX - 2 * P;
  const int gx = ceil_div(a.nn[DIM - 1], a.tile[DIM == 3 ? 1 : 0]);
  const int gy = DIM == 3 ? ceil_div(a.nn[1], a.tile[0]) : 1;
  // chunks of dim 0: at most 64 planes, at least 4, and about four blocks
  // per SM in all
  const int n0 = a.nn[0];
  int nz = ceil_div(4 * sm_count(), gx * gy);
  nz = nz > ceil_div(n0, 4) ? ceil_div(n0, 4) : nz;
  nz = nz < ceil_div(n0, 64) ? ceil_div(n0, 64) : nz;
  a.chunk = ceil_div(n0, nz < 1 ? 1 : nz);
  constexpr int NC2 = 1 << (DIM - 1);
  const int smem = ((2 + NC2) * (BY + 2) * (BX + 2) + P * kRing * BX * BY) * (int)sizeof(T);
  auto kernel = mg_nodal_jacobi_kernel<T, DIM, P>;
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  dim3 grid(gx, gy, ceil_div(n0, a.chunk));
  kernel<<<grid, dim3(BX, BY), smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DIM>
cudaError_t launch_stages(const NodalArgs<T>& a, int stages, cudaStream_t st) {
  switch (stages) {
    case 1: return launch<T, DIM, 1>(a, st);
    case 2: return launch<T, DIM, 2>(a, st);
    case 3: return launch<T, DIM, 3>(a, st);
    case 4: return launch<T, DIM, 4>(a, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int DIM>
int mg_nodal_jacobi_impl(const int* nn, int nsweeps, int want_resid, const void* phi, void* out,
                         void* tmp, const void* sigma, const void* rhs, const void* upd,
                         const void* mask, double omega, const double* coef, double kap,
                         const int* per, const int* dlo, const int* dhi, void* res,
                         cudaStream_t stream) {
  NodalArgs<T> a{};
  a.sigma = static_cast<const T*>(sigma);
  a.rhs = static_cast<const T*>(rhs);
  a.upd = static_cast<const T*>(upd);
  a.mask = static_cast<const T*>(mask);
  a.omega = T(omega);
  a.kap = T(kap);
  for (int w = 0; w < 8; ++w) a.coef[w] = T(w < (1 << DIM) ? coef[w] : 0.0);
  long long total = 1;
  for (int d = 0; d < 3; ++d) {
    a.nn[d] = d < DIM ? nn[d] : 1;
    a.per[d] = d < DIM ? per[d] : 0;
    a.dlo[d] = d < DIM ? dlo[d] : 0;
    a.dhi[d] = d < DIM ? dhi[d] : 0;
    total *= a.nn[d];
  }
  if (total >= (1LL << 31)) return (int)cudaErrorInvalidValue;  // 32-bit offsets
  // up to kMaxStages stages a launch (one with a periodic dim): more
  // sweeps chain launches, ping-ponging out and tmp so the last sweep lands
  // in out; the residual rides on the last sweep launch when it has room
  a.res = static_cast<T*>(res);
  const int ms = a.per[0] || a.per[1] || a.per[2] ? 1 : kMaxStages;
  const int nl = ceil_div(nsweeps, ms);
  const T* src = static_cast<const T*>(phi);
  for (int l = 0; l < nl; ++l) {
    a.nsweeps = nsweeps - l * ms < ms ? nsweeps - l * ms : ms;
    a.want_resid = want_resid && l == nl - 1 && a.nsweeps < ms;
    a.phi = src;
    a.out = static_cast<T*>((nl - 1 - l) % 2 == 0 ? out : tmp);
    cudaError_t err = launch_stages<T, DIM>(a, a.nsweeps + a.want_resid, stream);
    if (err != cudaSuccess) return (int)err;
    src = a.out;
  }
  if (want_resid && (nl == 0 || !a.want_resid)) {
    a.nsweeps = 0;
    a.want_resid = 1;
    a.phi = src;
    cudaError_t err = launch_stages<T, DIM>(a, 1, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dim(int dim, const int* nn, int nsweeps, int want_resid, const void* phi, void* out,
                 void* tmp, const void* sigma, const void* rhs, const void* upd,
                 const void* mask, double omega, const double* coef, double kap,
                 const int* per, const int* dlo, const int* dhi, void* res, cudaStream_t st) {
  if (dim == 3)
    return mg_nodal_jacobi_impl<T, 3>(nn, nsweeps, want_resid, phi, out, tmp, sigma, rhs, upd,
                                      mask, omega, coef, kap, per, dlo, dhi, res, st);
  return mg_nodal_jacobi_impl<T, 2>(nn, nsweeps, want_resid, phi, out, tmp, sigma, rhs, upd,
                                    mask, omega, coef, kap, per, dlo, dhi, res, st);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 float64. nn: dim ints (nodes per dim). nsweeps
// sweeps from phi, the last landing in out, then mask * (rhs - L phi) into
// res when want_resid; one launch for up to 4 stages (sweeps + residual;
// 1 with a periodic dim), more chain launches through tmp (null when at
// most one launch sweeps).
// upd and mask: null for omega * mask / diag formed here. coef: 2^dim
// doubles -lambda_w / (2^dim V); kap: sum_d 1 / (3^(dim-1) dx_d^2); per,
// dlo, dhi: dim ints, 1 on periodic dims / Dirichlet sides. Returns
// cudaGetLastError().
int mg_nodal_jacobi(int dtype, int dim, const int* nn, int nsweeps, int want_resid,
                    const void* phi, void* out, void* tmp, const void* sigma, const void* rhs,
                    const void* upd, const void* mask, double omega, const double* coef,
                    double kap, const int* per, const int* dlo, const int* dhi, void* res,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dim != 2 && dim != 3) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_dim<float>(dim, nn, nsweeps, want_resid, phi, out, tmp, sigma, rhs, upd,
                               mask, omega, coef, kap, per, dlo, dhi, res, st);
  if (dtype == 1)
    return dispatch_dim<double>(dim, nn, nsweeps, want_resid, phi, out, tmp, sigma, rhs, upd,
                                mask, omega, coef, kap, per, dlo, dhi, res, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
