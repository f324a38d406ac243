// Godunov-PLM kernels for Hopper (sm_90a), bound to PyTorch through a plain
// C interface (ctypes; see iamr_tpu_torch/native.py).
//
// Which TPU kernels these replace
//   extrap_plm        <- iamr_tpu/ops/pallas_godunov.py::extrap_plm_fused
//                        (_extrap_kernel): PLM ExtrapVelToFaces, the MAC
//                        velocity predictor (before BC face pinning).
//   godunov_plm_multi <- iamr_tpu/ops/pallas_godunov.py::godunov_plm_fused_multi
//                        (_godunov_kernel_multi -> _advect_field_tile), and at
//                        nc = 1 also godunov_plm_fused (_godunov_kernel):
//                        edge states, face fluxes and advective tendency of
//                        every advected field of a step.
//
// Arithmetic: each value is computed with the operation order of the plain
// PyTorch path (iamr_tpu_torch/ops/godunov.py: extrap_vel_to_faces,
// compute_edge_states, compute_fluxes_and_aofs), and the library is built
// with -fmad=false, so the f64 kernels agree with the plain path to roundoff
// and the f32 kernels differ from it only where a thresholded pick
// (_riemann_self / _upwind, sign tests and |speed| < 1e-14) flips on a
// one-ulp difference. The normal-ghost d(umac)/dx of the conservative
// correction uses the plain path's wrap (periodic) or edge-copy index
// arithmetic instead of the TPU kernel's ext_face arrays.
//
// Design (simple first): one thread per output face or cell; blocks tile
// (dim2 contiguous x dim1) and the grid's z runs over dim0. Each entry point
// is split into launches through a global scratch buffer instead of staging
// tiles in shared memory:
//   extrap_plm:        (A) the 9 Riemann-resolved hat states on the faces of
//                      the one-ghost region -> scratch, 3 launches (one per
//                      face direction); (B) the final face velocities with
//                      transverse corrections and 0.5 dt force, 3 launches.
//   godunov_plm_multi: per field, (A) the 3 upwinded hat states -> scratch;
//                      (B) edge states and fluxes into the flux outputs;
//                      (C) the advective tendency from the fluxes.
// Slopes are recomputed from device memory (L1/L2 serve the stencil reuse).
//
// Bound: device-memory bytes. At 256^3 f32 one extrap_plm call moves about
// 9 x 67 MB (velocity + force in, 3 faces out, hat scratch out and in) and
// one godunov_plm_multi call at nc = 5 about 31 x 67 MB, a floor of roughly
// 0.2 ms and 0.6 ms at 3.35 TB/s. These are estimates of the floor, not
// measurements; the scratch round trip of this first design moves more.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef long long i64;

template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return b < a ? b : a; }

template <typename T>
__device__ __forceinline__ T tabs(T a) { return a < T(0) ? -a : a; }

template <typename T>
__device__ __forceinline__ T tsign(T a) {
  return a > T(0) ? T(1) : (a < T(0) ? T(-1) : T(0));
}


// 2nd-order MC limited slope from (lo, c, hi): godunov.slope2
template <typename T>
__device__ __forceinline__ T slope2(T lo, T c, T hi) {
  T dc = T(0.5) * (hi - lo);
  T dl = T(2.0) * (c - lo);
  T dr = T(2.0) * (hi - c);
  T dlim = tmin(tabs(dl), tabs(dr));
  dlim = (dl * dr > T(0)) ? dlim : T(0);
  return tsign(dc) * tmin(tabs(dc), dlim);
}

// 4th-order MC limited slope at q[2] of q[0..4]: godunov.slope4
template <typename T>
__device__ __forceinline__ T slope4(const T* q) {
  T s2lo = slope2(q[0], q[1], q[2]);
  T s2hi = slope2(q[2], q[3], q[4]);
  T c = q[2], lo = q[1], hi = q[3];
  T dc = T((4.0 / 3.0) * 0.5) * (hi - lo) - T(1.0 / 6.0) * (s2hi + s2lo);
  T dl = T(2.0) * (c - lo);
  T dr = T(2.0) * (hi - c);
  T dlim = tmin(tabs(dl), tabs(dr));
  dlim = (dl * dr > T(0)) ? dlim : T(0);
  return tsign(dc) * tmin(tabs(dc), dlim);
}

// Burgers Riemann pick: godunov._riemann_self
template <typename T>
__device__ __forceinline__ T riemann_self(T ul, T ur) {
  T avg = ul + ur;
  T out = (ul > T(0) && avg > T(0)) ? ul : T(0);
  out = (ur < T(0) && avg < T(0)) ? ur : out;
  return out;
}

// thresholded upwind pick: godunov._upwind
template <typename T>
__device__ __forceinline__ T upwind(T sl, T sr, T speed) {
  bool small = tabs(speed) < T(1e-14);
  T out = speed > T(0) ? sl : sr;
  return small ? T(0.5) * (sl + sr) : out;
}

struct Ext3 {
  int a[3];
  __device__ __forceinline__ i64 at(int i, int j, int k) const {
    return ((i64)i * a[1] + j) * a[2] + k;
  }
  __device__ __forceinline__ i64 at(const int* c) const { return at(c[0], c[1], c[2]); }
};

__host__ __device__ inline Ext3 ext3(int a0, int a1, int a2) {
  Ext3 e;
  e.a[0] = a0; e.a[1] = a1; e.a[2] = a2;
  return e;
}

// extent of the hat arrays of face direction d: n_d + 1 in d, n_e + 2 else
__host__ __device__ inline Ext3 hat_ext(int d, const int* n) {
  return ext3(n[0] + (d == 0 ? 1 : 2), n[1] + (d == 1 ? 1 : 2), n[2] + (d == 2 ? 1 : 2));
}

// extent of the face arrays of direction d on the real domain
__host__ __device__ inline Ext3 face_ext(int d, const int* n) {
  return ext3(n[0] + (d == 0), n[1] + (d == 1), n[2] + (d == 2));
}

// rdx: 1 / dx in double. A division by a grid spacing is done as PyTorch's
// CUDA division by a Python scalar does it: multiplication by the
// reciprocal, formed in double and rounded to T (measured on PyTorch 2.11; a
// reciprocal formed in T differs by an ulp for some spacings).
struct Grid {
  int n[3];
  double rdx[3];
};

// the thread's (i0, i1, i2) over extents e; false past the ragged edge
__device__ __forceinline__ bool thread_index(const Ext3& e, int* c) {
  c[2] = blockIdx.x * blockDim.x + threadIdx.x;
  c[1] = blockIdx.y * blockDim.y + threadIdx.y;
  c[0] = blockIdx.z;
  return c[2] < e.a[2] && c[1] < e.a[1] && c[0] < e.a[0];
}

// Limited slopes along d at the two cells of face f of direction d (cells
// f-1 and f; real cell indices, ghosts negative) of a field with 3 ghosts,
// transverse cells from face_cell; qc gets the two cell values.
template <typename T>
__device__ __forceinline__ void lr_slopes(const T* __restrict__ g, const Ext3& ge, int d,
                                          const int* face_cell, T* sl, T* qc) {
  // q at cells f-3 .. f+2 along d
  T q[6];
  int c[3] = {face_cell[0] + 3, face_cell[1] + 3, face_cell[2] + 3};
  c[d] -= 3;
  for (int o = 0; o < 6; ++o) {
    q[o] = g[ge.at(c)];
    c[d] += 1;
  }
  sl[0] = slope4(q);      // cell f-1
  sl[1] = slope4(q + 1);  // cell f
  qc[0] = q[2];
  qc[1] = q[3];
}

// ---------------------------------------------------------------------------
// extrap_plm

template <typename T>
struct ExtrapArgs {
  const T* vel[3];    // (n+6)^3 each
  const T* force[3];  // (n+2)^3 each, or null
  const T* dt;        // device scalar
  T* hv[3];           // hat normal velocity per face direction
  T* hq[3][3];        // hq[e][c]: upwinded component c on e-faces (c != e)
  T* out[3];          // face velocities
  Grid g;
};

// (A) Riemann-resolved hat states on the faces of direction D of the
// one-ghost region (extrap_vel_to_faces: hat, hat_vel, hat_comp)
template <typename T, int D>
__global__ void extrap_hat_kernel(ExtrapArgs<T> a) {
  const int* n = a.g.n;
  Ext3 he = hat_ext(D, n);
  int t[3];
  if (!thread_index(he, t)) return;
  Ext3 ge = ext3(n[0] + 6, n[1] + 6, n[2] + 6);
  // face index in D, transverse cells -1 .. n_e
  int fc[3] = {t[0] - 1, t[1] - 1, t[2] - 1};
  fc[D] = t[D];
  const T dt = *a.dt;
  const T dtdx = dt * T(a.g.rdx[D]);
  T qL[3], qR[3];
  T unL = T(0), unR = T(0);
  {
    T sl[2], qc[2];
    lr_slopes(a.vel[D], ge, D, fc, sl, qc);
    unL = qc[0];
    unR = qc[1];
  }
  T cfl_L = dtdx * (unL > T(0) ? unL : T(0));
  T cfl_R = dtdx * (unR < T(0) ? unR : T(0));
  for (int c = 0; c < 3; ++c) {
    T sl[2], qc[2];
    lr_slopes(a.vel[c], ge, D, fc, sl, qc);
    qL[c] = qc[0] + T(0.5) * (T(1.0) - cfl_L) * sl[0];
    qR[c] = qc[1] - T(0.5) * (T(1.0) + cfl_R) * sl[1];
  }
  T uadv = riemann_self(qL[D], qR[D]);
  i64 o = he.at(t);
  a.hv[D][o] = uadv;
  for (int c = 0; c < 3; ++c) {
    if (c == D) continue;
    a.hq[D][c][o] = upwind(qL[c], qR[c], uadv);
  }
}

// (B) final MAC face velocities of direction D on the real faces
template <typename T, int D>
__global__ void extrap_face_kernel(ExtrapArgs<T> a) {
  const int* n = a.g.n;
  Ext3 fe = face_ext(D, n);
  int t[3];
  if (!thread_index(fe, t)) return;
  Ext3 ge = ext3(n[0] + 6, n[1] + 6, n[2] + 6);
  Ext3 fge = ext3(n[0] + 2, n[1] + 2, n[2] + 2);
  const T dt = *a.dt;
  const T dtdx = dt * T(a.g.rdx[D]);
  T sl[2], qc[2];
  lr_slopes(a.vel[D], ge, D, t, sl, qc);
  T cfl_L = dtdx * (qc[0] > T(0) ? qc[0] : T(0));
  T cfl_R = dtdx * (qc[1] < T(0) ? qc[1] : T(0));
  T uL = qc[0] + T(0.5) * (T(1.0) - cfl_L) * sl[0];
  T uR = qc[1] - T(0.5) * (T(1.0) + cfl_R) * sl[1];
  T half_dt = T(0.5) * dt;
  T full[2];
  for (int side = 0; side < 2; ++side) {
    // the cell left (side 0) or right (side 1) of the face
    int cell[3] = {t[0], t[1], t[2]};
    cell[D] = t[D] - 1 + side;
    T corr = T(0);
    for (int e = 0; e < 3; ++e) {
      if (e == D) continue;
      Ext3 he = hat_ext(e, n);
      // hat index: e-faces cell[e], cell[e]+1; the others ng=1 cells
      int lo[3] = {cell[0] + 1, cell[1] + 1, cell[2] + 1};
      lo[e] = cell[e];
      int hi[3] = {lo[0], lo[1], lo[2]};
      hi[e] += 1;
      T hv_lo = a.hv[e][he.at(lo)], hv_hi = a.hv[e][he.at(hi)];
      T hq_lo = a.hq[e][D][he.at(lo)], hq_hi = a.hq[e][D][he.at(hi)];
      T vbar = T(0.5) * (hv_lo + hv_hi);
      T dq = hq_hi - hq_lo;
      T tr = (T(-0.5) * dt) * T(a.g.rdx[e]) * vbar * dq;
      corr = (e == (D == 0 ? 1 : 0)) ? tr : corr + tr;
    }
    T u = (side == 0 ? uL : uR) + corr;
    if (a.force[D] != nullptr) {
      u = u + half_dt * a.force[D][fge.at(cell[0] + 1, cell[1] + 1, cell[2] + 1)];
    }
    full[side] = u;
  }
  a.out[D][fe.at(t)] = riemann_self(full[0], full[1]);
}

// ---------------------------------------------------------------------------
// godunov_plm_multi (one field per launch set)

template <typename T>
struct AdvectArgs {
  const T* s;         // (n+6)^3 field with 3 ghosts
  const T* force;     // (n+2)^3 or null
  const T* umac[3];   // raw MAC velocities, real faces
  const T* umac_g[3]; // transverse-grown MAC velocities (one ghost row)
  const T* dt;
  T* hat[3];          // upwinded hat states per face direction
  T* flux[3];         // fluxes on the real faces
  T* aofs;            // advective tendency, real cells
  int iconserv;
  int conv;
  int periodic[3];
  Grid g;
};

// (umac_g[d] has the extents of the hat arrays of direction d)
// (A) hat_s[D] = upwind(pL, pR, umac_g[D]) on the one-ghost region's faces
template <typename T, int D>
__global__ void advect_hat_kernel(AdvectArgs<T> a) {
  const int* n = a.g.n;
  Ext3 he = hat_ext(D, n);
  int t[3];
  if (!thread_index(he, t)) return;
  Ext3 ge = ext3(n[0] + 6, n[1] + 6, n[2] + 6);
  int fc[3] = {t[0] - 1, t[1] - 1, t[2] - 1};
  fc[D] = t[D];
  const T dt = *a.dt;
  i64 o = he.at(t);
  T uf = a.umac_g[D][o];
  T cfl = dt * T(a.g.rdx[D]) * uf;
  T sl[2], qc[2];
  lr_slopes(a.s, ge, D, fc, sl, qc);
  T pL = qc[0] + T(0.5) * (T(1.0) - cfl) * sl[0];
  T pR = qc[1] - T(0.5) * (T(1.0) + cfl) * sl[1];
  a.hat[D][o] = upwind(pL, pR, uf);
}

// (B) edge states with transverse (+ conservative + force) corrections and
// the fluxes umac * edge on the real faces of direction D
template <typename T, int D>
__global__ void advect_flux_kernel(AdvectArgs<T> a) {
  const int* n = a.g.n;
  Ext3 fe = face_ext(D, n);
  int t[3];
  if (!thread_index(fe, t)) return;
  Ext3 ge = ext3(n[0] + 6, n[1] + 6, n[2] + 6);
  Ext3 fge = ext3(n[0] + 2, n[1] + 2, n[2] + 2);
  Ext3 hd = hat_ext(D, n);
  const T dt = *a.dt;
  // real face in the grown array: transverse index + 1
  int gi[3] = {t[0] + 1, t[1] + 1, t[2] + 1};
  gi[D] = t[D];
  T u_real = a.umac_g[D][hd.at(gi)];
  T cfl = dt * T(a.g.rdx[D]) * u_real;
  T sl[2], qc[2];
  lr_slopes(a.s, ge, D, t, sl, qc);
  T pL = qc[0] + T(0.5) * (T(1.0) - cfl) * sl[0];
  T pR = qc[1] - T(0.5) * (T(1.0) + cfl) * sl[1];
  T half_dt = T(0.5) * dt;
  T mhalf_dt = T(-0.5) * dt;
  T full[2];
  for (int side = 0; side < 2; ++side) {
    int cell[3] = {t[0], t[1], t[2]};
    cell[D] = t[D] - 1 + side;
    T corr = T(0);
    bool first = true;
    for (int e = 0; e < 3; ++e) {
      if (e == D) continue;
      Ext3 he = hat_ext(e, n);
      int lo[3] = {cell[0] + 1, cell[1] + 1, cell[2] + 1};
      lo[e] = cell[e];
      int hi[3] = {lo[0], lo[1], lo[2]};
      hi[e] += 1;
      i64 il = he.at(lo), ih = he.at(hi);
      T hq_lo = a.hat[e][il], hq_hi = a.hat[e][ih];
      T uv_lo = a.umac_g[e][il], uv_hi = a.umac_g[e][ih];
      T tr;
      if (a.iconserv) {
        tr = mhalf_dt * T(a.g.rdx[e]) * (uv_hi * hq_hi - uv_lo * hq_lo);
      } else {
        T vbar = T(0.5) * (uv_lo + uv_hi);
        tr = mhalf_dt * T(a.g.rdx[e]) * vbar * (hq_hi - hq_lo);
      }
      corr = first ? tr : corr + tr;
      first = false;
    }
    if (a.iconserv) {
      // d(umac_D)/dx_D at the cell; normal-ghost cells wrap (periodic) or
      // copy the edge cell's value
      int cd = cell[D];
      if (cd < 0) cd = a.periodic[D] ? n[D] - 1 : 0;
      if (cd > n[D] - 1) cd = a.periodic[D] ? 0 : n[D] - 1;
      int ulo[3] = {cell[0] + 1, cell[1] + 1, cell[2] + 1};
      ulo[D] = cd;
      int uhi[3] = {ulo[0], ulo[1], ulo[2]};
      uhi[D] += 1;
      T dudx = (a.umac_g[D][hd.at(uhi)] - a.umac_g[D][hd.at(ulo)]) * T(a.g.rdx[D]);
      T q_cc = a.s[ge.at(cell[0] + 3, cell[1] + 3, cell[2] + 3)];
      corr = corr + mhalf_dt * q_cc * dudx;
    }
    if (a.force != nullptr) {
      corr = corr + half_dt * a.force[fge.at(cell[0] + 1, cell[1] + 1, cell[2] + 1)];
    }
    full[side] = (side == 0 ? pL : pR) + corr;
  }
  T edge = upwind(full[0], full[1], u_real);
  i64 o = fe.at(t);
  a.flux[D][o] = a.umac[D][o] * edge;
}

// (C) aofs = div(F) (conservative) or div(F) - s div(umac) (convective)
template <typename T>
__global__ void advect_aofs_kernel(AdvectArgs<T> a) {
  const int* n = a.g.n;
  Ext3 ce = ext3(n[0], n[1], n[2]);
  int t[3];
  if (!thread_index(ce, t)) return;
  T div = T(0), divu = T(0);
  for (int d = 0; d < 3; ++d) {
    Ext3 fe = face_ext(d, n);
    int hi[3] = {t[0], t[1], t[2]};
    hi[d] += 1;
    T term = (a.flux[d][fe.at(hi)] - a.flux[d][fe.at(t)]) * T(a.g.rdx[d]);
    div = d == 0 ? term : div + term;
    if (a.conv) {
      T tu = (a.umac[d][fe.at(hi)] - a.umac[d][fe.at(t)]) * T(a.g.rdx[d]);
      divu = d == 0 ? tu : divu + tu;
    }
  }
  if (a.conv) {
    Ext3 ge = ext3(n[0] + 6, n[1] + 6, n[2] + 6);
    div = div - a.s[ge.at(t[0] + 3, t[1] + 3, t[2] + 3)] * divu;
  }
  a.aofs[ce.at(t)] = div;
}

const dim3 kBlock(32, 8, 1);

inline dim3 grid_for(const Ext3& e) {
  return dim3((e.a[2] + kBlock.x - 1) / kBlock.x, (e.a[1] + kBlock.y - 1) / kBlock.y, e.a[0]);
}

inline i64 hat_size(int d, const int* n) {
  Ext3 e = hat_ext(d, n);
  return (i64)e.a[0] * e.a[1] * e.a[2];
}

template <typename T>
int extrap_plm_impl(const void* const* vel, const void* const* force, const void* dt,
                    const double* dx, const int* n, void* const* out, void* scratch,
                    cudaStream_t stream) {
  ExtrapArgs<T> a;
  for (int d = 0; d < 3; ++d) {
    a.g.n[d] = n[d];
    a.g.rdx[d] = 1.0 / dx[d];
    a.vel[d] = static_cast<const T*>(vel[d]);
    a.force[d] = static_cast<const T*>(force[d]);
    a.out[d] = static_cast<T*>(out[d]);
  }
  a.dt = static_cast<const T*>(dt);
  // scratch: per face direction e, hv[e] then hq[e][c] for c != e
  T* p = static_cast<T*>(scratch);
  for (int e = 0; e < 3; ++e) {
    i64 sz = hat_size(e, n);
    a.hv[e] = p;
    p += sz;
    for (int c = 0; c < 3; ++c) {
      a.hq[e][c] = nullptr;
      if (c == e) continue;
      a.hq[e][c] = p;
      p += sz;
    }
  }
  extrap_hat_kernel<T, 0><<<grid_for(hat_ext(0, n)), kBlock, 0, stream>>>(a);
  extrap_hat_kernel<T, 1><<<grid_for(hat_ext(1, n)), kBlock, 0, stream>>>(a);
  extrap_hat_kernel<T, 2><<<grid_for(hat_ext(2, n)), kBlock, 0, stream>>>(a);
  extrap_face_kernel<T, 0><<<grid_for(face_ext(0, n)), kBlock, 0, stream>>>(a);
  extrap_face_kernel<T, 1><<<grid_for(face_ext(1, n)), kBlock, 0, stream>>>(a);
  extrap_face_kernel<T, 2><<<grid_for(face_ext(2, n)), kBlock, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int godunov_plm_multi_impl(int nc, const void* const* s, const void* const* force,
                           const void* const* umac, const void* const* umac_g,
                           const void* dt, const int* iconserv, const int* conv,
                           const int* periodic, const double* dx, const int* n,
                           void* const* fx, void* const* fy, void* const* fz,
                           void* const* aofs, void* scratch, cudaStream_t stream) {
  AdvectArgs<T> a;
  for (int d = 0; d < 3; ++d) {
    a.g.n[d] = n[d];
    a.g.rdx[d] = 1.0 / dx[d];
    a.umac[d] = static_cast<const T*>(umac[d]);
    a.umac_g[d] = static_cast<const T*>(umac_g[d]);
    a.periodic[d] = periodic[d];
  }
  a.dt = static_cast<const T*>(dt);
  T* p = static_cast<T*>(scratch);
  for (int e = 0; e < 3; ++e) {
    a.hat[e] = p;
    p += hat_size(e, n);
  }
  for (int j = 0; j < nc; ++j) {
    a.s = static_cast<const T*>(s[j]);
    a.force = static_cast<const T*>(force[j]);
    a.flux[0] = static_cast<T*>(fx[j]);
    a.flux[1] = static_cast<T*>(fy[j]);
    a.flux[2] = static_cast<T*>(fz[j]);
    a.aofs = static_cast<T*>(aofs[j]);
    a.iconserv = iconserv[j];
    a.conv = conv[j];
    advect_hat_kernel<T, 0><<<grid_for(hat_ext(0, n)), kBlock, 0, stream>>>(a);
    advect_hat_kernel<T, 1><<<grid_for(hat_ext(1, n)), kBlock, 0, stream>>>(a);
    advect_hat_kernel<T, 2><<<grid_for(hat_ext(2, n)), kBlock, 0, stream>>>(a);
    advect_flux_kernel<T, 0><<<grid_for(face_ext(0, n)), kBlock, 0, stream>>>(a);
    advect_flux_kernel<T, 1><<<grid_for(face_ext(1, n)), kBlock, 0, stream>>>(a);
    advect_flux_kernel<T, 2><<<grid_for(face_ext(2, n)), kBlock, 0, stream>>>(a);
    advect_aofs_kernel<T><<<grid_for(ext3(n[0], n[1], n[2])), kBlock, 0, stream>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 float64. vel/force/out: 3 device pointers each (force
// entries may be null). dx: 3 doubles, n: 3 ints. scratch: device buffer of
// sum_e 3 * hat_size(e) elements. Returns cudaGetLastError().
int extrap_plm(int dtype, const void* const* vel, const void* const* force, const void* dt,
               const double* dx, const int* n, void* const* out, void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return extrap_plm_impl<float>(vel, force, dt, dx, n, out, scratch, st);
  if (dtype == 1) return extrap_plm_impl<double>(vel, force, dt, dx, n, out, scratch, st);
  return (int)cudaErrorInvalidValue;
}

// nc fields: s, force (null where the field has none), fx/fy/fz/aofs are
// nc-long host arrays of device pointers; iconserv/conv nc ints; umac and
// umac_g 3 device pointers each; periodic 3 ints. scratch: device buffer of
// sum_e hat_size(e) elements. Returns cudaGetLastError().
int godunov_plm_multi(int dtype, int nc, const void* const* s, const void* const* force,
                      const void* const* umac, const void* const* umac_g, const void* dt,
                      const int* iconserv, const int* conv, const int* periodic,
                      const double* dx, const int* n, void* const* fx, void* const* fy,
                      void* const* fz, void* const* aofs, void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return godunov_plm_multi_impl<float>(nc, s, force, umac, umac_g, dt, iconserv, conv,
                                         periodic, dx, n, fx, fy, fz, aofs, scratch, st);
  if (dtype == 1)
    return godunov_plm_multi_impl<double>(nc, s, force, umac, umac_g, dt, iconserv, conv,
                                          periodic, dx, n, fx, fy, fz, aofs, scratch, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
