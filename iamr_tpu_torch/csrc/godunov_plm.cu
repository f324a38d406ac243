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
// with -fmad=false, so the kernels equal the plain path in value (measured:
// bit for bit in f32 and f64, up to the sign of a zero slope; see limit()).
// Where inputs differ by an ulp a thresholded pick (_riemann_self / _upwind,
// sign tests and |speed| < 1e-14) can flip, which is why the f32 contract
// is stated by median and outlier share. Staging a value in shared memory or
// a register does not change it. The normal-ghost d(umac)/dx of the
// conservative correction uses the plain path's wrap (periodic) or
// edge-copy index arithmetic instead of the TPU kernel's ext_face arrays.
// Like the TPU kernel, godunov_plm_multi reads the face velocities from
// umac_g alone: its real part is umac (ops/godunov.py::grow_umac_transverse),
// which the fluxes umac * edge and div umac take from there.
//
// Design: one launch per call (godunov_plm_multi: per 8 fields); the hat
// states never reach device memory. A block owns a (dim 1 x dim 2) tile of
// TJ x TK cells of one field (godunov_plm_multi; the field is the
// fastest-varying block index, so the blocks that share a tile's umac_g
// planes run together and meet in L2) or of the three velocity components
// (extrap_plm), and a segment of dim 0 along which it marches. One thread
// per cell of the tile grown by one (the hat halo), for the whole march:
// what a cell needs along dim 0 (its column's values of planes t-1 .. t+3,
// its slopes, the dim-0 hat state, predictor states and correction of the
// face and plane before) stays in the thread's registers and rolls a plane
// forward each step; only what a neighbour in the plane reads goes through
// shared memory. A step t, four barriers:
//   1. limited slopes of the cell along dims 1 and 2 from plane t in shared
//      memory (with the s halo of 3), along dim 0 from the column;
//   2. the predictor and hat states of the cell's lo faces in dims 1 and 2
//      (plane t) and of its dim-0 face t+1, the face velocity beside them;
//   3. the cell's transverse terms (each serves the faces of the other two
//      directions on both sides of the cell) summed in the plain path's
//      order into the corrections C_0, C_1, C_2 (godunov_plm_multi: with
//      the conservative q d(umac)/dx term and the half-dt force);
//   4. the final upwind of the corrected predictor states, the fluxes or
//      face velocities of plane t (dim 0: face t, from C_0 of planes t-1
//      and t) stored once; godunov_plm_multi then forms the tendency of
//      plane t-1 from the staged fluxes; plane t+1 goes to shared memory.
// The global loads of a step (the column's plane t+4, the s halo of plane
// t+1, umac_g, force) are issued at its top. The halo (a step of warm-up and
// 5 planes per segment, 3 + 1 cells per tile side) is recomputed, not
// exchanged. Indices past a ragged edge are clamped for loads and masked
// for stores, so any extent runs; offsets are 32-bit (fields below 2^31
// elements; the wrappers refuse larger boxes). The tiles (ExtrapTile,
// AdvectTile) and the segment length were chosen by measurement at 256^3 f32
// on an H100 (PERF.md).
//
// Bound: device-memory bytes. At 256^3 f32 one extrap_plm call must move 9
// arrays of 67-72 MB (velocity and force in, 3 faces out), 0.19 ms at 3.35
// TB/s, and one godunov_plm_multi call at nc = 5 31 arrays (5 fields, 3
// forces, umac_g, 15 fluxes, 5 tendencies), 0.63 ms. What keeps the kernels
// from it, measured on an H100 (PERF.md): the instruction stream. Without
// multiply-add contraction a cell and field costs about 235 floating-point
// and 250 other instructions a step, on 1.2-1.3 times the cells (the grown
// tile), which fills the SMs' issue slots at about 3.5 times the bytes'
// time; more warps (smaller register budgets) spill, fewer stall on the
// barriers.

#include <cuda_runtime.h>

namespace {

// The MC limiter of godunov._limit: sign(dc) min(|dc|, dlim), dlim =
// min(|dl|, |dr|) where dl dr > 0, else 0. Written with the hardware's min,
// abs and copysign; it equals the plain form in value (a zero result may
// carry the other sign, which no later comparison or sum tells apart).
template <typename T>
__device__ __forceinline__ T limit(T dc, T dl, T dr) {
  T dlim = fmin(fabs(dl), fabs(dr));
  dlim = (dl * dr > T(0)) ? dlim : T(0);
  return copysign(fmin(fabs(dc), dlim), dc);
}

// 2nd-order MC limited slope from (lo, c, hi): godunov.slope2
template <typename T>
__device__ __forceinline__ T slope2(T lo, T c, T hi) {
  return limit(T(0.5) * (hi - lo), T(2.0) * (c - lo), T(2.0) * (hi - c));
}

// 4th-order MC limited slope of the cell (lo, c, hi) from the 2nd-order
// slopes of its two neighbours: godunov.slope4
template <typename T>
__device__ __forceinline__ T slope4_from(T s2lo, T s2hi, T lo, T c, T hi) {
  const T dc = T((4.0 / 3.0) * 0.5) * (hi - lo) - T(1.0 / 6.0) * (s2hi + s2lo);
  return limit(dc, T(2.0) * (c - lo), T(2.0) * (hi - c));
}

// ... at q[2] of q[0..4]
template <typename T>
__device__ __forceinline__ T slope4(const T* q) {
  return slope4_from(slope2(q[0], q[1], q[2]), slope2(q[2], q[3], q[4]), q[1], q[2], q[3]);
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
  bool small = fabs(speed) < T(1e-14);
  T out = speed > T(0) ? sl : sr;
  return small ? T(0.5) * (sl + sr) : out;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// A block's tile: TJ x TK output cells of (dim 1, dim 2), NT threads. The
// block works on the tile grown by one cell (the hat halo), GJ x GK = G
// cells, one a thread (NT >= G); grown cell (a, b) is the real cell (j0 -
// 1 + a, k0 - 1 + b), and a dim-1 (dim-2) face stored at (a, b) is the lo
// face of that cell. A field plane in shared memory carries the s halo of
// 3: FJ x FK; the H cells outside the grown tile are loaded by the first H
// threads.
template <int TJ_, int TK_, int NT_, int MINB_>
struct Tile {
  static constexpr int TJ = TJ_, TK = TK_, NT = NT_, MINB = MINB_;
  static constexpr int GJ = TJ + 2, GK = TK + 2, G = GJ * GK;
  static constexpr int FJ = TJ + 6, FK = TK + 6, F = FJ * FK;
  static constexpr int H = F - G;
  // a G array in shared memory is padded by a row and a cell on both sides,
  // so a cell may read its four neighbours' slots without a bound check
  // (what lies beyond the grown tile feeds no stored output)
  static constexpr int G0 = GK + 1, GP = G + 2 * G0;
  static_assert(NT >= G && NT >= H && NT % 32 == 0 && NT <= 1024, "one grown cell a thread");
  // a grown cell's offset in a field plane
  __device__ static __forceinline__ int field_at(int a, int b) { return (a + 2) * FK + b + 2; }
  // the h-th cell of a field plane outside the grown tile: two rows above,
  // two below, two columns left and right of the rows between
  __device__ static __forceinline__ int halo_at(int h) {
    if (h < 2 * FK) return h;
    h -= 2 * FK;
    if (h < 2 * FK) return (FJ - 2) * FK + h;
    h -= 2 * FK;
    const int row = 2 + h / 4, q = h % 4;
    return row * FK + (q < 2 ? q : FK - 4 + q);
  }
};

// What a thread keeps about its grown cell for the whole march: its place,
// whether it owns outputs, and its in-plane offsets into the arrays
struct Cell {
  int e, c;               // offset in a G array, in a field plane
  int j, k;               // real cell indices
  bool do0, do1, do2;     // computes a dim-0 / dim-1 / dim-2 face (lo face of the cell)
  bool own1, own2;        // ... and stores it (the tile's last face: only the domain's)
  int os;                 // in a plane of the field (3 ghosts), clamped
  int og, og1, og2;       // in a plane of force / umac_g[0], umac_g[1], umac_g[2], clamped
  int oc, o2;             // in a plane of the real cells / dim-1 faces, of the dim-2 faces
  int hs, ho;             // halo duty: offset in the shared plane (-1: none), in the field plane
};

template <typename TL>
__device__ __forceinline__ Cell make_cell(int n1, int n2, int j0, int k0) {
  Cell x;
  const int tid = threadIdx.x;
  x.e = tid < TL::G ? tid : TL::G - 1;  // spare threads repeat the last cell
  const int ga = x.e / TL::GK, gb = x.e - ga * TL::GK;
  x.c = TL::field_at(ga, gb);
  x.j = j0 - 1 + ga;
  x.k = k0 - 1 + gb;
  const bool inJ = ga >= 1 && ga <= TL::TJ && x.j < n1;
  const bool inK = gb >= 1 && gb <= TL::TK && x.k < n2;
  x.do0 = inJ && inK;
  x.do1 = ga >= 1 && x.j <= n1 && inK;
  x.do2 = gb >= 1 && x.k <= n2 && inJ;
  x.own1 = x.do1 && (ga <= TL::TJ || x.j == n1);
  x.own2 = x.do2 && (gb <= TL::TK || x.k == n2);
  const int jc = clampi(x.j, -1, n1) + 1, kc = clampi(x.k, -1, n2) + 1;
  x.os = (clampi(x.j, -3, n1 + 2) + 3) * (n2 + 6) + clampi(x.k, -3, n2 + 2) + 3;
  x.og = jc * (n2 + 2) + kc;
  x.og1 = clampi(x.j, 0, n1) * (n2 + 2) + kc;
  x.og2 = jc * (n2 + 1) + clampi(x.k, 0, n2);
  x.oc = clampi(x.j, 0, n1) * n2 + clampi(x.k, 0, n2 - 1);
  x.o2 = clampi(x.j, 0, n1 - 1) * (n2 + 1) + clampi(x.k, 0, n2);
  x.hs = -1;
  x.ho = 0;
  if (tid < TL::H) {
    x.hs = TL::halo_at(tid);
    const int fa = x.hs / TL::FK, fb = x.hs - fa * TL::FK;
    x.ho = (clampi(j0 - 3 + fa, -3, n1 + 2) + 3) * (n2 + 6) + clampi(k0 - 3 + fb, -3, n2 + 2) + 3;
  }
  return x;
}

// the planes [i0, i1) of the block's segment of dim 0
__device__ __forceinline__ void block_segment(int n0, int seg, int* i0, int* i1) {
  *i0 = blockIdx.z * seg;
  *i1 = min(*i0 + seg, n0);
}

// A thread's column of a field along dim 0 around plane t: the values of
// planes t-1 .. t+3 and the limited slopes of planes t and t+1, rolled a
// plane forward each step; the 2nd-order slopes of planes t and t+1 are
// kept so that each is computed once.
template <typename T>
struct Column {
  T q[5];      // planes t-1 .. t+3
  T s2a, s2b;  // slope2 of planes t, t+1
  T slc, sln;  // slope4 of planes t, t+1

  // from the values of planes t-2 .. t+3 (v[0..5])
  __device__ __forceinline__ void start(const T* v) {
#pragma unroll
    for (int o = 0; o < 5; ++o) q[o] = v[o + 1];
    const T s2m = slope2(v[0], v[1], v[2]);  // plane t-1
    s2a = slope2(v[1], v[2], v[3]);
    s2b = slope2(v[2], v[3], v[4]);
    slc = slope4_from(s2m, s2b, v[1], v[2], v[3]);
    slopes();
  }
  // the slope of plane t+1, once q[4] holds plane t+3
  __device__ __forceinline__ void slopes() {
    s2n = slope2(q[2], q[3], q[4]);
    sln = slope4_from(s2a, s2n, q[1], q[2], q[3]);
  }
  // to step t+1, given the value of plane t+4
  __device__ __forceinline__ void roll(T next) {
#pragma unroll
    for (int o = 0; o < 4; ++o) q[o] = q[o + 1];
    q[4] = next;
    s2a = s2b;
    s2b = s2n;
    slc = sln;
    slopes();
  }
  T s2n;  // slope2 of plane t+2
};

// offset of plane p of a field with 3 ghosts, clamped into the array
__device__ __forceinline__ int field_plane(int p, int n0, int stride) {
  return (clampi(p, -3, n0 + 2) + 3) * stride;
}

// limited slopes of the thread's cell along dims 1 and 2 in a shared plane
template <typename T, typename TL>
__device__ __forceinline__ void plane_slopes(const T* S, int c, T* s1, T* s2) {
  T q[5];
#pragma unroll
  for (int o = 0; o < 5; ++o) q[o] = S[c + (o - 2) * TL::FK];
  *s1 = slope4(q);
#pragma unroll
  for (int o = 0; o < 5; ++o) q[o] = S[c + o - 2];
  *s2 = slope4(q);
}

// ---------------------------------------------------------------------------
// extrap_plm

template <typename T>
struct ExtrapArgs {
  const T* vel[3];    // (n+6)^3 each
  const T* force[3];  // (n+2)^3 each, or null
  const T* dt;        // device scalar
  T* out[3];          // face velocities
  int n[3];
  double rdx[3];      // 1 / dx, formed in double by the host
  int seg;            // planes of dim 0 per block
};

// The left and right states of the three components on a face of direction
// D, given the two cells' values and slopes along D, Riemann-resolved
// (extrap_vel_to_faces: hat, hat_vel, hat_comp): hv, and hq[c] for c != D;
// uL, uR are the states of component D itself, which the final face takes
template <typename T>
__device__ __forceinline__ void extrap_hat(const T* qc0, const T* qc1, const T* s0, const T* s1,
                                           int D, T dtdx, T* hv, T* hq, T* uL, T* uR) {
  const T unL = qc0[D], unR = qc1[D];
  const T cfl_L = dtdx * (unL > T(0) ? unL : T(0));
  const T cfl_R = dtdx * (unR < T(0) ? unR : T(0));
  T qL[3], qR[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    qL[c] = qc0[c] + T(0.5) * (T(1.0) - cfl_L) * s0[c];
    qR[c] = qc1[c] - T(0.5) * (T(1.0) + cfl_R) * s1[c];
  }
  const T uadv = riemann_self(qL[D], qR[D]);
  *uL = qL[D];
  *uR = qR[D];
  *hv = uadv;
#pragma unroll
  for (int c = 0; c < 3; ++c) hq[c] = c == D ? T(0) : upwind(qL[c], qR[c], uadv);
}

// the Riemann pick of the normal component's predictor states with the
// transverse corrections and the half-dt force added
template <typename T>
__device__ __forceinline__ T extrap_face(T uL, T uR, T cL, T cR, T fL, T fR, bool forced,
                                         T half_dt) {
  uL = uL + cL;
  uR = uR + cR;
  if (forced) {
    uL = uL + half_dt * fL;
    uR = uR + half_dt * fR;
  }
  return riemann_self(uL, uR);
}

// shared memory of an extrap_plm block, in elements: per component two
// field planes, sl1, sl2; hv1, hv2, hq1 x 2, hq2 x 2; C1, C2
template <typename TL>
constexpr int extrap_smem_elems() { return 6 * TL::F + 14 * TL::GP; }

template <typename T, typename TL>
__global__ void __launch_bounds__(TL::NT, TL::MINB) extrap_plm_kernel(const ExtrapArgs<T> a) {
  constexpr int F = TL::F, GP = TL::GP, GK = TL::GK, FK = TL::FK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* SB = reinterpret_cast<T*>(smem_raw);  // [comp][2][F] planes t, t+1
  T* sl1 = SB + 6 * F + TL::G0;            // [comp][GP]
  T* sl2 = sl1 + 3 * GP;                   // [comp][GP]
  T* hv1 = sl2 + 3 * GP;
  T* hv2 = hv1 + GP;
  T* hq1 = hv2 + GP;                       // [2][GP]: components 0, 2
  T* hq2 = hq1 + 2 * GP;                   // [2][GP]: components 0, 1
  T* C1 = hq2 + 2 * GP;
  T* C2 = C1 + GP;

  const int n0 = a.n[0], n1 = a.n[1], n2 = a.n[2];
  int i0, i1;
  block_segment(n0, a.seg, &i0, &i1);
  const Cell x = make_cell<TL>(n1, n2, blockIdx.y * TL::TJ, blockIdx.x * TL::TK);
  const int e = x.e, c = x.c;
  const T dt = *a.dt;
  T dtdx[3], mhr[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    dtdx[d] = dt * T(a.rdx[d]);
    mhr[d] = (T(-0.5) * dt) * T(a.rdx[d]);
  }
  const T half_dt = T(0.5) * dt;
  const bool forced = a.force[0] != nullptr;
  const int ss = (n1 + 6) * (n2 + 6);  // plane strides: field,
  const int sg = (n1 + 2) * (n2 + 2);  // force,
  const int sc = n1 * n2, sf1 = (n1 + 1) * n2, sf2 = n1 * (n2 + 1);  // outputs
  // the last face of dim 0 belongs to the last segment
  const int t_end = i1 == n0 ? n0 : i1 - 1;

  Column<T> col[3];
  {
    const int t = i0 - 1;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      T v[6];
#pragma unroll
      for (int o = 0; o < 6; ++o) v[o] = a.vel[m][field_plane(t - 2 + o, n0, ss) + x.os];
      col[m].start(v);
      T* S = SB + (m * 2 + (t & 1)) * F;
      S[c] = v[2];
      if (x.hs >= 0) S[x.hs] = a.vel[m][field_plane(t, n0, ss) + x.ho];
    }
  }
  T hv0c = T(0), hq0c[3] = {T(0), T(0), T(0)};  // dim-0 hat states of face t
  T uL0c = T(0), uR0c = T(0);                  // ... and the normal component's states
  T C0p = T(0), f0p = T(0);                    // C_0 and force_0 of plane t-1
  __syncthreads();

  for (int t = i0 - 1; t <= t_end; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    const bool faces = t >= i0, inplane = faces && t < i1;
    // this step's loads: the columns' plane t+4, the halo of plane t+1, forces
    T qn[3], hn[3] = {T(0), T(0), T(0)};
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      qn[m] = a.vel[m][field_plane(t + 4, n0, ss) + x.os];
      if (x.hs >= 0) hn[m] = a.vel[m][field_plane(t + 1, n0, ss) + x.ho];
    }
    T f0c = T(0), f1L = T(0), f1R = T(0), f2L = T(0), f2R = T(0);
    if (forced) {
      const int pg = (t + 1) * sg;
      f0c = a.force[0][pg + x.og];
      if (inplane && x.own1) {
        f1L = a.force[1][pg + x.og - (n2 + 2)];
        f1R = a.force[1][pg + x.og];
      }
      if (inplane && x.own2) {
        f2L = a.force[2][pg + x.og - 1];
        f2R = a.force[2][pg + x.og];
      }
    }

    // slopes along dims 1 and 2 in plane t
    T s1v[3], s2v[3];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      plane_slopes<T, TL>(SB + (m * 2 + cur) * F, c, &s1v[m], &s2v[m]);
      sl1[m * GP + e] = s1v[m];
      sl2[m * GP + e] = s2v[m];
    }
    __syncthreads();

    // hat states: dim-0 face t+1 (registers), dim-1 and dim-2 faces of plane t
    T q0[3], q1[3], s0[3], s1[3], hv0n, hq0n[3], hv1v, hq1v[3], hv2v, hq2v[3];
    T uL0n, uR0n, uL1, uR1, uL2, uR2;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      q0[m] = col[m].q[1];
      q1[m] = col[m].q[2];
      s0[m] = col[m].slc;
      s1[m] = col[m].sln;
    }
    extrap_hat(q0, q1, s0, s1, 0, dtdx[0], &hv0n, hq0n, &uL0n, &uR0n);
    // in plane t the cell is the right cell of its lo faces
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      q1[m] = col[m].q[1];
      q0[m] = SB[(m * 2 + cur) * F + c - FK];
      s0[m] = sl1[m * GP + e - GK];
    }
    extrap_hat(q0, q1, s0, s1v, 1, dtdx[1], &hv1v, hq1v, &uL1, &uR1);
    hv1[e] = hv1v;
    hq1[e] = hq1v[0];
    hq1[GP + e] = hq1v[2];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      q0[m] = SB[(m * 2 + cur) * F + c - 1];
      s0[m] = sl2[m * GP + e - 1];
    }
    extrap_hat(q0, q1, s0, s2v, 2, dtdx[2], &hv2v, hq2v, &uL2, &uR2);
    hv2[e] = hv2v;
    hq2[e] = hq2v[0];
    hq2[GP + e] = hq2v[1];
    __syncthreads();

    // transverse corrections of the cell: C_D = sum over e != D of
    // -dt/2 / dx_e * vbar_e * d(hq[e][D]), e ascending
    const T vb0 = T(0.5) * (hv0c + hv0n);
    const T vb1 = T(0.5) * (hv1v + hv1[e + GK]);
    const T vb2 = T(0.5) * (hv2v + hv2[e + 1]);
    const T d01 = hq0n[1] - hq0c[1], d02 = hq0n[2] - hq0c[2];
    const T d10 = hq1[e + GK] - hq1v[0], d12 = hq1[GP + e + GK] - hq1v[2];
    const T d20 = hq2[e + 1] - hq2v[0], d21 = hq2[GP + e + 1] - hq2v[1];
    const T c0 = mhr[1] * vb1 * d10 + mhr[2] * vb2 * d20;
    const T c1 = mhr[0] * vb0 * d01 + mhr[2] * vb2 * d21;
    const T c2 = mhr[0] * vb0 * d02 + mhr[1] * vb1 * d12;
    C1[e] = c1;
    C2[e] = c2;
    __syncthreads();

    // the face velocities: dim 0 at face t, dims 1 and 2 in plane t
    if (faces && x.do0)
      a.out[0][t * sc + x.oc] = extrap_face(uL0c, uR0c, C0p, c0, f0p, f0c, forced, half_dt);
    if (inplane && x.own1)
      a.out[1][t * sf1 + x.oc] =
          extrap_face(uL1, uR1, C1[e - GK], c1, f1L, f1R, forced, half_dt);
    if (inplane && x.own2)
      a.out[2][t * sf2 + x.o2] =
          extrap_face(uL2, uR2, C2[e - 1], c2, f2L, f2R, forced, half_dt);
    // plane t+1 for the next step's in-plane slopes
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      T* S = SB + (m * 2 + nxt) * F;
      S[c] = col[m].q[2];
      if (x.hs >= 0) S[x.hs] = hn[m];
      col[m].roll(qn[m]);
    }
    hv0c = hv0n;
    uL0c = uL0n;
    uR0c = uR0n;
#pragma unroll
    for (int m = 0; m < 3; ++m) hq0c[m] = hq0n[m];
    C0p = c0;
    f0p = f0c;
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// godunov_plm_multi

constexpr int kMaxFields = 8;  // fields of one launch (more chain launches)

template <typename T>
struct AdvectArgs {
  const T* s[kMaxFields];      // (n+6)^3 fields with 3 ghosts
  const T* force[kMaxFields];  // (n+2)^3 or null
  T* flux[3][kMaxFields];      // fluxes on the real faces
  T* aofs[kMaxFields];         // advective tendency, real cells
  int iconserv[kMaxFields];
  int conv[kMaxFields];
  const T* umac_g[3];          // transverse-grown MAC velocities (one ghost row);
                               // their real part is umac, which the kernel reads here
  const T* dt;
  int nc;
  int periodic[3];
  int n[3];
  double rdx[3];
  int seg;
};

// the transverse term of a cell from the hat states and face velocities of
// its lo and hi face: compute_edge_states' t
template <typename T>
__device__ __forceinline__ T transverse(T h_lo, T h_hi, T u_lo, T u_hi, T mhr, bool iconserv) {
  if (iconserv) return mhr * (u_hi * h_hi - u_lo * h_lo);
  const T vbar = T(0.5) * (u_lo + u_hi);
  return mhr * vbar * (h_hi - h_lo);
}

// the cell whose d(umac)/dx a normal-ghost cell takes: wrapped or the edge
__device__ __forceinline__ int ghost_cell(int c, int n, int periodic) {
  if (c < 0) return periodic ? n - 1 : 0;
  if (c > n - 1) return periodic ? 0 : n - 1;
  return c;
}

// the normal predictor of a face, from its two cells' values and slopes:
// the left and right states at t + dt/2. The hat state is their upwind
// pick, the edge state the pick after the corrections are added.
template <typename T>
__device__ __forceinline__ void predict(T q0, T q1, T s0, T s1, T cfl, T* stL, T* stR) {
  *stL = q0 + T(0.5) * (T(1.0) - cfl) * s0;
  *stR = q1 - T(0.5) * (T(1.0) + cfl) * s1;
}

// shared memory of a godunov_plm_multi block, in elements: two field
// planes; sl1, sl2, hat1, hat2, ug1, ug2, C1, C2; f1 x 2, f2 x 2
template <typename TL>
constexpr int advect_smem_elems() { return 2 * TL::F + 12 * TL::GP; }

template <typename T, typename TL>
__global__ void __launch_bounds__(TL::NT, TL::MINB) godunov_plm_multi_kernel(const AdvectArgs<T> a) {
  constexpr int F = TL::F, GP = TL::GP, GK = TL::GK, FK = TL::FK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* SB = reinterpret_cast<T*>(smem_raw);  // [2][F] planes t, t+1
  T* sl1 = SB + 2 * F + TL::G0;
  T* sl2 = sl1 + GP;
  T* hat1 = sl2 + GP;
  T* hat2 = hat1 + GP;
  T* ug1 = hat2 + GP;                      // umac_g at the hat faces
  T* ug2 = ug1 + GP;
  T* C1 = ug2 + GP;
  T* C2 = C1 + GP;
  T* f1 = C2 + GP;                         // [2][GP] planes t-1, t
  T* f2 = f1 + 2 * GP;

  const int fld = blockIdx.x % a.nc;
  const int n0 = a.n[0], n1 = a.n[1], n2 = a.n[2];
  int i0, i1;
  block_segment(n0, a.seg, &i0, &i1);
  const Cell x = make_cell<TL>(n1, n2, blockIdx.y * TL::TJ, (blockIdx.x / a.nc) * TL::TK);
  const int e = x.e, c = x.c;
  const T* __restrict__ s = a.s[fld];
  const T* __restrict__ force = a.force[fld];
  T* __restrict__ fx = a.flux[0][fld];
  T* __restrict__ fy = a.flux[1][fld];
  T* __restrict__ fz = a.flux[2][fld];
  T* __restrict__ aofs = a.aofs[fld];
  const bool iconserv = a.iconserv[fld] != 0, conv = a.conv[fld] != 0;
  const T dt = *a.dt;
  T rdx[3], dtdx[3], mhr[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    rdx[d] = T(a.rdx[d]);
    dtdx[d] = dt * rdx[d];
    mhr[d] = (T(-0.5) * dt) * rdx[d];
  }
  const T half_dt = T(0.5) * dt, mhalf_dt = T(-0.5) * dt;
  const int ss = (n1 + 6) * (n2 + 6);  // plane strides: field,
  const int sg = (n1 + 2) * (n2 + 2);  // force and umac_g[0],
  const int sg1 = (n1 + 1) * (n2 + 2), sg2 = (n1 + 2) * (n2 + 1);  // umac_g[1], [2],
  const int sc = n1 * n2, sf1 = (n1 + 1) * n2, sf2 = n1 * (n2 + 1);  // cells, faces

  Column<T> col;
  {
    const int t = i0 - 1;
    T v[6];
#pragma unroll
    for (int o = 0; o < 6; ++o) v[o] = s[field_plane(t - 2 + o, n0, ss) + x.os];
    col.start(v);
    T* S = SB + (t & 1) * F;
    S[c] = v[2];
    if (x.hs >= 0) S[x.hs] = s[field_plane(t, n0, ss) + x.ho];
  }
  T hat0c = T(0), u0c = T(0);  // dim-0 hat state and umac_g of face t,
  T stL0c = T(0), stR0c = T(0);  // ... and its predictor states
  T C0p = T(0), f0p = T(0);    // C_0 and the dim-0 flux (face t-1) of plane t-1
  T divu_p = T(0);             // div umac of plane t-1 (convective fields)
  __syncthreads();

  for (int t = i0 - 1; t <= i1; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    const bool faces = t >= i0, inplane = faces && t < i1;
    const T* S = SB + cur * F;
    // this step's loads: the column's plane t+4, the halo of plane t+1, the
    // face velocities, the force
    const T qn = s[field_plane(t + 4, n0, ss) + x.os];
    T hn = T(0);
    if (x.hs >= 0) hn = s[field_plane(t + 1, n0, ss) + x.ho];
    const T u0n = a.umac_g[0][clampi(t + 1, 0, n0) * sg + x.og];
    const T u1 = a.umac_g[1][(t + 1) * sg1 + x.og1];
    const T u2 = a.umac_g[2][(t + 1) * sg2 + x.og2];
    T fv = T(0);
    if (force != nullptr) fv = force[(t + 1) * sg + x.og];

    // slopes along dims 1 and 2 in plane t
    T s1v, s2v;
    plane_slopes<T, TL>(S, c, &s1v, &s2v);
    sl1[e] = s1v;
    sl2[e] = s2v;
    __syncthreads();

    // hat states: dim-0 face t+1 (registers), dim-1 and dim-2 faces of plane t
    T stL0n, stR0n, stL1, stR1, stL2, stR2;
    predict(col.q[1], col.q[2], col.slc, col.sln, dtdx[0] * u0n, &stL0n, &stR0n);
    const T hat0n = upwind(stL0n, stR0n, u0n);
    predict(S[c - FK], col.q[1], sl1[e - GK], s1v, dtdx[1] * u1, &stL1, &stR1);
    const T hat1v = upwind(stL1, stR1, u1);
    hat1[e] = hat1v;
    ug1[e] = u1;
    predict(S[c - 1], col.q[1], sl2[e - 1], s2v, dtdx[2] * u2, &stL2, &stR2);
    const T hat2v = upwind(stL2, stR2, u2);
    hat2[e] = hat2v;
    ug2[e] = u2;
    __syncthreads();

    // corrections of the cell: C_D = the transverse terms of e != D (e
    // ascending), the conservative -dt/2 q d(umac_D)/dx_D, the force
    const T tr0 = transverse(hat0c, hat0n, u0c, u0n, mhr[0], iconserv);
    const T u1h = ug1[e + GK], u2h = ug2[e + 1];
    const T tr1 = transverse(hat1v, hat1[e + GK], u1, u1h, mhr[1], iconserv);
    const T tr2 = transverse(hat2v, hat2[e + 1], u2, u2h, mhr[2], iconserv);
    T divu = T(0);  // div umac of the cell (the real part of umac_g is umac)
    if (conv) {
      divu = (u0n - u0c) * rdx[0];
      divu = divu + (u1h - u1) * rdx[1];
      divu = divu + (u2h - u2) * rdx[2];
    }
    T c0 = tr1 + tr2, c1 = tr0 + tr2, c2 = tr0 + tr1;
    if (iconserv) {
      const T q = mhalf_dt * col.q[1];
      const int p0 = ghost_cell(t, n0, a.periodic[0]) * sg + x.og;
      c0 = c0 + q * ((a.umac_g[0][p0 + sg] - a.umac_g[0][p0]) * rdx[0]);
      // dims 1 and 2: the cell itself, or the one a normal-ghost cell takes
      const int jc = clampi(x.j, -1, n1), kc = clampi(x.k, -1, n2);
      const int p1 = (t + 1) * sg1 + ghost_cell(jc, n1, a.periodic[1]) * (n2 + 2) + kc + 1;
      c1 = c1 + q * ((a.umac_g[1][p1 + (n2 + 2)] - a.umac_g[1][p1]) * rdx[1]);
      const int p2 = (t + 1) * sg2 + (jc + 1) * (n2 + 1) + ghost_cell(kc, n2, a.periodic[2]);
      c2 = c2 + q * ((a.umac_g[2][p2 + 1] - a.umac_g[2][p2]) * rdx[2]);
    }
    if (force != nullptr) {
      const T hf = half_dt * fv;
      c0 = c0 + hf;
      c1 = c1 + hf;
      c2 = c2 + hf;
    }
    C1[e] = c1;
    C2[e] = c2;
    __syncthreads();

    // fluxes umac * edge: dim 0 at face t, dims 1 and 2 in plane t
    T f0c = T(0);
    if (faces && x.do0) {
      f0c = u0c * upwind(stL0c + C0p, stR0c + c0, u0c);
      if (t < i1 || t == n0) fx[t * sc + x.oc] = f0c;
    }
    if (inplane && x.do1) {
      const T f1v = u1 * upwind(stL1 + C1[e - GK], stR1 + c1, u1);
      f1[cur * GP + e] = f1v;
      if (x.own1) fy[t * sf1 + x.oc] = f1v;
    }
    if (inplane && x.do2) {
      const T f2v = u2 * upwind(stL2 + C2[e - 1], stR2 + c2, u2);
      f2[cur * GP + e] = f2v;
      if (x.own2) fz[t * sf2 + x.o2] = f2v;
    }
    // the tendency of plane t-1: div F, or div F - s div umac
    if (t > i0 && x.do0) {
      T div = (f0c - f0p) * rdx[0];
      div = div + (f1[nxt * GP + e + GK] - f1[nxt * GP + e]) * rdx[1];
      div = div + (f2[nxt * GP + e + 1] - f2[nxt * GP + e]) * rdx[2];
      if (conv) div = div - col.q[0] * divu_p;
      aofs[(t - 1) * sc + x.oc] = div;
    }
    // plane t+1 for the next step's in-plane slopes
    T* Sn = SB + nxt * F;
    Sn[c] = col.q[2];
    if (x.hs >= 0) Sn[x.hs] = hn;
    col.roll(qn);
    hat0c = hat0n;
    u0c = u0n;
    stL0c = stL0n;
    stR0c = stR0n;
    C0p = c0;
    f0p = f0c;
    divu_p = divu;
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// host side

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

// the kernels index with 32-bit offsets: the largest array, a field with 3
// ghosts, has to stay below 2^31 elements
inline bool fits_32bit(const int* n) {
  return (long long)(n[0] + 6) * (n[1] + 6) * (n[2] + 6) < (1LL << 31);
}

// planes of dim 0 per block: enough segments for about 24 blocks per SM, at
// least 64 planes each (a segment pays 4 planes of warm-up; shorter ones
// measured slower at 256^3)
int segment(int n0, int columns) {
  const int nseg = ceil_div(24 * sm_count(), columns);
  int seg = ceil_div(n0, nseg);
  if (seg < 64) seg = 64;
  return seg > n0 ? n0 : seg;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The tiles: rows x columns of cells, threads, and the blocks an SM must hold
// (which caps the registers)
using ExtrapTile = Tile<16, 32, 640, 1>;
using AdvectTile = Tile<10, 32, 416, 3>;

template <typename T>
cudaError_t launch_extrap(ExtrapArgs<T> a, cudaStream_t stream) {
  using TL = ExtrapTile;
  const int gx = ceil_div(a.n[2], TL::TK), gy = ceil_div(a.n[1], TL::TJ);
  a.seg = segment(a.n[0], gx * gy);
  const int smem = extrap_smem_elems<TL>() * (int)sizeof(T);
  auto kernel = extrap_plm_kernel<T, TL>;
  static bool smem_set = false;  // once per dtype
  if (!smem_set) {
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  kernel<<<dim3(gx, gy, ceil_div(a.n[0], a.seg)), TL::NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_advect(AdvectArgs<T> a, cudaStream_t stream) {
  using TL = AdvectTile;
  const int gx = ceil_div(a.n[2], TL::TK), gy = ceil_div(a.n[1], TL::TJ);
  a.seg = segment(a.n[0], a.nc * gx * gy);
  const int smem = advect_smem_elems<TL>() * (int)sizeof(T);
  auto kernel = godunov_plm_multi_kernel<T, TL>;
  static bool smem_set = false;  // once per dtype
  if (!smem_set) {
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  kernel<<<dim3(a.nc * gx, gy, ceil_div(a.n[0], a.seg)), TL::NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
int extrap_plm_impl(const void* const* vel, const void* const* force, const void* dt,
                    const double* dx, const int* n, void* const* out, cudaStream_t stream) {
  ExtrapArgs<T> a{};
  for (int d = 0; d < 3; ++d) {
    a.n[d] = n[d];
    a.rdx[d] = 1.0 / dx[d];
    a.vel[d] = static_cast<const T*>(vel[d]);
    a.force[d] = static_cast<const T*>(force[d]);
    a.out[d] = static_cast<T*>(out[d]);
  }
  a.dt = static_cast<const T*>(dt);
  if (!fits_32bit(n)) return (int)cudaErrorInvalidValue;
  return (int)launch_extrap<T>(a, stream);
}

template <typename T>
int godunov_plm_multi_impl(int nc, const void* const* s, const void* const* force,
                           const void* const* umac_g,
                           const void* dt, const int* iconserv, const int* conv,
                           const int* periodic, const double* dx, const int* n,
                           void* const* fx, void* const* fy, void* const* fz,
                           void* const* aofs, cudaStream_t stream) {
  AdvectArgs<T> a{};
  for (int d = 0; d < 3; ++d) {
    a.n[d] = n[d];
    a.rdx[d] = 1.0 / dx[d];
    a.umac_g[d] = static_cast<const T*>(umac_g[d]);
    a.periodic[d] = periodic[d];
  }
  a.dt = static_cast<const T*>(dt);
  if (!fits_32bit(n)) return (int)cudaErrorInvalidValue;
  // one launch holds kMaxFields fields; more fields chain launches
  for (int j0 = 0; j0 < nc; j0 += kMaxFields) {
    a.nc = nc - j0 < kMaxFields ? nc - j0 : kMaxFields;
    for (int j = 0; j < a.nc; ++j) {
      a.s[j] = static_cast<const T*>(s[j0 + j]);
      a.force[j] = static_cast<const T*>(force[j0 + j]);
      a.flux[0][j] = static_cast<T*>(fx[j0 + j]);
      a.flux[1][j] = static_cast<T*>(fy[j0 + j]);
      a.flux[2][j] = static_cast<T*>(fz[j0 + j]);
      a.aofs[j] = static_cast<T*>(aofs[j0 + j]);
      a.iconserv[j] = iconserv[j0 + j];
      a.conv[j] = conv[j0 + j];
    }
    cudaError_t err = launch_advect<T>(a, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 float64. vel/force/out: 3 device pointers each (force:
// all three or all null). dx: 3 doubles, n: 3 ints. Returns
// cudaGetLastError().
int extrap_plm(int dtype, const void* const* vel, const void* const* force, const void* dt,
               const double* dx, const int* n, void* const* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return extrap_plm_impl<float>(vel, force, dt, dx, n, out, st);
  if (dtype == 1) return extrap_plm_impl<double>(vel, force, dt, dx, n, out, st);
  return (int)cudaErrorInvalidValue;
}

// nc fields: s, force (null where the field has none), fx/fy/fz/aofs are
// nc-long host arrays of device pointers; iconserv/conv nc ints; umac_g 3
// device pointers (its real part is umac: the fluxes and div umac read it);
// periodic 3 ints. One launch per 8 fields. Returns cudaGetLastError().
int godunov_plm_multi(int dtype, int nc, const void* const* s, const void* const* force,
                      const void* const* umac_g, const void* dt,
                      const int* iconserv, const int* conv, const int* periodic,
                      const double* dx, const int* n, void* const* fx, void* const* fy,
                      void* const* fz, void* const* aofs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return godunov_plm_multi_impl<float>(nc, s, force, umac_g, dt, iconserv, conv,
                                         periodic, dx, n, fx, fy, fz, aofs, st);
  if (dtype == 1)
    return godunov_plm_multi_impl<double>(nc, s, force, umac_g, dt, iconserv, conv,
                                          periodic, dx, n, fx, fy, fz, aofs, st);
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory (bytes) of a block of kernel 0 (extrap_plm) or 1
// (godunov_plm_multi) for a dtype; -1 for an unknown kernel
int godunov_plm_smem_bytes(int kernel, int dtype) {
  const int elems = kernel == 0   ? extrap_smem_elems<ExtrapTile>()
                    : kernel == 1 ? advect_smem_elems<AdvectTile>()
                                  : -1;
  return elems < 0 ? -1 : elems * (dtype == 1 ? 8 : 4);
}

}  // extern "C"
