"""Geometric multigrid for the cell-centred ABecLaplacian
(counterpart of iamr_tpu/ops/mg.py).

Solves (a alpha - b div(beta grad)) phi = rhs with beta on faces, on one
dense level tensor per MG level:
  * hierarchy by factor-2 coarsening down to a dense-bottom level of at
    most DENSE_BOTTOM_DOFS cells, whose operator is inverted once per solve
    (or a 32-iteration CG bottom when the level is too big to materialize);
  * red-black Gauss-Seidel smoother and residual: the kernel mg_cell_gsrb on
    CUDA tensors (every level, no size gate), the plain PyTorch version on
    CPU tensors (ops/mg_kernels.py);
  * per (dim, side) BC kinds periodic / Dirichlet-on-face / Neumann;
    inhomogeneous values are folded into the rhs once (boundary lifting),
    so the multigrid internals are homogeneous;
  * fixed-cycle mode (reads nothing back to the host) and tolerance mode
    (one host read of the residual norm per V-cycle).

mixed=True runs f32 V-cycles with a true-f64 outer residual (the same
kernel instantiated for double); mixed=None means False. Multi-box levels
(interior_mask / union_dirichlet_coeffs) are not ported.

Dirichlet ghosts use g = (8/3) b - 2 c0 + (1/3) c1 (face value b).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from iamr_tpu_torch.ops import mg_kernels
from iamr_tpu_torch.ops.stencil import sl
from iamr_tpu_torch.parallel.reduce import invariant_matvec, invariant_mean, invariant_sum

# BC kinds
PERIODIC = 0
DIRICHLET = 1
NEUMANN = 2


@dataclasses.dataclass(frozen=True)
class PoissonBC:
    """Per-dim, per-side BC kinds for a cell-centred solve."""

    lo: Tuple[int, ...]
    hi: Tuple[int, ...]

    @property
    def dim(self):
        return len(self.lo)


def _pad_phi(phi, bc: PoissonBC):
    """Fill one homogeneous ghost layer around phi per the BC kinds (the
    first bc.dim dims; a trailing batch dim is carried along)."""
    for d in range(bc.dim):
        n = phi.shape[d]
        if bc.lo[d] == PERIODIC:
            lo = sl(phi, d, n - 1, n)
            hi = sl(phi, d, 0, 1)
        else:
            c0l, c1l = sl(phi, d, 0, 1), sl(phi, d, 1, 2)
            c0h, c1h = sl(phi, d, n - 1, n), sl(phi, d, n - 2, n - 1)
            lo = -2.0 * c0l + (1.0 / 3.0) * c1l if bc.lo[d] == DIRICHLET else c0l
            hi = -2.0 * c0h + (1.0 / 3.0) * c1h if bc.hi[d] == DIRICHLET else c0h
        phi = torch.cat([lo, phi, hi], dim=d)
    return phi


def _boundary_lift(shape, bc: PoissonBC, bvals, dtype, device):
    """Ghost-only array holding the inhomogeneous part of the BC fill
    (Dirichlet: (8/3) * face value; Neumann: the value as given)."""
    dim = len(shape)
    g = torch.zeros(tuple(s + 2 for s in shape), dtype=dtype, device=device)
    if not bvals:
        return g
    for (d, side), val in bvals.items():
        if bc.lo[d] == PERIODIC:
            continue
        kind = bc.lo[d] if side == 0 else bc.hi[d]
        idx = [slice(1, -1)] * dim
        idx[d] = slice(0, 1) if side == 0 else slice(-1, None)
        v = torch.as_tensor(val, dtype=dtype, device=device)
        if v.ndim == dim - 1:
            v = v.unsqueeze(d)
        contrib = (8.0 / 3.0) * v if kind == DIRICHLET else v
        g[tuple(idx)] += contrib
    return g


def _face_lo(beta_d, d):
    return sl(beta_d, d, 0, -1)


def _face_hi(beta_d, d):
    return sl(beta_d, d, 1, None)


def apply_op(phi_g, alpha, beta, a, b, dx, shape):
    """L(phi) given phi WITH one filled ghost layer (phi_g)."""
    dim = len(shape)
    ctr = phi_g[tuple(slice(1, -1) for _ in range(dim))]
    out = a * alpha * ctr if a != 0.0 else torch.zeros_like(ctr)
    for d in range(dim):
        idx_lo = [slice(1, -1)] * dim
        idx_hi = [slice(1, -1)] * dim
        idx_lo[d] = slice(0, -2)
        idx_hi[d] = slice(2, None)
        lo_n = phi_g[tuple(idx_lo)]
        hi_n = phi_g[tuple(idx_hi)]
        bl = _face_lo(beta[d], d)
        bh = _face_hi(beta[d], d)
        lap = (bh * (hi_n - ctr) - bl * (ctr - lo_n)) / (dx[d] * dx[d])
        out = out - b * lap
    return out


def _diag(alpha, beta, a, b, dx, bc: PoissonBC, shape, dtype):
    """Diagonal of the operator with boundary-modified coefficients: an
    interior face contributes beta/dx^2, a Dirichlet boundary face
    3 beta/dx^2 (3-point ghost), a Neumann boundary face 0."""
    dim = len(shape)
    dev = alpha.device
    diag = a * alpha if a != 0.0 else torch.zeros(shape, dtype=dtype, device=dev)
    for d in range(dim):
        bl = _face_lo(beta[d], d)
        bh = _face_hi(beta[d], d)
        cl = torch.ones(shape, dtype=dtype, device=dev)
        ch = torch.ones(shape, dtype=dtype, device=dev)
        fac = {DIRICHLET: 3.0, NEUMANN: 0.0}
        if bc.lo[d] in fac:
            cl.narrow(d, 0, 1).fill_(fac[bc.lo[d]])
        if bc.hi[d] in fac:
            ch.narrow(d, shape[d] - 1, 1).fill_(fac[bc.hi[d]])
        diag = diag + b * (cl * bl + ch * bh) / (dx[d] * dx[d])
    return diag


def _every2(a, d, offset):
    idx = [slice(None)] * a.ndim
    idx[d] = slice(offset, None, 2)
    return tuple(idx)


def _coarsen_cell(a, dim):
    """2x average coarsening of a cell array."""
    for d in range(dim):
        a = 0.5 * (a[_every2(a, d, 0)] + a[_every2(a, d, 1)])
    return a


def _coarsen_face(beta_d, d, dim):
    """Coarsen a face coefficient array for faces normal to d: average
    transverse pairs, take every other face in the normal dim."""
    out = beta_d
    for t in range(dim):
        if t == d:
            continue
        out = 0.5 * (out[_every2(out, t, 0)] + out[_every2(out, t, 1)])
    return out[_every2(out, d, 0)].contiguous()


def _prolong(e_c, dim):
    """Piecewise-constant prolongation (2x repeat per dim)."""
    for d in range(dim):
        e_c = torch.repeat_interleave(e_c, 2, dim=d)
    return e_c


@dataclasses.dataclass
class MGLevelData:
    """One MG level. The colour masks of the JAX package's level are formed
    where they are used (the kernel from the cell index, the plain version
    by stencil.checkerboard)."""

    alpha: torch.Tensor
    beta: Tuple[torch.Tensor, ...]
    diag: torch.Tensor
    dx: Tuple[float, ...]
    shape: Tuple[int, ...]


def build_hierarchy(alpha, beta, a: float, b, dx: Sequence[float], bc: PoissonBC,
                    min_size: int = 2, max_levels: int = 30, stop_dofs: int = 0):
    """The MG level list; stop_dofs also stops coarsening once a level has
    <= stop_dofs cells (the dense-bottom truncation)."""
    dim = alpha.ndim
    levels = []
    shape = tuple(alpha.shape)
    cur_alpha, cur_beta, cur_dx = alpha, tuple(beta), tuple(dx)
    while True:
        diag = _diag(cur_alpha, cur_beta, a, b, cur_dx, bc, shape, alpha.dtype)
        levels.append(MGLevelData(cur_alpha, cur_beta, diag, cur_dx, shape))
        if (len(levels) >= max_levels or any(n % 2 != 0 for n in shape)
                or min(shape) <= min_size or int(np.prod(shape)) <= stop_dofs):
            break
        cur_alpha = _coarsen_cell(cur_alpha, dim)
        cur_beta = tuple(_coarsen_face(cur_beta[d], d, dim) for d in range(dim))
        cur_dx = tuple(2.0 * h for h in cur_dx)
        shape = tuple(n // 2 for n in shape)
    return levels


def _smooth2(phi, rhs, lev: MGLevelData, a, b, bc, nsweeps: int, want_resid: bool):
    """nsweeps red-black GS sweeps, then the residual when want_resid:
    one mg_cell_gsrb call (kernel on CUDA, plain on the CPU)."""
    if nsweeps == 0 and not want_resid:
        return phi, None
    alpha = lev.alpha if a != 0.0 else None
    return mg_kernels.cell_smooth(phi, rhs, alpha, lev.beta, a, b, lev.dx, bc.lo, bc.hi,
                                  nsweeps, want_resid)


def _smooth_rb(phi, rhs, lev: MGLevelData, a, b, bc, nsweeps: int):
    """nsweeps red-black Gauss-Seidel sweeps."""
    return _smooth2(phi, rhs, lev, a, b, bc, nsweeps, False)[0]


def _residual(phi, rhs, lev: MGLevelData, a, b, bc):
    return _smooth2(phi, rhs, lev, a, b, bc, 0, True)[1]


def _singular(a, bc: PoissonBC, dim: int) -> bool:
    return a == 0.0 and all(bc.lo[d] != DIRICHLET and bc.hi[d] != DIRICHLET
                            for d in range(dim))


def _bottom_cg(rhs, lev: MGLevelData, a, b, bc, iters: int = 32):
    """Fixed-count conjugate-gradient bottom solve; iterations freeze once
    converged (rs / pap -> 0/0 would amplify roundoff)."""

    def matvec(p):
        return apply_op(_pad_phi(p, bc), lev.alpha, lev.beta, a, b, lev.dx, lev.shape)

    singular = _singular(a, bc, len(lev.shape))

    def demean(x):
        return x - invariant_mean(x) if singular else x

    rhs = demean(rhs)
    x = torch.zeros_like(rhs)
    r = rhs
    p = r
    rs = invariant_sum(r * r)
    rs0 = rs
    eps = torch.full((), 1e-30, dtype=rhs.dtype, device=rhs.device)
    zero = torch.zeros((), dtype=rhs.dtype, device=rhs.device)
    for _ in range(iters):
        active = rs > torch.maximum(1e-28 * rs0, eps)
        ap = matvec(p)
        pap = invariant_sum(p * ap)
        alpha_k = torch.where(active & (pap > eps), rs / torch.maximum(pap, eps), zero)
        x = x + alpha_k * p
        r = demean(r - alpha_k * ap)
        rs_new = invariant_sum(r * r)
        beta_k = torch.where(active, rs_new / torch.maximum(rs, eps), zero)
        p = r + beta_k * p
        rs = rs_new
    return x


# dense-bottom size cap: largest level solved by the direct (pseudo)inverse
DENSE_BOTTOM_DOFS = 512


def _bottom_dense_inv(lev: MGLevelData, a, b, bc):
    """The bottom level's operator applied to the identity basis (a
    trailing batch dim) and inverted once per solve; None when the level
    is too big to materialize (the CG bottom then runs). Cells with a
    (near-)zero diagonal get identity rows; singular operators get a
    rank-1 shift off the constants nullspace."""
    shape = lev.shape
    ndof = int(np.prod(shape))
    if ndof > 4096:
        return None
    dtype, dev = lev.alpha.dtype, lev.alpha.device
    eye = torch.eye(ndof, dtype=dtype, device=dev).reshape(shape + (ndof,))
    A = apply_op(_pad_phi(eye, bc), lev.alpha.unsqueeze(-1),
                 tuple(bd.unsqueeze(-1) for bd in lev.beta), a, b, lev.dx,
                 shape).reshape(ndof, ndof)  # A[i, j] = (L e_j)_i
    scale = invariant_mean(torch.abs(lev.diag))
    alive = (torch.abs(lev.diag) > 1e-10 * scale).to(dtype).reshape(-1)
    A = A + torch.diag(1.0 - alive)
    if _singular(a, bc, len(shape)):
        w = alive / torch.linalg.norm(alive)
        A = A + scale * torch.outer(w, w)
    return torch.linalg.inv_ex(A)[0], alive


def _bottom_solve(rhs, lev: MGLevelData, a, b, bc, binv):
    if binv is None:
        return _bottom_cg(rhs, lev, a, b, bc)
    inv, alive = binv
    singular = _singular(a, bc, len(lev.shape))
    nalive = invariant_sum(alive)
    r = alive * rhs.reshape(-1)
    if singular:
        r = alive * (r - invariant_sum(r) / nalive)
    x = alive * invariant_matvec(inv, r)
    if singular:
        x = alive * (x - invariant_sum(x) / nalive)
    return x.reshape(lev.shape)


def _use_dense_bottom() -> bool:
    return os.environ.get("IAMR_BOTTOM", "") != "cg"


def _vcycle(rhs, levels, a, b, bc, lev_idx, nu1, nu2, nu_bottom, binv=None):
    lev = levels[lev_idx]
    dim = len(lev.shape)
    phi = torch.zeros_like(rhs)
    if lev_idx == len(levels) - 1:
        if binv is not None:
            return _bottom_solve(rhs, lev, a, b, bc, binv)
        phi, _ = _smooth2(phi, rhs, lev, a, b, bc, min(nu_bottom, 4), False)
        return phi + _bottom_cg(
            rhs - apply_op(_pad_phi(phi, bc), lev.alpha, lev.beta, a, b, lev.dx, lev.shape),
            lev, a, b, bc,
        )
    phi, r = _smooth2(phi, rhs, lev, a, b, bc, nu1, True)
    e_c = _vcycle(_coarsen_cell(r, dim), levels, a, b, bc, lev_idx + 1, nu1, nu2,
                  nu_bottom, binv)
    phi = phi + _prolong(e_c, dim)
    return _smooth_rb(phi, rhs, lev, a, b, bc, nu2)


def union_dirichlet_coeffs(mask, alpha, beta, a, b, dx):
    """Multi-box level coefficient transform: not ported (single box)."""
    raise NotImplementedError("multi-box (union) solves are not ported")


def mg_solve(
    rhs,
    alpha,
    beta,
    a: float,
    b,
    dx: Sequence[float],
    bc: PoissonBC,
    phi0=None,
    bvals: Optional[Dict] = None,
    rtol: float = 1e-11,
    atol: float = 1e-16,
    max_vcycles: int = 100,
    nu1: int = 2,
    nu2: int = 2,
    nu_bottom: int = 16,
    fixed_cycles: Optional[int] = None,
    mixed: Optional[bool] = None,
    interior_mask=None,
    interior_vals=None,
):
    """Solve (a alpha - b div(beta grad)) phi = rhs; returns
    (phi, final max-norm residual as a 0-d tensor, V-cycles taken).

    b: a float or a 0-d tensor (theta dt). Singular problems (a = 0, no
    Dirichlet side) are demeaned: rhs once, phi after every cycle.
    fixed_cycles: run exactly that many V-cycles, reading nothing back;
    else iterate to max|r| <= max(rtol max|rhs|, atol)."""
    if interior_mask is not None or interior_vals is not None:
        raise NotImplementedError("multi-box (union) solves are not ported")
    dim = rhs.ndim
    dtype = rhs.dtype
    shape = tuple(rhs.shape)
    phi = torch.zeros_like(rhs) if phi0 is None else phi0
    singular = _singular(a, bc, dim)

    if bvals:
        g = _boundary_lift(shape, bc, bvals, dtype, rhs.device)
        rhs = rhs - apply_op(g, alpha, beta, a, b, dx, shape)
    if singular:
        rhs = rhs - invariant_mean(rhs)

    dense = _use_dense_bottom()
    stop = DENSE_BOTTOM_DOFS if dense else 0
    levels = build_hierarchy(alpha, beta, a, b, dx, bc, stop_dofs=stop)
    use_mixed = dtype == torch.float64 and bool(mixed)
    if use_mixed:
        f32 = torch.float32
        b32 = b.to(f32) if isinstance(b, torch.Tensor) else b
        cyc_levels = build_hierarchy(alpha.to(f32), tuple(bd.to(f32) for bd in beta),
                                     a, b32, dx, bc, stop_dofs=stop)
        cyc_b = b32
    else:
        cyc_levels, cyc_b = levels, b
    binv = _bottom_dense_inv(cyc_levels[-1], a, cyc_b, bc) if dense else None

    bnorm = torch.max(torch.abs(rhs))
    tol = torch.clamp(rtol * bnorm, min=atol)

    def residual(phi):
        return _residual(phi, rhs, levels[0], a, b, bc)

    def do_cycle(phi, r):
        e = _vcycle(r.to(cyc_levels[0].alpha.dtype), cyc_levels, a, cyc_b, bc, 0,
                    nu1, nu2, nu_bottom, binv).to(dtype)
        phi = phi + e
        if singular:
            phi = phi - invariant_mean(phi)
        return phi, residual(phi)

    r = residual(phi)
    if fixed_cycles is not None:
        for _ in range(fixed_cycles):
            phi, r = do_cycle(phi, r)
        return phi, torch.max(torch.abs(r)), int(fixed_cycles)

    res = torch.max(torch.abs(r))
    it = 0
    while it < max_vcycles and bool(res > tol):
        phi, r = do_cycle(phi, r)
        res = torch.max(torch.abs(r))
        it += 1
    return phi, res, it


def get_fluxes(phi, beta, b: float, dx, bc: PoissonBC, bvals: Optional[Dict] = None):
    """-b * beta * grad(phi) on all faces (tuple, shape +1 in dim d)."""
    dim = phi.ndim
    phi_g = _pad_phi(phi, bc)
    if bvals:
        phi_g = phi_g + _boundary_lift(tuple(phi.shape), bc, bvals, phi.dtype, phi.device)
    fluxes = []
    for d in range(dim):
        idx_all = [slice(1, -1)] * dim
        idx_all[d] = slice(None)
        line = phi_g[tuple(idx_all)]
        grad = (sl(line, d, 1, None) - sl(line, d, 0, -1)) / dx[d]
        fluxes.append(-b * beta[d] * grad)
    return tuple(fluxes)
