"""Crank-Nicolson diffusion (counterpart of iamr_tpu/solvers/diffusion.py).

diffuse_scalar solves
    (alpha_op - theta dt div beta grad) S^{n+1}
        = alpha_new S* + (1-theta) dt div beta grad S^n
The implicit solve is the all-periodic constant-coefficient FFT solve
(spectral) or the cell multigrid (ops/mg.py), warm-started from S*;
theta == 0 is the explicit update. The multi-box (union) solves are not
ported.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from iamr_tpu_torch.core.bc import BCRec, MathBC
from iamr_tpu_torch.ops import mg
from iamr_tpu_torch.ops.mg import DIRICHLET, NEUMANN, PERIODIC, PoissonBC
from iamr_tpu_torch.solvers.spectral import solve_cell_helmholtz


def poisson_bc_from_bcrec(bcrec: BCRec) -> PoissonBC:
    """ext_dir / reflect_odd -> Dirichlet, int_dir -> periodic, the
    extrapolating and even kinds -> Neumann (zero diffusive flux)."""

    def kind(b: MathBC):
        if b == MathBC.int_dir:
            return PERIODIC
        if b in (MathBC.ext_dir, MathBC.reflect_odd):
            return DIRICHLET
        return NEUMANN

    return PoissonBC(lo=tuple(kind(b) for b in bcrec.lo), hi=tuple(kind(b) for b in bcrec.hi))


def bvals_from_scalar(bcrec: BCRec, vals_lo, vals_hi, dim) -> Dict:
    """Dirichlet face values for ext_dir sides (reflect_odd gives 0)."""
    out = {}
    for d in range(dim):
        if bcrec.lo[d] == MathBC.ext_dir:
            out[(d, 0)] = vals_lo[d]
        elif bcrec.lo[d] == MathBC.reflect_odd:
            out[(d, 0)] = 0.0
        if bcrec.hi[d] == MathBC.ext_dir:
            out[(d, 1)] = vals_hi[d]
        elif bcrec.hi[d] == MathBC.reflect_odd:
            out[(d, 1)] = 0.0
    return out


def _solver_bc(bcrec: BCRec, dim, bvals_lo, bvals_hi, poisson_bc, poisson_bvals):
    """The solve's PoissonBC and Dirichlet values: the given ones, else
    derived from the ghost-fill BCRec and its ext_dir values."""
    if poisson_bc is not None:
        return poisson_bc, poisson_bvals or {}
    vals_lo = bvals_lo if bvals_lo is not None else (0.0,) * dim
    vals_hi = bvals_hi if bvals_hi is not None else (0.0,) * dim
    return poisson_bc_from_bcrec(bcrec), bvals_from_scalar(bcrec, vals_lo, vals_hi, dim)


def apply_diffusion_op(s, beta, dx, bc: PoissonBC, bvals: Optional[Dict] = None):
    """Explicit div(beta grad s) with inhomogeneous BCs."""
    shape = tuple(s.shape)
    phi_g = mg._pad_phi(s, bc)
    if bvals:
        phi_g = phi_g + mg._boundary_lift(shape, bc, bvals, s.dtype, s.device)
    # the operator is (a alpha - b div beta grad): a=0, b=-1 gives +div beta grad
    return mg.apply_op(phi_g, torch.zeros_like(s), beta, 0.0, -1.0, dx, shape)


def diffuse_scalar(
    s_star,
    s_old,
    alpha_new,
    alpha_old,
    beta,
    dt,
    dx: Sequence[float],
    bcrec: BCRec,
    bvals_lo=None,
    bvals_hi=None,
    theta: float = 0.5,
    rtol: float = 1e-10,
    atol: float = 1e-14,
    fixed_cycles: Optional[int] = None,
    poisson_bc: Optional[PoissonBC] = None,
    poisson_bvals: Optional[Dict] = None,
    alpha_op=None,
    spectral=None,
):
    """CN diffusion update after advection; returns (S^{n+1}, (res, it)),
    or (S^{n+1}, None) for the explicit theta == 0 update.

    spectral: optional (alpha0, beta0) scalars of an all-periodic
    constant-coefficient solve (the FFT Helmholtz solve); otherwise the
    cell multigrid solves to rtol/atol (or fixed_cycles V-cycles) from
    s_star."""
    bc, bvals = _solver_bc(bcrec, s_star.ndim, bvals_lo, bvals_hi, poisson_bc, poisson_bvals)
    lap_old = apply_diffusion_op(s_old, beta, dx, bc, bvals)
    rhs = alpha_new * s_star + (1.0 - theta) * dt * lap_old
    if alpha_op is None:
        alpha_op = alpha_new
    if theta == 0.0:
        return rhs / alpha_op, None
    if spectral is not None:
        alpha0, beta0 = spectral
        s_new = solve_cell_helmholtz(rhs, alpha0, theta * dt * beta0, dx)
        return s_new, (torch.zeros((), dtype=s_star.dtype, device=s_star.device), 0)
    s_new, res, it = mg.mg_solve(rhs, alpha_op, beta, 1.0, theta * dt, dx, bc,
                                 phi0=s_star, bvals=bvals, rtol=rtol, atol=atol,
                                 fixed_cycles=fixed_cycles)
    return s_new, (res, it)


def visc_terms_component(
    u,
    mu_faces,
    dx,
    bcrec: BCRec,
    bvals_lo=None,
    bvals_hi=None,
    poisson_bc: Optional[PoissonBC] = None,
    poisson_bvals: Optional[Dict] = None,
):
    """Explicit viscous term div mu grad u (getViscTerms)."""
    bc, bvals = _solver_bc(bcrec, u.ndim, bvals_lo, bvals_hi, poisson_bc, poisson_bvals)
    return apply_diffusion_op(u, mu_faces, dx, bc, bvals)
