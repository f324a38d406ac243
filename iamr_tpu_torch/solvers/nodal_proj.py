"""Nodal approximate projection, single level
(counterpart of iamr_tpu/solvers/nodal_proj.py).

    Vs = U*/dt + Gp^{n-1/2}/rho_half
    solve  L(phi) = D(Vs)                (sigma = 1/rho_half)
    U^{n+1} = (Vs - sigma G(phi)) * dt;  p^{n+1/2} = phi;  Gp = G(phi)

The solve is the all-periodic uniform-density FFT solve (spectral_sigma0)
or the nodal multigrid (ops/mg_nodal.py), warm-started from p^{n-1/2}.
initial_velocity_project is the initial projection of driver.initialize.
The EB, RZ and multi-box projections and initial_pressure_project (the
hydrostatic start of gravity runs) are not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from iamr_tpu_torch.core.bc import DomainBC, PhysBC
from iamr_tpu_torch.ops.mg_nodal import (
    N_DIRICHLET,
    N_NEUMANN,
    N_PERIODIC,
    NodalBC,
    avg_cell_to_node,
    div_cell_to_node,
    grad_node_to_cell,
    nodal_solve,
)
from iamr_tpu_torch.solvers.spectral import solve_nodal_poisson


def nodal_bc(dom: DomainBC) -> NodalBC:
    def kind(p: PhysBC):
        if p == PhysBC.Interior:
            return N_PERIODIC
        if p == PhysBC.Outflow:
            return N_DIRICHLET
        return N_NEUMANN

    return NodalBC(
        lo=tuple(kind(p) for p in dom.phys_lo),
        hi=tuple(kind(p) for p in dom.phys_hi),
    )


def _inflow_vals(dom: DomainBC, dim: int, dt=None):
    """Prescribed inflow normal velocities {(d, side): value}, divided by
    dt when given."""
    return {
        (d, s): dom.value(d, s, d) if dt is None else dom.value(d, s, d) / dt
        for d in range(dim)
        for s, p in ((0, dom.phys_lo[d]), (1, dom.phys_hi[d]))
        if p == PhysBC.Inflow
    }


def level_project(
    vel_star,
    rho_half,
    p_old,
    gradp_old,
    dt,
    dom: DomainBC,
    dx: Sequence[float],
    rtol: float = 1e-12,
    atol: float = 1e-16,
    fixed_cycles: Optional[int] = None,
    bc: Optional[NodalBC] = None,
    phi_bc=None,
    divu_src=None,
    spectral_sigma0=None,
):
    """Approximate nodal projection of the provisional velocity; returns
    (vel_new, p_new, gradp_new, (res, it)). spectral_sigma0: scalar
    1/rho_half of an all-periodic uniform-density run (the FFT solve, used
    when no Dirichlet phi_bc values are given). Otherwise the nodal
    multigrid solves to rtol/atol (or fixed_cycles V-cycles), warm-started
    from p_old: p^{n-1/2} solves the same equation one step earlier."""
    dim = rho_half.ndim
    if bc is None:
        bc = nodal_bc(dom)
    sigma = 1.0 / rho_half
    vs = tuple(vel_star[d] / dt + gradp_old[d] * sigma for d in range(dim))
    # prescribed inflow normal velocity enters the divergence, scaled like vs
    rhs = div_cell_to_node(vs, dx, bc, _inflow_vals(dom, dim, dt))
    if divu_src is not None:
        rhs = rhs - avg_cell_to_node(divu_src, bc) / dt
    if spectral_sigma0 is not None and phi_bc is None:
        phi = solve_nodal_poisson(rhs, spectral_sigma0, dx)
        res, it = torch.zeros((), dtype=rho_half.dtype, device=rho_half.device), 0
    else:
        # the phi_bc lifting assumes the lifted part starts homogeneous
        phi0 = p_old if tuple(p_old.shape) == tuple(rhs.shape) and phi_bc is None else None
        phi, res, it = nodal_solve(rhs, sigma, dx, bc, phi0=phi0, rtol=rtol, atol=atol,
                                   fixed_cycles=fixed_cycles, phi_bc=phi_bc)
    gphi = grad_node_to_cell(phi, dx)
    vel_new = torch.stack([(vs[d] - sigma * gphi[d]) * dt for d in range(dim)])
    gradp_new = torch.stack(list(gphi))
    return vel_new, phi, gradp_new, (res, it)


def initial_velocity_project(
    vel,
    rho,
    dom: DomainBC,
    dx: Sequence[float],
    divu_src=None,
    rtol: float = 1e-12,
    atol: float = 1e-16,
    fixed_cycles: Optional[int] = None,
):
    """Make the initial velocity divergence-free (initialVelocityProject):
    solve L(phi) = D(U) with sigma = 1/rho, U <- U - sigma G(phi); the
    initial pressure stays zero. Returns (vel_new, (res, it))."""
    dim = rho.ndim
    bc = nodal_bc(dom)
    sigma = 1.0 / rho
    u = tuple(vel[d] for d in range(dim))
    rhs = div_cell_to_node(u, dx, bc, _inflow_vals(dom, dim))
    if divu_src is not None:
        rhs = rhs - divu_src
    phi, res, it = nodal_solve(rhs, sigma, dx, bc, rtol=rtol, atol=atol,
                               fixed_cycles=fixed_cycles)
    gphi = grad_node_to_cell(phi, dx)
    return torch.stack([u[d] - sigma * gphi[d] for d in range(dim)]), (res, it)
