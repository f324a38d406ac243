"""Nodal approximate projection, single level
(counterpart of iamr_tpu/solvers/nodal_proj.py), spectral branch.

    Vs = U*/dt + Gp^{n-1/2}/rho_half
    solve  L(phi) = D(Vs)                (sigma = 1/rho_half)
    U^{n+1} = (Vs - sigma G(phi)) * dt;  p^{n+1/2} = phi;  Gp = G(phi)

Only the all-periodic uniform-density FFT solve is ported; the nodal
multigrid (and with it the initial velocity projection), EB, RZ and
multi-box projections raise.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from iamr_tpu.core.bc import DomainBC, PhysBC
from iamr_tpu_torch.ops.mg_nodal import (
    N_DIRICHLET,
    N_NEUMANN,
    N_PERIODIC,
    NodalBC,
    avg_cell_to_node,
    div_cell_to_node,
    grad_node_to_cell,
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


def level_project(
    vel_star,
    rho_half,
    p_old,
    gradp_old,
    dt,
    dom: DomainBC,
    dx: Sequence[float],
    bc: Optional[NodalBC] = None,
    phi_bc=None,
    divu_src=None,
    spectral_sigma0=None,
):
    """Approximate nodal projection of the provisional velocity; returns
    (vel_new, p_new, gradp_new, stats). spectral_sigma0: scalar 1/rho_half
    of an all-periodic uniform-density run (the FFT solve); p_old, the
    multigrid's warm start, is unused by it. The multigrid solve (needed
    without spectral_sigma0 or with Dirichlet phi_bc values) and the EB, RZ
    and multi-box projections are not ported yet."""
    if spectral_sigma0 is None or phi_bc is not None:
        raise NotImplementedError("the nodal multigrid solve is not ported (spectral only)")
    dim = rho_half.ndim
    if bc is None:
        bc = nodal_bc(dom)
    sigma = 1.0 / rho_half
    vs = tuple(vel_star[d] / dt + gradp_old[d] * sigma for d in range(dim))
    # prescribed inflow normal velocity enters the divergence, scaled like vs
    inflow_vals = {
        (d, s): dom.value(d, s, d) / dt
        for d in range(dim)
        for s, p in ((0, dom.phys_lo[d]), (1, dom.phys_hi[d]))
        if p == PhysBC.Inflow
    }
    rhs = div_cell_to_node(vs, dx, bc, inflow_vals)
    if divu_src is not None:
        rhs = rhs - avg_cell_to_node(divu_src, bc) / dt
    phi = solve_nodal_poisson(rhs, spectral_sigma0, dx)
    gphi = grad_node_to_cell(phi, dx)
    vel_new = torch.stack([(vs[d] - sigma * gphi[d]) * dt for d in range(dim)])
    gradp_new = torch.stack(list(gphi))
    zero = torch.zeros((), dtype=rho_half.dtype, device=rho_half.device)
    return vel_new, phi, gradp_new, (zero, 0)
