"""MAC projection (counterpart of iamr_tpu/solvers/mac.py).

Solves div((1/rho)_faces grad phi) = div(u_mac) - S and corrects
u_mac <- u_mac - (1/rho) grad phi, so div(u_mac) = S. Face coefficients are
arithmetic averages of 1/rho. The solve is the all-periodic uniform-density
FFT solve (spectral_beta0) or the cell multigrid (ops/mg.py); the EB, RZ
and multi-box projections are not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from iamr_tpu_torch.core.bc import DomainBC, PhysBC
from iamr_tpu_torch.ops import mg
from iamr_tpu_torch.ops.mg import DIRICHLET, NEUMANN, PERIODIC, PoissonBC
from iamr_tpu_torch.ops.stencil import cell_to_face, mac_div
from iamr_tpu_torch.solvers.spectral import solve_cell_helmholtz


def mac_poisson_bc(dom: DomainBC) -> PoissonBC:
    """Physical BC -> MAC Poisson BC (outflow: homogeneous Dirichlet phi)."""
    def kind(p: PhysBC):
        if p == PhysBC.Interior:
            return PERIODIC
        if p == PhysBC.Outflow:
            return DIRICHLET
        return NEUMANN

    return PoissonBC(
        lo=tuple(kind(p) for p in dom.phys_lo),
        hi=tuple(kind(p) for p in dom.phys_hi),
    )


def beta_from_rho(rho, dom: DomainBC):
    """(1/rho) averaged to faces; periodic dims wrap."""
    inv = 1.0 / rho
    return tuple(
        cell_to_face(inv, d, bc_wrap=dom.is_periodic(d)) for d in range(rho.ndim)
    )


def mac_project(
    umac,
    rho,
    dom: DomainBC,
    dx: Sequence[float],
    divu_src=None,
    phi0=None,
    rtol: float = 1e-12,
    atol: float = 1e-16,
    fixed_cycles: Optional[int] = None,
    bc: Optional[PoissonBC] = None,
    bvals=None,
    spectral_beta0=None,
):
    """Project the MAC velocities; returns (umac_corrected, phi, (res, it)).

    spectral_beta0: scalar 1/rho of an all-periodic uniform-density run; the
    Poisson solve then runs in Fourier space (solvers.spectral). Otherwise
    the cell multigrid solves -div(beta grad phi) = -div(u_mac) from phi0,
    to rtol/atol or for fixed_cycles V-cycles, and the faces of
    non-periodic, non-outflow sides keep their velocity."""
    dim = rho.ndim
    if bc is None:
        bc = mac_poisson_bc(dom)
    beta = beta_from_rho(rho, dom)
    div = mac_div(umac, dx)
    if divu_src is not None:
        div = div - divu_src
    if spectral_beta0 is not None:
        phi = solve_cell_helmholtz(-div, 0.0, spectral_beta0, dx)
        corr = mg.get_fluxes(phi, beta, 1.0, dx, bc, bvals=bvals)
        umac_new = tuple(umac[d] + corr[d] for d in range(dim))
        return umac_new, phi, (torch.zeros((), dtype=rho.dtype, device=rho.device), 0)

    # the operator is (a alpha - b div beta grad): a = 0, b = 1 gives
    # -div(beta grad phi) = -div
    phi, res, it = mg.mg_solve(-div, torch.zeros_like(rho), beta, 0.0, 1.0, dx, bc,
                               phi0=phi0, bvals=bvals, rtol=rtol, atol=atol,
                               fixed_cycles=fixed_cycles)
    corr = mg.get_fluxes(phi, beta, 1.0, dx, bc, bvals=bvals)
    umac_new = []
    for d in range(dim):
        u = umac[d] + corr[d]
        # no correction through non-periodic, non-outflow boundaries
        if bc.lo[d] == NEUMANN:
            u.narrow(d, 0, 1).copy_(umac[d].narrow(d, 0, 1))
        if bc.hi[d] == NEUMANN:
            u.narrow(d, u.shape[d] - 1, 1).copy_(umac[d].narrow(d, u.shape[d] - 1, 1))
        umac_new.append(u)
    return tuple(umac_new), phi, (res, it)
