"""MAC projection (counterpart of iamr_tpu/solvers/mac.py), spectral branch.

Solves div((1/rho)_faces grad phi) = div(u_mac) - S and corrects
u_mac <- u_mac - (1/rho) grad phi, so div(u_mac) = S. Face coefficients are
arithmetic averages of 1/rho. Only the all-periodic uniform-density FFT
solve is ported; the multigrid, EB, RZ and multi-box solves raise.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from iamr_tpu.core.bc import DomainBC, PhysBC
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
    bc: Optional[PoissonBC] = None,
    bvals=None,
    spectral_beta0=None,
):
    """Project the MAC velocities; returns (umac_corrected, phi, stats).

    spectral_beta0: scalar 1/rho of an all-periodic uniform-density run; the
    Poisson solve then runs in Fourier space (solvers.spectral). Without it
    the multigrid solve is needed, which is not ported yet (nor are the EB,
    RZ and multi-box projections)."""
    if spectral_beta0 is None:
        raise NotImplementedError("the multigrid MAC solve is not ported (spectral only)")
    dim = rho.ndim
    if bc is None:
        bc = mac_poisson_bc(dom)
    beta = beta_from_rho(rho, dom)
    div = mac_div(umac, dx)
    if divu_src is not None:
        div = div - divu_src
    phi = solve_cell_helmholtz(-div, 0.0, spectral_beta0, dx)
    corr = mg.get_fluxes(phi, beta, 1.0, dx, bc, bvals=bvals)
    umac_new = tuple(umac[d] + corr[d] for d in range(dim))
    return umac_new, phi, (torch.zeros((), dtype=rho.dtype, device=rho.device), 0)
