"""MAC projection (counterpart of iamr_tpu/solvers/mac.py).

Solves div((1/rho)_faces grad phi) = div(u_mac) - S and corrects
u_mac <- u_mac - (1/rho) grad phi, so div(u_mac) = S. Face coefficients are
arithmetic averages of 1/rho. The solve is the all-periodic uniform-density
FFT solve (spectral_beta0) or the cell multigrid (ops/mg.py). In RZ (2D
axisymmetric) the coefficients and the velocities are weighted by radius,
under EB by the area fractions (the cut-cell operator). The multi-box
projection is not ported.
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
    rz=None,
    eb=None,
):
    """Project the MAC velocities; returns (umac_corrected, phi, (res, it)).

    spectral_beta0: scalar 1/rho of an all-periodic uniform-density run; the
    Poisson solve then runs in Fourier space (solvers.spectral). Otherwise
    the cell multigrid solves -div(beta grad phi) = -div(u_mac) from phi0,
    to rtol/atol or for fixed_cycles V-cycles, and the faces of
    non-periodic, non-outflow sides keep their velocity.

    rz: (r_cell, r_face) of a 2D axisymmetric run (the reference's radMult
    scaling): the solve is d(r b phi_r)/dr + d(r b phi_z)/dz =
    d(r u_r)/dr + d(r u_z)/dz - r S, the correction u -= b grad phi is
    unscaled, and the FFT solve is not used.

    eb: the level's EBData (MLEBABecLap): the face coefficients are scaled
    by the area fractions and the covered cells pinned by the identity
    (alpha = covered, a = b = 1), so that the corrected velocities meet the
    cut-cell constraint sum_d d(afrac u)/dx_d = vfrac S; faces without area
    carry no velocity. It takes precedence over rz and the FFT solve."""
    dim = rho.ndim
    if bc is None:
        bc = mac_poisson_bc(dom)
    beta = beta_from_rho(rho, dom)
    beta_op = beta
    alpha, a = torch.zeros_like(rho), 0.0
    if eb is not None:
        beta_op = tuple(b * af for b, af in zip(beta, eb.afrac))
        div = mac_div(tuple(af * u for af, u in zip(eb.afrac, umac)), dx)
        if divu_src is not None:
            div = div - eb.vfrac * divu_src
        alpha, a = eb.covered, 1.0
    elif rz is not None:
        r_cell, r_face = rz
        beta_op = (r_face * beta[0], r_cell * beta[1])
        div = mac_div((r_face * umac[0], r_cell * umac[1]), dx)
        if divu_src is not None:
            div = div - r_cell * divu_src
    else:
        div = mac_div(umac, dx)
        if divu_src is not None:
            div = div - divu_src
    if spectral_beta0 is not None and rz is None and eb is None:
        phi = solve_cell_helmholtz(-div, 0.0, spectral_beta0, dx)
        corr = mg.get_fluxes(phi, beta, 1.0, dx, bc, bvals=bvals)
        umac_new = tuple(umac[d] + corr[d] for d in range(dim))
        return umac_new, phi, (torch.zeros((), dtype=rho.dtype, device=rho.device), 0)

    # the operator is (a alpha - b div beta grad): a = 0, b = 1 gives
    # -div(beta grad phi) = -div
    phi, res, it = mg.mg_solve(-div, alpha, beta_op, a, 1.0, dx, bc, phi0=phi0, bvals=bvals,
                               rtol=rtol, atol=atol, fixed_cycles=fixed_cycles)
    corr = mg.get_fluxes(phi, beta, 1.0, dx, bc, bvals=bvals)
    umac_new = []
    for d in range(dim):
        u = umac[d] + corr[d]
        if eb is not None:
            u = u * (eb.afrac[d] > 0.0)
        # no correction through non-periodic, non-outflow boundaries
        if bc.lo[d] == NEUMANN:
            u.narrow(d, 0, 1).copy_(umac[d].narrow(d, 0, 1))
        if bc.hi[d] == NEUMANN:
            u.narrow(d, u.shape[d] - 1, 1).copy_(umac[d].narrow(d, u.shape[d] - 1, 1))
        umac_new.append(u)
    return tuple(umac_new), phi, (res, it)
