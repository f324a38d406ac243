"""Nodal approximate projection, single level
(counterpart of iamr_tpu/solvers/nodal_proj.py).

    Vs = U*/dt + Gp^{n-1/2}/rho_half
    solve  L(phi) = D(Vs)                (sigma = 1/rho_half)
    U^{n+1} = (Vs - sigma G(phi)) * dt;  p^{n+1/2} = phi;  Gp = G(phi)

The solve is the all-periodic uniform-density FFT solve (spectral_sigma0)
or the nodal multigrid (ops/mg_nodal.py), warm-started from p^{n-1/2}.
initial_velocity_project is the initial projection of driver.initialize,
initial_pressure_project its hydrostatic start of gravity runs, and
hydrostatic_phi_bc the Dirichlet phi of outflow faces under gravity. In RZ
(2D axisymmetric) sigma, the velocity and the divergence source are
weighted by the cell radius and the correction stays unscaled; under EB
(MLNodeLaplacian's EB form) they are weighted by the volume fraction and
the covered cells' velocity and Gp are zero. The multi-box projection is
not ported.
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
    rz=None,
    eb=None,
):
    """Approximate nodal projection of the provisional velocity; returns
    (vel_new, p_new, gradp_new, (res, it)). spectral_sigma0: scalar
    1/rho_half of an all-periodic uniform-density run (the FFT solve, used
    when no Dirichlet phi_bc values are given and not in RZ). Otherwise the
    nodal multigrid solves to rtol/atol (or fixed_cycles V-cycles),
    warm-started from p_old: p^{n-1/2} solves the same equation one step
    earlier. rz: (r_cell, r_face) of a 2D axisymmetric run. eb: the
    level's EBData; sigma, Vs and S are weighted by vfrac, the solve starts
    from zero (the covered nodes, whose diagonal is zero, would keep
    p_old's values) and never in Fourier space, and the covered cells'
    velocity and Gp are zero."""
    dim = rho_half.ndim
    if bc is None:
        bc = nodal_bc(dom)
    sigma = 1.0 / rho_half
    vs = tuple(vel_star[d] / dt + gradp_old[d] * sigma for d in range(dim))
    # prescribed inflow normal velocity enters the divergence, scaled like vs
    inflow = _inflow_vals(dom, dim, dt)
    # sigma, U and S weighted by vfrac (EB) or the cell radius (scaleVar
    # radMult)
    wgt = eb.vfrac if eb is not None else rz[0] if rz is not None else None
    sigma_op = sigma if wgt is None else sigma * wgt
    rhs = div_cell_to_node(vs if wgt is None else tuple(wgt * v for v in vs), dx, bc, inflow)
    if divu_src is not None:
        src = divu_src if wgt is None else wgt * divu_src
        rhs = rhs - avg_cell_to_node(src, bc) / dt
    if spectral_sigma0 is not None and phi_bc is None and wgt is None:
        phi = solve_nodal_poisson(rhs, spectral_sigma0, dx)
        res, it = torch.zeros((), dtype=rho_half.dtype, device=rho_half.device), 0
    else:
        # the phi_bc lifting assumes the lifted part starts homogeneous
        warm = tuple(p_old.shape) == tuple(rhs.shape) and phi_bc is None and eb is None
        phi, res, it = nodal_solve(rhs, sigma_op, dx, bc, phi0=p_old if warm else None,
                                   rtol=rtol, atol=atol, fixed_cycles=fixed_cycles,
                                   phi_bc=phi_bc)
    gphi = grad_node_to_cell(phi, dx)
    vel_new = torch.stack([(vs[d] - sigma * gphi[d]) * dt for d in range(dim)])
    gradp_new = torch.stack(list(gphi))
    if eb is not None:
        vel_new, gradp_new = vel_new * eb.fluid, gradp_new * eb.fluid
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
    rz=None,
    eb=None,
):
    """Make the initial velocity divergence-free (initialVelocityProject):
    solve L(phi) = D(U) with sigma = 1/rho, U <- U - sigma G(phi); the
    initial pressure stays zero. rz: (r_cell, r_face) of a 2D axisymmetric
    run, whose sigma and U are weighted by the cell radius; eb: the level's
    EBData, weighting them by vfrac and zeroing the covered cells' velocity.
    divu_src: a node array, subtracted as it is. Returns (vel_new, (res,
    it))."""
    dim = rho.ndim
    bc = nodal_bc(dom)
    sigma = 1.0 / rho
    u = tuple(vel[d] for d in range(dim))
    wgt = eb.vfrac if eb is not None else rz[0] if rz is not None else None
    sigma_op = sigma if wgt is None else sigma * wgt
    rhs = div_cell_to_node(u if wgt is None else tuple(wgt * ud for ud in u), dx, bc,
                           _inflow_vals(dom, dim))
    if divu_src is not None:
        rhs = rhs - divu_src
    phi, res, it = nodal_solve(rhs, sigma_op, dx, bc, rtol=rtol, atol=atol,
                               fixed_cycles=fixed_cycles)
    gphi = grad_node_to_cell(phi, dx)
    vel_new = torch.stack([u[d] - sigma * gphi[d] for d in range(dim)])
    if eb is not None:
        vel_new = vel_new * eb.fluid
    return vel_new, (res, it)


def initial_pressure_project(
    rho,
    gravity: float,
    dom: DomainBC,
    dx: Sequence[float],
    geom=None,
    rtol: float = 1e-12,
    atol: float = 1e-16,
    fixed_cycles: Optional[int] = None,
    eb=None,
):
    """Hydrostatic initial pressure of gravity runs
    (initialPressureProject): project the body-force field (0, ..., 0, g)
    with sigma = 1/rho (under EB both weighted by vfrac); phi is the
    hydrostatic pressure and Gp its nodal gradient. Given geom, outflow
    faces take hydrostatic_phi_bc's values. Returns (p, gradp)."""
    dim = rho.ndim
    bc = nodal_bc(dom)
    g = torch.full_like(rho, gravity)
    u = tuple(g if d == dim - 1 else torch.zeros_like(rho) for d in range(dim))
    sigma = 1.0 / rho
    if eb is not None:
        sigma, u = sigma * eb.vfrac, tuple(eb.vfrac * ud for ud in u)
    phi_bc = hydrostatic_phi_bc(geom, dom, rho, gravity) if geom is not None else None
    phi, _, _ = nodal_solve(div_cell_to_node(u, dx, bc), sigma, dx, bc, rtol=rtol,
                            atol=atol, fixed_cycles=fixed_cycles, phi_bc=phi_bc)
    return phi, torch.stack(list(grad_node_to_cell(phi, dx)))


def hydrostatic_phi_bc(geom, dom: DomainBC, rho, gravity: float):
    """Dirichlet phi of outflow faces under gravity (set_outflow_bcs with
    computeRhoG): 0 on a top outflow face; on a lateral one, phi integrated
    down from the top, each cell row adding -gravity rhoExt dh with rhoExt =
    (3 rho_1 - rho_2)/2 extrapolated to the face. A bottom outflow face
    with gravity raises, as the reference aborts there. Returns a node
    array (zero off the outflow faces), or None when no face needs values."""
    dim = rho.ndim
    g = float(gravity)
    if abs(g) < 1e-4:
        return None
    zdim = dim - 1
    out = None
    for d in range(dim):
        for side in (0, 1):
            if (dom.phys_lo[d] if side == 0 else dom.phys_hi[d]) != PhysBC.Outflow:
                continue
            if d == zdim:
                if side == 1:
                    continue  # top outflow: phi = 0, the default
                raise NotImplementedError(
                    "outflow at the bottom with gravity != 0 (the reference aborts "
                    "here too)")
            if out is None:
                out = torch.zeros(tuple(s + 1 for s in rho.shape), dtype=rho.dtype,
                                  device=rho.device)
            m = rho.shape[d]
            rho1 = rho.narrow(d, 0 if side == 0 else m - 1, 1)
            rho2 = rho.narrow(d, 1 if side == 0 else m - 2, 1)
            w = -g * geom.dx[zdim] * (0.5 * (3.0 * rho1 - rho2)).squeeze(d)
            # the vertical axis once d is squeezed out
            zax = zdim - (1 if d < zdim else 0)
            # each row's phi: the rows' -g rhoExt dh summed from the top; the
            # top node carries 0
            rows = torch.flip(torch.cumsum(torch.flip(w, (zax,)), dim=zax), (zax,))
            nodes = torch.cat([rows, torch.zeros_like(rows.narrow(zax, 0, 1))], dim=zax)
            # the other transverse dims: cells to nodes by averaging
            for e in range(dim):
                ax = e - (1 if d < e else 0)
                if e == d or ax == zax:
                    continue
                k = nodes.shape[ax]
                inner = 0.5 * (nodes.narrow(ax, 0, k - 1) + nodes.narrow(ax, 1, k - 1))
                nodes = torch.cat([nodes.narrow(ax, 0, 1), inner, nodes.narrow(ax, k - 1, 1)],
                                  dim=ax)
            out.narrow(d, 0 if side == 0 else m, 1).copy_(nodes.unsqueeze(d))
    return out
