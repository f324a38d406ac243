"""Implicit tensor-viscosity solve, single level (counterpart of
iamr_tpu/solvers/tensor.py; the reference's MLTensorOp velocity solve).

The velocity diffusion of a variable-viscosity (LES) run solves the stress
divergence implicitly:

    (alpha - theta dt div tau) U^{n+1} = alpha U* + (1 - theta) dt div tau(U^n)
    tau_ij = mu (d_j u_i + d_i u_j)

as a segregated iteration over the components: each outer pass solves the
componentwise scalar system

    (alpha - theta dt div mu grad) u_c = rhs_c + theta dt X_c(u^k)

with the transpose part X_c(u) = sum_j d_j(mu d_c u_j) lagged at the
previous iterate, each through the cell multigrid (ops/mg.py, whose
smoother is the mg_cell_gsrb kernel on the card).

Also here: the implicit solves on AMR's sync corrections (diffuse_vsync,
diffuse_ssync; the reference's diffuse_Vsync / diffuse_Ssync).
"""

from __future__ import annotations

from typing import Optional

import torch

from iamr_tpu_torch.ns.les import tensor_cross_terms
from iamr_tpu_torch.ops import mg
from iamr_tpu_torch.solvers import diffusion as diff

# segregated outer passes: 3 take the splitting error below the CN
# truncation error at CFL-limited dt
N_OUTER = 3


def tensor_visc_terms(cfg, bcp, vel, mu_f):
    """Explicit div(tau) = div(mu grad u_c) + X_c(u) per component
    (getTensorViscTerms)."""
    comps = []
    for c in range(cfg.dim):
        vbc, vbv = bcp.vel_diff_bc(c)
        comps.append(diff.visc_terms_component(vel[c], mu_f, cfg.geom.dx, None,
                                               poisson_bc=vbc, poisson_bvals=vbv))
    return torch.stack(comps) + tensor_cross_terms(cfg, bcp, vel, mu_f)


def diffuse_tensor_velocity(
    cfg,
    bcp,
    vel_star,
    vel_old,
    alpha,
    mu_f,
    dt,
    theta: float,
    rtol: float = 1e-10,
    fixed_cycles: Optional[int] = None,
):
    """The CN tensor solve (alpha - theta dt div tau) U = alpha U* +
    (1 - theta) dt div tau(U^n): alpha multiplies U (pass rho_half) and dt
    is the true dt. N_OUTER segregated passes of dim scalar solves each,
    warm-started from the previous pass (to rtol, or fixed_cycles
    V-cycles each)."""
    dim = cfg.dim
    dx = cfg.geom.dx

    # the old-time explicit part, assembled once (cross + componentwise)
    x_old = tensor_cross_terms(cfg, bcp, vel_old, mu_f)
    rhs = []
    for c in range(dim):
        vbc, vbv = bcp.vel_diff_bc(c)
        lap_old = diff.visc_terms_component(vel_old[c], mu_f, dx, None, poisson_bc=vbc,
                                            poisson_bvals=vbv)
        rhs.append(alpha * vel_star[c] + (1.0 - theta) * dt * (lap_old + x_old[c]))

    u = vel_star
    for _ in range(N_OUTER):
        x_k = tensor_cross_terms(cfg, bcp, u, mu_f)
        comps = []
        for c in range(dim):
            vbc, vbv = bcp.vel_diff_bc(c)
            u_c, _, _ = mg.mg_solve(rhs[c] + theta * dt * x_k[c], alpha, mu_f, 1.0,
                                    theta * dt, dx, vbc, phi0=u[c], bvals=vbv, rtol=rtol,
                                    fixed_cycles=fixed_cycles)
            comps.append(u_c)
        u = torch.stack(comps)
    return u


def diffuse_vsync(cfg, bcp, vsync, rho_half, mu_f, dt, theta: float, rtol: float = 1e-8,
                  fixed_cycles: Optional[int] = None):
    """The implicit viscous solve on the velocity sync correction
    (diffuse_Vsync / diffuse_tensor_Vsync):

        (rho_half - theta dt div mu grad) V = rho_half Vsync

    with the homogeneous form of the velocity BCs (the correction vanishes
    at inflow faces and walls); the cross terms enter through one lagged
    update (the correction is a small field). One scalar solve per
    component."""
    if mu_f is None:
        return vsync
    x_k = tensor_cross_terms(cfg, bcp, vsync, mu_f)
    comps = []
    for c in range(cfg.dim):
        vbc, _ = bcp.vel_diff_bc(c)
        v_c, _, _ = mg.mg_solve(rho_half * vsync[c] + theta * dt * x_k[c], rho_half, mu_f, 1.0,
                                theta * dt, cfg.geom.dx, vbc, phi0=vsync[c], rtol=rtol,
                                fixed_cycles=fixed_cycles)
        comps.append(v_c)
    return torch.stack(comps)


def diffuse_ssync(cfg, bcp, ssync, rho_new, beta_f, dt, theta: float, scomp: int,
                  rtol: float = 1e-8, fixed_cycles: Optional[int] = None):
    """The implicit diffusion solve on a scalar sync correction
    (diffuse_Ssync): (rho^{n+1} - theta dt div beta grad) S = rho^{n+1} Ssync,
    with the homogeneous form of the scalar's BCs."""
    if beta_f is None:
        return ssync
    sbc, _ = bcp.scal_diff_bc(scomp)
    s, _, _ = mg.mg_solve(rho_new * ssync, rho_new, beta_f, 1.0, theta * dt, cfg.geom.dx, sbc,
                          phi0=ssync, rtol=rtol, fixed_cycles=fixed_cycles)
    return s
