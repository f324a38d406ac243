"""The Navier-Stokes timestep, single level (counterpart of
iamr_tpu/ns/advance.py).

NavierStokes::advance (Almgren-Bell-Colella-Howell-Welcome JCP 142, 1998):

  1. predict time-centred MAC velocities (Godunov PLM extrapolation with
     forcing (visc + rho g - Gp)/rho; kernel K1 on the GPU)
  2. MAC-project them
  3. Godunov advection of every advected field in one multi-field pass
     (kernel K2 on the GPU): velocity (convective), density (conservative),
     tracers
  4. scalar updates: rho, then tracers with CN diffusion
  5. velocity update u* = u^n - dt aofs + dt (f - Gp)/rho_half, then the
     CN viscous solve
  6. nodal projection -> U^{n+1}, p^{n+1/2}, Gp

Ported path: 3D, single level, PLM, with either the spectral (FFT) solvers
of an all-periodic uniform-density run or the multigrid solvers (cell
red-black Gauss-Seidel, FEM nodal Jacobi), to tolerance or for a fixed
number of V-cycles. EB, RZ, LES, multi-box levels, temperature, BDS/PPM and
use_forces_in_trans raise NotImplementedError. The step runs eagerly on the
tensors' device; in fixed-cycle or spectral mode it reads nothing back to
the host (tolerance mode reads one residual norm per V-cycle).
"""

from __future__ import annotations

import torch

from iamr_tpu_torch.ns.bcprovider import PhysBCProvider
from iamr_tpu_torch.ns.forcing_hit import HITForcing
from iamr_tpu_torch.ns.particles import advect_with_umac
from iamr_tpu_torch.ns.state import NSConfig, NSState
from iamr_tpu_torch.ops.godunov import extrap_vel_to_faces
from iamr_tpu_torch.ops.godunov_kernels import godunov_plm_multi
from iamr_tpu_torch.parallel.reduce import invariant_mean
from iamr_tpu_torch.solvers import diffusion as diff
from iamr_tpu_torch.solvers.mac import mac_project
from iamr_tpu_torch.solvers.nodal_proj import level_project


def mu_faces(cfg: NSConfig, device):
    """Constant-viscosity face coefficients."""
    return beta_faces(cfg, cfg.vel_visc_coef, device)


def beta_faces(cfg: NSConfig, coef: float, device):
    """Face coefficients of the constant `coef` (shape +1 in each face's dim)."""
    n = cfg.geom.ncell
    out = []
    for d in range(cfg.dim):
        shp = list(n)
        shp[d] += 1
        out.append(torch.full(shp, coef, dtype=cfg.tdtype, device=device))
    return tuple(out)


def get_force(cfg: NSConfig, rho, time=None, hit=None):
    """Body force (rho-weighted): rho * gravity in the last dim, plus the
    HIT spectral forcing evaluated at `time`."""
    dim = cfg.dim
    f = [torch.zeros_like(rho) for _ in range(dim)]
    if abs(cfg.gravity) > 1e-4:
        f[dim - 1] = cfg.gravity * rho
    out = torch.stack(f)
    if hit is not None and time is not None:
        out = out + hit.eval(cfg.geom, time, dtype=cfg.tdtype, device=rho.device)
    return out


def make_hit_forcing(cfg: NSConfig):
    """HIT forcing mode tables when configured (turb.* namespace), else None.
    User-registered forcings (the plugin registry) are not ported."""
    if cfg.forcing == "default":
        return None
    if cfg.forcing != "hit":
        raise NotImplementedError(f"forcing {cfg.forcing!r} is not ported")
    return HITForcing.create(
        cfg.geom,
        nmodes=int(cfg.turb_param("nmodes", 4)),
        div_free=bool(cfg.turb_param("div_free_force", 1)),
        mode_start=int(cfg.turb_param("mode_start", 0)),
        force_scale=float(cfg.turb_param("force_scale", 1.0)),
        seed=int(cfg.turb_param("seed", 111397)),
    )


def est_time_step(cfg: NSConfig, state: NSState, hit=None):
    """CFL timestep: cfl * min over dims of dx_d / max|u_d|, with the force
    limit sqrt(2 dx_d / max|f_d|), f = (tforces - Gp)/rho; ns.fixed_dt
    short-circuits. A 0-d tensor (no host read)."""
    dtype, dev = cfg.tdtype, state.rho.device
    if cfg.fixed_dt > 0.0:
        return torch.full((), cfg.fixed_dt, dtype=dtype, device=dev)
    dx = cfg.geom.dx
    small = 1e-8
    dt = torch.full((), 1e20, dtype=dtype, device=dev)
    fallback = torch.full((), 1e20, dtype=dtype, device=dev)
    tf = get_force(cfg, state.rho, state.time, hit)
    inv_rho = 1.0 / state.rho
    ax = tuple(range(1, 1 + cfg.dim))
    maxes = torch.stack([
        torch.amax(torch.abs(state.vel), dim=ax),
        torch.amax(torch.abs((tf - state.gradp) * inv_rho), dim=ax),
        torch.amax(torch.abs(tf * inv_rho), dim=ax),
    ])
    for d in range(cfg.dim):
        umax = maxes[0, d]
        dt = torch.where(
            umax > small, torch.minimum(dt, dx[d] / torch.clamp(umax, min=small)), dt
        )
        fmax = maxes[1, d]
        dt = torch.where(
            fmax > small,
            torch.minimum(dt, torch.sqrt(2.0 * dx[d] / torch.clamp(fmax, min=small))),
            dt,
        )
        # the raw body-force timescale bounds dt only when nothing else does
        fraw = maxes[2, d]
        fallback = torch.where(
            fraw > small,
            torch.minimum(fallback, torch.sqrt(2.0 * dx[d] / torch.clamp(fraw, min=small))),
            fallback,
        )
    ok = dt < 1e19
    if cfg.init_dt > 0.0:
        return torch.where(ok, cfg.cfl * dt, torch.full_like(dt, cfg.init_dt))
    return cfg.cfl * torch.where(ok, dt, fallback)


def _check_supported(cfg: NSConfig):
    if cfg.dim != 3:
        raise NotImplementedError("2D is not ported")
    if cfg.geom.coord_sys != 0:
        raise NotImplementedError("RZ is not ported")
    if cfg.do_les:
        raise NotImplementedError("LES is not ported")
    if cfg.do_temp:
        raise NotImplementedError("ns.do_temp is not ported")
    if cfg.do_mom_diff:
        raise NotImplementedError("ns.do_mom_diff is not ported")
    if cfg.do_denminmax:
        raise NotImplementedError("ns.do_denminmax is not ported")
    if cfg.advection_scheme != "Godunov_PLM":
        raise NotImplementedError(f"{cfg.advection_scheme} is not ported (PLM is)")
    if cfg.use_forces_in_trans:
        raise NotImplementedError("godunov.use_forces_in_trans is not ported")
    if not cfg.do_mac_proj:
        raise NotImplementedError("ns.do_mac_proj=0 is not ported")


def advance(
    state: NSState,
    cfg: NSConfig,
    fixed_mg_cycles=None,
    hit=None,
    return_umac: bool = False,
    bcp=None,
    spectral: bool = False,
):
    """One timestep: consumes state^n, returns state^{n+1} (and the
    projected MAC velocities with return_umac).

    spectral: every implicit solve (MAC and nodal projection, CN diffusion)
    runs in Fourier space; the caller decides eligibility beforehand
    (solvers.spectral.spectral_eligible). Otherwise the solves are
    multigrid: to the config's tolerances, or with fixed_mg_cycles
    V-cycles for the projections and max(1, fixed_mg_cycles // 4) for the
    diffusion solves (strongly diagonally dominant at CFL-limited dt)."""
    _check_supported(cfg)
    if bcp is None:
        bcp = PhysBCProvider(cfg)
    dim = cfg.dim
    dev = state.rho.device
    dx = cfg.geom.dx
    dt = state.dt
    vel, rho, trac, p, gradp = state.vel, state.rho, state.trac, state.p, state.gradp
    recs = [bcp.vel_bcrec(c) for c in range(dim)]
    periodic = tuple(cfg.geom.periodic)
    t_half = state.time + 0.5 * dt
    mf = mu_faces(cfg, dev)
    diff_cycles = None if fixed_mg_cycles is None else max(1, fixed_mg_cycles // 4)

    # --- 1. predict MAC velocities -------------------------------------
    if cfg.vel_visc_coef > 0.0 and cfg.be_cn_theta != 1.0:
        visc = torch.stack([
            diff.visc_terms_component(
                vel[c], mf, dx, recs[c],
                poisson_bc=bcp.vel_diff_bc(c)[0],
                poisson_bvals=bcp.vel_diff_bc(c)[1],
            )
            for c in range(dim)
        ])
    else:
        visc = torch.zeros_like(vel)
    tf = get_force(cfg, rho, t_half, hit)
    forcing = (tf + visc - gradp) / rho
    vel_g = bcp.fill_vel(vel, 3)
    force_g = bcp.fill_force(forcing)
    bcvals_lo = tuple(bcp.vel_bcvals(c)[0] for c in range(dim))
    bcvals_hi = tuple(bcp.vel_bcvals(c)[1] for c in range(dim))
    bl = tuple(tuple(bcvals_lo[c][d] for c in range(dim)) for d in range(dim))
    bh = tuple(tuple(bcvals_hi[c][d] for c in range(dim)) for d in range(dim))
    umac = extrap_vel_to_faces(vel_g, force_g, dt, dx, cfg.geom.ncell, recs, bl, bh)

    # --- 2. MAC projection ---------------------------------------------
    mac_bc, mac_bvals = bcp.mac_bc()
    umac, mac_phi, _ = mac_project(
        umac, rho, cfg.dom, dx, rtol=cfg.mac_tol, atol=cfg.mac_abs_tol,
        fixed_cycles=fixed_mg_cycles, bc=mac_bc, bvals=mac_bvals,
        spectral_beta0=(1.0 / invariant_mean(rho)) if spectral else None,
    )
    umac_g = bcp.grow_umac(umac)

    # every advected field filled up front: u, v, w (forced, convective),
    # rho (conservative), tracers
    rho_g = bcp.fill_scal(rho, 3, 0)
    trac_gs = [bcp.fill_scal(trac[t], 3, 1 + t) for t in range(cfg.ntrac)]
    fields = [(vel_g[c], False, force_g[c]) for c in range(dim)]
    fields.append((rho_g, True, None))
    fields += [(trac_gs[t], bool(cfg.do_cons_trac), None) for t in range(cfg.ntrac)]

    # all fields in one multi-field pass (kernel K2 on CUDA tensors)
    flist = [f for (_, _, f) in fields if f is not None]
    rows, k = [], 0
    for (_, _, f) in fields:
        rows.append(k if f is not None else -1)
        k += f is not None
    adv = godunov_plm_multi(
        [f[0] for f in fields], umac, umac_g, dt, dx, cfg.geom.ncell,
        [f[1] for f in fields], flist, rows, [not f[1] for f in fields],
        periodic=periodic,
    )

    # --- 3. velocity advection (convective form) --------------------------
    aofs_vel = torch.stack([adv[c][1] for c in range(dim)])

    # --- 4. scalar advection + updates ----------------------------------
    aofs_rho = adv[dim][1]
    rho_new = rho - dt * aofs_rho
    rho_half = 0.5 * (rho + rho_new)

    trac_new = []
    for t in range(cfg.ntrac):
        s = trac[t]
        s_star = s - dt * adv[dim + 1 + t][1]
        coef = cfg.scal_diff_coefs[t] if t < len(cfg.scal_diff_coefs) else 0.0
        if coef > 0.0:
            sbc, sbv = bcp.scal_diff_bc(1 + t)
            s_star, _ = diff.diffuse_scalar(
                s_star, s, rho_new, rho, beta_faces(cfg, coef, dev), dt, dx,
                bcp._scal_rec, theta=cfg.be_cn_theta, rtol=cfg.visc_tol,
                fixed_cycles=diff_cycles, poisson_bc=sbc, poisson_bvals=sbv,
                spectral=(invariant_mean(rho_new), coef) if spectral else None,
            )
        trac_new.append(s_star)
    trac_new = torch.stack(trac_new)

    # --- 5. velocity update + CN viscous solve ---------------------------
    tf_half = get_force(cfg, rho_half, t_half, hit)
    vel_star = torch.stack([
        vel[c] - dt * aofs_vel[c] + dt * (tf_half[c] - gradp[c]) / rho_half
        for c in range(dim)
    ])
    if cfg.vel_visc_coef > 0.0:
        # dt folded into alpha: (alpha - theta L) u = ..., alpha = rho_half / dt
        alpha = rho_half / dt
        sp_args = (invariant_mean(alpha), cfg.vel_visc_coef) if spectral else None
        comps = []
        for c in range(dim):
            # the spectral solve takes component 0's (all-periodic) BCs
            vbc, vbv = bcp.vel_diff_bc(0 if spectral else c)
            comps.append(diff.diffuse_scalar(
                vel_star[c], vel[c], alpha, alpha, mf, 1.0, dx, recs[0 if spectral else c],
                theta=cfg.be_cn_theta, rtol=cfg.visc_tol, fixed_cycles=diff_cycles,
                poisson_bc=vbc, poisson_bvals=vbv, spectral=sp_args,
            )[0])
        vel_star = torch.stack(comps)

    # --- 6. nodal projection ---------------------------------------------
    nodal_bc_, nodal_phi_bc = bcp.nodal()
    vel_new, p_new, gradp_new, _ = level_project(
        vel_star, rho_half, p, gradp, dt, cfg.dom, dx, rtol=cfg.proj_tol,
        atol=cfg.proj_abs_tol, fixed_cycles=fixed_mg_cycles, bc=nodal_bc_,
        phi_bc=nodal_phi_bc,
        spectral_sigma0=(1.0 / invariant_mean(rho_half)) if spectral else None,
    )

    # --- next dt ----------------------------------------------------------
    new_state = NSState(
        vel=vel_new, rho=rho_new, trac=trac_new, temp=state.temp, p=p_new,
        gradp=gradp_new, time=state.time + dt, dt=dt, dsdt=None,
    )
    dt_next = est_time_step(cfg, new_state, hit)
    dt_next = torch.minimum(dt_next, cfg.change_max * dt)
    new_state = new_state._replace(dt=dt_next)
    if return_umac:
        return new_state, umac
    return new_state


def make_step(cfg: NSConfig, fixed_mg_cycles=None, spectral: bool = False):
    """Step function closed over the static config."""
    hit = make_hit_forcing(cfg)
    return lambda s: advance(s, cfg, fixed_mg_cycles, hit=hit, spectral=spectral)


def make_step_with_particles(cfg: NSConfig, fixed_mg_cycles=None, spectral: bool = False):
    """Step that also advects tracer particles with the step's MAC
    velocities (AdvectWithUmac in advance)."""
    hit = make_hit_forcing(cfg)

    def step(state, parts):
        new_state, umac = advance(
            state, cfg, fixed_mg_cycles, hit=hit, return_umac=True, spectral=spectral,
        )
        return new_state, advect_with_umac(parts, umac, state.dt, cfg.geom)

    return step
