"""The Navier-Stokes timestep, single level (counterpart of
iamr_tpu/ns/advance.py).

NavierStokes::advance (Almgren-Bell-Colella-Howell-Welcome JCP 142, 1998):

  1. predict time-centred MAC velocities (Godunov extrapolation with
     forcing (visc + rho g - Gp)/rho; kernel K1 on the GPU in 3D PLM)
  2. MAC-project them (with the thermal divergence source of do_temp runs)
  3. Godunov advection of every advected field in one multi-field pass
     (kernel K2 on the GPU in 3D PLM; the plain functions field by field
     otherwise): velocity (convective, or rho U conservative under
     do_mom_diff), density (conservative), tracers, temperature
  4. scalar updates: rho (clamped under do_denminmax), tracers and
     temperature with CN diffusion
  5. velocity update u* = u^n - dt aofs + dt (f - Gp)/rho_half, then the
     CN viscous solve (under LES the implicit tensor solve,
     solvers/tensor.py, with the eddy viscosity of ns/les.py)
  6. nodal projection -> U^{n+1}, p^{n+1/2}, Gp (outflow faces under
     gravity hold the hydrostatic phi)

With embedded boundaries (eb, the level's eb/geom.py::EBData) the step
follows the reference's EB path: near-wall slopes in the plain Godunov
advection (no K2, as the JAX package gates its kernel), the advective
tendencies redistributed (eb/redist.py, ns.redistribution_type), the
projections and the CN solves on area- and volume-fraction-weighted
operators with an implicit no-slip wall drag, and the covered cells
holding the body state (velocity 0, their old density and scalars).

Ported path: 2D and 3D, single level, periodic, walled, inflow and outflow
sides, variable density, the advection schemes Godunov_PLM, Godunov_PPM
and BDS (any other name runs as PLM, as in the JAX package; the MAC
predictor stays PLM under BDS), godunov.use_forces_in_trans, do_temp,
do_mom_diff, do_denminmax, do_mac_proj, LES (Smagorinsky, Sigma in 3D),
RZ (2D axisymmetric, without velocity viscosity or LES, as the reference
requires) and EB (not with RZ or use_forces_in_trans, as in the JAX
package), with either the spectral (FFT) solvers of an all-periodic
uniform-density run (not under LES, RZ or EB) or the multigrid solvers
(cell red-black Gauss-Seidel, FEM nodal Jacobi), to tolerance or for a
fixed number of V-cycles. A fine AMR level takes its ghost cells and its
solvers' coarse-fine BCs from the caller's provider (bcp, a
CoarseFineBCProvider) and, with return_aux, returns what the flux
registers and the sync need. Multi-box levels are not ported. The step runs
eagerly on the tensors' device; in
fixed-cycle or spectral mode it reads nothing back to the host (tolerance
mode reads one residual norm per V-cycle; the Sigma model's eigenvalue
solve reads its status).
"""

from __future__ import annotations

import itertools

import torch

from iamr_tpu_torch import plugins
from iamr_tpu_torch.eb.redist import eb_aofs, set_body_state, state_redist_geometry
from iamr_tpu_torch.ns.bcprovider import PhysBCProvider
from iamr_tpu_torch.ns.forcing_hit import HITForcing
from iamr_tpu_torch.ns.les import eddy_viscosity_faces, tensor_cross_fluxes, tensor_cross_terms
from iamr_tpu_torch.ns.particles import advect_with_umac
from iamr_tpu_torch.ns.state import NSConfig, NSState
from iamr_tpu_torch.ops import mg
from iamr_tpu_torch.ops.godunov import advect_field, extrap_vel_to_faces
from iamr_tpu_torch.ops.godunov_kernels import godunov_plm_multi
from iamr_tpu_torch.parallel.reduce import invariant_mean
from iamr_tpu_torch.solvers import diffusion as diff
from iamr_tpu_torch.solvers.mac import mac_project
from iamr_tpu_torch.solvers.nodal_proj import hydrostatic_phi_bc, level_project
from iamr_tpu_torch.solvers.tensor import diffuse_tensor_velocity

# ns.advection_scheme -> the Godunov functions' scheme; any other name runs
# as PLM, as in the JAX package
SCHEMES = {"Godunov_PLM": "plm", "Godunov_PPM": "ppm", "BDS": "bds"}


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
    forcing `hit` (the HIT spectral forcing or a user forcing) evaluated at
    `time`, a 0-d tensor on rho's device."""
    dim = cfg.dim
    f = [torch.zeros_like(rho) for _ in range(dim)]
    if abs(cfg.gravity) > 1e-4:
        f[dim - 1] = cfg.gravity * rho
    out = torch.stack(f)
    if hit is not None and time is not None:
        out = out + hit.eval(cfg.geom, time, dtype=cfg.tdtype)
    return out


def make_hit_forcing(cfg: NSConfig):
    """The forcing of prob.forcing: a user forcing registered under that
    name (plugins.forcing), the HIT forcing mode tables (turb.* namespace),
    or None."""
    if cfg.forcing in plugins.FORCINGS:
        return plugins.FORCINGS[cfg.forcing](cfg)
    if cfg.forcing != "hit":
        return None
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


def rz_radii(cfg: NSConfig, dtype, device):
    """(r_cell, r_face) of an RZ run (coord_sys = 1, 2D, dim 0 radial) as
    (n_r, 1) and (n_r + 1, 1) tensors on `device`, broadcastable against
    cell and x-face arrays (the reference's radMult scaling of divergences
    and projection coefficients), or None when the geometry is Cartesian.
    Formed on the device in float64 and cast: a copy from the host would
    wait for the stream."""
    geom = cfg.geom
    if geom.coord_sys != 1:
        return None
    lo, h, n = geom.prob_lo[0], geom.dx[0], geom.ncell[0]
    ar = lambda k: torch.arange(k, dtype=torch.float64, device=device)
    r_cell = lo + (ar(n) + 0.5) * h
    r_face = lo + ar(n + 1) * h
    return r_cell.to(dtype)[:, None], r_face.to(dtype)[:, None]


def _check_rz(cfg: NSConfig, eb=None):
    """The reference forbids RZ with viscosity (NavierStokesBase.cpp:246-256);
    RZ with EB is not supported, as in the JAX package."""
    if cfg.geom.coord_sys == 1 and (cfg.vel_visc_coef > 0.0 or cfg.do_les):
        raise NotImplementedError("RZ with viscosity is not supported "
                                  "(matches the reference restriction)")
    if cfg.geom.coord_sys == 1 and eb is not None:
        raise NotImplementedError("RZ + EB not supported")


def _thermal_divu(cfg: NSConfig, bcp, temp, rho):
    """The thermal divergence source S = div(lambda grad T) / (rho T) of
    do_temp runs with conduction (calc_divu), else None."""
    if not (cfg.do_temp and cfg.temp_cond_coef > 0.0):
        return None
    tbc, tbv = bcp.temp_diff_bc()
    lap = diff.visc_terms_component(
        temp, beta_faces(cfg, cfg.temp_cond_coef, temp.device), cfg.geom.dx,
        bcp._temp_rec, poisson_bc=tbc, poisson_bvals=tbv,
    )
    return lap / (rho * temp)


def _scal_min_max(s_g, s_new):
    """Clamp each new value to the min/max of its old 3^dim neighbourhood
    (ConvectiveScalMinMax)."""
    dim = s_new.ndim
    ng = (s_g.shape[0] - s_new.shape[0]) // 2
    lo = hi = None
    for off in itertools.product((-1, 0, 1), repeat=dim):
        v = s_g[tuple(slice(ng + off[d], ng + off[d] + s_new.shape[d]) for d in range(dim))]
        lo = v if lo is None else torch.minimum(lo, v)
        hi = v if hi is None else torch.maximum(hi, v)
    return torch.clamp(s_new, lo, hi)


def advance(
    state: NSState,
    cfg: NSConfig,
    fixed_mg_cycles=None,
    hit=None,
    return_umac: bool = False,
    bcp=None,
    spectral: bool = False,
    eb=None,
    eb_redist=None,
    return_aux: bool = False,
):
    """One timestep: consumes state^n, returns state^{n+1} (and the
    projected MAC velocities with return_umac). bcp: the level's
    boundary-condition provider (default PhysBCProvider(cfg); a fine AMR
    level passes a CoarseFineBCProvider). return_aux: return (state, aux)
    instead, aux = {"umac", "mac_phi", "flux_rho", "flux_trac", "flux_vel",
    "vflux_vel", "vflux_trac"}: the projected MAC velocities and potential,
    the advective face fluxes of density, tracers and velocity (K2's under
    3D PLM) and the CN viscous face fluxes of velocity (None without
    viscosity; with the LES cross fluxes) and of each diffused tracer
    (None per tracer that is not), the viscous ones None under EB, as in
    the JAX package; for the coarse-fine flux registers and the sync of AMR
    and for particles. eb: the level's EBData
    (module docstring); use_forces_in_trans with it raises, as the
    reference aborts. eb_redist: redist_geometry(cfg, eb) where the caller
    keeps it across steps (formed here when not given).

    spectral: every implicit solve (MAC and nodal projection, CN diffusion)
    runs in Fourier space; the caller decides eligibility beforehand
    (solvers.spectral.spectral_eligible), and the flag is turned off here
    under LES, RZ, EB and a side that is not periodic. Otherwise the solves are
    multigrid: to the config's tolerances, or with fixed_mg_cycles
    V-cycles for the projections and max(1, fixed_mg_cycles // 4) for the
    diffusion solves (strongly diagonally dominant at CFL-limited dt)."""
    _check_rz(cfg, eb)
    if eb is not None and cfg.use_forces_in_trans:
        # the reference aborts (NavierStokesBase.cpp:566-567)
        raise NotImplementedError("use_forces_in_trans not implemented within EB Godunov. "
                                  "Set godunov.use_forces_in_trans=0.")
    if bcp is None:
        bcp = PhysBCProvider(cfg)
    dim = cfg.dim
    dev = state.rho.device
    dx = cfg.geom.dx
    dt = state.dt
    vel, rho, trac, p, gradp = state.vel, state.rho, state.trac, state.p, state.gradp
    recs = [bcp.vel_bcrec(c) for c in range(dim)]
    periodic = tuple(cfg.geom.periodic)
    # the FFT solvers need all-periodic Cartesian constant-viscosity runs
    # without EB
    spectral = (spectral and eb is None and cfg.geom.coord_sys == 0 and not cfg.do_les
                and all(periodic))
    scheme = SCHEMES.get(cfg.advection_scheme, "plm")
    # BDS advects the fields; the MAC predictor stays Godunov
    mac_scheme = "plm" if scheme == "bds" else scheme
    uft = cfg.use_forces_in_trans
    rz = rz_radii(cfg, cfg.tdtype, dev)
    t_half = state.time + 0.5 * dt
    mf = mu_faces(cfg, dev)
    if cfg.do_les:
        # molecular + eddy viscosity at t^n (getViscosity + calc_mut_LES)
        mf = tuple(m + t for m, t in zip(mf, eddy_viscosity_faces(cfg, bcp, vel)))
    viscous = cfg.vel_visc_coef > 0.0 or cfg.do_les
    diff_cycles = None if fixed_mg_cycles is None else max(1, fixed_mg_cycles // 4)
    mom_diff = cfg.do_mom_diff
    if eb is not None:
        # EB: face coefficients times the area fractions, the wall drag
        # coefficient mu A_eb / (V d) and vfrac kept off zero
        ebmul = lambda fs: tuple(f * af for f, af in zip(fs, eb.afrac))
        drag_v = cfg.vel_visc_coef * eb.aeb_vol / eb.d_eb
        vfs = torch.clamp(eb.vfrac, min=1e-12)

    # --- 1. predict MAC velocities -------------------------------------
    if viscous and cfg.be_cn_theta != 1.0:
        mf0 = mf if eb is None else ebmul(mf)
        visc = torch.stack([
            diff.visc_terms_component(
                vel[c], mf0, dx, recs[c],
                poisson_bc=bcp.vel_diff_bc(c)[0],
                poisson_bvals=bcp.vel_diff_bc(c)[1],
            )
            for c in range(dim)
        ])
        if eb is not None:
            # the volume-weighted term per volume, less the explicit wall drag
            visc = torch.stack([eb.fluid * (visc[c] / vfs - drag_v * vel[c])
                                for c in range(dim)])
        elif cfg.do_les:
            # the variable viscosity's tensor cross terms (not under EB)
            visc = visc + tensor_cross_terms(cfg, bcp, vel, mf)
    else:
        visc = torch.zeros_like(vel)
    tf = get_force(cfg, rho, t_half, hit)
    forcing = (tf + visc - gradp) / rho
    if eb is not None:
        forcing = forcing * eb.fluid
    vel_g = bcp.fill_vel(vel, 3)
    force_g = bcp.fill_force(forcing)
    bcvals_lo = tuple(bcp.vel_bcvals(c)[0] for c in range(dim))
    bcvals_hi = tuple(bcp.vel_bcvals(c)[1] for c in range(dim))
    bl = tuple(tuple(bcvals_lo[c][d] for c in range(dim)) for d in range(dim))
    bh = tuple(tuple(bcvals_hi[c][d] for c in range(dim)) for d in range(dim))
    umac = extrap_vel_to_faces(vel_g, force_g, dt, dx, cfg.geom.ncell, recs, bl, bh,
                               use_forces_in_trans=uft, scheme=mac_scheme)

    # --- 2. MAC projection ---------------------------------------------
    # the thermal source, centred in time with the previous step's dsdt
    divu_src = _thermal_divu(cfg, bcp, state.temp, rho)
    mac_divu = divu_src
    if divu_src is not None and state.dsdt is not None:
        mac_divu = divu_src + 0.5 * dt * state.dsdt
    if cfg.do_mac_proj:
        mac_bc, mac_bvals = bcp.mac_bc()
        umac, mac_phi, _ = mac_project(
            umac, rho, cfg.dom, dx, divu_src=mac_divu, rtol=cfg.mac_tol,
            atol=cfg.mac_abs_tol, fixed_cycles=fixed_mg_cycles, bc=mac_bc, bvals=mac_bvals,
            spectral_beta0=(1.0 / invariant_mean(rho)) if spectral else None, rz=rz, eb=eb,
        )
    else:
        # ns.do_mac_proj = 0, a debugging switch: advect with the predicted
        # MAC velocities
        mac_phi = torch.zeros(tuple(cfg.geom.ncell), dtype=cfg.tdtype, device=dev)
    umac_g = bcp.grow_umac(umac)

    # every advected field filled up front, in the order vel x dim (forced;
    # rho U, conservative, under do_mom_diff), rho (conservative), tracers,
    # temperature (convective)
    rho_g = bcp.fill_scal(rho, 3, 0)
    trac_gs = [bcp.fill_scal(trac[t], 3, 1 + t) for t in range(cfg.ntrac)]
    fields = [(rho_g * vel_g[c] if mom_diff else vel_g[c], mom_diff, force_g[c])
              for c in range(dim)]
    fields.append((rho_g, True, None))
    fields += [(trac_gs[t], bool(cfg.do_cons_trac), None) for t in range(cfg.ntrac)]
    if cfg.do_temp:
        fields.append((bcp.fill_temp(state.temp, 3), False, None))

    if dim == 3 and scheme == "plm" and rz is None and eb is None and not uft:
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
    else:
        # 2D, PPM, BDS, RZ, EB and use_forces_in_trans have no Godunov
        # kernel (nor has the JAX package): the plain functions, one field
        # at a time, on every device
        inner = (slice(3, -3),) * dim
        adv = [
            advect_field(s_g, umac, umac_g, dt, dx, cfg.geom.ncell, icons,
                         s_cc=None if icons else s_g[inner], force_g=fg,
                         periodic=periodic, scheme=scheme, rz=rz, eb=eb,
                         use_forces_in_trans=uft)
            for (s_g, icons, fg) in fields
        ]
    aofs = [a for _, a in adv]
    if eb is not None:
        # the cut-cell tendencies, redistributed (ns.redistribution_type)
        s_ccs = [rho * vel[c] if mom_diff else vel[c] for c in range(dim)] + [rho] \
            + [trac[t] for t in range(cfg.ntrac)] + ([state.temp] if cfg.do_temp else [])
        if eb_redist is None:
            eb_redist = redist_geometry(cfg, eb)
        aofs = [eb_aofs(fl, umac, eb, dx, icons, s_cc=s_cc, periodic=periodic,
                        rtype=cfg.redist_type, dt=dt, rg=eb_redist)
                for (fl, _), (_, icons, _), s_cc in zip(adv, fields, s_ccs)]

    # --- 3. velocity advection (convective, or rho U conservative) -------
    aofs_vel = torch.stack(aofs[:dim])

    # --- 4. scalar advection + updates ----------------------------------
    rho_new = rho - dt * aofs[dim]
    if cfg.do_denminmax:
        rho_new = _scal_min_max(rho_g, rho_new)
    if eb is not None:
        # covered cells keep their density
        rho_new = set_body_state(rho_new, eb) + eb.covered * rho
    rho_half = 0.5 * (rho + rho_new)

    trac_new, vflux_trac = [], []
    for t in range(cfg.ntrac):
        s = trac[t]
        s_star = s - dt * aofs[dim + 1 + t]
        coef = cfg.scal_diff_coefs[t] if t < len(cfg.scal_diff_coefs) else 0.0
        if coef > 0.0:
            sbc, sbv = bcp.scal_diff_bc(1 + t)
            bcoef = beta_faces(cfg, coef, dev)
            s_in, s_old, a_new, a_old = s_star, s, rho_new, rho
            if eb is not None:
                # the volume-weighted operator; no flux through the wall
                bcoef = ebmul(bcoef)
                s_in, s_old = eb.fluid * s_star, eb.fluid * s
                a_new, a_old = eb.vfrac * rho_new + eb.covered, eb.vfrac * rho + eb.covered
            s_star, _ = diff.diffuse_scalar(
                s_in, s_old, a_new, a_old, bcoef, dt, dx, bcp._scal_rec,
                theta=cfg.be_cn_theta, rtol=cfg.visc_tol, fixed_cycles=diff_cycles,
                poisson_bc=sbc, poisson_bvals=sbv,
                spectral=(invariant_mean(a_new), coef) if spectral else None,
            )
        if eb is not None:
            s_star = eb.fluid * s_star + eb.covered * s
        vflux = None
        if return_aux and coef > 0.0 and eb is None:
            # the CN viscous flux -beta grad((1 - theta) s^n + theta s^{n+1})
            # of the viscous flux registers
            th = cfg.be_cn_theta
            vflux = mg.get_fluxes((1.0 - th) * s + th * s_star, bcoef, 1.0, dx, sbc, bvals=sbv)
        vflux_trac.append(vflux)
        trac_new.append(s_star)
    trac_new = torch.stack(trac_new)

    # --- 4b. temperature: advection + CN conduction, rho cp dT/dt =
    # div(lambda grad T) with cp folded into temp_cond_coef -----------------
    temp_new = state.temp
    if cfg.do_temp:
        temp_new = state.temp - dt * aofs[dim + 1 + cfg.ntrac]
        if cfg.temp_cond_coef > 0.0:
            tbc, tbv = bcp.temp_diff_bc()
            lamf = beta_faces(cfg, cfg.temp_cond_coef, dev)
            a_new, a_old = rho_new, rho
            if eb is not None:
                lamf = ebmul(lamf)
                a_new, a_old = eb.vfrac * rho_new + eb.covered, eb.vfrac * rho + eb.covered
            temp_new, _ = diff.diffuse_scalar(
                temp_new, state.temp, a_new, a_old, lamf, dt, dx, bcp._temp_rec,
                theta=cfg.be_cn_theta, rtol=cfg.visc_tol, fixed_cycles=diff_cycles,
                poisson_bc=tbc, poisson_bvals=tbv,
                spectral=(invariant_mean(a_new), cfg.temp_cond_coef) if spectral else None,
            )
        if eb is not None:
            temp_new = eb.fluid * temp_new + eb.covered * state.temp

    # --- 5. velocity update + CN viscous solve ---------------------------
    tf_half = get_force(cfg, rho_half, t_half, hit)
    if mom_diff:
        # (rho U)* = rho^n U^n - dt div(rho U u_mac) + dt (F - Gp);
        # U* = (rho U)* / rho^{n+1}
        vel_star = torch.stack([
            (rho * vel[c] - dt * aofs_vel[c] + dt * (tf_half[c] - gradp[c])) / rho_new
            for c in range(dim)
        ])
    else:
        vel_star = torch.stack([
            vel[c] - dt * aofs_vel[c] + dt * (tf_half[c] - gradp[c]) / rho_half
            for c in range(dim)
        ])
    if eb is not None:
        vel_star = vel_star * eb.fluid
    if cfg.do_les and eb is None:
        # variable viscosity: the implicit tensor solve, cross terms inside
        # the CN operator by a segregated outer iteration
        vel_star = diffuse_tensor_velocity(
            cfg, bcp, vel_star, vel, rho_half, mf, dt, cfg.be_cn_theta, rtol=cfg.visc_tol,
            fixed_cycles=diff_cycles,
        )
    elif viscous and eb is not None:
        # the volume-weighted operator with the implicit no-slip wall drag,
        # theta-weighted like the interior CN terms; its explicit half goes
        # into the right-hand side through the provisional velocity
        theta = cfg.be_cn_theta
        a_rhs = eb.vfrac * (rho_half / dt) + eb.covered
        a_op = a_rhs + theta * drag_v
        mfe = ebmul(mf)
        comps = []
        for c in range(dim):
            vbc, vbv = bcp.vel_diff_bc(c)
            vs = vel_star[c] - (1.0 - theta) * drag_v * vel[c] / a_rhs
            u_new, _ = diff.diffuse_scalar(
                vs, eb.fluid * vel[c], a_rhs, a_rhs, mfe, 1.0, dx, recs[c], theta=theta,
                rtol=cfg.visc_tol, fixed_cycles=diff_cycles, poisson_bc=vbc,
                poisson_bvals=vbv, alpha_op=a_op,
            )
            comps.append(u_new * eb.fluid)
        vel_star = torch.stack(comps)
    elif viscous:
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

    vflux_vel = None
    if return_aux and viscous and eb is None:
        # the CN viscous fluxes of the velocity registers; under LES with
        # the transpose (cross) part, the full stress flux mu (grad u +
        # grad u^T) (computeExtensiveFluxes)
        th = cfg.be_cn_theta
        u_th = (1.0 - th) * vel + th * vel_star
        vflux_vel = []
        for c in range(dim):
            vbc, vbv = bcp.vel_diff_bc(c)
            vflux_vel.append(mg.get_fluxes(u_th[c], mf, 1.0, dx, vbc, bvals=vbv))
        if cfg.do_les:
            xf = tensor_cross_fluxes(cfg, bcp, u_th, mf)
            vflux_vel = [tuple(f + x for f, x in zip(vflux_vel[c], xf[c])) for c in range(dim)]

    # --- 6. nodal projection ---------------------------------------------
    divu_new = _thermal_divu(cfg, bcp, temp_new, rho_new)
    nodal_bc_, nodal_phi_bc = bcp.nodal()
    if nodal_phi_bc is None and cfg.dom.has_outflow():
        # outflow faces under gravity hold the hydrostatic phi
        nodal_phi_bc = hydrostatic_phi_bc(cfg.geom, cfg.dom, rho_half, cfg.gravity)
    vel_new, p_new, gradp_new, _ = level_project(
        vel_star, rho_half, p, gradp, dt, cfg.dom, dx, rtol=cfg.proj_tol,
        atol=cfg.proj_abs_tol, fixed_cycles=fixed_mg_cycles, bc=nodal_bc_,
        phi_bc=nodal_phi_bc, divu_src=divu_new,
        spectral_sigma0=(1.0 / invariant_mean(rho_half)) if spectral else None, rz=rz, eb=eb,
    )

    # dsdt for the next step's MAC source (calc_dsdt)
    dsdt_new = None
    if divu_new is not None and divu_src is not None:
        dsdt_new = (divu_new - divu_src) / dt

    # --- next dt ----------------------------------------------------------
    new_state = NSState(
        vel=vel_new, rho=rho_new, trac=trac_new, temp=temp_new, p=p_new,
        gradp=gradp_new, time=state.time + dt, dt=dt, dsdt=dsdt_new,
    )
    dt_next = est_time_step(cfg, new_state, hit)
    dt_next = torch.minimum(dt_next, cfg.change_max * dt)
    new_state = new_state._replace(dt=dt_next)
    if return_aux:
        return new_state, {
            "umac": umac, "mac_phi": mac_phi, "flux_rho": adv[dim][0],
            "flux_trac": tuple(adv[dim + 1 + t][0] for t in range(cfg.ntrac)),
            "flux_vel": tuple(adv[c][0] for c in range(dim)),
            "vflux_vel": tuple(vflux_vel) if vflux_vel is not None else None,
            "vflux_trac": tuple(vflux_trac),
        }
    if return_umac:
        return new_state, umac
    return new_state


def redist_geometry(cfg: NSConfig, eb):
    """StateRedist's geometry terms of eb (eb/redist.py::
    state_redist_geometry), or None without EB or under another
    ns.redistribution_type."""
    if eb is None or cfg.redist_type != "StateRedist" or eb.merge_dir is None:
        return None
    return state_redist_geometry(eb, tuple(cfg.geom.periodic))


def make_step(cfg: NSConfig, fixed_mg_cycles=None, spectral: bool = False, eb=None):
    """Step function closed over the static config (and the EB geometry,
    with its redistribution terms formed once)."""
    hit = make_hit_forcing(cfg)
    rg = redist_geometry(cfg, eb)
    return lambda s: advance(s, cfg, fixed_mg_cycles, hit=hit, spectral=spectral, eb=eb,
                             eb_redist=rg)


def make_step_with_particles(cfg: NSConfig, fixed_mg_cycles=None, spectral: bool = False,
                             eb=None):
    """Step that also advects tracer particles with the step's MAC
    velocities (AdvectWithUmac in advance). Unlike the JAX package's, it
    takes the EB geometry (ROADMAP.md, notes on the reference)."""
    hit = make_hit_forcing(cfg)
    rg = redist_geometry(cfg, eb)

    def step(state, parts):
        new_state, umac = advance(
            state, cfg, fixed_mg_cycles, hit=hit, return_umac=True, spectral=spectral,
            eb=eb, eb_redist=rg,
        )
        return new_state, advect_with_umac(parts, umac, state.dt, cfg.geom)

    return step
