"""The AMR timestep over single-box levels (counterpart of
iamr_tpu/amr/multilevel.py).

Two kinds of coarse step:

  * advance_two_level, the composite (non-subcycled) step
    (amr.subcycling_mode = None): both levels advance with the same dt;
    then avgDown replaces the covered coarse data with restricted fine
    data and the uncovered coarse cells at the interface are refluxed
    (density, and conservative tracers).
  * advance_hierarchy_subcycled, the reference's Amr::timeStep recursion
    (advance_subtree): a level advances by dt, its child takes `ratio`
    subcycles with ghost fills and solver BCs interpolated in time from
    the parent (CoarseFineBCProvider), then _couple_levels runs the sync:
    avgDown (volume-fraction weighted under EB), the advective and viscous
    reflux into Vsync/Ssync, the MAC sync (Ucorr re-advection), the
    implicit sync diffusion and the composite two-level sync projection
    with the nodal sync-register RHS (amr/sync.py).

Each level's advance is the single-level step (ns/advance.py), so K1 and
K2 run once on the coarse level and `ratio` times on the fine level a
coarse step in 3D PLM, and the MG kernels in every level's solves and in
the sync's. The step functions (make_two_level_step, ...) are plain
functions over tensors that read nothing back to the host in fixed-cycle
mode; each keeps the HIT tables and the per-level EB redistribution terms
it was made with. A level of more than one box (boxlists) raises
NotImplementedError: multi-box (union) levels are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from iamr_tpu_torch.amr.hierarchy import (
    LevelSpec,
    avg_down,
    avg_down_node,
    crse_region,
    prolong_patch,
    reflux_correct,
    restrict_cell,
)
from iamr_tpu_torch.amr.sync import (
    UNION,
    interface_delta_umac,
    interp_cell_to_fine,
    interp_cell_to_fine_protected,
    mac_sync_velocity,
    sync_aofs,
    sync_aofs_vel,
    sync_project,
    sync_project_composite,
    sync_register_rhs,
)
from iamr_tpu_torch.ns.advance import (
    advance,
    beta_faces,
    est_time_step,
    make_hit_forcing,
    mu_faces,
    redist_geometry,
)
from iamr_tpu_torch.ns.bcprovider import (
    CoarseFineBCProvider,
    PhysBCProvider,
    _prolong_node_patch,
)
from iamr_tpu_torch.ns.particles import advect_with_umac_levels
from iamr_tpu_torch.ns.state import NSConfig, NSState
from iamr_tpu_torch.ops.mg_nodal import grad_node_to_cell
from iamr_tpu_torch.solvers.tensor import diffuse_ssync, diffuse_vsync


class MLState(NamedTuple):
    crse: NSState
    fine: NSState


def make_fine_config(cfg: NSConfig, spec: LevelSpec) -> NSConfig:
    return dataclasses.replace(cfg, geom=spec.fine_geom(cfg.geom))


def init_fine_from_coarse(cfg: NSConfig, spec: LevelSpec, crse: NSState) -> NSState:
    """The coarse state interpolated onto the fine patch (FillCoarsePatch):
    cell fields conservatively, the pressure multilinearly."""
    pc = lambda a: prolong_patch(a, spec)
    return NSState(
        vel=torch.stack([pc(crse.vel[c]) for c in range(crse.vel.shape[0])]),
        rho=pc(crse.rho),
        trac=torch.stack([pc(crse.trac[t]) for t in range(crse.trac.shape[0])]),
        temp=pc(crse.temp),
        p=_prolong_node_patch(crse.p, spec),
        gradp=torch.stack([pc(crse.gradp[c]) for c in range(crse.gradp.shape[0])]),
        time=crse.time, dt=crse.dt,
        dsdt=None if crse.dsdt is None else pc(crse.dsdt),
    )


def _crse_dict(s: NSState):
    return {"vel": s.vel, "rho": s.rho, "trac": s.trac, "temp": s.temp}


def advance_two_level(ml: MLState, cfg: NSConfig, spec: LevelSpec, fixed_mg_cycles=None,
                      hit=None, return_umacs: bool = False):
    """One composite (non-subcycled) step; returns the new MLState (and
    both levels' MAC velocities with return_umacs)."""
    cfg_f = make_fine_config(cfg, spec)
    dim = cfg.dim
    dt = torch.minimum(ml.crse.dt, ml.fine.dt)
    crse = ml.crse._replace(dt=dt)
    fine = ml.fine._replace(dt=dt)

    # 1. the coarse level, with its own physical BCs
    crse_new, crse_aux = advance(crse, cfg, fixed_mg_cycles, hit=hit, return_aux=True)
    # 2. the fine level, with the parent's fills and coarse-fine BCs
    bcp = CoarseFineBCProvider(cfg_f, spec, cfg.geom, _crse_dict(crse), _crse_dict(crse_new),
                               crse_p=crse_new.p, crse_mac_phi=crse_aux["mac_phi"],
                               crse_umac=crse_aux["umac"])
    fine_new, fine_aux = advance(fine, cfg_f, fixed_mg_cycles, hit=hit, bcp=bcp,
                                 return_aux=True)
    # 3. avgDown (State, Press, Gradp)
    rho_c = avg_down(crse_new.rho, fine_new.rho, spec)
    vel_c = torch.stack([avg_down(crse_new.vel[c], fine_new.vel[c], spec) for c in range(dim)])
    trac_c = torch.stack([avg_down(crse_new.trac[t], fine_new.trac[t], spec)
                          for t in range(cfg.ntrac)])
    p_c = avg_down_node(crse_new.p, fine_new.p, spec)
    gradp_c = torch.stack([avg_down(crse_new.gradp[c], fine_new.gradp[c], spec)
                           for c in range(dim)])
    # 4. reflux of the conservative scalars (rho; tracers when conservative)
    dxc = cfg.geom.dx
    dt_over_dx = tuple(dt / dxc[d] for d in range(dim))
    rho_c = reflux_correct(rho_c, crse_aux["flux_rho"], fine_aux["flux_rho"], spec, dt_over_dx)
    if cfg.do_cons_trac:
        trac_c = torch.stack([
            reflux_correct(trac_c[t], crse_aux["flux_trac"][t], fine_aux["flux_trac"][t], spec,
                           dt_over_dx)
            for t in range(cfg.ntrac)])
    temp_c = avg_down(crse_new.temp, fine_new.temp, spec)
    crse_out = crse_new._replace(rho=rho_c, vel=vel_c, trac=trac_c, temp=temp_c, p=p_c,
                                 gradp=gradp_c)
    # the next dt: the min over the levels (computeNewDt)
    dt_next = torch.minimum(
        torch.minimum(est_time_step(cfg, crse_out), est_time_step(cfg_f, fine_new)),
        cfg.change_max * dt)
    out = MLState(crse=crse_out._replace(dt=dt_next), fine=fine_new._replace(dt=dt_next))
    if return_umacs:
        return out, [crse_aux["umac"], fine_aux["umac"]]
    return out


def post_init_press_two_level(cfg: NSConfig, spec: LevelSpec, crse: NSState, fine: NSState,
                              fixed_mg_cycles=None, hit=None):
    """The initial composite pressure iterations of a two-level start
    (post_init_press + initialSyncProject): cfg.init_iter trial composite
    steps, each followed by a two-level composite nodal projection of the
    levels' accelerations dU/dt (sigma = rho_half); its phi is kept (P +=
    phi, Gp += G(phi)) while every other field goes back to its initial
    value."""
    if cfg.init_iter <= 0:
        return crse, fine
    cfg_f = make_fine_config(cfg, spec)
    for _ in range(cfg.init_iter):
        ml = advance_two_level(MLState(crse=crse, fine=fine), cfg, spec, fixed_mg_cycles,
                               hit=hit)
        dt = torch.minimum(crse.dt, fine.dt)
        rho_h_c = 0.5 * (crse.rho + ml.crse.rho)
        rho_h_f = 0.5 * (fine.rho + ml.fine.rho)
        # ml.crse.vel is avgDown'd already: dv_c and dv_f agree on covered cells
        _, _, phi_c, phi_f = sync_project_composite(
            cfg, cfg_f, spec, ml.crse.vel - crse.vel, rho_h_c, rho_h_f, dt,
            fixed_cycles=fixed_mg_cycles, vcorr=ml.fine.vel - fine.vel)
        gpc = grad_node_to_cell(phi_c, cfg.geom.dx)
        gpf = grad_node_to_cell(phi_f, cfg_f.geom.dx)
        crse = crse._replace(p=ml.crse.p + phi_c, gradp=ml.crse.gradp + torch.stack(list(gpc)))
        fine = fine._replace(p=ml.fine.p + phi_f, gradp=ml.fine.gradp + torch.stack(list(gpf)))
    return crse, fine


def _interp_states(crse_old, crse_new, theta):
    return {k: (1 - theta) * getattr(crse_old, k) + theta * getattr(crse_new, k)
            for k in ("vel", "rho", "trac", "temp")}


def _couple_levels(cfg, cfg_f, spec, crse_new, crse_aux, fine_new, fine_avg, dt_c,
                   fixed_mg_cycles, eb_c=None, eb_f=None, union=None, parent_cmask=None):
    """The parent/child coupling after the child's subcycles: avgDown, the
    advective reflux and the sync machinery (mac_sync, sync diffusion, the
    sync projection). Returns (crse_out, fine_out).

    eb_c/eb_f: per-level EBData; the restriction of cut cells is
    volume-fraction weighted (EB_average_down), fully covered coarse cells
    keep their body state. union / parent_cmask (multi-box levels) raise
    NotImplementedError."""
    if union is not None or parent_cmask is not None:
        raise NotImplementedError(f"_couple_levels(union=, parent_cmask=): {UNION}")
    dim = cfg.dim
    reg = crse_region(spec)
    if eb_f is not None:
        wf = torch.clamp(restrict_cell(eb_f.vfrac, spec.ratio), min=1e-12)
        cov_c = eb_c.covered[reg] if eb_c is not None else torch.zeros_like(wf)

        def _avg(crse, fine):
            num = restrict_cell(eb_f.vfrac * fine, spec.ratio) / wf
            out = crse.clone()
            # the fully covered coarse cells keep their body state (the
            # weighted restriction is 0/0 there)
            out[reg] = torch.where(cov_c > 0.0, crse[reg], num)
            return out
    else:
        def _avg(crse, fine):
            return avg_down(crse, fine, spec)

    rho_c = _avg(crse_new.rho, fine_new.rho)
    vel_c = torch.stack([_avg(crse_new.vel[c], fine_new.vel[c]) for c in range(dim)])
    trac_c = torch.stack([_avg(crse_new.trac[t], fine_new.trac[t]) for t in range(cfg.ntrac)])
    temp_c = _avg(crse_new.temp, fine_new.temp)
    p_c = avg_down_node(crse_new.p, fine_new.p, spec)
    gradp_c = torch.stack([avg_down(crse_new.gradp[c], fine_new.gradp[c], spec)
                           for c in range(dim)])
    dxc = cfg.geom.dx
    dt_over_dx = tuple(dt_c / dxc[d] for d in range(dim))
    if cfg.do_reflux:
        def _reflux(base, fc, ff):
            return reflux_correct(base, fc, tuple(ff), spec, dt_over_dx)
    else:
        # ns.do_reflux = 0, a debugging switch: avgDown only
        def _reflux(base, fc, ff):
            return base

    rho_c = _reflux(rho_c, crse_aux["flux_rho"], fine_avg["flux_rho"])
    crse_out = crse_new._replace(rho=rho_c, vel=vel_c, trac=trac_c, temp=temp_c, p=p_c,
                                 gradp=gradp_c)

    # the flux-register reflux into Vsync/Ssync (NavierStokes::reflux): the
    # velocity's advective mismatch and, in convective form, its CN viscous
    # mismatch over rho; the diffused tracers' viscous mismatch
    # (NonConservative: over rho); the conservative tracers' advective one
    zero_c = torch.zeros_like(rho_c)

    def _mismatch(fc, ff):
        return _reflux(zero_c, fc, ff)

    vsync_reflux = []
    for c in range(dim):
        v = _mismatch(crse_aux["flux_vel"][c], fine_avg["flux_vel"][c])
        if crse_aux["vflux_vel"] is not None:
            vm = _mismatch(crse_aux["vflux_vel"][c], fine_avg["vflux_vel"][c])
            # momentum form (do_mom_diff): both parts stay momentum units
            # and the / rho^{n+1} below converts them
            v = v + (vm if cfg.do_mom_diff else vm / rho_c)
        vsync_reflux.append(v)
    ssync_reflux = []
    for t in range(cfg.ntrac):
        s = zero_c
        if cfg.do_cons_trac:
            s = _mismatch(crse_aux["flux_trac"][t], fine_avg["flux_trac"][t])
        if crse_aux["vflux_trac"][t] is not None:
            dv = _mismatch(crse_aux["vflux_trac"][t], fine_avg["vflux_trac"][t])
            s = s + (dv if cfg.do_cons_trac else dv / rho_c)
        ssync_reflux.append(s)

    deltas = interface_delta_umac(crse_aux["umac"], tuple(fine_avg["umac"]), spec)

    def uncovered(a):
        a = a.clone()
        a[reg] = 0.0
        return a

    ucorr, _ = mac_sync_velocity(cfg, crse_out.rho, deltas, spec, fixed_cycles=fixed_mg_cycles)

    # Ssync: the scalars re-advected with Ucorr (convective for tracers,
    # conservative for rho). The rho correction stays in flux form over the
    # whole level and its covered part goes to the fine level by
    # interpolation (the Pember DeltaSsync consistency); convective tracers
    # are zeroed under the fine patch, as the reference's Ssync
    ssync_rho = -dt_c * sync_aofs(cfg, crse_out.rho, ucorr, 0, True)
    rho_sync = crse_out.rho + ssync_rho

    # the implicit sync diffusion (diffuse_Ssync / diffuse_Vsync)
    dev = rho_c.device
    bcp_c = PhysBCProvider(cfg)
    trac_sync = []
    for t in range(cfg.ntrac):
        ds = uncovered(-dt_c * sync_aofs(cfg, crse_out.trac[t], ucorr, 1 + t, cfg.do_cons_trac)
                       + ssync_reflux[t])
        coef = cfg.scal_diff_coefs[t] if t < len(cfg.scal_diff_coefs) else 0.0
        if coef > 0.0 and eb_c is None:
            ds = diffuse_ssync(cfg, bcp_c, ds, rho_sync, beta_faces(cfg, coef, dev), dt_c,
                               cfg.be_cn_theta, 1 + t, fixed_cycles=fixed_mg_cycles)
        trac_sync.append(crse_out.trac[t] + ds)
    trac_sync = torch.stack(trac_sync)

    # Vsync: the velocity correction, then the sync projection; the
    # corrections go onto the coarse level and, interpolated, the fine one
    a_vel = sync_aofs_vel(cfg, crse_out.vel, ucorr,
                          rho=crse_out.rho if cfg.do_mom_diff else None)
    vsync = torch.stack([uncovered(-dt_c * a_vel[c] + vsync_reflux[c]) for c in range(dim)])
    if cfg.do_mom_diff:
        # the momentum-units Vsync -> a velocity correction
        vsync = vsync / rho_sync
    if cfg.vel_visc_coef > 0.0 and eb_c is None:
        rho_half_c = 0.5 * (crse_new.rho + rho_sync)
        vsync = diffuse_vsync(cfg, bcp_c, vsync, rho_half_c, mu_faces(cfg, dev), dt_c,
                              cfg.be_cn_theta, fixed_cycles=fixed_mg_cycles)
    if not cfg.do_sync_proj:
        # ns.do_sync_proj = 0, a debugging switch: the unprojected Vsync
        vel_sync = crse_out.vel + vsync
        p_sync = crse_out.p
        fine_out = fine_new
    elif (eb_c is None) == (eb_f is None):
        # the two-level composite sync projection with the nodal
        # sync-register RHS (with the EB nodal operator under EB)
        rhnd = sync_register_rhs(cfg, spec, crse_new.vel, fine_avg["vel_new"], dt_c)
        vsync_p, vcorr_p, phi_sync, phi_f = sync_project_composite(
            cfg, cfg_f, spec, vsync, crse_out.rho, fine_new.rho, dt_c, rhnd=rhnd,
            fixed_cycles=fixed_mg_cycles, eb_c=eb_c, eb_f=eb_f)
        vel_sync = crse_out.vel + vsync_p
        p_sync = crse_out.p + phi_sync
        fine_out = fine_new._replace(
            vel=fine_new.vel + vcorr_p,
            rho=fine_new.rho + interp_cell_to_fine_protected(ssync_rho, fine_new.rho, spec),
            p=fine_new.p + phi_f)
    else:
        # EB on one level only: the coarse-level sync projection and the
        # interpolated fine correction
        vsync_p, phi_sync = sync_project(cfg, vsync, crse_out.rho, dt_c, spec,
                                         fixed_cycles=fixed_mg_cycles)
        vel_sync = crse_out.vel + vsync_p
        p_sync = crse_out.p + phi_sync
        fine_out = fine_new._replace(
            vel=fine_new.vel + torch.stack([interp_cell_to_fine(vsync_p[c], spec)
                                            for c in range(dim)]),
            rho=fine_new.rho + interp_cell_to_fine(ssync_rho, spec),
            p=fine_new.p + _prolong_node_patch(phi_sync, spec))
    if eb_c is not None:
        vel_sync = vel_sync * eb_c.fluid
        rho_sync = eb_c.fluid * rho_sync + eb_c.covered * crse_new.rho
    if eb_f is not None:
        fine_out = fine_out._replace(vel=fine_out.vel * eb_f.fluid)
    crse_out = crse_out._replace(rho=rho_sync, trac=trac_sync, vel=vel_sync, p=p_sync)
    return crse_out, fine_out


def _acc(sums, tree, w):
    """sums + w * tree over matching None-preserving nested tuples/lists."""
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        if sums is None:
            sums = [None] * len(tree)
        return [_acc(s0, t0, w) for s0, t0 in zip(sums, tree)]
    return w * tree if sums is None else sums + w * tree


def advance_subtree(cfgs, specs, states, lev, dt, fixed_mg_cycles=None, hit=None, bcp=None,
                    ebs=None, boxlists=None, boxes=None, eb_redists=None):
    """The Amr::timeStep recursion: advance level `lev` by dt, then take
    specs[lev].ratio subcycles of level lev+1 (which recurse further), then
    couple the two. states: per-level NSStates; specs[k]: the LevelSpec of
    level k+1 inside level k; cfgs[k]: per-level configs
    (hierarchy_configs); ebs[k] / eb_redists[k]: per-level EBData and its
    redistribution terms (ns/advance.py::redist_geometry). Returns (the new
    states, this level's aux, the per-level subcycle-time-averaged MAC
    velocities of levels lev.., which tracer particles advect with).

    boxlists / boxes: a level of more than one box raises
    NotImplementedError (multi-box levels are not ported); a one-box list
    is the patch itself."""
    if boxes is not None:
        raise NotImplementedError(f"advance_subtree(boxes=): {UNION}")
    crse_old = states[lev]
    eb_l = ebs[lev] if ebs else None
    rg_l = eb_redists[lev] if eb_redists else None
    crse_new, aux = advance(crse_old._replace(dt=dt), cfgs[lev], fixed_mg_cycles, hit=hit,
                            bcp=bcp, return_aux=True, eb=eb_l, eb_redist=rg_l)
    out = list(states)
    out[lev] = crse_new
    umacs = [aux["umac"]]
    if lev + 1 < len(states):
        spec = specs[lev]
        r = spec.ratio
        if boxlists is not None and boxlists[lev] and len(boxlists[lev]) > 1:
            raise NotImplementedError(
                f"level {lev + 1} has {len(boxlists[lev])} boxes: {UNION}")
        fine_avg = {}
        for k in range(r):
            bcp_f = CoarseFineBCProvider(
                cfgs[lev + 1], spec, cfgs[lev].geom,
                _interp_states(crse_old, crse_new, k / r),
                _interp_states(crse_old, crse_new, (k + 1) / r),
                crse_p=crse_new.p, crse_mac_phi=aux["mac_phi"], crse_umac=aux["umac"])
            out, aux_f, sub_umacs = advance_subtree(
                cfgs, specs, out, lev + 1, dt / r, fixed_mg_cycles, hit, bcp=bcp_f, ebs=ebs,
                boxlists=boxlists, eb_redists=eb_redists)
            # the subcycle time average of every deeper level's umac
            for j, um in enumerate(sub_umacs):
                if len(umacs) <= 1 + j:
                    umacs.append(tuple(u / r for u in um))
                else:
                    umacs[1 + j] = tuple(acc + u / r for acc, u in zip(umacs[1 + j], um))
            # the time-averaged fine fluxes and fields over the subcycles
            # (FineAdd times 1/crse_dt_ratio)
            for key in ("flux_rho", "umac", "flux_trac", "flux_vel", "vflux_vel",
                        "vflux_trac"):
                fine_avg[key] = _acc(fine_avg.get(key), aux_f[key], 1.0 / r)
            fine_avg["vel_new"] = _acc(fine_avg.get("vel_new"), out[lev + 1].vel, 1.0 / r)
        crse_out, fine_out = _couple_levels(
            cfgs[lev], cfgs[lev + 1], spec, crse_new, aux, out[lev + 1], fine_avg, dt,
            fixed_mg_cycles, eb_c=eb_l, eb_f=ebs[lev + 1] if ebs else None)
        out[lev] = crse_out
        out[lev + 1] = fine_out
    return out, aux, umacs


def hierarchy_configs(cfg: NSConfig, specs):
    """Per-level configs from nested LevelSpecs."""
    cfgs = [cfg]
    for spec in specs:
        cfgs.append(make_fine_config(cfgs[-1], spec))
    return cfgs


def advance_hierarchy_subcycled(states, cfg: NSConfig, specs, fixed_mg_cycles=None, hit=None,
                                ebs=None, return_umacs: bool = False, boxlists=None,
                                eb_redists=None):
    """One coarse step of a subcycled hierarchy of any depth (levels
    0..len(specs)); the next dt is the min over the levels of (the product
    of the ratios down to the level) times the level's estimate, capped at
    change_max times this dt, each level then stepping dt / product.
    return_umacs: also return the per-level subcycle-time-averaged MAC
    velocities."""
    cfgs = hierarchy_configs(cfg, specs)
    dt_c = states[0].dt
    out, _, umacs = advance_subtree(cfgs, specs, list(states), 0, dt_c, fixed_mg_cycles, hit,
                                    ebs=ebs, boxlists=boxlists, eb_redists=eb_redists)
    dt_next = est_time_step(cfgs[0], out[0])
    nfac = 1
    for lev in range(1, len(out)):
        nfac *= specs[lev - 1].ratio
        dt_next = torch.minimum(dt_next, nfac * est_time_step(cfgs[lev], out[lev]))
    dt_next = torch.minimum(dt_next, cfg.change_max * dt_c)
    result = []
    nfac = 1
    for lev in range(len(out)):
        if lev > 0:
            nfac *= specs[lev - 1].ratio
        result.append(out[lev]._replace(dt=dt_next / nfac))
    if return_umacs:
        return tuple(result), umacs
    return tuple(result)


def advance_two_level_subcycled(ml: MLState, cfg: NSConfig, spec: LevelSpec,
                                fixed_mg_cycles=None, hit=None):
    """One coarse step with `ratio` fine subcycles: the depth-1 case of
    advance_hierarchy_subcycled."""
    out = advance_hierarchy_subcycled((ml.crse, ml.fine), cfg, [spec], fixed_mg_cycles, hit)
    return MLState(crse=out[0], fine=out[1])


def level_redists(cfgs, ebs):
    """Each level's redistribution terms (None without EB)."""
    if ebs is None:
        return None
    return [redist_geometry(c, e) for c, e in zip(cfgs, ebs)]


def make_two_level_step(cfg: NSConfig, spec: LevelSpec, fixed_mg_cycles=None,
                        subcycle: bool = False, ebs=None):
    """The two-level step as a function of an MLState: subcycled or
    composite; with ebs (the levels' EBData) always subcycled, as in the
    JAX package (its composite step has no EB coupling)."""
    hit = make_hit_forcing(cfg)
    if ebs is not None:
        ebs = list(ebs)
        rgs = level_redists(hierarchy_configs(cfg, [spec]), ebs)

        def fn(ml):
            out = advance_hierarchy_subcycled((ml.crse, ml.fine), cfg, [spec], fixed_mg_cycles,
                                              hit, ebs=ebs, eb_redists=rgs)
            return MLState(crse=out[0], fine=out[1])

        return fn
    step = advance_two_level_subcycled if subcycle else advance_two_level
    return lambda ml: step(ml, cfg, spec, fixed_mg_cycles, hit=hit)


def make_two_level_step_with_particles(cfg: NSConfig, spec: LevelSpec, fixed_mg_cycles=None,
                                       subcycle: bool = False):
    """The two-level step that also advects tracer particles with the
    composite (finest-containing-level) MAC velocities, the fine ones the
    subcycle time averages (AmrTracerParticleContainer)."""
    hit = make_hit_forcing(cfg)
    cfg_f = make_fine_config(cfg, spec)

    def step(ml, parts):
        dt = ml.crse.dt
        if subcycle:
            out, umacs = advance_hierarchy_subcycled((ml.crse, ml.fine), cfg, [spec],
                                                     fixed_mg_cycles, hit, return_umacs=True)
            new = MLState(crse=out[0], fine=out[1])
        else:
            new, umacs = advance_two_level(ml, cfg, spec, fixed_mg_cycles, hit=hit,
                                           return_umacs=True)
        levels = [(umacs[0], cfg.geom), (umacs[1], cfg_f.geom)]
        return new, advect_with_umac_levels(parts, levels, dt)

    return step
