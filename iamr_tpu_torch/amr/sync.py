"""Multilevel synchronization of single-box levels: the MAC sync and the
sync projection (counterpart of the single-box half of
iamr_tpu/amr/sync.py).

The reference's post-subcycle sync machinery:
  * the MAC flux-register mismatch (MacProj mac_reg CrseInit/FineAdd): the
    time-averaged fine interface MAC velocity less the coarse one, on the
    coarse coarse-fine interface faces (interface_delta_umac);
  * mac_sync_solve: an elliptic solve spreads that interface divergence
    defect into a correction velocity Ucorr = beta grad(phi_sync)
    (mac_sync_velocity);
  * mac_sync_compute: the coarse states re-advected with Ucorr as the
    fluxing velocity (sync_aofs, sync_aofs_vel), by the plain Godunov
    functions at dt = 0, as the JAX package does;
  * the sync projection (MLsyncProject): a two-level FAC solve over the
    coarse level and the fine patch with the nodal sync-register RHS
    (sync_project_composite, sync_register_rhs), or the coarse-level form
    (sync_project);
  * SyncInterp's variants (sync_interp: PC, CellCons, CellConsLin,
    CellConsProt).

Multi-box (union) levels are not ported: sync_project_composite raises on
union=. Everything runs on the tensors' device; nothing is read back in
fixed-cycle mode.
"""

from __future__ import annotations

from typing import Optional

import torch

from iamr_tpu_torch.amr.hierarchy import (
    LevelSpec,
    _mc_slope,
    avg_down,
    avg_down_node,
    crse_region,
    fine_offsets,
    patch_region,
    prolong_patch,
)
from iamr_tpu_torch.ns.bcprovider import PhysBCProvider, _prolong_node_patch
from iamr_tpu_torch.ns.state import NSConfig
from iamr_tpu_torch.ops import mg
from iamr_tpu_torch.ops.godunov import (
    compute_edge_states,
    compute_fluxes_and_aofs,
    grow_umac_transverse,
)
from iamr_tpu_torch.ops.mg_nodal import (
    N_DIRICHLET,
    NodalBC,
    apply_nodal,
    div_cell_to_node,
    grad_node_to_cell,
    nodal_solve,
)
from iamr_tpu_torch.ops.stencil import mac_div, sl
from iamr_tpu_torch.solvers.mac import beta_from_rho, mac_poisson_bc
from iamr_tpu_torch.solvers.nodal_proj import nodal_bc

UNION = "multi-box (union) levels are not ported"


def _restrict_face(ff, d, spec: LevelSpec):
    """A fine face array's boundary faces averaged onto the coarse
    interface faces: {side: transverse mean over ratio^(dim-1) faces}."""
    dim = ff.ndim
    r = spec.ratio
    out = {}
    for side in (0, 1):
        f = sl(ff, d, 0, 1) if side == 0 else sl(ff, d, -1, None)
        for e in range(dim):
            if e == d:
                continue
            m = f.shape[e] // r
            acc = None
            for k in range(r):
                idx = [slice(None)] * dim
                idx[e] = slice(k, k + r * m, r)
                t = f[tuple(idx)]
                acc = t if acc is None else acc + t
            f = acc / r
        out[side] = f.squeeze(d)
    return out


def interface_delta_umac(crse_umac, fine_umac_avg, spec: LevelSpec):
    """delta[d]: coarse face arrays, nonzero only on the coarse-fine
    interface faces, holding (restricted time-averaged fine u_mac) -
    (coarse u_mac): the MAC flux register."""
    dim = len(crse_umac)
    deltas = []
    for d in range(dim):
        delta = torch.zeros_like(crse_umac[d])
        fr = _restrict_face(fine_umac_avg[d], d, spec)
        for side in (0, 1):
            cf = spec.crse_lo[d] if side == 0 else spec.crse_lo[d] + spec.crse_ncell[d]
            if cf <= 0 or cf >= crse_umac[d].shape[d] - 1:
                continue  # the interface lies on the domain boundary
            idx = [slice(spec.crse_lo[e], spec.crse_lo[e] + spec.crse_ncell[e])
                   for e in range(dim)]
            idx[d] = cf
            delta[tuple(idx)] = fr[side] - crse_umac[d][tuple(idx)]
        deltas.append(delta)
    return tuple(deltas)


def mac_sync_velocity(cfg: NSConfig, rho, deltas, spec: LevelSpec,
                      fixed_cycles: Optional[int] = None, cmask=None):
    """mac_sync_solve: the correction velocity Ucorr with div(Ucorr) =
    div(delta) on the uncovered cells. Solves -div(beta grad phi) =
    -defect with beta = 1/rho (the defect zeroed under the fine patch, as
    the reference zeroes the Reflux there) and returns (Ucorr = beta
    grad(phi) as face arrays, (residual, V-cycles))."""
    if cmask is not None:
        raise NotImplementedError(f"mac_sync_velocity(cmask=): {UNION}")
    dx = cfg.geom.dx
    rhs = mac_div(deltas, dx).clone()
    rhs[crse_region(spec)] = 0.0
    bc = mac_poisson_bc(cfg.dom)
    beta = beta_from_rho(rho, cfg.dom)
    phi, res, it = mg.mg_solve(-rhs, torch.zeros_like(rho), beta, 0.0, 1.0, dx, bc,
                               rtol=1e-10, atol=1e-14, fixed_cycles=fixed_cycles)
    corr = mg.get_fluxes(phi, beta, 1.0, dx, bc)  # -beta grad phi
    return tuple(-c for c in corr), (res, it)


def _zero_dt(like):
    """dt = 0 as a 0-d tensor formed on the device (a Python number made a
    CUDA tensor would be copied from the host and wait for the stream)."""
    return torch.zeros((), dtype=like.dtype, device=like.device)


def sync_aofs(cfg: NSConfig, s, ucorr, scomp: int, iconserv: bool):
    """The advective tendency of s with Ucorr as the fluxing velocity
    (mac_sync_compute; the predictor at dt = 0)."""
    periodic = tuple(cfg.geom.periodic)
    s_g = PhysBCProvider(cfg).fill_scal(s, 3, scomp)
    ug = grow_umac_transverse(ucorr, periodic)
    edges = compute_edge_states(s_g, ug, _zero_dt(s), cfg.geom.dx, cfg.geom.ncell, iconserv,
                                periodic=periodic)
    return compute_fluxes_and_aofs(edges, ucorr, cfg.geom.dx, iconserv, s_cc=s)[1]


def sync_aofs_vel(cfg: NSConfig, vel, ucorr, rho=None):
    """The advective sync tendencies of the velocity with Ucorr as the
    fluxing velocity (MacProj::mac_sync_compute). Under ns.do_mom_diff
    (pass rho) the advected state is the momentum rho U, conservatively,
    and the caller divides the momentum-units Vsync by rho^{n+1}."""
    periodic = tuple(cfg.geom.periodic)
    mom = rho is not None and cfg.do_mom_diff
    bcp = PhysBCProvider(cfg)
    vel_g = bcp.fill_vel(vel, 3)
    if mom:
        vel_g = bcp.fill_scal(rho, 3, 0)[None] * vel_g
    ug = grow_umac_transverse(ucorr, periodic)
    out = []
    for c in range(cfg.dim):
        edges = compute_edge_states(vel_g[c], ug, _zero_dt(vel), cfg.geom.dx, cfg.geom.ncell,
                                    mom, periodic=periodic)
        out.append(compute_fluxes_and_aofs(edges, ucorr, cfg.geom.dx, mom,
                                           s_cc=None if mom else vel[c])[1])
    return torch.stack(out)


def sync_project(cfg: NSConfig, vsync, rho, dt, spec: LevelSpec,
                 fixed_cycles: Optional[int] = None):
    """The sync projection of the velocity correction in its coarse-level
    form: L(phi) = D(Vsync/dt); Vsync -= dt sigma G(phi). Returns (the
    projected Vsync, phi)."""
    dim = rho.ndim
    dx = cfg.geom.dx
    bc = nodal_bc(cfg.dom)
    sigma = 1.0 / rho
    vs = tuple(vsync[d] / dt for d in range(dim))
    rhs = div_cell_to_node(vs, dx, bc)
    phi, _, _ = nodal_solve(rhs, sigma, dx, bc, rtol=1e-10, atol=1e-14,
                            fixed_cycles=fixed_cycles)
    gphi = grad_node_to_cell(phi, dx)
    return torch.stack([(vs[d] - sigma * gphi[d]) * dt for d in range(dim)]), phi


def interp_cell_to_fine(a, spec: LevelSpec):
    """SyncInterp's CellCons default: the coarse correction interpolated
    onto the fine patch, MC-limited and exactly conservative."""
    return prolong_patch(a, spec)


def interp_cell_to_fine_lincc(fields, spec: LevelSpec):
    """CellConsLin (lincc_interp): conservative linear interpolation with
    the limiting shared across components: one scale factor per coarse
    cell, the min over components of |limited| / |central| slope,
    multiplies every component's central slope, so that the interpolation
    commutes with linear combinations of the components.

    fields: [ncomp, ...] coarse corrections. Returns [ncomp, fine patch]."""
    r = spec.ratio
    dim = spec.dim
    out = fields
    for d in range(dim):
        out = torch.repeat_interleave(out, r, dim=1 + d)
    tiny = torch.finfo(fields.dtype).tiny
    for d in range(dim):
        m = fields.shape[1 + d]
        cen = torch.zeros_like(fields)
        idx_c = [slice(None)] * (dim + 1)
        idx_c[1 + d] = slice(1, m - 1)
        cen[tuple(idx_c)] = 0.5 * (sl(fields, 1 + d, 2, m) - sl(fields, 1 + d, 0, m - 2))
        lim = torch.stack([_mc_slope(fields[c], d) for c in range(fields.shape[0])])
        # the denominator masked before dividing (0/0 in the branch not taken)
        nonzero = torch.abs(cen) > 0.0
        denom = torch.where(nonzero, torch.abs(cen), torch.full_like(cen, tiny))
        ratio_c = torch.where(nonzero, torch.abs(lim) / denom, torch.ones_like(cen))
        alpha = torch.amin(ratio_c, dim=0)
        slope = cen * alpha[None]
        for e in range(dim):
            slope = torch.repeat_interleave(slope, r, dim=1 + e)
        off = fine_offsets(slope.shape[1 + d], r, d, dim, fields.dtype, fields.device)
        out = out + slope * off[None]
    return out[(slice(None),) + patch_region(spec)]


def interp_cell_to_fine_protected(inc_c, fine_field, spec: LevelSpec):
    """protected_interp (CellConsProt, the reference's SyncInterp of the
    density): the limited conservative interpolation of the correction,
    piecewise constant instead in every coarse cell where it would drive
    a fine value negative (both exactly conservative)."""
    dim = spec.dim
    r = spec.ratio
    inc_lim = prolong_patch(inc_c, spec)
    inc_pc = prolong_patch(inc_c, spec, limited=False)
    b = (fine_field + inc_lim) < 0.0
    # per coarse cell: any offending fine child -> PC for the whole cell
    for d in range(dim):
        shp = list(b.shape)
        shp[d] //= r
        shp.insert(d + 1, r)
        b = torch.any(b.reshape(shp), dim=d + 1)
    for d in range(dim):
        b = torch.repeat_interleave(b, r, dim=d)
    return torch.where(b, inc_pc, inc_lim)


def sync_interp(a, spec: LevelSpec, which: str = "cellcons", fine_field=None):
    """SyncInterp's variants: 'pc' (pc_interp), 'cellcons'
    (cell_cons_interp, the reference's default), 'cellconslin'
    (lincc_interp; `a` is [ncomp, ...]), 'protected' (protected_interp;
    needs `fine_field`)."""
    if which == "pc":
        return prolong_patch(a, spec, limited=False)
    if which == "cellcons":
        return interp_cell_to_fine(a, spec)
    if which == "cellconslin":
        return interp_cell_to_fine_lincc(a, spec)
    if which == "protected":
        assert fine_field is not None
        return interp_cell_to_fine_protected(a, fine_field, spec)
    raise ValueError(f"unknown SyncInterp variant {which!r}")


# ---------------------------------------------------------------------------
# the composite two-level sync projection (MLsyncProject + SyncRegister RHS)


def _interface_node_mask(spec: LevelSpec, crse_geom, nshape, dtype, device):
    """1 on the coarse nodes on the boundary of the coarsened fine patch
    (the SyncRegister's nodes), but for patch faces on the physical domain
    boundary (no coarse-fine interface there). Formed on the device."""
    dim = spec.dim
    m = torch.zeros(tuple(nshape), dtype=dtype, device=device)
    lo, nc = spec.crse_lo, spec.crse_ncell
    for d in range(dim):
        for side in (0, 1):
            if spec.touches_domain(crse_geom, d, side):
                continue
            idx = [slice(lo[e], lo[e] + nc[e] + 1) for e in range(dim)]
            idx[d] = lo[d] if side == 0 else lo[d] + nc[d]
            m[tuple(idx)] = 1.0
    return m


def sync_register_rhs(cfg: NSConfig, spec: LevelSpec, vel_c, vel_f_avg, dt_c):
    """The nodal sync-register RHS (SyncRegister::InitRHS): the composite
    nodal divergence of the coarse new velocity blended with the restricted
    time-averaged fine velocity, in units U/dt, on the interface nodes."""
    bc = nodal_bc(cfg.dom)
    ub = tuple(avg_down(vel_c[c], vel_f_avg[c], spec) / dt_c for c in range(cfg.dim))
    rh = div_cell_to_node(ub, cfg.geom.dx, bc)
    return rh * _interface_node_mask(spec, cfg.geom, rh.shape, rh.dtype, rh.device)


def _fine_sync_nodal_bc(cfg_f, spec: LevelSpec, crse_geom):
    """The fine patch's nodal BC of the sync solve: Dirichlet on the
    coarse-fine sides (values from the coarse phi), physical elsewhere."""
    nb = nodal_bc(cfg_f.dom)
    lo, hi = list(nb.lo), list(nb.hi)
    for d in range(spec.dim):
        if not spec.touches_domain(crse_geom, d, 0):
            lo[d] = N_DIRICHLET
        if not spec.touches_domain(crse_geom, d, 1):
            hi[d] = N_DIRICHLET
    return NodalBC(lo=tuple(lo), hi=tuple(hi))


def sync_project_composite(cfg: NSConfig, cfg_f: NSConfig, spec: LevelSpec, vsync, rho_c,
                           rho_f, dt, rhnd=None, fixed_cycles: Optional[int] = None,
                           n_fac: int = 2, union=None, vcorr=None, eb_c=None, eb_f=None):
    """The two-level composite sync projection (Projection::MLsyncProject):
    solves

        L_comp(phi) = D(Vsync/dt) [coarse] + D(Vcorr/dt) [fine] + rhnd

    over the coarse level and the fine patch by n_fac FAC iterations: a
    coarse solve over the whole domain, a fine-patch solve with Dirichlet
    phi interpolated from the coarse solution on the coarse-fine sides,
    the fine phi restricted into the covered region and the coarse
    residual equation solved again. rhnd: the sync-register RHS
    (sync_register_rhs). vcorr: the fine correction (default the
    SyncInterp of Vsync; initialSyncProject passes each level's own).

    eb_c / eb_f: per-level EBData: the FAC solves run the EB nodal operator
    (sigma times vfrac, the divergence of vfrac-weighted corrections, the
    projected corrections masked to the fluid).

    Returns (vsync_proj, vcorr_proj, phi_c, phi_f). union= (multi-box
    levels) raises NotImplementedError."""
    if union is not None:
        raise NotImplementedError(f"sync_project_composite(union=): {UNION}")
    dim = cfg.dim
    dxc, dxf = cfg.geom.dx, cfg_f.geom.dx
    bc_c = nodal_bc(cfg.dom)
    bc_f = _fine_sync_nodal_bc(cfg_f, spec, cfg.geom)
    sigma_c = 1.0 / rho_c
    sigma_f = 1.0 / rho_f
    # EB: the operator runs vfrac-weighted sigma; the velocity correction
    # uses the raw 1/rho
    vf_c = eb_c.vfrac if eb_c is not None else None
    vf_f = eb_f.vfrac if eb_f is not None else None
    sig_op_c = sigma_c * vf_c if vf_c is not None else sigma_c
    sig_op_f = sigma_f * vf_f if vf_f is not None else sigma_f
    if vcorr is None:
        vcorr = torch.stack([interp_cell_to_fine(vsync[c], spec) for c in range(dim)])
    rhs_c = div_cell_to_node(
        tuple((vf_c * vsync[d] if vf_c is not None else vsync[d]) / dt for d in range(dim)),
        dxc, bc_c)
    if rhnd is not None:
        rhs_c = rhs_c + rhnd
    rhs_f = div_cell_to_node(
        tuple((vf_f * vcorr[d] if vf_f is not None else vcorr[d]) / dt for d in range(dim)),
        dxf, bc_f)

    phi_c = torch.zeros_like(rhs_c)
    phi_f = None
    for it in range(n_fac):
        if it == 0:
            r_c = rhs_c
        else:
            # the covered nodes carry the restricted fine solution; solve
            # the coarse defect equation again
            phi_c = avg_down_node(phi_c, phi_f, spec)
            r_c = rhs_c - apply_nodal(phi_c, sig_op_c, dxc, bc_c)
        e_c, _, _ = nodal_solve(r_c, sig_op_c, dxc, bc_c, rtol=1e-10, atol=1e-14,
                                fixed_cycles=fixed_cycles)
        phi_c = phi_c + e_c
        phi_f, _, _ = nodal_solve(rhs_f, sig_op_f, dxf, bc_f, rtol=1e-10, atol=1e-14,
                                  fixed_cycles=fixed_cycles,
                                  phi_bc=_prolong_node_patch(phi_c, spec))

    gc = grad_node_to_cell(phi_c, dxc)
    gf = grad_node_to_cell(phi_f, dxf)
    vsync_p = torch.stack([vsync[d] - dt * sigma_c * gc[d] for d in range(dim)])
    vcorr_p = torch.stack([vcorr[d] - dt * sigma_f * gf[d] for d in range(dim)])
    if eb_c is not None:
        vsync_p = vsync_p * eb_c.fluid
    if eb_f is not None:
        vcorr_p = vcorr_p * eb_f.fluid
    return vsync_p, vcorr_p, phi_c, phi_f
