"""Godunov PLM advection: MAC velocity prediction and scalar edge states
(counterpart of iamr_tpu/ops/godunov.py, PLM path).

Corner-transport-upwind scheme of Almgren-Bell-Colella-Howell-Welcome
(JCP 142, 1998) with 4th-order monotonicity-limited slopes:

  1. limited slopes of each quantity in each dim,
  2. normal predictor: L/R states extrapolated to faces at t + dt/2,
  3. transverse corrections from upwinded "hat" states on transverse faces,
  4. Riemann upwinding at the face.

Inputs arrive pre-grown with filled ghosts (3 for the advected fields, 1
for forces). These plain tensor functions are the reference for the CUDA
kernels in ops/godunov_kernels.py; in 3D PLM without use_forces_in_trans
(and without EB/RZ) extrap_vel_to_faces and advect_field hand off to those
kernels, which run the plain functions themselves for CPU tensors.

PPM, BDS, EB slopes, RZ and use_forces_in_trans are not ported yet and
raise NotImplementedError.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from iamr_tpu_torch.core.bc import BCRec, MathBC
from iamr_tpu_torch.ops.stencil import sl


def _shift(a, d, off, extent):
    """Slice of length `extent` along d starting at offset `off`."""
    return sl(a, d, off, off + extent)


def _limit(dc, dl, dr):
    dlim = torch.minimum(torch.abs(dl), torch.abs(dr))
    dlim = torch.where(dl * dr > 0.0, dlim, torch.zeros_like(dlim))
    return torch.sign(dc) * torch.minimum(torch.abs(dc), dlim)


def slope2(qg, d):
    """2nd-order monotonized-central limited slope along d (extent m -> m-2)."""
    m = qg.shape[d]
    c = _shift(qg, d, 1, m - 2)
    lo = _shift(qg, d, 0, m - 2)
    hi = _shift(qg, d, 2, m - 2)
    dc = 0.5 * (hi - lo)
    dl = 2.0 * (c - lo)
    dr = 2.0 * (hi - c)
    return _limit(dc, dl, dr)


def slope4(qg, d):
    """4th-order MC limited slope along d (extent m -> m-4)."""
    m = qg.shape[d]
    s2 = slope2(qg, d)
    c = _shift(qg, d, 2, m - 4)
    lo = _shift(qg, d, 1, m - 4)
    hi = _shift(qg, d, 3, m - 4)
    s2_lo = _shift(s2, d, 0, m - 4)
    s2_hi = _shift(s2, d, 2, m - 4)
    dc = (4.0 / 3.0) * 0.5 * (hi - lo) - (1.0 / 6.0) * (s2_hi + s2_lo)
    dl = 2.0 * (c - lo)
    dr = 2.0 * (hi - c)
    return _limit(dc, dl, dr)


def _trim(a, keep_ng, have_ng, dims=None):
    """Trim a grown array from have_ng to keep_ng ghosts (selected dims)."""
    cut = have_ng - keep_ng
    idx = []
    for d in range(a.ndim):
        if dims is None or d in dims:
            idx.append(slice(cut, a.shape[d] - cut))
        else:
            idx.append(slice(None))
    return a[tuple(idx)]


def _riemann_self(ul, ur):
    """Upwind state for the self-advected normal velocity (Burgers Riemann):
    ul if compression moves right, ur if left, 0 at expansions and ties."""
    avg = ul + ur
    zero = torch.zeros_like(ul)
    out = torch.where((ul > 0.0) & (avg > 0.0), ul, zero)
    return torch.where((ur < 0.0) & (avg < 0.0), ur, out)


def _upwind(sl_, sr, speed, eps=1e-14):
    small = torch.abs(speed) < eps
    out = torch.where(speed > 0.0, sl_, sr)
    return torch.where(small, 0.5 * (sl_ + sr), out)


def _as_dt(dt, like):
    """dt as a 0-d tensor of the fields' dtype and device, so the plain path
    and the kernels round dt-products in the same precision."""
    return torch.as_tensor(dt, dtype=like.dtype, device=like.device)


def _check_scheme(scheme, use_forces_in_trans):
    if scheme != "plm":
        raise NotImplementedError(f"advection scheme {scheme!r} is not ported")
    if use_forces_in_trans:
        raise NotImplementedError("use_forces_in_trans is not ported")


def extrap_vel_to_faces(
    vel_g,
    force_g,
    dt,
    dx: Sequence[float],
    ncell: Sequence[int],
    bcrecs: Sequence[BCRec],
    bcvals_lo,
    bcvals_hi,
    use_forces_in_trans: bool = False,
    scheme: str = "plm",
    fused: bool = True,
):
    """Predict time-centred normal velocities on faces (the MAC velocities).

    vel_g: (dim, n+6, ...) velocity with 3 filled ghosts; force_g: (dim,
    n+2, ...) force (tf + visc - gradp)/rho with 1 ghost, or None.
    bcrecs[c]: BCRec of velocity component c; bcvals_lo/hi[d][c]: ext_dir
    values used to pin faces on inflow/no-slip boundaries.
    fused: hand the 3D case to the kernel wrapper (godunov_kernels.extrap_plm).

    Returns the face arrays u_mac[d] (shape n_d+1 in dim d).
    """
    _check_scheme(scheme, use_forces_in_trans)
    dim = vel_g.shape[0]
    ng = 3
    n = tuple(ncell)
    if fused and dim == 3:
        from iamr_tpu_torch.ops.godunov_kernels import extrap_plm

        umac = extrap_plm(vel_g, force_g, dt, dx, n)
        return tuple(
            _pin_faces(umac[d], d, bcrecs[d], bcvals_lo, bcvals_hi)
            for d in range(dim)
        )
    dt = _as_dt(dt, vel_g)

    # limited slopes of every component in every dim on the ng=1 region
    slopes = [[None] * dim for _ in range(dim)]  # [comp][dir]
    for c in range(dim):
        for d in range(dim):
            s = slope4(vel_g[c], d)
            slopes[c][d] = _trim(s, 1, ng, dims=[e for e in range(dim) if e != d])

    vel_1 = torch.stack([_trim(vel_g[c], 1, ng) for c in range(dim)])

    # hat states: normal predictor on the faces of the ng=1 region;
    # hat[d][c] has extent n_d+1 in d and n_e+2 in e != d
    hat = [[None] * dim for _ in range(dim)]
    for d in range(dim):
        m = vel_1[0].shape[d]
        un_L = _shift(vel_1[d], d, 0, m - 1)
        un_R = _shift(vel_1[d], d, 1, m - 1)
        cfl_L = dt / dx[d] * torch.clamp(un_L, min=0.0)
        cfl_R = dt / dx[d] * torch.clamp(un_R, max=0.0)
        for c in range(dim):
            q = vel_1[c]
            sq = slopes[c][d]
            qL = _shift(q, d, 0, m - 1) + 0.5 * (1.0 - cfl_L) * _shift(sq, d, 0, m - 1)
            qR = _shift(q, d, 1, m - 1) - 0.5 * (1.0 + cfl_R) * _shift(sq, d, 1, m - 1)
            hat[d][c] = (qL, qR)

    # Riemann-resolved hat values
    hat_vel = [None] * dim
    hat_comp = [[None] * dim for _ in range(dim)]
    for d in range(dim):
        uL, uR = hat[d][d]
        uadv = _riemann_self(uL, uR)
        hat_vel[d] = uadv
        for c in range(dim):
            if c != d:
                qL, qR = hat[d][c]
                hat_comp[d][c] = _upwind(qL, qR, uadv)

    def real_transverse(a, face_dim):
        return a[tuple(
            slice(None) if e == face_dim else slice(1, 1 + n[e])
            for e in range(dim)
        )]

    u_mac = []
    for d in range(dim):
        uL, uR = hat[d][d]
        uL = real_transverse(uL, d)
        uR = real_transverse(uR, d)
        corr_L = 0.0
        corr_R = 0.0
        for e in range(dim):
            if e == d:
                continue
            lo_idx, hi_idx = _cell_face_idx(dim, d, e, n)
            hv = hat_vel[e]
            hq = hat_comp[e][d]
            vbar = 0.5 * (hv[lo_idx] + hv[hi_idx])
            dq = hq[hi_idx] - hq[lo_idx]
            t = -0.5 * dt / dx[e] * vbar * dq
            corr_L = corr_L + _shift(t, d, 0, n[d] + 1)
            corr_R = corr_R + _shift(t, d, 1, n[d] + 1)
        uL_full = uL + corr_L
        uR_full = uR + corr_R
        if force_g is not None:
            f_real = real_transverse(force_g[d], d)
            uL_full = uL_full + 0.5 * dt * _shift(f_real, d, 0, n[d] + 1)
            uR_full = uR_full + 0.5 * dt * _shift(f_real, d, 1, n[d] + 1)
        face = _riemann_self(uL_full, uR_full)
        u_mac.append(_pin_faces(face, d, bcrecs[d], bcvals_lo, bcvals_hi))
    return tuple(u_mac)


def _cell_face_idx(dim, d, e, n):
    """Index tuples of the lo/hi e-faces of the cells (ng=1 in d, real in the
    others) within an array on e-faces whose non-e dims carry one ghost."""
    lo_idx, hi_idx = [], []
    for f in range(dim):
        if f == e:
            lo_idx.append(slice(0, n[e]))
            hi_idx.append(slice(1, n[e] + 1))
        elif f == d:
            lo_idx.append(slice(None))
            hi_idx.append(slice(None))
        else:
            lo_idx.append(slice(1, 1 + n[f]))
            hi_idx.append(slice(1, 1 + n[f]))
    return tuple(lo_idx), tuple(hi_idx)


def _pin_faces(face, d, bcr, bcvals_lo, bcvals_hi):
    """Pin ext_dir domain faces to the BC value; reflect_odd faces are zero.
    Returns a new tensor when it pins, the input otherwise."""
    if bcr.lo[d] == MathBC.ext_dir:
        face = _set_face(face, d, 0, bcvals_lo[d][d])
    elif bcr.lo[d] == MathBC.reflect_odd:
        face = _set_face(face, d, 0, 0.0)
    if bcr.hi[d] == MathBC.ext_dir:
        face = _set_face(face, d, -1, bcvals_hi[d][d])
    elif bcr.hi[d] == MathBC.reflect_odd:
        face = _set_face(face, d, -1, 0.0)
    return face


def _set_face(a, d, pos, val):
    out = a.clone()
    idx = [slice(None)] * a.ndim
    idx[d] = slice(0, 1) if pos == 0 else slice(-1, None)
    out[tuple(idx)].fill_(val)
    return out


def grow_umac_transverse(umac, bc_periodic: Sequence[bool]):
    """Add one ghost row to each MAC component in its transverse dims:
    periodic dims wrap, the others copy the edge row."""
    out = []
    for d, u in enumerate(umac):
        for e in range(u.ndim):
            if e == d:
                continue
            if bc_periodic[e]:
                lo, hi = sl(u, e, -1, None), sl(u, e, 0, 1)
            else:
                lo, hi = sl(u, e, 0, 1), sl(u, e, -1, None)
            u = torch.cat([lo, u, hi], dim=e)
        out.append(u)
    return tuple(out)


def advect_field(
    s_g,
    umac,
    umac_g,
    dt,
    dx,
    ncell,
    iconserv: bool,
    s_cc=None,
    force_g=None,
    periodic=None,
    scheme: str = "plm",
    rz=None,
    eb=None,
    umac_gn=None,
    use_forces_in_trans: bool = False,
):
    """Edge states + fluxes + advective tendency for one field; returns
    (fluxes, aofs). In 3D it goes through the kernel wrapper
    (godunov_kernels.godunov_plm, the multi-field kernel at nc=1)."""
    _check_scheme(scheme, use_forces_in_trans)
    if rz is not None or eb is not None or umac_gn is not None:
        raise NotImplementedError("RZ, EB and box-batched advection are not ported")
    if s_g.ndim == 3:
        from iamr_tpu_torch.ops.godunov_kernels import godunov_plm

        return godunov_plm(
            s_g, umac, umac_g, dt, dx, ncell, iconserv, force_g=force_g,
            periodic=periodic,
        )
    edges = compute_edge_states(
        s_g, umac_g, dt, dx, ncell, iconserv, force_g=force_g, periodic=periodic,
    )
    return compute_fluxes_and_aofs(edges, umac, dx, iconserv, s_cc=s_cc)


def compute_edge_states(
    s_g,
    umac_grown,
    dt,
    dx: Sequence[float],
    ncell: Sequence[int],
    iconserv: bool,
    force_g=None,
    periodic: Optional[Sequence[bool]] = None,
    scheme: str = "plm",
    use_forces_in_trans: bool = False,
):
    """Scalar edge states on all real faces given time-centred u_mac.

    s_g: scalar with 3 filled ghosts; umac_grown: MAC velocities with one
    transverse ghost row (grow_umac_transverse); force_g: optional, 1 ghost.
    Conservative form uses the flux difference d(v_mac s_hat)/dy in the
    transverse correction (plus -dt/2 s d(u_mac)/dx normal term),
    convective form vbar * d(s_hat)/dy."""
    _check_scheme(scheme, use_forces_in_trans)
    dim = s_g.ndim
    ng = 3
    n = tuple(ncell)
    dt = _as_dt(dt, s_g)

    slopes = [
        _trim(slope4(s_g, d), 1, ng, dims=[e for e in range(dim) if e != d])
        for d in range(dim)
    ]
    s_1 = _trim(s_g, 1, ng)

    def _predict(d):
        u_f = umac_grown[d]
        m = s_1.shape[d]
        cfl = dt / dx[d] * u_f
        pL = _shift(s_1, d, 0, m - 1) + 0.5 * (1.0 - cfl) * _shift(slopes[d], d, 0, m - 1)
        pR = _shift(s_1, d, 1, m - 1) - 0.5 * (1.0 + cfl) * _shift(slopes[d], d, 1, m - 1)
        return pL, pR

    preds = [_predict(d) for d in range(dim)]
    hat_s = [_upwind(preds[d][0], preds[d][1], umac_grown[d]) for d in range(dim)]

    def to_real(a, face_dim):
        return a[tuple(
            slice(None) if e == face_dim else slice(1, 1 + n[e])
            for e in range(dim)
        )]

    edges = []
    for d in range(dim):
        pL, pR = (to_real(p, d) for p in preds[d])
        corr_L = 0.0
        corr_R = 0.0
        for e in range(dim):
            if e == d:
                continue
            lo_idx, hi_idx = _cell_face_idx(dim, d, e, n)
            hq_lo, hq_hi = hat_s[e][lo_idx], hat_s[e][hi_idx]
            ue = umac_grown[e]
            uv_lo, uv_hi = ue[lo_idx], ue[hi_idx]
            if iconserv:
                t = -0.5 * dt / dx[e] * (uv_hi * hq_hi - uv_lo * hq_lo)
            else:
                vbar = 0.5 * (uv_lo + uv_hi)
                t = -0.5 * dt / dx[e] * vbar * (hq_hi - hq_lo)
            corr_L = corr_L + _shift(t, d, 0, n[d] + 1)
            corr_R = corr_R + _shift(t, d, 1, n[d] + 1)

        if iconserv:
            # +dt/2 * s * d(u_mac_d)/dx_d per cell; the normal-ghost cells
            # wrap (periodic) or copy the edge cell's divergence
            ud = umac_grown[d]
            dudx = (sl(ud, d, 1, None) - sl(ud, d, 0, -1)) / dx[d]
            if periodic is not None and periodic[d]:
                dudx = torch.cat(
                    [sl(dudx, d, -1, None), dudx, sl(dudx, d, 0, 1)], dim=d
                )
            else:
                dudx = torch.cat(
                    [sl(dudx, d, 0, 1), dudx, sl(dudx, d, -1, None)], dim=d
                )
            t = -0.5 * dt * to_real(s_1, d) * to_real(dudx, d)
            corr_L = corr_L + _shift(t, d, 0, n[d] + 1)
            corr_R = corr_R + _shift(t, d, 1, n[d] + 1)

        if force_g is not None:
            f_real = to_real(force_g, d)
            corr_L = corr_L + 0.5 * dt * _shift(f_real, d, 0, n[d] + 1)
            corr_R = corr_R + 0.5 * dt * _shift(f_real, d, 1, n[d] + 1)

        u_real = to_real(umac_grown[d], d)
        edges.append(_upwind(pL + corr_L, pR + corr_R, u_real))
    return tuple(edges)


def compute_fluxes_and_aofs(edges, umac, dx: Sequence[float], iconserv: bool,
                            s_cc=None, rz=None):
    """Fluxes F_d = u_mac_d * s_edge_d and the advective tendency:
    conservative aofs = div(F); convective aofs = div(F) - s * div(u_mac).
    Updates apply as S_new = S_old - dt * aofs."""
    if rz is not None:
        raise NotImplementedError("RZ advection is not ported")
    dim = len(edges)
    fluxes = tuple(umac[d] * edges[d] for d in range(dim))

    def _div(fs):
        out = 0.0
        for d in range(dim):
            out = out + (sl(fs[d], d, 1, None) - sl(fs[d], d, 0, -1)) / dx[d]
        return out

    div = _div(fluxes)
    if iconserv:
        return fluxes, div
    return fluxes, div - s_cc * _div(umac)
