"""EB divergences and redistribution (counterpart of iamr_tpu/eb/redist.py).

The AMReX-Hydro EB advection pieces IAMR calls (EB_ComputeDivergence and
ApplyRedistribution, ns.redistribution_type):

  * FluxRedist: the hybrid divergence of Colella et al. in cut cells,
        D_i = vfrac_i Dc_i + (1 - vfrac_i) Dnc_i,
    Dc the conservative cut-cell divergence and Dnc its vfrac-weighted
    3^dim neighbourhood average, with the defect
    vfrac_i (1 - vfrac_i)(Dc_i - Dnc_i) redistributed to the fluid
    neighbourhood in proportion to volume fraction (globally conservative);
  * StateRedist (the default): weighted state redistribution with a
    limited linear reconstruction over the merged neighbourhoods of the
    geometry's merge tracker (Giuliani et al. 2022);
  * NoRedist: the conservative divergence as it is.

Plain torch on every device, as plain jnp in the JAX package; none of it
reads the device back (no .item(), no boolean indexing), so a fixed-cycle
EB step makes no host sync.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from iamr_tpu_torch.eb.geom import EBData
from iamr_tpu_torch.ops.stencil import diff

_EPS = 1e-12


def eb_mac_div(umac, eb: EBData, dx: Sequence[float]):
    """Conservative divergence of face velocities per fluid volume:
    Dc = (1/vfrac) sum_d ((afrac u)_hi - (afrac u)_lo) / dx_d; 0 in covered
    cells."""
    out = 0.0
    for d, u in enumerate(umac):
        out = out + diff(eb.afrac[d] * u, d) / dx[d]
    return eb.fluid * out / torch.clamp(eb.vfrac, min=_EPS)


def _pad1(a, dim: int, periodic, value=0.0):
    """a grown by one cell on each side of every dim: wrapped where
    periodic, `value` elsewhere."""
    for d in range(dim):
        if periodic[d]:
            a = torch.cat([a.narrow(d, a.shape[d] - 1, 1), a, a.narrow(d, 0, 1)], dim=d)
        else:
            pad = [0, 0] * dim
            pad[2 * (dim - 1 - d)] = pad[2 * (dim - 1 - d) + 1] = 1
            a = F.pad(a, pad, value=value)
    return a


def _hood(ap, n, off):
    """The view of a once-grown array at offset off (each 0, 1 or 2)."""
    return ap[tuple(slice(off[d], off[d] + n[d]) for d in range(len(n)))]


def _neighborhood_sum(a, dim: int, periodic):
    """Sum of a over the 3^dim neighbourhood (with the cell itself); sides
    that are not periodic see zeros beyond the domain."""
    ap = _pad1(a, dim, periodic)
    out = None
    for off in itertools.product((0, 1, 2), repeat=dim):
        s = _hood(ap, a.shape, off)
        out = s if out is None else out + s
    return out


def hybrid_divergence(dc, eb: EBData, periodic):
    """FluxRedist: the hybrid divergence and the redistributed defect.

    dc: the conservative divergence (eb_mac_div of the fluxes). Returns D
    with sum V vfrac D == sum V vfrac dc."""
    dim = dc.ndim
    vf = eb.vfrac
    w = _neighborhood_sum(vf, dim, periodic)
    wmax = torch.clamp(w, min=_EPS)
    dnc = _neighborhood_sum(vf * dc, dim, periodic) / wmax
    cut = eb.fluid * (1.0 - eb.regular)
    hyb = torch.where(cut > 0.0, vf * dc + (1.0 - vf) * dnc, dc)
    delta = cut * vf * (1.0 - vf) * (dc - dnc)
    # neighbour j of i receives delta_i vfrac_j / W_i; per volume, cell j
    # receives sum_{i in N(j)} delta_i / W_i
    receive = _neighborhood_sum(delta / wmax, dim, periodic)
    return eb.fluid * (hyb + receive)


def _shift(a, d, s, periodic):
    """a shifted so that result[i] = a[i + s] along d, wrapped; along a dim
    that is not periodic the last |s| entries are 0, for either sign of s,
    as in the JAX package (for s < 0 the first entries keep the wrapped
    values: ROADMAP.md, notes on the reference)."""
    out = torch.roll(a, -s, d)
    if not periodic:
        out.narrow(d, a.shape[d] - abs(s), abs(s)).zero_()
    return out


def _shift_vec(a, off, periodic):
    for d, s in enumerate(off):
        if s != 0:
            a = _shift(a, d, s, periodic[d])
    return a


def _hood_minmax(q, fluid, dim, periodic):
    """(min, max) of q over the 3^dim fluid neighbourhood (with the cell);
    +-1e300 stand for no fluid (infinite in float32, as 1e300 rounds)."""
    big = 1e300 if q.dtype == torch.float64 else float("inf")
    qlo = torch.where(fluid > 0.0, q, big)
    qhi = torch.where(fluid > 0.0, q, -big)
    plo, phi = _pad1(qlo, dim, periodic, big), _pad1(qhi, dim, periodic, -big)
    mn = mx = None
    for off in itertools.product((0, 1, 2), repeat=dim):
        lo, hi = _hood(plo, q.shape, off), _hood(phi, q.shape, off)
        mn = lo if mn is None else torch.minimum(mn, lo)
        mx = hi if mx is None else torch.maximum(mx, hi)
    return mn, mx


def _offsets(dim):
    """The 3^dim - 1 neighbour offsets of a cell."""
    return [off for off in itertools.product((-1, 0, 1), repeat=dim) if any(off)]


class RedistGeom(NamedTuple):
    """What StateRedist reads of the geometry alone, formed once per
    geometry (state_redist_geometry) and shared by every field and step."""
    masks: tuple         # per merge face k = 2d + side, (merge_dir == k)
    nu: torch.Tensor     # 1 + the number of cells merging into the cell
    w: torch.Tensor      # vfrac / nu
    dxrel: tuple         # per merge face k and dim e, the target's position less x_i
    wdelta: tuple        # per neighbour offset (_offsets) and dim e, fluid_n (x_n - x_i)_e
    cof: tuple           # the least-squares normal matrix's cofactors, row by row
    det: torch.Tensor    # its determinant, 1 where singular
    ok: torch.Tensor     # where the determinant is not singular


def _merge_offsets(k):
    """(dim, step) of merge face k."""
    return k // 2, (-1 if k % 2 == 0 else 1)


def state_redist_geometry(eb: EBData, periodic) -> RedistGeom:
    """StateRedist's geometry terms of eb: the merge masks and counts, the
    merge targets' centroid offsets, and the least-squares normal matrix
    of the 3^dim fluid neighbourhood at the centroids (its cofactors and
    determinant)."""
    fluid, vf, md = eb.fluid, eb.vfrac, eb.merge_dir
    dim = vf.ndim
    nk = 2 * dim
    masks = [(md == k).to(vf.dtype) for k in range(nk)]
    nu = torch.ones_like(vf)
    for k in range(nk):
        d, s = _merge_offsets(k)
        nu = nu + _shift(masks[k], d, -s, periodic[d])
    cent = eb.cent if eb.cent is not None else tuple(torch.zeros_like(vf) for _ in range(dim))
    # per merge face k, the target's position less x_i: the integer step
    # never wraps, only the centroid field shifts
    dxrel = tuple(tuple((s if e == d else 0.0) + _shift(cent[e], d, s, periodic[d]) - cent[e]
                        for e in range(dim))
                  for d, s in map(_merge_offsets, range(nk)))

    A = [[torch.zeros_like(vf) for _ in range(dim)] for _ in range(dim)]
    wdelta = []
    for off in _offsets(dim):
        m = _shift_vec(fluid, off, periodic)
        delta = [off[e] + _shift_vec(cent[e], off, periodic) - cent[e] for e in range(dim)]
        wd = tuple(m * delta[e] for e in range(dim))
        wdelta.append(wd)
        for e in range(dim):
            for f in range(e, dim):
                A[e][f] = A[e][f] + wd[e] * delta[f]
    if dim == 2:
        det = A[0][0] * A[1][1] - A[0][1] * A[0][1]
        c01 = -A[0][1]
        cof = ((A[1][1], c01), (c01, A[0][0]))
    else:
        c00 = A[1][1] * A[2][2] - A[1][2] * A[1][2]
        c01 = A[0][2] * A[1][2] - A[0][1] * A[2][2]
        c02 = A[0][1] * A[1][2] - A[0][2] * A[1][1]
        c11 = A[0][0] * A[2][2] - A[0][2] * A[0][2]
        c12 = A[0][1] * A[0][2] - A[0][0] * A[1][2]
        c22 = A[0][0] * A[1][1] - A[0][1] * A[0][1]
        det = A[0][0] * c00 + A[0][1] * c01 + A[0][2] * c02
        cof = ((c00, c01, c02), (c01, c11, c12), (c02, c12, c22))
    ok = torch.abs(det) > _EPS
    return RedistGeom(masks=tuple(masks), nu=nu, w=vf / nu, dxrel=dxrel, wdelta=tuple(wdelta),
                      cof=cof, det=torch.where(ok, det, 1.0), ok=ok)


def _ls_slopes(q, rg: RedistGeom, fluid, periodic):
    """Least-squares slopes of q over the 3^dim fluid neighbourhood at the
    centroid positions (exact for linear fields, one-sided where the wall
    cuts the stencil), per dim in index units."""
    dim = q.ndim
    b = [torch.zeros_like(q) for _ in range(dim)]
    for off, wd in zip(_offsets(dim), rg.wdelta):
        dq = _shift_vec(q, off, periodic) - q
        for e in range(dim):
            b[e] = b[e] + wd[e] * dq
    g = []
    for row in rg.cof:
        num = row[0] * b[0]
        for f in range(1, dim):
            num = num + row[f] * b[f]
        g.append(torch.where(rg.ok, num / rg.det, 0.0) * fluid)
    return g


def state_redistribute(q, eb: EBData, periodic, rg: Optional[RedistGeom] = None):
    """StateRedist: weighted state redistribution with a limited linear
    reconstruction (AMReX-Hydro Redistribution::StateRedistribute).

    Each small cut cell (vfrac < 0.5) merges with its largest-volume face
    neighbour (eb.merge_dir). With nu_j the number of merged neighbourhoods
    holding cell j and w_r = vfrac_r / nu_r:

        Vhat_i = sum_{r in N(i)} w_r
        Qhat_i = sum_{r in N(i)} w_r q_r / Vhat_i
        xhat_i = sum_{r in N(i)} w_r x_r / Vhat_i
        q_j    = (1/nu_j) sum_{i : j in N(i)} [Qhat_i + alpha_i g_i . (x_j - xhat_i)]

    g_i the least-squares slope of q and alpha_i a Barth-Jespersen factor
    keeping every scattered value within the 3^dim fluid neighbourhood's
    bounds. sum vfrac q is conserved for any alpha, and linear fields are
    reproduced. Positions are the fluid centroids (eb.cent). rg: the
    geometry's terms (state_redist_geometry), formed here when not given."""
    dim = q.ndim
    fluid = eb.fluid
    if rg is None:
        rg = state_redist_geometry(eb, periodic)
    masks, nu, w, dxrel = rg.masks, rg.nu, rg.w, rg.dxrel
    nk = 2 * dim

    # the neighbourhood sums (self and target) of the merging cells
    sum_w = w
    sum_wq = w * q
    sum_wx = [torch.zeros_like(q) for _ in range(dim)]
    for k in range(nk):
        d, s = _merge_offsets(k)
        wt = _shift(w, d, s, periodic[d])
        sum_w = sum_w + masks[k] * wt
        sum_wq = sum_wq + masks[k] * _shift(w * q, d, s, periodic[d])
        for e in range(dim):
            sum_wx[e] = sum_wx[e] + masks[k] * wt * dxrel[k][e]
    vhat = torch.clamp(sum_w, min=_EPS)
    has = sum_w > _EPS
    qhat = torch.where(has, sum_wq / vhat, q)
    xrel_hat = [torch.where(has, sx / vhat, 0.0) for sx in sum_wx]

    # least-squares slopes and the Barth-Jespersen alpha over every target
    g = _ls_slopes(q, rg, fluid, periodic)
    qmin, qmax = _hood_minmax(q, fluid, dim, periodic)
    pos, neg = qmax - qhat, qmin - qhat

    def bj_ratio(val, alpha):
        r = torch.where(
            val > _EPS, pos / torch.clamp(val, min=_EPS),
            torch.where(val < -_EPS, neg / torch.clamp(val, max=-_EPS), 1.0),
        )
        return torch.minimum(alpha, torch.clamp(r, 0.0, 1.0))

    d_self = sum(g[e] * (-xrel_hat[e]) for e in range(dim))
    alpha = bj_ratio(d_self, torch.ones_like(q))
    d_tgt = []
    for k in range(nk):
        dt = sum(g[e] * (dxrel[k][e] - xrel_hat[e]) for e in range(dim))
        d_tgt.append(dt)
        alpha = torch.where(masks[k] > 0.0, bj_ratio(dt, alpha), alpha)

    # scatter: the cell's own receipt and those of the cells merging into it
    out = qhat + alpha * d_self
    for k in range(nk):
        d, s = _merge_offsets(k)
        out = out + _shift(masks[k] * (qhat + alpha * d_tgt[k]), d, -s, periodic[d])
    return fluid * out / nu


def eb_aofs(flux, umac, eb: EBData, dx: Sequence[float], iconserv: bool, s_cc=None,
            periodic=(), rtype: str = "FluxRedist", dt=None, rg: Optional[RedistGeom] = None):
    """The EB advective tendency with redistribution.

    flux: the face fluxes (u_mac times the edge states). Conservative:
    redistribute Dc(flux); convective: Dc(flux) - s Dc(u_mac). rtype
    NoRedist, FluxRedist or StateRedist (ns.redistribution_type);
    StateRedist redistributes the updated state q - dt Dc and turns it back
    into a tendency, and needs s_cc and dt (without them, FluxRedist); rg:
    its geometry terms where the caller has them (state_redist_geometry)."""
    dim = len(flux)
    if not periodic:
        periodic = (False,) * dim
    dc = eb_mac_div(flux, eb, dx)
    if not iconserv:
        dc = dc - s_cc * eb_mac_div(umac, eb, dx)
    if rtype == "NoRedist":
        return dc
    if rtype == "StateRedist" and eb.merge_dir is not None and s_cc is not None \
            and dt is not None:
        q_new = state_redistribute(s_cc - dt * dc, eb, periodic, rg)
        return (s_cc - q_new) * eb.fluid / dt
    return hybrid_divergence(dc, eb, periodic)


def set_body_state(a, eb: EBData, body_value=0.0):
    """Covered cells take the body state (set_body_state)."""
    return a * eb.fluid + body_value * eb.covered
