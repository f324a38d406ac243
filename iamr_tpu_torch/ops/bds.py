"""BDS (Bell-Dawson-Shubin) advection edge states
(counterpart of iamr_tpu/ops/bds.py; ns.advection_scheme = BDS).

Per cell, a limited multilinear reconstruction built from corner (node)
values; an edge state is the average of the upwind cell's profile over the
space-time domain of dependence of the face: the normal sweep u*dt deep,
sheared by the cell's transverse velocities. At each backward time tau the
face footprint splits by cell membership into 2^(dim-1) boxes (for each
transverse dim e a band of width |v_e| tau lies in the neighbour opposite
v_e); a box's average of its own cell's multilinear profile is the profile
at the box centroid, and the tau integral of the resulting polynomial
(degree <= 5) is 3-point Gauss-Legendre, which is exact. The edge state is
thus a convex combination of limited in-cell profile values. Plain tensor
functions on every device: the JAX package has no kernel for them either.
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence

import torch

from iamr_tpu_torch.ops.godunov import _as_dt
from iamr_tpu_torch.ops.stencil import sl


def _shift(a, d, off, extent):
    return sl(a, d, off, off + extent)


def _pairwise(a, d, op):
    return op(sl(a, d, 0, -1), sl(a, d, 1, None))


def _corner_stats(s2, dim):
    """Corner (node) values, the average of the 2^dim adjacent cells
    clamped to their min/max, and those bounds. s2: the cells with 2 ghosts
    (extent n+4); outputs extent n+3 (the nodes of the ng=1 cells)."""
    avg, lo, hi = s2, s2, s2
    for d in range(dim):
        avg = _pairwise(avg, d, lambda x, y: 0.5 * (x + y))
        lo = _pairwise(lo, d, torch.minimum)
        hi = _pairwise(hi, d, torch.maximum)
    return torch.clamp(avg, lo, hi), lo, hi


def _cell_corners(corners, dim, sigma):
    """The corner array at offset sigma in {0,1}^dim of every ng=1 cell
    (extent n+2)."""
    m = corners.shape
    return corners[tuple(slice(sigma[d], m[d] - 1 + sigma[d]) for d in range(dim))]


def bds_coefficients(s_g, dx: Sequence[float]):
    """Per-cell multilinear coefficients on the ng=1 region of s_g (3
    ghosts). Returns ({monomial: coefficient}, (corner min, corner max)),
    monomials keyed by the 0/1 tuple of their dims (2D: (1, 0) sx, (0, 1)
    sy, (1, 1) sxy); the constant term is the cell value itself."""
    dim = s_g.ndim
    have = 3
    s2 = s_g[tuple(slice(have - 2, s_g.shape[d] - (have - 2)) for d in range(dim))]
    s1 = s_g[tuple(slice(have - 1, s_g.shape[d] - (have - 1)) for d in range(dim))]

    corners, clo, chi = _corner_stats(s2, dim)
    sigmas = list(itertools.product((0, 1), repeat=dim))
    C = {sg: _cell_corners(corners, dim, sg) for sg in sigmas}
    Lo = {sg: _cell_corners(clo, dim, sg) for sg in sigmas}
    Hi = {sg: _cell_corners(chi, dim, sg) for sg in sigmas}

    # mean-preserving limiter: clamp each corner to its neighbourhood
    # bounds, shift all corners to restore the cell mean; 3 rounds, the
    # final clamp wins
    ncor = float(len(sigmas))
    for _ in range(3):
        C = {sg: torch.clamp(C[sg], Lo[sg], Hi[sg]) for sg in sigmas}
        mean = sum(C.values()) / ncor
        corr = s1 - mean
        C = {sg: C[sg] + corr for sg in sigmas}
    C = {sg: torch.clamp(C[sg], Lo[sg], Hi[sg]) for sg in sigmas}

    # monomial M: sum_sg prod_{d in M} (2 sg_d - 1) C_sg / (2^dim prod dx_d/2)
    coefs = {}
    for mset in itertools.product((0, 1), repeat=dim):
        if sum(mset) == 0:
            continue
        acc = 0.0
        for sg in sigmas:
            w = 1.0
            for d in range(dim):
                if mset[d]:
                    w *= 2.0 * sg[d] - 1.0
            acc = acc + w * C[sg]
        denom = 2.0**dim
        for d in range(dim):
            if mset[d]:
                denom *= dx[d] / 2.0
        coefs[mset] = acc / denom
    coefs[(0,) * dim] = s1
    cmin = cmax = C[sigmas[0]]
    for sg in sigmas[1:]:
        cmin = torch.minimum(cmin, C[sg])
        cmax = torch.maximum(cmax, C[sg])
    return coefs, (cmin, cmax)


# 3-point Gauss-Legendre on [0, 1]: exact for the tau polynomial
_GS = 0.5 * (0.6 ** 0.5)
GL3 = ((0.5 - _GS, 5.0 / 18.0), (0.5, 8.0 / 18.0), (0.5 + _GS, 5.0 / 18.0))


def bds_edge_states(
    s_g,
    umac_grown,
    dt,
    dx: Sequence[float],
    ncell: Sequence[int],
    force_g=None,
    periodic: Optional[Sequence[bool]] = None,
):
    """BDS edge states on all real faces (the contract of
    godunov.compute_edge_states; the transverse velocities of the ghost
    cells wrap on periodic dims and copy the edge cell's otherwise)."""
    dim = s_g.ndim
    n = tuple(ncell)
    dt = _as_dt(dt, s_g)
    coefs, _ = bds_coefficients(s_g, dx)

    def cell_vel(e):
        """Cell-centred velocity e on the ng=1 region: the average of the
        two faces, extended by one cell along e."""
        ue = umac_grown[e]
        vb = 0.5 * (sl(ue, e, 0, -1) + sl(ue, e, 1, None))
        if periodic is not None and periodic[e]:
            lo, hi = sl(vb, e, -1, None), sl(vb, e, 0, 1)
        else:
            lo, hi = sl(vb, e, 0, 1), sl(vb, e, -1, None)
        return torch.cat([lo, vb, hi], dim=e)

    vcell = [cell_vel(e) for e in range(dim)]

    edges = []
    for d in range(dim):
        u_f = umac_grown[d]
        tdims = [e for e in range(dim) if e != d]

        def to_face_pair(a, shifts=None):
            """The L/R cells' values on the n_d+1 faces, real transverse,
            shifted by {e: +-1} transverse cells (the diagonal neighbour the
            sheared region spills into)."""
            shifts = shifts or {}
            m = a.shape[d]
            L = _shift(a, d, 0, m - 1)
            R = _shift(a, d, 1, m - 1)
            idx = tuple(
                slice(None) if e == d
                else slice(1 + shifts.get(e, 0), 1 + shifts.get(e, 0) + n[e])
                for e in range(dim)
            )
            return L[idx], R[idx]

        u_real = u_f[tuple(slice(None) if e == d else slice(1, 1 + n[e]) for e in range(dim))]
        au = torch.abs(u_real)
        su = torch.sign(u_real)
        up = u_real > 0.0

        # the upwind cell's transverse velocities
        v = {}
        for e in tdims:
            vL, vR = to_face_pair(vcell[e])
            v[e] = torch.where(up, vL, vR)

        subsets = []
        for r in range(len(tdims) + 1):
            subsets.extend(itertools.combinations(tdims, r))

        def coef_sel(mset, S):
            """The upwind coefficient of the cell that footprint subset S
            lands in (for e in S the neighbour opposite v_e): the shifted
            variants, each masked by the signs of v that select it."""
            out = None
            for sgs in itertools.product((-1, 1), repeat=len(S)):
                L, R = to_face_pair(coefs[mset], dict(zip(S, sgs)))
                c = torch.where(up, L, R)
                w = None
                for e, sg in zip(S, sgs):
                    # v_e > 0: the band leaves by the low side, neighbour -1
                    m = (v[e] > 0.0) if sg == -1 else (v[e] <= 0.0)
                    w = m if w is None else torch.logical_and(w, m)
                c = c if w is None else torch.where(w, c, torch.zeros_like(c))
                out = c if out is None else out + c
            return out

        csel = {S: {mset: coef_sel(mset, S) for mset in coefs} for S in subsets}

        out = 0.0
        for tq, wq in GL3:
            tau = tq * dt
            X = su * (0.5 * dx[d] - torch.clamp(au * tau, max=dx[d]))
            a_e = {e: torch.clamp(torch.abs(v[e]) * tau, max=dx[e]) for e in tdims}
            sg_e = {e: torch.sign(v[e]) for e in tdims}
            for S in subsets:
                # the footprint's fraction in this membership box and the
                # box centroid's offsets
                w_S = 1.0
                mu = {}
                for e in tdims:
                    if e in S:
                        w_S = w_S * (a_e[e] / dx[e])
                        mu[e] = sg_e[e] * 0.5 * (dx[e] - a_e[e])
                    else:
                        w_S = w_S * (1.0 - a_e[e] / dx[e])
                        mu[e] = -sg_e[e] * 0.5 * a_e[e]
                # the box's own cell's profile at the centroid
                P = 0.0
                for mset, c in csel[S].items():
                    term = c
                    if mset[d]:
                        term = term * X
                    for e in tdims:
                        if mset[e]:
                            term = term * mu[e]
                    P = P + term
                out = out + wq * w_S * P

        if force_g is not None:
            f_real = force_g[tuple(slice(None) if e == d else slice(1, 1 + n[e])
                                   for e in range(dim))]
            m = f_real.shape[d]
            fL = _shift(f_real, d, 0, m - 1)
            fR = _shift(f_real, d, 1, m - 1)
            out = out + 0.5 * dt * torch.where(u_real > 0.0, fL, fR)
        edges.append(out)
    return tuple(edges)
