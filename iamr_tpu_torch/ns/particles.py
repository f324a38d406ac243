"""Passive tracer particles (counterpart of iamr_tpu/ns/particles.py).

Structure of arrays: positions (N, dim) and an alive mask. AdvectWithUmac is
RK2 midpoint advection with multilinear interpolation of the MAC
velocities; redistribute wraps periodic positions and retires particles
that leave through other boundaries.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from iamr_tpu_torch.core.geometry import Geometry


class Particles(NamedTuple):
    pos: torch.Tensor    # (N, dim)
    alive: torch.Tensor  # (N,) bool


def from_positions(pos, device, dtype=torch.float64) -> Particles:
    pos = torch.as_tensor(pos, dtype=dtype, device=device)
    return Particles(pos=pos, alive=torch.ones(pos.shape[0], dtype=torch.bool, device=device))


def _interp_mac(umac, pos, geom: Geometry):
    """MAC velocities at particle positions (linear per dim): component d is
    face-centred in d and cell-centred in the others; periodic dims wrap,
    the others clamp."""
    dim = geom.dim
    dx = geom.dx
    out = []
    for d in range(dim):
        idxs = []
        for e in range(dim):
            xe = (pos[:, e] - geom.prob_lo[e]) / dx[e]
            idxs.append(xe if e == d else xe - 0.5)
        out.append(_multilinear(umac[d], idxs, geom, face_dim=d))
    return torch.stack(out, dim=-1)


def _multilinear(a, fidx: Sequence, geom: Geometry, face_dim: int):
    """One flat gather of all 2^dim corners per particle."""
    dim = a.ndim
    n = geom.ncell
    base, frac = [], []
    for e in range(dim):
        f0 = torch.floor(fidx[e])
        base.append(f0.to(torch.int64))
        frac.append(fidx[e] - f0)
    lins, ws = [], []
    for corner in range(2**dim):
        w = 1.0
        lin = 0
        for e in range(dim):
            bit = (corner >> e) & 1
            ie = base[e] + bit
            we = frac[e] if bit else (1.0 - frac[e])
            size = a.shape[e]
            if geom.periodic[e]:
                # a face array carries the duplicated face (size n+1): wrap
                # on the n real faces
                ie = torch.remainder(ie, n[e] if e == face_dim else size)
            else:
                ie = torch.clamp(ie, 0, size - 1)
            lin = lin * size + ie
            w = w * we
        lins.append(lin)
        ws.append(w)
    vals = torch.take(a.reshape(-1), torch.stack(lins, -1).reshape(-1))
    return torch.sum(vals.reshape(-1, 2**dim) * torch.stack(ws, -1), -1)


def advect_with_umac(parts: Particles, umac, dt, geom: Geometry) -> Particles:
    """RK2 midpoint: x* = x + dt/2 u(x); x^{n+1} = x + dt u(x*)."""
    u1 = _interp_mac(umac, parts.pos, geom)
    mid = _wrap(parts.pos + 0.5 * dt * u1, geom)
    u2 = _interp_mac(umac, mid, geom)
    return redistribute(parts._replace(pos=parts.pos + dt * u2), geom)


def _wrap(pos, geom: Geometry):
    cols = []
    for e in range(geom.dim):
        x = pos[:, e]
        lo, hi = geom.prob_lo[e], geom.prob_hi[e]
        if geom.periodic[e]:
            x = lo + torch.remainder(x - lo, hi - lo)
        cols.append(x)
    return torch.stack(cols, dim=-1)


def redistribute(parts: Particles, geom: Geometry) -> Particles:
    """Wrap periodic positions; retire particles that leave the domain
    through non-periodic boundaries."""
    alive = parts.alive
    for e in range(geom.dim):
        if not geom.periodic[e]:
            x = parts.pos[:, e]
            alive = alive & (x >= geom.prob_lo[e]) & (x <= geom.prob_hi[e])
    return Particles(pos=_wrap(parts.pos, geom), alive=alive)
