"""Passive tracer particles (counterpart of iamr_tpu/ns/particles.py).

Structure of arrays: positions (N, dim) and an alive mask. AdvectWithUmac is
RK2 midpoint advection with multilinear interpolation of the MAC
velocities; redistribute wraps periodic positions and retires particles
that leave through other boundaries. On an AMR hierarchy a particle
advects with the MAC velocities of the finest level that contains it
(advect_with_umac_levels). The files: the ascii init file
(particles.particle_init_file), the Timestamp file and the output file
(particles.particle_output_file), the same bytes as the JAX package's, and
the particle_count derive of plotfiles.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from iamr_tpu_torch.core.geometry import Geometry


class Particles(NamedTuple):
    pos: torch.Tensor    # (N, dim)
    alive: torch.Tensor  # (N,) bool


def from_positions(pos, device, dtype=torch.float64) -> Particles:
    pos = torch.as_tensor(pos, dtype=dtype, device=device)
    return Particles(pos=pos, alive=torch.ones(pos.shape[0], dtype=torch.bool, device=device))


def read_ascii_init_file(path: str, dim: int) -> np.ndarray:
    """The particles.particle_init_file format: the count, then one
    position per line -> (N, dim) float64."""
    with open(path) as f:
        toks = f.read().split()
    n = int(toks[0])
    return np.asarray(toks[1: 1 + n * dim], dtype=np.float64).reshape(n, dim)


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


def _composite_mac_velocity(levels, pos):
    """The velocity at the particle positions from the finest level that
    contains each particle (AmrTracerParticleContainer: a particle lives on
    the finest level whose grids contain it). levels: (umac, Geometry)
    pairs from coarse to fine, the finer geometries patch boxes in absolute
    coordinates. A particle counts as on a finer level while it is at least
    one cell inside its patch (the interpolation then needs no ghosts)."""
    u = _interp_mac(levels[0][0], pos, levels[0][1])
    for umac_l, geom_l in levels[1:]:
        inside = None
        for e in range(geom_l.dim):
            lo = geom_l.prob_lo[e] + geom_l.dx[e]
            hi = geom_l.prob_hi[e] - geom_l.dx[e]
            m = (pos[:, e] >= lo) & (pos[:, e] <= hi)
            inside = m if inside is None else inside & m
        u = torch.where(inside[:, None], _interp_mac(umac_l, pos, geom_l), u)
    return u


def advect_with_umac_levels(parts: Particles, levels, dt) -> Particles:
    """RK2 midpoint advection with a hierarchy's MAC velocities (the
    finest containing level per particle; the fine levels' should be the
    subcycle time averages), redistributed on level 0's geometry."""
    geom0 = levels[0][1]
    u1 = _composite_mac_velocity(levels, parts.pos)
    mid = _wrap(parts.pos + 0.5 * dt * u1, geom0)
    u2 = _composite_mac_velocity(levels, mid)
    return redistribute(parts._replace(pos=parts.pos + dt * u2), geom0)


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


def particle_count(parts: Particles, geom: Geometry):
    """Live particles per cell (the particle_count derive), int32 on the
    particles' device; integer adds, so the same on any device."""
    n = geom.ncell
    lin = torch.zeros_like(parts.alive, dtype=torch.int64)
    for e in range(geom.dim):
        ie = torch.floor((parts.pos[:, e] - geom.prob_lo[e]) / geom.dx[e]).to(torch.int64)
        lin = lin * n[e] + torch.clamp(ie, 0, n[e] - 1)
    flat = torch.zeros(int(np.prod(n)), dtype=torch.int32, device=lin.device)
    return flat.index_add_(0, lin, parts.alive.to(torch.int32)).reshape(n)


def timestamp(parts: Particles, path: str, time: float):
    """Append the live particles' index, the time and their positions to
    the Timestamp file `path`, one line each."""
    pos = parts.pos.cpu().numpy()
    idx = np.flatnonzero(parts.alive.cpu().numpy())
    line = f"%d {time:.12e} " + " ".join(["%.12e"] * pos.shape[1]) + "\n"
    with open(path, "a") as f:
        f.write("".join(map(line.__mod__, zip(idx.tolist(), *pos[idx].T.tolist()))))


def write_ascii_particles(path: str, parts: Particles):
    """particles.particle_output_file: the live particles' positions in the
    ascii init-file format (the count, then one position per line)."""
    pos = parts.pos.cpu().numpy()[parts.alive.cpu().numpy()]
    line = " ".join(["%.16e"] * pos.shape[1]) + "\n"
    with open(path, "w") as f:
        f.write(f"{pos.shape[0]}\n")
        f.write("".join(map(line.__mod__, zip(*pos.T.tolist()))))
