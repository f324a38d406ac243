"""AMR level hierarchy: patch specs and the coarse <-> fine transfer
operators (counterpart of iamr_tpu/amr/hierarchy.py).

The reference's AmrCore machinery on dense tensors: FillPatch coarse-to-fine
interpolation (cell_cons_interp), avgDown restriction and the reflux
correction of the uncovered coarse cells at a coarse-fine interface. A fine
level is one dense tensor over its patch (a single box); multi-box levels
are not ported.

Index conventions: a LevelSpec gives the fine patch's lo corner and size in
the FINE index space; the covered coarse region is [lo/r, (lo+n)/r). Every
operator runs on the tensors' device and reads nothing back to the host.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Sequence, Tuple

import torch

from iamr_tpu_torch.core.geometry import Geometry
from iamr_tpu_torch.ops.stencil import sl


@dataclasses.dataclass(frozen=True)
class LevelSpec:
    """A fine level patch. lo/ncell in fine-level index units; ratio is the
    refinement ratio to the parent level."""

    lo: Tuple[int, ...]
    ncell: Tuple[int, ...]
    ratio: int = 2

    def __post_init__(self):
        for d in range(len(self.lo)):
            assert self.lo[d] % self.ratio == 0, "patch must align to coarse cells"
            assert self.ncell[d] % self.ratio == 0

    @property
    def dim(self):
        return len(self.lo)

    @property
    def crse_lo(self):
        return tuple(lo // self.ratio for lo in self.lo)

    @property
    def crse_ncell(self):
        return tuple(n // self.ratio for n in self.ncell)

    def fine_geom(self, crse_geom: Geometry) -> Geometry:
        dxf = tuple(h / self.ratio for h in crse_geom.dx)
        lo = tuple(crse_geom.prob_lo[d] + self.lo[d] * dxf[d] for d in range(self.dim))
        hi = tuple(lo[d] + self.ncell[d] * dxf[d] for d in range(self.dim))
        # periodic only if the patch spans the whole domain in that dim
        per = tuple(
            crse_geom.periodic[d] and self.lo[d] == 0
            and self.ncell[d] == crse_geom.ncell[d] * self.ratio
            for d in range(self.dim)
        )
        return Geometry(ncell=self.ncell, prob_lo=lo, prob_hi=hi, periodic=per,
                        coord_sys=crse_geom.coord_sys)

    def touches_domain(self, crse_geom: Geometry, d: int, side: int) -> bool:
        """Whether the patch face (d, side) lies on the physical domain
        boundary (physical BCs apply there, not coarse-fine interpolation)."""
        if side == 0:
            return self.lo[d] == 0
        return self.lo[d] + self.ncell[d] == crse_geom.ncell[d] * self.ratio


def patch_region(spec: LevelSpec):
    """Slice tuple of the fine patch inside the parent refined by its ratio."""
    return tuple(slice(spec.lo[d], spec.lo[d] + spec.ncell[d]) for d in range(spec.dim))


def _mc_slope(q, d):
    """Monotonized-central limited slope per coarse cell (interior; zero at
    the array's ends)."""
    m = q.shape[d]
    c = sl(q, d, 1, m - 1)
    lo = sl(q, d, 0, m - 2)
    hi = sl(q, d, 2, m)
    dc = 0.5 * (hi - lo)
    dl = 2.0 * (c - lo)
    dr = 2.0 * (hi - c)
    lim = torch.minimum(torch.abs(dl), torch.abs(dr))
    lim = torch.where(dl * dr > 0.0, lim, torch.zeros_like(lim))
    s = torch.sign(dc) * torch.minimum(torch.abs(dc), lim)
    z = torch.zeros_like(sl(q, d, 0, 1))
    return torch.cat([z, s, z], dim=d)


def fine_offsets(n_f: int, ratio: int, d: int, dim: int, dtype, device):
    """Each fine cell's offset within its coarse cell along d, in coarse-cell
    units, shaped to broadcast along dim d."""
    pos = (torch.arange(n_f, device=device) % ratio).to(dtype)
    shape = [1] * dim
    shape[d] = n_f
    return ((pos + 0.5) / ratio - 0.5).reshape(shape)


def prolong_cell(crse, ratio: int, limited: bool = True):
    """Conservative linear interpolation of a coarse cell array to fine cells
    (cell_cons_interp): fine = crse + sum_d slope_d * offset_d with
    MC-limited slopes; exactly conservative (the offsets average to zero)."""
    dim = crse.ndim
    out = crse
    for d in range(dim):
        out = torch.repeat_interleave(out, ratio, dim=d)
    if limited:
        for d in range(dim):
            s = _mc_slope(crse, d)
            for e in range(dim):
                s = torch.repeat_interleave(s, ratio, dim=e)
            out = out + s * fine_offsets(out.shape[d], ratio, d, dim, out.dtype, out.device)
    return out


def prolong_patch(crse, spec: LevelSpec, limited: bool = True):
    """prolong_cell(crse, spec.ratio)[patch_region(spec)], formed from the
    covered coarse cells and one neighbour each side (where the array has
    it): the same values, without refining the whole coarse array."""
    win, cut = crse, []
    for d in range(spec.dim):
        lo, hi = spec.crse_lo[d], spec.crse_lo[d] + spec.crse_ncell[d]
        wlo, whi = max(lo - 1, 0), min(hi + 1, crse.shape[d])
        win = sl(win, d, wlo, whi)
        cut.append(slice((lo - wlo) * spec.ratio, (hi - wlo) * spec.ratio))
    return prolong_cell(win, spec.ratio, limited)[tuple(cut)]


def restrict_cell(fine, ratio: int):
    """avgDown: the mean over the ratio^dim children."""
    out = fine
    for d in range(out.ndim):
        m = out.shape[d] // ratio
        acc = None
        for k in range(ratio):
            idx = [slice(None)] * out.ndim
            idx[d] = slice(k, k + ratio * m, ratio)
            take = out[tuple(idx)]
            acc = take if acc is None else acc + take
        out = acc / ratio
    return out


def restrict_node(fine, ratio: int):
    """Node restriction: injection at the coincident nodes (avgDown of the
    node-centred pressure)."""
    return fine[tuple(slice(0, None, ratio) for _ in range(fine.ndim))]


def crse_region(spec: LevelSpec):
    """Slice tuple of the coarse region covered by the fine patch."""
    return tuple(slice(spec.crse_lo[d], spec.crse_lo[d] + spec.crse_ncell[d])
                 for d in range(spec.dim))


def avg_down(crse, fine, spec: LevelSpec):
    """The coarse array with its covered region replaced by the restricted
    fine data (a new tensor)."""
    out = crse.clone()
    out[crse_region(spec)] = restrict_cell(fine, spec.ratio)
    return out


def avg_down_node(crse_p, fine_p, spec: LevelSpec):
    reg = tuple(slice(spec.crse_lo[d], spec.crse_lo[d] + spec.crse_ncell[d] + 1)
                for d in range(spec.dim))
    out = crse_p.clone()
    out[reg] = restrict_node(fine_p, spec.ratio)
    return out


def fill_patch_from_coarse(fine, crse, spec: LevelSpec, ng: int):
    """The fine patch grown by ng ghosts filled from the coarse level.

    Builds the prolonged coarse field over the grown patch box and pastes
    the fine interior on top (FillPatchTwoLevels at interior coarse-fine
    sides; the caller overwrites the physical-domain sides with its BC
    fill). Coarse cells outside the coarse array are edge-padded first
    (their values matter only where physical BCs overwrite them)."""
    dim = fine.ndim
    r = spec.ratio
    ngc = (ng + r - 1) // r  # coarse ghost cells needed
    win = crse
    for d in range(dim):
        lo = spec.crse_lo[d] - ngc
        hi = spec.crse_lo[d] + spec.crse_ncell[d] + ngc
        clo, chi = max(lo, 0), min(hi, crse.shape[d])
        win = sl(win, d, clo, chi)
        # edge-pad the window where it left the coarse array
        parts = []
        if clo - lo > 0:
            parts.append(sl(win, d, 0, 1).repeat_interleave(clo - lo, dim=d))
        parts.append(win)
        if hi - chi > 0:
            parts.append(sl(win, d, -1, None).repeat_interleave(hi - chi, dim=d))
        win = torch.cat(parts, dim=d) if len(parts) > 1 else win
    f_bg = prolong_cell(win, r)
    cut = ngc * r - ng
    if cut > 0:
        f_bg = f_bg[tuple(slice(cut, f_bg.shape[d] - cut) for d in range(dim))]
    f_bg = f_bg.contiguous()
    f_bg[tuple(slice(ng, ng + fine.shape[d]) for d in range(dim))] = fine
    return f_bg


def _transverse_mean(f, d, r):
    """Mean over r fine faces in every dim but d."""
    dim = f.ndim
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
    return f


def reflux_correct(crse, crse_flux, fine_flux, spec: LevelSpec, dt_over_dx: Sequence):
    """Flux-register correction of the uncovered coarse cells at the
    coarse-fine interface: for each face dim d and side, the coarse cell
    just outside the patch used crse_flux through the interface where the
    fine level moved the transverse mean of its fluxes; its update
    S -= dt (F_hi - F_lo)/dx is corrected by the difference (lo side:
    -dt/dx * delta, hi side: +dt/dx * delta). Interfaces on the domain
    boundary have no outside cell. Returns a new tensor."""
    dim = crse.ndim
    r = spec.ratio
    out = crse.clone()
    for d in range(dim):
        ff = fine_flux[d]
        for side in (0, 1):
            f_face = sl(ff, d, 0, 1) if side == 0 else sl(ff, d, -1, None)
            f_red = _transverse_mean(f_face, d, r)
            cf = spec.crse_lo[d] if side == 0 else spec.crse_lo[d] + spec.crse_ncell[d]
            if cf <= 0 or cf >= crse.shape[d]:
                continue
            idx_cf = [slice(spec.crse_lo[e], spec.crse_lo[e] + spec.crse_ncell[e])
                      for e in range(dim)]
            idx_cf[d] = slice(cf, cf + 1)
            delta = f_red - crse_flux[d][tuple(idx_cf)]
            cell = cf - 1 if side == 0 else cf
            idx_cell = list(idx_cf)
            idx_cell[d] = slice(cell, cell + 1)
            sign = -1.0 if side == 0 else 1.0
            out[tuple(idx_cell)] = out[tuple(idx_cell)] + sign * dt_over_dx[d] * delta
    return out


def read_fixed_grids(path: str, dim: int):
    """Parse an AMReX fixed-grids file (amr.regrid_file):

        <n refined levels>
        <ngrids at level 1>
        ((lo...) (hi...) (type...))   # one per grid, hi INCLUSIVE,
        <ngrids at level 2>           # indices in that level's own space
        ...

    Returns [level][grid] -> (lo tuple, hi_exclusive tuple)."""
    with open(path) as f:
        txt = f.read()
    items = []
    for line in txt.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("(("):
            groups = re.findall(r"\(([-\d,\s]+)\)", line)
            vals = [tuple(int(x) for x in g.replace(" ", ",").split(",") if x)
                    for g in groups]
            items.append(("box", vals))
        else:
            items.append(("count", int(line.split()[0])))
    assert items and items[0][0] == "count"
    nlev = items[0][1]
    out = []
    i = 1
    for _ in range(nlev):
        assert items[i][0] == "count"
        ng = items[i][1]
        i += 1
        grids = []
        for _ in range(ng):
            kind, vals = items[i]
            assert kind == "box"
            lo, hi = vals[0][:dim], vals[1][:dim]
            grids.append((tuple(lo), tuple(h + 1 for h in hi)))
            i += 1
        out.append(grids)
    return out
