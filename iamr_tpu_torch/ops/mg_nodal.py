"""Node-centred operators of the approximate nodal projection
(counterpart of iamr_tpu/ops/mg_nodal.py).

Only what the spectral projection calls is ported: the BC kinds, the cell
padding, G (nodes -> cell gradient), D (cells -> nodal divergence, the
adjoint of -G) and the cell-to-node average. The nodal multigrid solver
(smoothers, hierarchy, nodal_solve) waits for the multigrid slice.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from iamr_tpu_torch.ops.stencil import sl

# node BC kinds per (dim, side)
N_PERIODIC = 0
N_NEUMANN = 1  # wall/inflow/symmetry: sigma=0 outside
N_DIRICHLET = 2  # outflow: phi=0 on boundary nodes


@dataclasses.dataclass(frozen=True)
class NodalBC:
    lo: Tuple[int, ...]
    hi: Tuple[int, ...]

    @property
    def dim(self):
        return len(self.lo)


def _pad_cells(u, bc: NodalBC, dim):
    """Pad a cell array by one cell per side: wrap if periodic else zeros."""
    for d in range(dim):
        if bc.lo[d] == N_PERIODIC:
            lo, hi = sl(u, d, -1, None), sl(u, d, 0, 1)
        else:
            shp = list(u.shape)
            shp[d] = 1
            lo = torch.zeros(shp, dtype=u.dtype, device=u.device)
            hi = lo
        u = torch.cat([lo, u, hi], dim=d)
    return u


def _corner_avg(phi, d_target, dim):
    """Difference nodal phi along d_target, then average along every other
    dim (nodes -> cells): the cell derivative numerator * dx."""
    out = sl(phi, d_target, 1, None) - sl(phi, d_target, 0, -1)
    for d in range(dim):
        if d == d_target:
            continue
        out = 0.5 * (sl(out, d, 1, None) + sl(out, d, 0, -1))
    return out


def grad_node_to_cell(phi, dx):
    """G: nodal phi -> cell-centred gradient (tuple of cell arrays)."""
    dim = phi.ndim
    return tuple(_corner_avg(phi, d, dim) / dx[d] for d in range(dim))


def div_cell_to_node(u, dx, bc: NodalBC, inflow_vals=None):
    """D: cell vector field -> nodal divergence (adjoint of -G). Exterior
    cells are zero (walls) or wrapped (periodic); inflow_vals {(d, side):
    value} sets the prescribed normal velocity outside inflow faces."""
    dim = len(u)
    out = None
    for d in range(dim):
        ud = _pad_cells(u[d], bc, dim)
        if inflow_vals:
            for side in (0, 1):
                v = inflow_vals.get((d, side))
                if v is None:
                    continue
                idx = [slice(None)] * dim
                idx[d] = slice(0, 1) if side == 0 else slice(-1, None)
                ud = ud.clone()
                ud[tuple(idx)].fill_(v)
        t = sl(ud, d, 1, None) - sl(ud, d, 0, -1)
        for e in range(dim):
            if e == d:
                continue
            t = 0.5 * (sl(t, e, 1, None) + sl(t, e, 0, -1))
        t = t / dx[d]
        out = t if out is None else out + t
    return out


def avg_cell_to_node(s, bc: NodalBC):
    """Average a cell field to nodes (divu sources in the nodal rhs)."""
    return _adjacent_cell_sum(s, bc) / (2 ** s.ndim)


def _adjacent_cell_sum(sigma, bc: NodalBC):
    """Sum of sigma over the 2^dim cells adjacent to each node."""
    dim = sigma.ndim
    s = _pad_cells(sigma, bc, dim)
    for d in range(dim):
        s = sl(s, d, 1, None) + sl(s, d, 0, -1)
    return s
