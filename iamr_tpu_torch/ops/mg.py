"""Cell-centred ABecLaplacian pieces (counterpart of iamr_tpu/ops/mg.py).

Only what the spectral path calls is ported: the BC kinds, the ghost fill
(_pad_phi, _boundary_lift), the operator apply and get_fluxes. The multigrid
solver itself (hierarchy, smoothers, V-cycles, mg_solve) waits for the
multigrid slice.

Operator: (a alpha - b div(beta grad)) phi with beta on faces. Dirichlet
ghosts use g = (8/3) b - 2 c0 + (1/3) c1 (face value b).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from iamr_tpu_torch.ops.stencil import sl

# BC kinds
PERIODIC = 0
DIRICHLET = 1
NEUMANN = 2


@dataclasses.dataclass(frozen=True)
class PoissonBC:
    """Per-dim, per-side BC kinds for a cell-centred solve."""

    lo: Tuple[int, ...]
    hi: Tuple[int, ...]

    @property
    def dim(self):
        return len(self.lo)


def _pad_phi(phi, bc: PoissonBC):
    """Fill one homogeneous ghost layer around phi per the BC kinds."""
    for d in range(phi.ndim):
        n = phi.shape[d]
        if bc.lo[d] == PERIODIC:
            lo = sl(phi, d, n - 1, n)
            hi = sl(phi, d, 0, 1)
        else:
            c0l, c1l = sl(phi, d, 0, 1), sl(phi, d, 1, 2)
            c0h, c1h = sl(phi, d, n - 1, n), sl(phi, d, n - 2, n - 1)
            lo = -2.0 * c0l + (1.0 / 3.0) * c1l if bc.lo[d] == DIRICHLET else c0l
            hi = -2.0 * c0h + (1.0 / 3.0) * c1h if bc.hi[d] == DIRICHLET else c0h
        phi = torch.cat([lo, phi, hi], dim=d)
    return phi


def _boundary_lift(shape, bc: PoissonBC, bvals, dtype, device):
    """Ghost-only array holding the inhomogeneous part of the BC fill
    (Dirichlet: (8/3) * face value; Neumann: the value as given)."""
    dim = len(shape)
    g = torch.zeros(tuple(s + 2 for s in shape), dtype=dtype, device=device)
    if not bvals:
        return g
    for (d, side), val in bvals.items():
        if bc.lo[d] == PERIODIC:
            continue
        kind = bc.lo[d] if side == 0 else bc.hi[d]
        idx = [slice(1, -1)] * dim
        idx[d] = slice(0, 1) if side == 0 else slice(-1, None)
        v = torch.as_tensor(val, dtype=dtype, device=device)
        if v.ndim == dim - 1:
            v = v.unsqueeze(d)
        contrib = (8.0 / 3.0) * v if kind == DIRICHLET else v
        g[tuple(idx)] += contrib
    return g


def _face_lo(beta_d, d):
    return sl(beta_d, d, 0, -1)


def _face_hi(beta_d, d):
    return sl(beta_d, d, 1, None)


def apply_op(phi_g, alpha, beta, a, b, dx, shape):
    """L(phi) given phi WITH one filled ghost layer (phi_g)."""
    dim = len(shape)
    ctr = phi_g[tuple(slice(1, -1) for _ in range(dim))]
    out = a * alpha * ctr if a != 0.0 else torch.zeros_like(ctr)
    for d in range(dim):
        idx_lo = [slice(1, -1)] * dim
        idx_hi = [slice(1, -1)] * dim
        idx_lo[d] = slice(0, -2)
        idx_hi[d] = slice(2, None)
        lo_n = phi_g[tuple(idx_lo)]
        hi_n = phi_g[tuple(idx_hi)]
        bl = _face_lo(beta[d], d)
        bh = _face_hi(beta[d], d)
        lap = (bh * (hi_n - ctr) - bl * (ctr - lo_n)) / (dx[d] * dx[d])
        out = out - b * lap
    return out


def get_fluxes(phi, beta, b: float, dx, bc: PoissonBC, bvals: Optional[Dict] = None):
    """-b * beta * grad(phi) on all faces (tuple, shape +1 in dim d)."""
    dim = phi.ndim
    phi_g = _pad_phi(phi, bc)
    if bvals:
        phi_g = phi_g + _boundary_lift(tuple(phi.shape), bc, bvals, phi.dtype, phi.device)
    fluxes = []
    for d in range(dim):
        idx_all = [slice(1, -1)] * dim
        idx_all[d] = slice(None)
        line = phi_g[tuple(idx_all)]
        grad = (sl(line, d, 1, None) - sl(line, d, 0, -1)) / dx[d]
        fluxes.append(-b * beta[d] * grad)
    return tuple(fluxes)
