"""Ghost-cell fills for one dense level (counterpart of iamr_tpu/core/fill.py).

Physical BCs become pad rules per (dim, side), axes in order so edge and
corner ghosts are consistent:

  int_dir       periodic wrap
  ext_dir       ghost = prescribed boundary value
  foextrap      ghost = nearest interior cell
  hoextrap      quadratic extrapolation through the first 3 interior cells
  reflect_even  mirror across the face
  reflect_odd   negated mirror
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from iamr_tpu_torch.core.bc import BCRec, MathBC


def _ghost_block(a, d, side, ng, bc: MathBC, bcval):
    """The ng-wide ghost slab for (dim d, side 0=lo/1=hi)."""
    n = a.shape[d]
    if bc == MathBC.int_dir:
        return a.narrow(d, n - ng, ng) if side == 0 else a.narrow(d, 0, ng)
    if bc == MathBC.ext_dir:
        shp = list(a.shape)
        shp[d] = ng
        return torch.full(shp, bcval, dtype=a.dtype, device=a.device)
    if bc == MathBC.foextrap:
        edge = a.narrow(d, 0, 1) if side == 0 else a.narrow(d, n - 1, 1)
        reps = [1] * a.ndim
        reps[d] = ng
        return edge.repeat(reps)
    if bc == MathBC.hoextrap:
        # quadratic through the 3 nearest interior cells (centres 0.5, 1.5,
        # 2.5 from the face), evaluated at ghost centres x = -(k - 0.5)
        if side == 0:
            c0, c1, c2 = (a.narrow(d, k, 1) for k in range(3))
        else:
            c0, c1, c2 = (a.narrow(d, n - 1 - k, 1) for k in range(3))
        blocks = []
        for k in range(1, ng + 1):
            x = -(k - 0.5)
            l0 = (x - 1.5) * (x - 2.5) / ((0.5 - 1.5) * (0.5 - 2.5))
            l1 = (x - 0.5) * (x - 2.5) / ((1.5 - 0.5) * (1.5 - 2.5))
            l2 = (x - 0.5) * (x - 1.5) / ((2.5 - 0.5) * (2.5 - 1.5))
            blocks.append(l0 * c0 + l1 * c1 + l2 * c2)
        if side == 0:
            blocks = blocks[::-1]
        return torch.cat(blocks, dim=d)
    if bc in (MathBC.reflect_even, MathBC.reflect_odd):
        s = a.narrow(d, 0, ng) if side == 0 else a.narrow(d, n - ng, ng)
        s = torch.flip(s, dims=(d,))
        if bc == MathBC.reflect_odd:
            s = -s
        return s
    raise ValueError(f"unknown MathBC {bc}")


def pad_axis(a, d: int, ng: int, bc_lo: MathBC, bc_hi: MathBC, val_lo=0.0, val_hi=0.0):
    lo = _ghost_block(a, d, 0, ng, bc_lo, val_lo)
    hi = _ghost_block(a, d, 1, ng, bc_hi, val_hi)
    return torch.cat([lo, a, hi], dim=d)


def fill_ghost(
    a,
    ng: int,
    bcrec: BCRec,
    vals_lo: Optional[Sequence[float]] = None,
    vals_hi: Optional[Sequence[float]] = None,
):
    """Pad a single-component cell array with ng filled ghost cells
    (shape +2ng per dim); vals_lo/vals_hi are the ext_dir values per dim."""
    dim = a.ndim
    vals_lo = vals_lo if vals_lo is not None else (0.0,) * dim
    vals_hi = vals_hi if vals_hi is not None else (0.0,) * dim
    for d in range(dim):
        a = pad_axis(a, d, ng, bcrec.lo[d], bcrec.hi[d], vals_lo[d], vals_hi[d])
    return a
