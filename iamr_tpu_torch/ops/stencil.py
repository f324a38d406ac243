"""Low-level stencil helpers over dense level tensors
(counterpart of iamr_tpu/ops/stencil.py).

Conventions:
  * cell arrays: shape (nx, ny[, nz])
  * face arrays for dim d: shape +1 in dim d (MAC staggering)
  * node arrays: shape +1 in every dim
"""

from __future__ import annotations

import torch


def sl(a, d: int, start, stop):
    """Slice axis d with [start:stop] (None allowed)."""
    idx = [slice(None)] * a.ndim
    idx[d] = slice(start, stop)
    return a[tuple(idx)]


def diff(a, d: int):
    """Forward difference along d: out has one fewer entry in d."""
    return sl(a, d, 1, None) - sl(a, d, None, -1)


def avg2(a, d: int):
    """Average of adjacent entries along d: out has one fewer entry in d."""
    return 0.5 * (sl(a, d, 1, None) + sl(a, d, None, -1))


def mac_div(umac, dx):
    """Divergence of a MAC (face-centred) vector field at cell centres."""
    out = 0.0
    for d, u in enumerate(umac):
        out = out + diff(u, d) / dx[d]
    return out


def checkerboard(shape, parity: int, dtype, device=None):
    """Mask of cells with (i+j+k) % 2 == parity."""
    total = None
    for d in range(len(shape)):
        view = [1] * len(shape)
        view[d] = shape[d]
        it = torch.arange(shape[d], device=device).reshape(view)
        total = it if total is None else total + it
    return (total % 2 == parity).to(dtype).expand(tuple(shape)).contiguous()


def cell_to_face(a, d: int, bc_wrap: bool = False):
    """Arithmetic average of a cell array to the faces of dim d (shape +1 in
    d). Periodic (bc_wrap): both domain faces get the wrapped average; else
    the edge cells are copied to the domain faces."""
    inner = avg2(a, d)
    if bc_wrap:
        wrap = 0.5 * (sl(a, d, 0, 1) + sl(a, d, -1, None))
        return torch.cat([wrap, inner, wrap], dim=d)
    return torch.cat([sl(a, d, 0, 1), inner, sl(a, d, -1, None)], dim=d)
