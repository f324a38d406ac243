"""Host-side numpy float64 mirrors of the FEM nodal operators (the port's
copy of iamr_tpu/ops/np_nodal.py).

They are the independent f64 oracle of the nodal solve: the true residual
of a solution returned by mg_nodal.nodal_solve (mixed f32/f64 on the card)
is recomputed here in plain numpy double precision, mirroring
ops/mg_nodal term by term:
  * np_apply_nodal      <-> mg_nodal.apply_nodal
  * np_div_cell_to_node <-> mg_nodal.div_cell_to_node
Verification helpers, never on the hot path.
"""

from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np

from iamr_tpu_torch.ops.mg_nodal import N_PERIODIC, NodalBC, _fem_element_matrix


def _sl(a, d, i0, i1):
    idx = [slice(None)] * a.ndim
    idx[d] = slice(i0, i1)
    return a[tuple(idx)]


def np_pad_cells(u: np.ndarray, bc: NodalBC, dim: int) -> np.ndarray:
    """Pad a cell array by one cell/side: wrap if periodic else zeros."""
    for d in range(dim):
        if bc.lo[d] == N_PERIODIC:
            lo = _sl(u, d, -1, None)
            hi = _sl(u, d, 0, 1)
        else:
            shp = list(u.shape)
            shp[d] = 1
            lo = np.zeros(shp, dtype=u.dtype)
            hi = np.zeros(shp, dtype=u.dtype)
        u = np.concatenate([lo, u, hi], axis=d)
    return u


def np_pad_nodes(phi: np.ndarray, bc: NodalBC) -> np.ndarray:
    """Pad a node array by one node/side (duplicated-DOF periodic)."""
    for d in range(phi.ndim):
        nn = phi.shape[d]
        if bc.lo[d] == N_PERIODIC:
            lo = _sl(phi, d, nn - 2, nn - 1)
            hi = _sl(phi, d, 1, 2)
        else:
            shp = list(phi.shape)
            shp[d] = 1
            lo = np.zeros(shp, dtype=phi.dtype)
            hi = np.zeros(shp, dtype=phi.dtype)
        phi = np.concatenate([lo, phi, hi], axis=d)
    return phi


def np_apply_nodal(phi, sigma, dx: Sequence[float], bc: NodalBC):
    """L(phi) in numpy f64 (mirror of mg_nodal.apply_nodal)."""
    phi = np.asarray(phi, np.float64)
    sigma = np.asarray(sigma, np.float64)
    dim = phi.ndim
    vol = 1.0
    for h in dx:
        vol *= float(h)
    K = _fem_element_matrix(dx)
    sp = np_pad_cells(sigma, bc, dim)
    pp = np_pad_nodes(phi, bc)
    nshape = tuple(s + 1 for s in sigma.shape)
    out = np.zeros(nshape, dtype=np.float64)
    for o in itertools.product((-1, 0, 1), repeat=dim):
        phi_o = pp[tuple(slice(1 + o[d], 1 + o[d] + nshape[d])
                         for d in range(dim))]
        coef = np.zeros(nshape, dtype=np.float64)
        choices = []
        for d in range(dim):
            if o[d] == -1:
                choices.append([(0, 1, 0)])
            elif o[d] == 1:
                choices.append([(1, 0, 1)])
            else:
                choices.append([(0, 1, 1), (1, 0, 0)])
        for combo in itertools.product(*choices):
            t = tuple(c[0] for c in combo)
            a = tuple(c[1] for c in combo)
            b = tuple(c[2] for c in combo)
            sg = sp[tuple(slice(t[d], t[d] + nshape[d]) for d in range(dim))]
            coef = coef + sg * K[(a, b)]
        out = out + coef * phi_o
    return -out / vol


def np_residual_nodal(phi, rhs, sigma, mask, dx: Sequence[float],
                      bc: NodalBC):
    """mask * (rhs - L(phi)) in numpy f64."""
    r = np.asarray(rhs, np.float64) - np_apply_nodal(phi, sigma, dx, bc)
    if mask is not None:
        r = np.asarray(mask, np.float64) * r
    return r


def np_div_cell_to_node(u, dx: Sequence[float], bc: NodalBC):
    """D: cell vector field -> nodal divergence in numpy f64 (mirror of
    mg_nodal.div_cell_to_node, exterior cells zero/wrapped)."""
    dim = len(u)
    out = None
    for d in range(dim):
        ud = np_pad_cells(np.asarray(u[d], np.float64), bc, dim)
        t = _sl(ud, d, 1, None) - _sl(ud, d, 0, -1)
        for e in range(dim):
            if e == d:
                continue
            t = 0.5 * (_sl(t, e, 1, None) + _sl(t, e, 0, -1))
        t = t / float(dx[d])
        out = t if out is None else out + t
    return out
