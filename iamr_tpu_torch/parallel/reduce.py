"""Layout-invariant reductions (counterpart of iamr_tpu/parallel/reduce.py),
on one device.

invariant_sum is a fixed index-pairing binary tree (x[:n/2] + x[n/2:] until
one element, zero-padded to a power of two), so its rounding order is a
property of the algorithm and matches the JAX package's bit for bit.
"""

from __future__ import annotations

import torch


def _tree_reduce_axis(v, axis: int):
    n = v.shape[axis]
    p = 1
    while p < n:
        p *= 2
    if p != n:
        shp = list(v.shape)
        shp[axis] = p - n
        v = torch.cat([v, torch.zeros(shp, dtype=v.dtype, device=v.device)], dim=axis)
    while v.shape[axis] > 1:
        h = v.shape[axis] // 2
        v = v.narrow(axis, 0, h) + v.narrow(axis, h, h)
    return v.squeeze(axis)


def invariant_sum(x):
    """Layout-invariant sum; a 0-d tensor of x.dtype."""
    return _tree_reduce_axis(x.reshape(-1), 0)


def invariant_mean(x):
    return invariant_sum(x) / x.numel()


def invariant_matvec(A, v):
    """A @ v with each row's contraction tree-reduced in the fixed pairing
    order (for the small dense bottom-solve matrices)."""
    return _tree_reduce_axis(A * v.unsqueeze(0), 1)
