"""Spectral (FFT) solvers for all-periodic, constant-coefficient problems
(counterpart of iamr_tpu/solvers/spectral.py, on torch.fft).

The MAC projection, nodal projection and CN diffusion of an all-periodic run
with uniform density and constant viscosity are constant-coefficient
operators (7-point cell ABecLaplacian, 27-point FEM nodal Laplacian): one
rfftn, a divide by the operator's exact discrete symbol and one irfftn solve
them to roundoff. The symbols are formed in float64, as in the JAX
package, and cast to the field's dtype.
"""

from __future__ import annotations

from typing import Sequence

import math

import torch


def _freqs(shape, d, device):
    """2 pi k / n of dim d in rfftn layout, as a float64 tensor made on
    `device` (no host copy)."""
    n = shape[d]
    freq = torch.fft.rfftfreq if d == len(shape) - 1 else torch.fft.fftfreq
    return 2.0 * math.pi * freq(n, dtype=torch.float64, device=device)


def _bcast(f, d, dim):
    sh = [1] * dim
    sh[d] = f.shape[0]
    return f.reshape(sh)


def _cell_minus_lap_symbol(shape, dx, dtype, device):
    """Symbol of MINUS the 7-point cell Laplacian: sum_d (2-2cos k_d)/h_d^2,
    rfftn layout over `shape`. Formed in float64 on `device` (nothing
    crosses from the host), then cast."""
    dim = len(shape)
    sym = None
    for d in range(dim):
        k = _freqs(shape, d, device)
        s = _bcast((2.0 - 2.0 * torch.cos(k)) / (dx[d] * dx[d]), d, dim)
        sym = s if sym is None else sym + s
    return sym.to(dtype)


def _nodal_minus_lap_symbol(shape, dx, dtype, device):
    """Symbol of MINUS apply_nodal with sigma == 1 on the n^d periodic node
    lattice: sum_d (2-2cos k_d)/h_d^2 * prod_{e!=d} (4+2cos k_e)/6."""
    dim = len(shape)
    stiff, mass = [], []
    for d in range(dim):
        k = _freqs(shape, d, device)
        stiff.append((2.0 - 2.0 * torch.cos(k)) / (dx[d] * dx[d]))
        mass.append((4.0 + 2.0 * torch.cos(k)) / 6.0)
    sym = None
    for d in range(dim):
        term = None
        for e in range(dim):
            t = _bcast(stiff[e] if e == d else mass[e], e, dim)
            term = t if term is None else term * t
        sym = term if sym is None else sym + term
    return sym.to(dtype)


def solve_cell_helmholtz(rhs, a_alpha0, b_beta0, dx: Sequence[float]):
    """Solve (a_alpha0 - b_beta0 * lap7) phi = rhs on the all-periodic cell
    grid with scalar coefficients (floats or 0-d tensors). a_alpha0 == 0 is
    the singular Poisson case: the zero mode is discarded, phi mean-free."""
    shape = tuple(rhs.shape)
    dtype = rhs.dtype
    sym = _cell_minus_lap_symbol(shape, dx, dtype, rhs.device)
    rh = torch.fft.rfftn(rhs)
    denom = (a_alpha0 + b_beta0 * sym).clone()
    zero = (0,) * rhs.ndim
    d0 = denom[zero]
    # regularise the (0,...,0) mode; exact when a_alpha0 > 0
    denom[zero] = torch.where(torch.abs(d0) > 0.0, d0, torch.ones_like(d0))
    ph = rh / denom
    if isinstance(a_alpha0, torch.Tensor):
        ph0 = ph.clone()
        ph0[zero].fill_(0.0)
        ph = torch.where(a_alpha0.to(dtype) > 0.0, ph, ph0)
    elif not a_alpha0 > 0.0:
        ph[zero].fill_(0.0)
    return torch.fft.irfftn(ph, s=shape).to(dtype)


def solve_nodal_poisson(rhs_nodes, sigma0, dx: Sequence[float]):
    """Solve apply_nodal(phi, sigma0*ones) = rhs on all-periodic nodes
    ((n+1)^d arrays whose last slice duplicates the first), mean-free over
    the n^d independent nodes. Returns the full (n+1)^d wrapped phi."""
    dim = rhs_nodes.ndim
    dtype = rhs_nodes.dtype
    inner = rhs_nodes[(slice(0, -1),) * dim]
    shape = tuple(inner.shape)
    sym = _nodal_minus_lap_symbol(shape, dx, dtype, rhs_nodes.device)
    # apply_nodal is minus the assembled operator -> minus symbol
    rh = torch.fft.rfftn(-inner)
    zero = (0,) * dim
    # (fill_ on the zero mode: assigning a Python number there would copy
    # it from the host and wait for the stream)
    sym[zero].fill_(1.0)
    ph = rh / (sym * sigma0)
    ph[zero].fill_(0.0)
    phi = torch.fft.irfftn(ph, s=shape).to(dtype)
    for d in range(dim):
        phi = torch.cat([phi, phi.narrow(d, 0, 1)], dim=d)
    return phi


def spectral_eligible(cfg, rho0=None) -> bool:
    """Eligibility of the FFT path for a single-level, non-EB, non-RZ run:
    every side periodic, no LES, and (ns.fft_solve = -1, auto) a uniform
    initial density. ns.fft_solve = 1 forces it on, 0 off. Reads rho0 on
    the host once."""
    if cfg.fft_solve == 0:
        return False
    if not all(cfg.dom.is_periodic(d) for d in range(cfg.dim)):
        return False
    if cfg.do_les:
        return False
    if cfg.fft_solve == 1:
        return True
    if rho0 is None:
        return False
    r = torch.as_tensor(rho0).reshape(-1)
    return bool((r == r[0]).all())
