"""Multigrid smoother kernels: CUDA wrappers and their plain PyTorch versions
(counterpart of iamr_tpu/ops/pallas_mg.py and the smoothers of
iamr_tpu/ops/pallas_fused.py).

  cell_smooth   mg_cell_gsrb, replaces pallas_fused.cell_smooth_fused (K4:
                nsweeps x (red, black) Gauss-Seidel passes plus an optional
                residual) and pallas_mg.cell_sweep (K5: one colour, or the
                residual alone, with colour= / nsweeps=0)
  nodal_jacobi  mg_nodal_jacobi, replaces pallas_mg.nodal_sweep (K6: one
                weighted-Jacobi sweep or the masked residual),
                pallas_fused.nodal_smooth_fused (K7: nsweeps sweeps plus the
                residual) and pallas_fused.nodal_smooth_sr (K8: the same
                with caller-given upd and mask arrays, upd= and mask=)

Dispatch: the arguments (device, dtype, shape, contiguity) are checked on
either device; then a CPU tensor goes to the plain version
(cell_smooth_ref, nodal_jacobi_ref, built from ops/mg.py and
ops/mg_nodal.py) and a CUDA tensor to the kernel (csrc/mg_cell.cu,
csrc/mg_nodal.cu; f32 or f64, 2D or 3D, any size). Both kernels form the
diagonal (and the nodal Dirichlet mask) themselves, so neither takes it;
cell_diag and nodal_diag_mask write their formulas out in PyTorch, and
nodal_coefs gives the nodal kernel its factored element matrix. Each
wrapper adds one to LAUNCHES per call that launches: one CUDA launch runs
all of a V-cycle call's sweeps and its residual (up to CELL_STAGES /
NODAL_STAGES stages; longer calls chain launches).
"""

from __future__ import annotations

import ctypes
import itertools

import torch

from iamr_tpu_torch import native
from iamr_tpu_torch.ops import mg, mg_nodal
from iamr_tpu_torch.ops.stencil import checkerboard

LAUNCHES = {"mg_cell_gsrb": 0, "mg_nodal_jacobi": 0}
# stages (colour passes or sweeps, plus the residual) of one launch, as
# compiled into csrc/mg_cell.cu and csrc/mg_nodal.cu (kMaxStages)
CELL_STAGES = 5
NODAL_STAGES = 4


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _cell_passes(nsweeps, colour):
    if colour is None:
        return [0, 1] * nsweeps
    if nsweeps:
        raise ValueError("colour= selects one pass; give nsweeps=0 with it")
    return [int(colour)]


def _ints(xs):
    return (ctypes.c_int * 3)(*(list(xs) + [0] * (3 - len(xs))))


def _doubles(xs, n=3):
    return (ctypes.c_double * n)(*(list(map(float, xs)) + [0.0] * (n - len(xs))))


def _ptr(t):
    return t.data_ptr() if t is not None else None


# ---------------------------------------------------------------------------
# mg_cell_gsrb: red-black Gauss-Seidel on the cell ABecLaplacian


def cell_smooth_ref(phi, rhs, alpha, beta, a, b, dx, bc_lo, bc_hi, nsweeps, want_resid,
                    colour=None):
    """Plain version of mg_cell_gsrb (mg._smooth_rb / mg._residual of the
    JAX package): each pass phi + mask * (rhs - L phi) / diag with the
    ghosts of mg._pad_phi and diag = mg._diag; returns (phi, residual or
    None)."""
    bc = mg.PoissonBC(tuple(bc_lo), tuple(bc_hi))
    shape = tuple(phi.shape)
    diag = mg._diag(torch.zeros_like(phi) if alpha is None else alpha, beta, a, b, dx, bc,
                    shape, phi.dtype)

    def residual(p):
        return rhs - mg.apply_op(mg._pad_phi(p, bc), alpha, beta, a, b, dx, shape)

    masks = [checkerboard(shape, c, phi.dtype, phi.device) for c in (0, 1)]
    for c in _cell_passes(nsweeps, colour):
        phi = phi + masks[c] * residual(phi) / diag
    return phi, (residual(phi) if want_resid else None)


def cell_diag(alpha, beta, a, b, dx, bc_lo, bc_hi):
    """The diagonal mg_cell.cu forms per cell, written out: a alpha +
    sum_d (b (f_lo beta_lo + f_hi beta_hi)) * (1 / dx_d^2), f = 3 on a
    Dirichlet boundary face, 0 on a Neumann one, 1 elsewhere, 0 replaced by
    1 (mg._diag up to the reciprocal multiply)."""
    dim = len(beta)
    shape = tuple(beta[0].shape[e] - (1 if e == 0 else 0) for e in range(dim))
    dtype, dev = beta[0].dtype, beta[0].device
    factor = {mg.DIRICHLET: 3.0, mg.NEUMANN: 0.0, mg.PERIODIC: 1.0}
    dg = a * alpha if a != 0.0 else torch.zeros(shape, dtype=dtype, device=dev)
    for d in range(dim):
        idx = torch.arange(shape[d], device=dev).reshape([-1 if e == d else 1
                                                          for e in range(dim)])
        one = torch.ones((), dtype=dtype, device=dev)
        cl = torch.where(idx == 0, factor[bc_lo[d]] * one, one)
        ch = torch.where(idx == shape[d] - 1, factor[bc_hi[d]] * one, one)
        bl, bh = beta[d].narrow(d, 0, shape[d]), beta[d].narrow(d, 1, shape[d])
        dg = dg + (b * (cl * bl + ch * bh)) * (1.0 / (dx[d] * dx[d]))
    return torch.where(dg == 0.0, torch.ones_like(dg), dg)


def cell_smooth(phi, rhs, alpha, beta, a: float, b, dx, bc_lo, bc_hi,
                nsweeps: int, want_resid: bool, colour=None):
    """nsweeps x (red, black) GS passes of (a alpha - b div beta grad) phi
    = rhs, or the one pass of `colour` (0 red, 1 black), then the residual
    rhs - L phi when want_resid. Returns (phi, residual or None).

    alpha: None when a == 0; beta: face arrays (+1 in their dim); b: a
    float or a 0-d tensor; bc_lo/bc_hi: mg BC kinds. The ghosts and the
    diagonal are formed in the kernel. phi itself is not modified. The
    arguments are checked on either device."""
    passes = _cell_passes(nsweeps, colour)
    dim, dtype, dev = phi.ndim, phi.dtype, phi.device
    n = tuple(phi.shape)
    if dev.type not in ("cuda", "cpu") or dim not in (2, 3) or dtype not in native.DTYPES:
        raise ValueError(f"mg_cell_gsrb: 2D/3D f32/f64 CUDA or CPU tensors, got "
                         f"{dim}D {dtype} on {dev}")
    if (alpha is None) != (a == 0.0):
        raise ValueError("mg_cell_gsrb: alpha must be given exactly when a != 0")
    for d in range(dim):
        if bc_lo[d] != mg.PERIODIC and n[d] < 2:
            raise ValueError("mg_cell_gsrb: a non-periodic dim needs >= 2 cells")
    for name, t in (("phi", phi), ("rhs", rhs), ("alpha", alpha)):
        if t is not None:
            native.check_tensor(name, t, n, dtype, dev)
    for d in range(dim):
        fshape = tuple(n[e] + (1 if e == d else 0) for e in range(dim))
        native.check_tensor(f"beta[{d}]", beta[d], fshape, dtype, dev)
    b_t = None
    if isinstance(b, torch.Tensor):
        if b.device != dev or b.numel() != 1:
            raise ValueError(f"mg_cell_gsrb: b must be a float or a 1-element tensor on {dev}")
        b_t = b.to(dtype).reshape(())
    if dev.type == "cpu":
        return cell_smooth_ref(phi, rhs, alpha, beta, a, b, dx, bc_lo, bc_hi,
                               nsweeps, want_resid, colour)
    if not passes and not want_resid:
        return phi, None
    out = torch.empty_like(phi) if passes else phi
    tmp = torch.empty_like(phi) if len(passes) > CELL_STAGES else None
    res = torch.empty_like(phi) if want_resid else None
    betas = (ctypes.c_void_p * 3)(*([bd.data_ptr() for bd in beta] + [0] * (3 - dim)))
    rc = native.kernels().mg_cell_gsrb(
        native.DTYPES[dtype], dim, _ints(n), len(passes), passes[0] if passes else 0,
        int(want_resid), phi.data_ptr(), _ptr(out) if passes else None, _ptr(tmp),
        rhs.data_ptr(), _ptr(alpha), float(a), _ptr(b_t),
        0.0 if b_t is not None else float(b), betas,
        # 1 / dx^2 in double: the plain path divides by the Python float dx^2
        _doubles([1.0 / (h * h) for h in dx]), _ints(bc_lo), _ints(bc_hi), _ptr(res),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    native.check_rc(rc, "mg_cell_gsrb")
    LAUNCHES["mg_cell_gsrb"] += 1
    return out, res


# ---------------------------------------------------------------------------
# mg_nodal_jacobi: weighted Jacobi on the FEM nodal Laplacian


def nodal_jacobi_ref(phi, sigma, rhs, dx, bc_lo, bc_hi, nsweeps, want_resid,
                     omega=None, upd=None, mask=None):
    """Plain version of mg_nodal_jacobi (mg_nodal._jacobi /
    _nodal_residual of the JAX package): each sweep phi + omega * mask * r
    / diag with mask = _dirichlet_mask and diag = nodal_diag (or phi + upd
    * r with upd and mask given), r = rhs - L phi; the residual is mask *
    r. Returns (phi, residual or None)."""
    bc = mg_nodal.NodalBC(tuple(bc_lo), tuple(bc_hi))
    diag = None
    if upd is None:
        mask = mg_nodal._dirichlet_mask(tuple(phi.shape), bc, phi.dtype, phi.device)
        diag = mg_nodal.nodal_diag(sigma, dx, bc)

    def residual(p):
        return rhs - mg_nodal.apply_nodal(p, sigma, dx, bc)

    for _ in range(nsweeps):
        r = residual(phi)
        phi = phi + upd * r if upd is not None else phi + omega * mask * r / diag
    return phi, (mask * residual(phi) if want_resid else None)


def fem_eigenvalues(dx):
    """The eigenvalues lambda_w of mg_nodal._fem_element_matrix in the
    Walsh-Hadamard basis of the corners, w with dim 0 the most significant
    bit: K = H diag(lambda) H / 2^dim, H_wa = (-1)^popcount(w & a). Every
    2x2 factor [[p, q], [q, p]] of K = sum_d S_d (x) prod M_e has
    eigenvalues p + q (w_d = 0) and p - q (w_d = 1): S_d gives 0 and
    2 / dx_d, M_e gives dx_e / 2 and dx_e / 6."""
    dim = len(dx)
    lam = []
    for w in itertools.product((0, 1), repeat=dim):
        val = 0.0
        for d in range(dim):
            term = 2.0 / dx[d] if w[d] else 0.0
            for e in range(dim):
                if e != d:
                    term *= dx[e] / 6.0 if w[e] else dx[e] / 2.0
            val += term
        lam.append(val)
    return lam


def nodal_coefs(dx):
    """What mg_nodal.cu multiplies the transformed corners by: -lambda_w /
    (2^dim V), in double (the kernel rounds them to its type)."""
    vol = 1.0
    for h in dx:
        vol *= h
    return [-lam / (2 ** len(dx) * vol) for lam in fem_eigenvalues(dx)]


def nodal_diag_mask(sigma, dx, bc_lo, bc_hi):
    """diag and mask as mg_nodal.cu forms them per node, written out: the
    sigma of the cells n - 1 + t (wrapped on periodic dims, 0 outside
    others) summed along dim 0, then dim 1, then dim 2, times -kap, pinned
    to -kap where 0; mask 0 on the nodes of Dirichlet sides. Equals
    mg_nodal.nodal_diag and _dirichlet_mask."""
    dim = sigma.ndim
    nc = tuple(sigma.shape)
    nn = tuple(c + 1 for c in nc)
    dev = sigma.device

    def cells(t):
        """sigma at cell n - 1 + t[d] per dim, for every node n."""
        out = sigma
        inside = torch.ones(nn, dtype=torch.bool, device=dev)
        for d in range(dim):
            g = torch.arange(nn[d], device=dev) - 1 + t[d]
            if bc_lo[d] == mg_nodal.N_PERIODIC:
                ok = torch.ones_like(g, dtype=torch.bool)
                g = g % nc[d]
            else:
                ok = (g >= 0) & (g < nc[d])
                g = g.clamp(0, nc[d] - 1)
            out = out.index_select(d, g)
            inside = inside & ok.reshape([-1 if e == d else 1 for e in range(dim)])
        return torch.where(inside, out, torch.zeros_like(out))

    # per column: sigma(p) + sigma(p - 1); then the gathers of the columns
    u = {t: cells((1,) + t) + cells((0,) + t) for t in itertools.product((1, 0), repeat=dim - 1)}
    if dim == 3:
        adj = (u[(1, 1)] + u[(0, 1)]) + (u[(1, 0)] + u[(0, 0)])
    else:
        adj = u[(1,)] + u[(0,)]
    kap = sum(1.0 / (3 ** (dim - 1) * dx[d] ** 2) for d in range(dim))
    diag = -adj * kap
    diag = torch.where(diag == 0.0, torch.full_like(diag, -kap), diag)
    mask = torch.ones(nn, dtype=sigma.dtype, device=dev)
    for d in range(dim):
        if bc_lo[d] == mg_nodal.N_PERIODIC:
            continue
        g = torch.arange(nn[d], device=dev).reshape([-1 if e == d else 1 for e in range(dim)])
        dirichlet = ((g == 0) & (bc_lo[d] == mg_nodal.N_DIRICHLET)) | \
            ((g == nn[d] - 1) & (bc_hi[d] == mg_nodal.N_DIRICHLET))
        mask = torch.where(dirichlet, torch.zeros_like(mask), mask)
    return diag, mask


def nodal_jacobi(phi, sigma, rhs, dx, bc_lo, bc_hi, nsweeps: int, want_resid: bool,
                 omega=None, upd=None, mask=None):
    """nsweeps weighted-Jacobi sweeps of the sigma-weighted FEM nodal
    Laplacian (27-point 3D, 9-point 2D), then the masked residual when
    want_resid. Returns (phi, residual or None).

    phi, rhs, upd, mask: node arrays (n+1 per dim); sigma: cells. The
    update is phi + omega * mask * (rhs - L phi) / diag with the Dirichlet
    mask and diag formed from sigma and the BC kinds, or with upd and mask
    given (K8) phi + upd * (rhs - L phi); the residual is mask * (rhs - L
    phi). Periodic dims (bc_lo kind N_PERIODIC) wrap with the
    duplicated-DOF convention; other sides have zero ghosts and zero sigma
    outside. phi itself is not modified. The arguments are checked on
    either device."""
    dim, dtype, dev = phi.ndim, phi.dtype, phi.device
    nn = tuple(phi.shape)
    if dev.type not in ("cuda", "cpu") or dim not in (2, 3) or dtype not in native.DTYPES:
        raise ValueError(f"mg_nodal_jacobi: 2D/3D f32/f64 CUDA or CPU tensors, got "
                         f"{dim}D {dtype} on {dev}")
    if (upd is None) != (mask is None):
        raise ValueError("mg_nodal_jacobi: give upd and mask together, or neither")
    if nsweeps and upd is None and omega is None:
        raise ValueError("mg_nodal_jacobi: a sweep needs omega, or upd and mask")
    native.check_tensor("sigma", sigma, tuple(x - 1 for x in nn), dtype, dev)
    for name, t in (("phi", phi), ("rhs", rhs), ("upd", upd), ("mask", mask)):
        if t is not None:
            native.check_tensor(name, t, nn, dtype, dev)
    if dev.type == "cpu":
        return nodal_jacobi_ref(phi, sigma, rhs, dx, bc_lo, bc_hi, nsweeps, want_resid,
                                omega, upd, mask)
    if not nsweeps and not want_resid:
        return phi, None
    out = torch.empty_like(phi) if nsweeps else phi
    tmp = torch.empty_like(phi) if nsweeps > NODAL_STAGES else None
    res = torch.empty_like(phi) if want_resid else None
    kinds = lambda side, kind: _ints([int(side[d] == kind) for d in range(dim)])
    kap = sum(1.0 / (3 ** (dim - 1) * dx[d] ** 2) for d in range(dim))
    rc = native.kernels().mg_nodal_jacobi(
        native.DTYPES[dtype], dim, _ints(nn), nsweeps, int(want_resid), phi.data_ptr(),
        _ptr(out) if nsweeps else None, _ptr(tmp), sigma.data_ptr(), rhs.data_ptr(),
        _ptr(upd), _ptr(mask), float(omega) if omega is not None else 0.0,
        _doubles(nodal_coefs(dx), 8), kap, kinds(bc_lo, mg_nodal.N_PERIODIC),
        kinds(bc_lo, mg_nodal.N_DIRICHLET), kinds(bc_hi, mg_nodal.N_DIRICHLET), _ptr(res),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    native.check_rc(rc, "mg_nodal_jacobi")
    LAUNCHES["mg_nodal_jacobi"] += 1
    return out, res
