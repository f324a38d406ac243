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
                with caller-given upd and mask arrays, upd=)

Dispatch: the arguments (device, dtype, shape, contiguity) are checked on
either device; then a CPU tensor goes to the plain version
(cell_smooth_ref, nodal_jacobi_ref, built from ops/mg.py and
ops/mg_nodal.py) and a CUDA tensor to the kernel (csrc/mg_cell.cu,
csrc/mg_nodal.cu; f32 or f64, 2D or 3D, any size). Each wrapper adds one to
LAUNCHES per call that launches (one call runs all of its sweeps and the
residual, one CUDA launch each).
"""

from __future__ import annotations

import ctypes

import torch

from iamr_tpu_torch import native
from iamr_tpu_torch.ops import mg, mg_nodal
from iamr_tpu_torch.ops.stencil import checkerboard

LAUNCHES = {"mg_cell_gsrb": 0, "mg_nodal_jacobi": 0}


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


def _doubles(xs):
    return (ctypes.c_double * 3)(*(list(map(float, xs)) + [0.0] * (3 - len(xs))))


# ---------------------------------------------------------------------------
# mg_cell_gsrb: red-black Gauss-Seidel on the cell ABecLaplacian


def cell_smooth_ref(phi, rhs, alpha, beta, diag, a, b, dx, bc_lo, bc_hi,
                    nsweeps, want_resid, colour=None):
    """Plain version of mg_cell_gsrb (mg._smooth_rb / mg._residual of the
    JAX package): each pass phi + mask * (rhs - L phi) / diag with the
    ghosts of mg._pad_phi; returns (phi, residual or None)."""
    bc = mg.PoissonBC(tuple(bc_lo), tuple(bc_hi))
    shape = tuple(phi.shape)

    def residual(p):
        return rhs - mg.apply_op(mg._pad_phi(p, bc), alpha, beta, a, b, dx, shape)

    masks = [checkerboard(shape, c, phi.dtype, phi.device) for c in (0, 1)]
    for c in _cell_passes(nsweeps, colour):
        phi = phi + masks[c] * residual(phi) / diag
    return phi, (residual(phi) if want_resid else None)


def cell_smooth(phi, rhs, alpha, beta, diag, a: float, b, dx, bc_lo, bc_hi,
                nsweeps: int, want_resid: bool, colour=None):
    """nsweeps x (red, black) GS passes of (a alpha - b div beta grad) phi
    = rhs, or the one pass of `colour` (0 red, 1 black), then the residual
    rhs - L phi when want_resid. Returns (phi, residual or None).

    alpha: None when a == 0; beta: face arrays (+1 in their dim); diag:
    mg._diag; b: a float or a 0-d tensor; bc_lo/bc_hi: mg BC kinds. The
    ghosts are formed in the kernel. phi itself is not modified. The
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
    for name, t in (("phi", phi), ("rhs", rhs), ("diag", diag), ("alpha", alpha)):
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
        return cell_smooth_ref(phi, rhs, alpha, beta, diag, a, b, dx, bc_lo, bc_hi,
                               nsweeps, want_resid, colour)
    out = phi.clone() if passes else phi
    res = torch.empty_like(phi) if want_resid else None
    # an odd periodic extent puts same-colour cells side by side across the
    # wrap: each pass then reads a copy instead of updating in place
    odd = any(bc_lo[d] == mg.PERIODIC and n[d] % 2 for d in range(dim))
    copy = torch.empty_like(phi) if passes and odd else None
    betas = (ctypes.c_void_p * 3)(*([bd.data_ptr() for bd in beta] + [0] * (3 - dim)))
    rc = native.kernels().mg_cell_gsrb(
        native.DTYPES[dtype], dim, _ints(n), len(passes), passes[0] if passes else 0,
        out.data_ptr(),
        copy.data_ptr() if copy is not None else None, rhs.data_ptr(),
        alpha.data_ptr() if alpha is not None else None, float(a),
        b_t.data_ptr() if b_t is not None else None, 0.0 if b_t is not None else float(b),
        # 1 / dx^2 in double: the plain path divides by the Python float dx^2
        betas, diag.data_ptr(), _doubles([1.0 / (h * h) for h in dx]), _ints(bc_lo),
        _ints(bc_hi),
        res.data_ptr() if res is not None else None,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    native.check_rc(rc, "mg_cell_gsrb")
    LAUNCHES["mg_cell_gsrb"] += 1
    return out, res


# ---------------------------------------------------------------------------
# mg_nodal_jacobi: weighted Jacobi on the FEM nodal Laplacian


def nodal_jacobi_ref(phi, sigma, rhs, dx, bc_lo, bc_hi, nsweeps, want_resid,
                     mask, omega=None, diag=None, upd=None):
    """Plain version of mg_nodal_jacobi (mg_nodal._jacobi /
    _nodal_residual of the JAX package): each sweep phi + omega * mask * r
    / diag (or phi + upd * r with upd given), r = rhs - L phi; the residual
    is mask * r. Returns (phi, residual or None)."""
    bc = mg_nodal.NodalBC(tuple(bc_lo), tuple(bc_hi))

    def residual(p):
        return rhs - mg_nodal.apply_nodal(p, sigma, dx, bc)

    for _ in range(nsweeps):
        r = residual(phi)
        phi = phi + upd * r if upd is not None else phi + omega * mask * r / diag
    return phi, (mask * residual(phi) if want_resid else None)


def _corner_index(c):
    i = 0
    for x in c:
        i = 2 * i + x
    return i


def fem_k_table(dx):
    """mg_nodal._fem_element_matrix as a flat list: K[a][b] at
    a * 2^dim + b, corners numbered with dim 0 the most significant bit."""
    K = mg_nodal._fem_element_matrix(dx)
    nc = 2 ** len(dx)
    flat = [0.0] * 64
    for (ca, cb), v in K.items():
        flat[_corner_index(ca) * nc + _corner_index(cb)] = v
    return flat


def nodal_jacobi(phi, sigma, rhs, dx, bc_lo, bc_hi, nsweeps: int, want_resid: bool,
                 mask, omega=None, diag=None, upd=None):
    """nsweeps weighted-Jacobi sweeps of the sigma-weighted FEM nodal
    Laplacian (27-point 3D, 9-point 2D), then the masked residual when
    want_resid. Returns (phi, residual or None).

    phi, rhs, mask, diag, upd: node arrays (n+1 per dim); sigma: cells.
    The update is phi + omega * mask * (rhs - L phi) / diag, or with upd
    given phi + upd * (rhs - L phi). Periodic dims (bc_lo kind N_PERIODIC)
    wrap with the duplicated-DOF convention; other sides have zero ghosts
    and zero sigma outside. phi itself is not modified. The arguments are
    checked on either device."""
    dim, dtype, dev = phi.ndim, phi.dtype, phi.device
    nn = tuple(phi.shape)
    if dev.type not in ("cuda", "cpu") or dim not in (2, 3) or dtype not in native.DTYPES:
        raise ValueError(f"mg_nodal_jacobi: 2D/3D f32/f64 CUDA or CPU tensors, got "
                         f"{dim}D {dtype} on {dev}")
    if nsweeps and upd is None and (mask is None or diag is None or omega is None):
        raise ValueError("mg_nodal_jacobi: a sweep needs upd, or mask, diag and omega")
    if want_resid and mask is None:
        raise ValueError("mg_nodal_jacobi: the residual needs mask")
    native.check_tensor("sigma", sigma, tuple(x - 1 for x in nn), dtype, dev)
    for name, t in (("phi", phi), ("rhs", rhs), ("mask", mask), ("diag", diag),
                    ("upd", upd)):
        if t is not None:
            native.check_tensor(name, t, nn, dtype, dev)
    if dev.type == "cpu":
        return nodal_jacobi_ref(phi, sigma, rhs, dx, bc_lo, bc_hi, nsweeps, want_resid,
                                mask, omega, diag, upd)
    out = torch.empty_like(phi) if nsweeps else phi
    tmp = torch.empty_like(phi) if nsweeps > 1 else None
    res = torch.empty_like(phi) if want_resid else None
    vol = 1.0
    for h in dx:
        vol *= h
    per = [int(bc_lo[d] == mg_nodal.N_PERIODIC) for d in range(dim)]
    ptr = lambda t: t.data_ptr() if t is not None else None
    rc = native.kernels().mg_nodal_jacobi(
        native.DTYPES[dtype], dim, _ints(nn), nsweeps, phi.data_ptr(), ptr(out), ptr(tmp),
        sigma.data_ptr(), rhs.data_ptr(), ptr(upd), ptr(mask), ptr(diag),
        float(omega) if omega is not None else 0.0,
        (ctypes.c_double * 64)(*fem_k_table(dx)), 1.0 / vol, _ints(per), ptr(res),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    native.check_rc(rc, "mg_nodal_jacobi")
    LAUNCHES["mg_nodal_jacobi"] += 1
    return out, res
