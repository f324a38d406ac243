"""Node-centred Laplacian multigrid for the approximate nodal projection
(counterpart of iamr_tpu/ops/mg_nodal.py).

Solves L(phi) = rhs on node-centred phi with cell-centred sigma (= 1/rho),
L the sigma-weighted bilinear/trilinear FEM Laplacian (27-point 3D, 9-point
2D). G (nodes -> cell gradient) and D (cells -> nodal divergence, the
adjoint of -G) are the projection's operators. sigma = 0 outside walls
(Neumann), phi = 0 on outflow nodes (Dirichlet), periodic wrap otherwise;
node arrays carry the duplicated periodic DOF (shape n+1).

Smoother: weighted Jacobi, the kernel mg_nodal_jacobi on CUDA tensors and
its plain version on CPU tensors (ops/mg_kernels.py). Full-weighting
restriction, bilinear prolongation, a dense (or CG) bottom solve, an FMG
opening in mixed mode. mixed=True runs f32 V-cycles with a true-f64 outer
residual (the kernel instantiated for double); mixed=None means False.
nodal_solve_df (the TPU's f32-pair solve) is not ported: the card has
native f64.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from iamr_tpu_torch.ops import mg, mg_kernels
from iamr_tpu_torch.ops.stencil import sl
from iamr_tpu_torch.parallel.reduce import invariant_matvec, invariant_mean, invariant_sum

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


def _pad_nodes(phi, bc: NodalBC):
    """Pad a node array by one node per side (the first bc.dim dims; a
    trailing batch dim is carried along). Periodic dims use the
    duplicated-DOF convention (node 0 == node n): the node left of 0 is
    n-1, right of n is 1. Non-periodic sides pad zero."""
    for d in range(bc.dim):
        nn = phi.shape[d]
        if bc.lo[d] == N_PERIODIC:
            lo, hi = sl(phi, d, nn - 2, nn - 1), sl(phi, d, 1, 2)
        else:
            shp = list(phi.shape)
            shp[d] = 1
            lo = torch.zeros(shp, dtype=phi.dtype, device=phi.device)
            hi = lo
        phi = torch.cat([lo, phi, hi], dim=d)
    return phi


def _fem_element_matrix(dx):
    """Element stiffness K[a][b] for a bilinear/trilinear element of size dx:
    K = sum_d S_d (x) prod_{e!=d} M_e, S = (1/dx)[[1,-1],[-1,1]], M =
    (dx/6)[[2,1],[1,2]]; a dict keyed by corner tuples a, b in {0,1}^dim."""
    dim = len(dx)
    S = [np.array([[1.0, -1.0], [-1.0, 1.0]]) / dx[d] for d in range(dim)]
    M = [np.array([[2.0, 1.0], [1.0, 2.0]]) * dx[d] / 6.0 for d in range(dim)]
    corners = list(itertools.product((0, 1), repeat=dim))
    K = {}
    for a in corners:
        for b in corners:
            val = 0.0
            for d in range(dim):
                term = 1.0
                for e in range(dim):
                    mat = S[e] if e == d else M[e]
                    term *= mat[a[e], b[e]]
                val += term
            K[(a, b)] = float(val)
    return K


def _dirichlet_mask(shape, bc: NodalBC, dtype, device):
    """1 where phi is an unknown, 0 at Dirichlet (outflow) boundary nodes."""
    m = torch.ones(shape, dtype=dtype, device=device)
    for d in range(len(shape)):
        if bc.lo[d] == N_DIRICHLET:
            m.narrow(d, 0, 1).fill_(0.0)
        if bc.hi[d] == N_DIRICHLET:
            m.narrow(d, shape[d] - 1, 1).fill_(0.0)
    return m


def _offset_choices(o):
    """Per dim, the (t, a, b) of the cells shared by node n and n+o: t the
    cell offset (cell n-1+t), a and b the corners of the two nodes."""
    out = []
    for od in o:
        if od == -1:
            out.append([(0, 1, 0)])
        elif od == 1:
            out.append([(1, 0, 1)])
        else:
            out.append([(0, 1, 1), (1, 0, 0)])
    return out


def apply_nodal(phi, sigma, dx, bc: NodalBC):
    """L(phi) = -(1/V) assemble(sigma K_elem), exterior sigma = 0 (walls,
    inflow) or wrapped (periodic). The FEM stencil, not D(sigma G phi):
    the latter decouples into checkerboard sublattices on square cells.
    phi may carry a trailing batch dim."""
    dim = sigma.ndim
    vol = 1.0
    for h in dx:
        vol *= h
    K = _fem_element_matrix(dx)
    sp = _pad_cells(sigma, bc, dim)  # cells padded by 1: nn+1 per dim
    pp = _pad_nodes(phi, bc)         # nodes padded by 1: nn+2 per dim
    nshape = tuple(s + 1 for s in sigma.shape)
    batch = (1,) * (phi.ndim - dim)
    out = torch.zeros(tuple(phi.shape), dtype=phi.dtype, device=phi.device)
    for o in itertools.product((-1, 0, 1), repeat=dim):
        phi_o = pp[tuple(slice(1 + o[d], 1 + o[d] + nshape[d]) for d in range(dim))]
        coef = torch.zeros(nshape, dtype=phi.dtype, device=phi.device)
        for combo in itertools.product(*_offset_choices(o)):
            t = tuple(c[0] for c in combo)
            a = tuple(c[1] for c in combo)
            b = tuple(c[2] for c in combo)
            sig = sp[tuple(slice(t[d], t[d] + nshape[d]) for d in range(dim))]
            coef = coef + sig * K[(a, b)]
        out = out - coef.reshape(nshape + batch) * phi_o / vol
    return out


def _jacobi_safe_omega(dx, dim: int, cap: float = 0.85) -> float:
    """Weighted-Jacobi damping that cannot diverge: by Gershgorin,
    min(cap, 1.8 / bound) with bound the row sum over the diagonal of the
    locally-constant-sigma stencil (0.85 on isotropic grids; smaller where
    anisotropy costs the trilinear stencil its diagonal dominance)."""
    K = _fem_element_matrix(dx)
    diag_abs = 0.0
    absrow = 0.0
    for o in itertools.product((-1, 0, 1), repeat=dim):
        coef = 0.0
        for combo in itertools.product(*_offset_choices(o)):
            coef += K[(tuple(c[1] for c in combo), tuple(c[2] for c in combo))]
        if all(x == 0 for x in o):
            diag_abs = abs(coef)
        else:
            absrow += abs(coef)
    bound = (absrow + diag_abs) / diag_abs
    return float(min(cap, 1.8 / bound))


def nodal_diag(sigma, dx, bc: NodalBC):
    """Diagonal of the FEM L: -(sum of adjacent sigma) sum_d 1/(3^(dim-1)
    dx_d^2); nodes with no adjacent sigma (covered) are pinned to -kap."""
    dim = sigma.ndim
    kap = sum(1.0 / (3 ** (dim - 1) * dx[d] ** 2) for d in range(dim))
    d = -_adjacent_cell_sum(sigma, bc) * kap
    return torch.where(d == 0.0, torch.full_like(d, -kap), d)


def _coarsen_sigma(sigma, dim):
    for d in range(dim):
        idx0 = [slice(None)] * sigma.ndim
        idx1 = [slice(None)] * sigma.ndim
        idx0[d] = slice(0, None, 2)
        idx1[d] = slice(1, None, 2)
        sigma = 0.5 * (sigma[tuple(idx0)] + sigma[tuple(idx1)])
    return sigma


def _stride2(a, d, start, count):
    idx = [slice(None)] * a.ndim
    idx[d] = slice(start, start + 2 * count - 1, 2)
    return a[tuple(idx)]


def _restrict_node(r, bc: NodalBC):
    """Full-weighting restriction rc[j] = 0.5 r[2j] + 0.25 (r[2j-1] +
    r[2j+1]); missing neighbours wrap in periodic dims and drop at walls
    and outflow."""
    for d in range(r.ndim):
        n = r.shape[d] - 1
        if bc.lo[d] == N_PERIODIC:
            lo, hi = sl(r, d, n - 1, n), sl(r, d, 1, 2)
        else:
            shp = list(r.shape)
            shp[d] = 1
            lo = torch.zeros(shp, dtype=r.dtype, device=r.device)
            hi = lo
        rp = torch.cat([lo, r, hi], dim=d)  # node k at rp[k+1]
        nc = n // 2 + 1
        r = 0.5 * _stride2(rp, d, 1, nc) + 0.25 * (_stride2(rp, d, 0, nc)
                                                   + _stride2(rp, d, 2, nc))
    return r


def _prolong_node(e, dim):
    """Bilinear nodal prolongation: coincident nodes copy, odd nodes average."""
    for d in range(dim):
        odd = 0.5 * (sl(e, d, 1, None) + sl(e, d, 0, -1))
        shp = list(e.shape)
        shp[d] = e.shape[d] + odd.shape[d]
        out = torch.empty(shp, dtype=e.dtype, device=e.device)
        idx_e = [slice(None)] * e.ndim
        idx_e[d] = slice(0, None, 2)
        idx_o = [slice(None)] * e.ndim
        idx_o[d] = slice(1, None, 2)
        out[tuple(idx_e)] = e
        out[tuple(idx_o)] = odd
        e = out
    return e


@dataclasses.dataclass
class NodalLevel:
    sigma: torch.Tensor
    diag: torch.Tensor
    mask: torch.Tensor
    dx: Tuple[float, ...]
    nshape: Tuple[int, ...]
    omega: float = 0.85  # divergence-safe Jacobi damping (_jacobi_safe_omega)


def build_nodal_hierarchy(sigma, dx, bc: NodalBC, min_size: int = 2,
                          max_levels: int = 30, stop_dofs: int = 0, mask0=None):
    """stop_dofs: stop coarsening once a level has <= stop_dofs nodes (the
    dense-bottom truncation). mask0 (the multi-box solve's constrained
    nodes) is not ported."""
    if mask0 is not None:
        raise NotImplementedError("multi-box (union) nodal solves are not ported")
    dim = sigma.ndim
    levels = []
    cur_sigma, cur_dx = sigma, tuple(dx)
    while True:
        cshape = tuple(cur_sigma.shape)
        nshape = tuple(n + 1 for n in cshape)
        levels.append(NodalLevel(
            cur_sigma, nodal_diag(cur_sigma, cur_dx, bc),
            _dirichlet_mask(nshape, bc, sigma.dtype, sigma.device), cur_dx, nshape,
            _jacobi_safe_omega(cur_dx, dim),
        ))
        if (len(levels) >= max_levels or any(n % 2 != 0 for n in cshape)
                or min(cshape) <= min_size or int(np.prod(nshape)) <= stop_dofs):
            break
        cur_sigma = _coarsen_sigma(cur_sigma, dim)
        cur_dx = tuple(2.0 * h for h in cur_dx)
    return levels


def _smooth2(phi, rhs, lev: NodalLevel, bc: NodalBC, nsweeps: int, want_resid: bool,
             omega: Optional[float] = None):
    """Jacobi sweeps, then the masked residual when want_resid: one
    mg_nodal_jacobi call (kernel on CUDA, plain on the CPU)."""
    if nsweeps == 0 and not want_resid:
        return phi, None
    return mg_kernels.nodal_jacobi(phi, lev.sigma, rhs, lev.dx, bc.lo, bc.hi, nsweeps,
                                   want_resid, omega=lev.omega if omega is None else omega)


def _jacobi(phi, rhs, lev: NodalLevel, bc: NodalBC, nsweeps: int,
            omega: Optional[float] = None):
    return _smooth2(phi, rhs, lev, bc, nsweeps, False, omega)[0]


def _nodal_residual(phi, rhs, lev: NodalLevel, bc: NodalBC):
    return _smooth2(phi, rhs, lev, bc, 0, True)[1]


def _singular(bc: NodalBC, dim: int) -> bool:
    return all(bc.lo[d] != N_DIRICHLET and bc.hi[d] != N_DIRICHLET for d in range(dim))


def _own(nshape, bc: NodalBC, dtype, device):
    """1 except on the duplicated hi-side copy of a periodic dim."""
    own = torch.ones(nshape, dtype=dtype, device=device)
    for d in range(len(nshape)):
        if bc.lo[d] == N_PERIODIC:
            own.narrow(d, nshape[d] - 1, 1).fill_(0.0)
    return own


def _bottom_cg(rhs, lev: NodalLevel, bc: NodalBC, iters: int = 32):
    """CG bottom solve on -L x = -rhs (L is negative semi-definite),
    Dirichlet-masked, own-weighted demeaning when singular."""

    def matvec(p):
        return -lev.mask * apply_nodal(p, lev.sigma, lev.dx, bc)

    if _singular(bc, lev.sigma.ndim):
        own = _own(lev.nshape, bc, rhs.dtype, rhs.device)
        wsum = invariant_sum(own)

        def demean(x):
            return x - invariant_sum(x * own) / wsum
    else:
        def demean(x):
            return x

    rhs = demean(-lev.mask * rhs)
    x = torch.zeros_like(rhs)
    r = rhs
    p = r
    rs = invariant_sum(r * r)
    rs0 = rs
    eps = torch.full((), 1e-30, dtype=rhs.dtype, device=rhs.device)
    zero = torch.zeros((), dtype=rhs.dtype, device=rhs.device)
    for _ in range(iters):
        active = rs > torch.maximum(1e-28 * rs0, eps)
        ap = matvec(p)
        pap = invariant_sum(p * ap)
        alpha_k = torch.where(active & (pap > eps), rs / torch.maximum(pap, eps), zero)
        x = x + alpha_k * p
        r = demean(r - alpha_k * ap)
        rs_new = invariant_sum(r * r)
        beta_k = torch.where(active, rs_new / torch.maximum(rs, eps), zero)
        p = r + beta_k * p
        rs = rs_new
    return lev.mask * x


# dense-bottom size cap in NODES (9^3 = 729 in 3D)
NODAL_DENSE_BOTTOM_DOFS = 1000


def _nodal_own(lev: NodalLevel, bc: NodalBC):
    """Owned-node weights (0 on the duplicated periodic copy and on
    Dirichlet-masked nodes)."""
    return _own(lev.nshape, bc, lev.sigma.dtype, lev.sigma.device) * lev.mask


def _bottom_dense_inv_nodal(lev: NodalLevel, bc: NodalBC):
    """Dense bottom (pseudo)inverse of -mask L mask, applied to the
    identity basis (a trailing batch dim) and inverted once per solve;
    masked-out and covered nodes get identity rows, singular operators a
    rank-1 shift on the own-weighted constants. None when too big."""
    nshape = lev.nshape
    ndof = int(np.prod(nshape))
    if ndof > 4096:
        return None
    dtype, dev = lev.sigma.dtype, lev.sigma.device
    eye = torch.eye(ndof, dtype=dtype, device=dev).reshape(nshape + (ndof,))
    m = lev.mask.unsqueeze(-1)
    A = (-(m * apply_nodal(m * eye, lev.sigma, lev.dx, bc))).reshape(ndof, ndof)
    scale = invariant_mean(torch.abs(lev.diag))
    adj = _adjacent_cell_sum(lev.sigma, bc)
    alive = (lev.mask * (adj > 0.0).to(dtype)).reshape(-1)
    A = A + torch.diag(1.0 - alive)
    if _singular(bc, lev.sigma.ndim):
        w = _nodal_own(lev, bc).reshape(-1) * alive
        w = w / torch.linalg.norm(w)
        A = A + scale * torch.outer(w, w)
    return torch.linalg.inv_ex(A)[0], alive


def _bottom_solve_nodal(rhs, lev: NodalLevel, bc: NodalBC, binv):
    if binv is None:
        return _bottom_cg(rhs, lev, bc)
    inv, alive = binv
    r = -alive * rhs.reshape(-1)  # -L x = -rhs
    if _singular(bc, lev.sigma.ndim):
        own = _nodal_own(lev, bc).reshape(-1) * alive
        wsum = invariant_sum(own)
        r = r - invariant_sum(r * own) / wsum
        x = alive * invariant_matvec(inv, r)
        x = alive * (x - invariant_sum(x * own) / wsum)
    else:
        x = alive * invariant_matvec(inv, r)
    return x.reshape(lev.nshape)


def _nodal_vcycle(rhs, levels, bc, lev_idx, nu1, nu2, nu_bottom, binv=None):
    lev = levels[lev_idx]
    dim = lev.sigma.ndim
    phi = torch.zeros_like(rhs)
    if lev_idx == len(levels) - 1:
        if binv is not None:
            return _bottom_solve_nodal(rhs, lev, bc, binv)
        phi, _ = _smooth2(phi, rhs, lev, bc, min(nu_bottom, 4), False)
        return phi + _bottom_cg(
            lev.mask * (rhs - apply_nodal(phi, lev.sigma, lev.dx, bc)), lev, bc)
    phi, r = _smooth2(phi, rhs, lev, bc, nu1, True)
    e_c = _nodal_vcycle(_restrict_node(r, bc), levels, bc, lev_idx + 1, nu1, nu2,
                        nu_bottom, binv)
    phi = phi + lev.mask * _prolong_node(e_c, dim)
    return _jacobi(phi, rhs, lev, bc, nu2)


def _nodal_fmg(rhs, levels, bc, nu1, nu2, nu_bottom, binv=None):
    """Full-multigrid start: restrict the rhs to every level, bottom-solve,
    then prolong + one V-cycle per level on the way up."""
    rhss = [rhs]
    for k in range(len(levels) - 1):
        rhss.append(_restrict_node(levels[k].mask * rhss[-1], bc))
    bot = len(levels) - 1
    if binv is not None:
        phi = _bottom_solve_nodal(levels[bot].mask * rhss[bot], levels[bot], bc, binv)
    else:
        phi = _nodal_vcycle(rhss[bot], levels, bc, bot, nu1, nu2, nu_bottom, binv)
    for k in range(bot - 1, -1, -1):
        lev = levels[k]
        phi = lev.mask * _prolong_node(phi, lev.sigma.ndim)
        r = lev.mask * (rhss[k] - apply_nodal(phi, lev.sigma, lev.dx, bc))
        phi = phi + lev.mask * _nodal_vcycle(r, levels, bc, k, nu1, nu2, nu_bottom, binv)
    return phi


def nodal_solve(
    rhs,
    sigma,
    dx: Sequence[float],
    bc: NodalBC,
    phi0=None,
    rtol: float = 1e-11,
    atol: float = 1e-16,
    max_vcycles: int = 200,
    nu1: int = 2,
    nu2: int = 2,
    nu_bottom: int = 40,
    fixed_cycles: Optional[int] = None,
    phi_bc=None,
    mixed: Optional[bool] = None,
    interior_mask=None,
):
    """Solve L(phi) = rhs; returns (phi, max-norm residual as a 0-d tensor,
    V-cycles taken).

    phi_bc: node array whose values on Dirichlet boundary nodes are imposed
    (lifting: phi = phi_b + psi, psi = 0 there). Singular when no side is
    Dirichlet: rhs and phi are demeaned over the owned nodes.
    fixed_cycles: exactly that many V-cycles, reading nothing back; else
    iterate to max|r| <= max(rtol max|rhs|, atol). mixed: f32 V-cycles
    around a true-f64 residual; in tolerance mode an f32 FMG cycle opens
    the solve."""
    if interior_mask is not None:
        raise NotImplementedError("multi-box (union) nodal solves are not ported")
    dim = sigma.ndim
    dense = mg._use_dense_bottom()
    stop = NODAL_DENSE_BOTTOM_DOFS if dense else 0
    levels = build_nodal_hierarchy(sigma, dx, bc, stop_dofs=stop)
    lev0 = levels[0]
    dtype = rhs.dtype
    phi = torch.zeros(lev0.nshape, dtype=dtype, device=rhs.device) if phi0 is None else phi0

    phi_b = None
    if phi_bc is not None:
        phi_b = (1.0 - lev0.mask) * phi_bc
        rhs = rhs - apply_nodal(phi_b, sigma, dx, bc)
        phi = lev0.mask * phi

    singular = _singular(bc, dim)
    own = _own(lev0.nshape, bc, dtype, rhs.device)

    def demean(x):
        return x - invariant_sum(x * own) / invariant_sum(own)

    rhs = lev0.mask * rhs
    if singular:
        rhs = demean(rhs)

    use_mixed = dtype == torch.float64 and bool(mixed)
    if use_mixed:
        cyc_levels = build_nodal_hierarchy(sigma.to(torch.float32), dx, bc, stop_dofs=stop)
    else:
        cyc_levels = levels
    cyc_dtype = cyc_levels[0].sigma.dtype
    binv = _bottom_dense_inv_nodal(cyc_levels[-1], bc) if dense else None

    bnorm = torch.max(torch.abs(rhs))
    tol = torch.clamp(rtol * bnorm, min=atol)

    def residual(phi):
        return _nodal_residual(phi, rhs, lev0, bc)

    def do_cycle(phi, r):
        e = _nodal_vcycle(r.to(cyc_dtype), cyc_levels, bc, 0, nu1, nu2, nu_bottom, binv)
        phi = phi + lev0.mask * e.to(dtype)
        if singular:
            phi = demean(phi)
        return phi, residual(phi)

    def finalize(phi):
        return phi if phi_b is None else phi + phi_b

    if fixed_cycles is not None:
        r = residual(phi)
        for _ in range(fixed_cycles):
            phi, r = do_cycle(phi, r)
        return finalize(phi), torch.max(torch.abs(r)), int(fixed_cycles)

    r = residual(phi)
    if use_mixed:
        # an FMG opening in f32 (not counted as a cycle, as in the JAX
        # package); from zero the opening residual is rhs itself
        e = _nodal_fmg(r.to(cyc_dtype), cyc_levels, bc, nu1, nu2, nu_bottom, binv)
        phi = phi + lev0.mask * e.to(dtype)
        if singular:
            phi = demean(phi)
        r = residual(phi)
    res = torch.max(torch.abs(r))
    it = 0
    while it < max_vcycles and bool(res > tol):
        phi, r = do_cycle(phi, r)
        res = torch.max(torch.abs(r))
        it += 1
    return finalize(phi), res, it
