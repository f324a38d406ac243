"""The port's CUDA multigrid kernels (iamr_tpu_torch/ops/mg_kernels.py): on
the card against their plain PyTorch versions, and on the CPU what the
host computes for them.

On the card (marked cuda, skipped without a device): mg_cell_gsrb (K4:
2 sweeps + residual; K5: one colour, the residual) and mg_nodal_jacobi (K6:
one sweep, the residual; K7: 3 sweeps + residual; K8: the same with
caller-given upd and mask), 2D and 3D, every BC kind; and the shapes that
exercise the kernels' tiles: the smallest smoothed levels of the 256^3 path
(16^3 cells, 17^3 nodes), extents no tile divides (80x96x112 and 2D), an
odd periodic extent (40x24x21), nsweeps 0 to 4 (chained launches past a
launch's stages), with the periodic copies of the duplicated nodes equal
and apart (each copy is updated from its own values), and one CUDA launch
per call (a stage a launch for a nodal call with a periodic dim). The kernels sum in another
order than their plain versions (and contract multiply-adds), so they
agree to 1e-6 (f32) and 1e-12 (f64) of max|plain|, or of the largest term
an output sums where that is larger (max|phi_in| for a sweep's phi,
max|diag| max|phi_in| for a residual), since on random inputs both come
out much smaller than the terms they sum.

On the CPU: the factored element matrix the nodal kernel gets
(nodal_coefs) rebuilds mg_nodal._fem_element_matrix and, applied per cell
as the kernel does, apply_nodal; the diag and mask formulas the kernels use
(cell_diag, nodal_diag_mask) equal mg._diag, mg_nodal.nodal_diag and
_dirichlet_mask; the CUDA launches a call makes (grids); the wrappers
check their arguments.
"""

import itertools

import numpy as np
import pytest
import torch

from iamr_tpu_torch.ops import mg, mg_kernels as mk, mg_nodal as mn
from iamr_tpu_torch.ops.stencil import checkerboard

torch.set_num_threads(2)
TOL = {torch.float32: 1e-6, torch.float64: 1e-12}
P, D, N = mg.PERIODIC, mg.DIRICHLET, mg.NEUMANN
CELL_BCS = [((P, P, P), (P, P, P)), ((D, D, D), (D, D, D)), ((N, D, P), (D, N, P)),
            ((D, P), (N, P))]
NP, NN, ND = mn.N_PERIODIC, mn.N_NEUMANN, mn.N_DIRICHLET
NODAL_BCS = [((NP, NP, NP), (NP, NP, NP)), ((NN, NN, NN), (NN, NN, NN)),
             ((ND, NN, NP), (NN, ND, NP)), ((NN, NP), (ND, NP))]
# tile-exercising shapes: (cells, lo, hi)
CELL_TILES = [((16, 16, 16), (D, N, P), (N, D, P)), ((80, 96, 112), (N, D, P), (D, N, P)),
              ((40, 24, 21), (P, P, P), (P, P, P)), ((130, 70), (D, N), (N, D)),
              ((21, 33), (P, P), (P, P))]
NODAL_TILES = [((16, 16, 16), (NP, NP, NP), (NP, NP, NP)),
               ((80, 96, 112), (ND, NN, NP), (NN, ND, NP)),
               ((40, 24, 21), (NP, NP, NP), (NP, NP, NP)), ((130, 70), (NN, NP), (ND, NP))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _agree(pairs, dtype, terms):
    """pairs alternate (phi, residual); terms: their largest summed terms."""
    for k, (got, ref) in enumerate(pairs):
        assert (got is None) == (ref is None)
        if ref is not None:
            scale = max(float(ref.abs().max()), terms[k % 2], 1e-300)
            assert float((got - ref).abs().max()) <= TOL[dtype] * scale


def _faces(rng, shape, lo, t):
    beta = []
    for d in range(len(shape)):
        b = 0.5 + rng.rand(*[x + (1 if e == d else 0) for e, x in enumerate(shape)])
        if lo[d] == P:
            b[tuple(-1 if e == d else slice(None) for e in range(len(shape)))] = \
                b[tuple(0 if e == d else slice(None) for e in range(len(shape)))]
        beta.append(t(b))
    return tuple(beta)


def _cell_args(dev, shape, lo, hi, a, dtype, seed=0):
    rng = np.random.RandomState(seed)
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
    beta = _faces(rng, shape, lo, t)
    dx = tuple(1.0 / (x * (1.0 + 0.1 * d)) for d, x in enumerate(shape))
    alpha = t(0.5 + rng.rand(*shape))
    b = t(0.7).reshape(()) if a else 0.7
    return (t(rng.randn(*shape)), t(rng.randn(*shape)), alpha if a else None, beta, a, b, dx,
            lo, hi)


def _cell_term(args):
    phi, _, alpha, beta, a, b, dx, lo, hi = args
    m = float(phi.abs().max())
    return m, float(mk.cell_diag(alpha, beta, a, b, dx, lo, hi).abs().max()) * m


def _nodal_case(dev, cshape, lo, hi, dtype, seed=1, apart=False):
    """Random phi and rhs (nodes), sigma (cells) and dx. A periodic dim's
    last node equals its first unless `apart`: then the copies differ, as
    no solver leaves them but as the convention covers."""
    rng = np.random.RandomState(seed)
    nshape = tuple(c + 1 for c in cshape)
    phi, rhs = rng.randn(*nshape), rng.randn(*nshape)
    for d in range(len(cshape)):
        if lo[d] == NP and not apart:
            for x in (phi, rhs):
                x[tuple(-1 if e == d else slice(None) for e in range(len(cshape)))] = \
                    x[tuple(0 if e == d else slice(None) for e in range(len(cshape)))]
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
    dx = tuple(1.0 / (c * (1.0 + 0.1 * d)) for d, c in enumerate(cshape))
    return (t(phi), t(0.5 + rng.rand(*cshape)), t(rhs), dx, lo, hi)


def _nodal_term(base):
    phi, sigma, _, dx, lo, hi = base
    m = float(phi.abs().max())
    return m, float(mk.nodal_diag_mask(sigma, dx, lo, hi)[0].abs().max()) * m


@pytest.mark.cuda
@pytest.mark.parametrize("lo,hi", CELL_BCS)
@pytest.mark.parametrize("a", [1.0, 0.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cell_kernel(cuda, lo, hi, a, dtype):
    shape = (24, 16, 20) if len(lo) == 3 else (48, 32)
    args = _cell_args(cuda, shape, lo, hi, a, dtype)
    before = mk.LAUNCHES["mg_cell_gsrb"]
    for kw in ({"nsweeps": 2, "want_resid": True}, {"nsweeps": 0, "want_resid": True},
               {"nsweeps": 0, "want_resid": False, "colour": 0},
               {"nsweeps": 0, "want_resid": False, "colour": 1}):
        _agree(zip(mk.cell_smooth(*args, **kw), mk.cell_smooth_ref(*args, **kw)), dtype,
               _cell_term(args))
    assert mk.LAUNCHES["mg_cell_gsrb"] == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize("shape,lo,hi", CELL_TILES)
@pytest.mark.parametrize("nsweeps", [0, 1, 2, 3, 4])
def test_cell_kernel_tiles(cuda, shape, lo, hi, nsweeps):
    args = _cell_args(cuda, shape, lo, hi, 0.0, torch.float32, seed=nsweeps)
    for want_resid in (True, False):
        kw = {"nsweeps": nsweeps, "want_resid": want_resid}
        _agree(zip(mk.cell_smooth(*args, **kw), mk.cell_smooth_ref(*args, **kw)),
               torch.float32, _cell_term(args))


@pytest.mark.cuda
@pytest.mark.parametrize("lo,hi", NODAL_BCS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("copies", ["equal", "apart"])
def test_nodal_kernel(cuda, lo, hi, dtype, copies):
    cshape = (16, 12, 20) if len(lo) == 3 else (40, 24)
    base = _nodal_case(cuda, cshape, lo, hi, dtype, apart=copies == "apart")
    lev = mn.build_nodal_hierarchy(base[1], base[3], mn.NodalBC(lo, hi))[0]
    upd = lev.omega * lev.mask / lev.diag
    before = mk.LAUNCHES["mg_nodal_jacobi"]
    for args, kw in (((1, False), {"omega": lev.omega}), ((0, True), {}),
                     ((3, True), {"omega": lev.omega}),
                     ((3, True), {"upd": upd, "mask": lev.mask})):
        _agree(zip(mk.nodal_jacobi(*base, *args, **kw), mk.nodal_jacobi_ref(*base, *args, **kw)),
               dtype, _nodal_term(base))
    assert mk.LAUNCHES["mg_nodal_jacobi"] == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize("cshape,lo,hi", NODAL_TILES)
@pytest.mark.parametrize("nsweeps", [0, 1, 2, 3, 4])
def test_nodal_kernel_tiles(cuda, cshape, lo, hi, nsweeps):
    # the periodic copies apart, each updated from its own values across
    # tiles, chunks and chained launches
    base = _nodal_case(cuda, cshape, lo, hi, torch.float32, seed=nsweeps, apart=True)
    omega = mn._jacobi_safe_omega(base[3], len(cshape))
    for want_resid in (True, False):
        args = (nsweeps, want_resid)
        _agree(zip(mk.nodal_jacobi(*base, *args, omega=omega),
                   mk.nodal_jacobi_ref(*base, *args, omega=omega)), torch.float32,
               _nodal_term(base))


@pytest.mark.cuda
def test_one_launch_per_call(cuda):
    """A V-cycle call (2 sweeps + residual, or 2 sweeps) is one CUDA launch,
    but for a nodal call with a periodic dim, which makes one a stage; GRIDS
    counts them."""
    from torch.profiler import ProfilerActivity, profile

    cargs = _cell_args(cuda, (32, 32, 32), (P,) * 3, (P,) * 3, 0.0, torch.float32)
    periodic = _nodal_case(cuda, (32, 32, 32), (NP,) * 3, (NP,) * 3, torch.float32)
    walled = _nodal_case(cuda, (32, 32, 32), (NN,) * 3, (NN,) * 3, torch.float32)
    for want_resid in (True, False):
        mk.reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            mk.cell_smooth(*cargs, 2, want_resid)
            mk.nodal_jacobi(*walled, 2, want_resid, omega=0.8)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages() for _ in range(e.count)]
        assert sum("mg_cell_gsrb_kernel" in k for k in names) == 1
        assert sum("mg_nodal_jacobi_kernel" in k for k in names) == 1
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            mk.nodal_jacobi(*periodic, 2, want_resid, omega=0.8)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages() for _ in range(e.count)]
        assert sum("mg_nodal_jacobi_kernel" in k for k in names) == 2 + want_resid
        assert mk.GRIDS == {"mg_cell_gsrb": 1, "mg_nodal_jacobi": 3 + want_resid}


@pytest.mark.parametrize("stages,cap,want_resid,want", [
    (0, 4, True, 1), (2, 4, True, 1), (3, 4, True, 1), (4, 4, True, 2), (4, 4, False, 1),
    (9, 4, True, 3), (2, 1, True, 3), (2, 1, False, 2), (0, 1, True, 1), (10, 5, True, 3)])
def test_grids_follow_the_chaining(stages, cap, want_resid, want):
    """The CUDA launches a call makes: cap stages a launch, the residual on
    the last sweep launch when it has room."""
    assert mk.grids(stages, cap, want_resid) == want


def _hadamard(dim):
    n = 2 ** dim
    return np.array([[(-1) ** bin(w & a).count("1") for a in range(n)] for w in range(n)],
                    dtype=float)


@pytest.mark.parametrize("dx", [(0.1, 0.25), (1 / 16,) * 3, (0.1, 0.037, 0.6)])
def test_fem_eigenvalues_rebuild_element_matrix(dx):
    """H diag(lambda) H / 2^dim == _fem_element_matrix, and coef = -lambda /
    (2^dim V)."""
    dim = len(dx)
    K = mn._fem_element_matrix(dx)
    corners = list(itertools.product((0, 1), repeat=dim))
    Kmat = np.array([[K[(a, b)] for b in corners] for a in corners])
    H = _hadamard(dim)
    lam = np.array(mk.fem_eigenvalues(dx))
    rebuilt = H @ np.diag(lam) @ H / 2 ** dim
    np.testing.assert_allclose(rebuilt, Kmat, rtol=0, atol=1e-14 * np.abs(Kmat).max())
    assert lam[0] == 0.0  # constants are in the nullspace
    np.testing.assert_allclose(mk.nodal_coefs(dx), -lam / (2 ** dim * np.prod(dx)),
                               rtol=1e-15)


@pytest.mark.parametrize("lo,hi", NODAL_BCS)
def test_factored_form_matches_apply_nodal(lo, hi):
    """The kernel's per-cell arithmetic (psi = H phi_c, z = sigma coef psi,
    y = H z, each node summing the y of its cells) in f64 equals
    apply_nodal."""
    dim = len(lo)
    cshape = (6, 5, 7) if dim == 3 else (9, 6)
    phi, sigma, _, dx, _, _ = _nodal_case("cpu", cshape, lo, hi, torch.float64)
    bc = mn.NodalBC(lo, hi)
    pp = mn._pad_nodes(phi, bc)            # node k at k + 1
    sp = mn._pad_cells(sigma, bc, dim)     # cell k at k + 1
    coef = torch.tensor(mk.nodal_coefs(dx), dtype=torch.float64)
    H = torch.as_tensor(_hadamard(dim))
    ncell = tuple(c + 2 for c in cshape)   # cells -1 .. nc
    corners = torch.stack([pp[tuple(slice(a[d], a[d] + ncell[d]) for d in range(dim))]
                           for a in itertools.product((0, 1), repeat=dim)], dim=-1)
    z = (corners @ H.T) * coef * sp.unsqueeze(-1)
    y = z @ H.T                             # y[..., a]: cell -> its corner a
    out = torch.zeros_like(phi)
    for t in itertools.product((0, 1), repeat=dim):  # node n's cell n - 1 + t, corner 1 - t
        a = int("".join(str(1 - x) for x in t), 2)
        out = out + y[tuple(slice(t[d], t[d] + phi.shape[d]) for d in range(dim))][..., a]
    ref = mn.apply_nodal(phi, sigma, dx, bc)
    assert float((out - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


@pytest.mark.parametrize("lo,hi", CELL_BCS)
@pytest.mark.parametrize("a", [1.0, 0.0])
def test_cell_diag_formula_matches_mg_diag(lo, hi, a):
    shape = (5, 4, 6) if len(lo) == 3 else (7, 5)
    _, _, alpha, beta, a, b, dx, lo, hi = _cell_args("cpu", shape, lo, hi, a, torch.float64)
    ref = mg._diag(alpha if a else torch.zeros(shape, dtype=torch.float64), beta, a, b, dx,
                   mg.PoissonBC(lo, hi), shape, torch.float64)
    got = mk.cell_diag(alpha, beta, a, b, dx, lo, hi)
    assert float((got - ref).abs().max()) <= 1e-15 * float(ref.abs().max())


@pytest.mark.parametrize("lo,hi", CELL_BCS)
@pytest.mark.parametrize("a", [1.0, 0.0])
def test_cell_folded_weights_match_plain(lo, hi, a):
    """The cell kernel's per-cell weights, ghosts folded in (a Dirichlet
    ghost -2 c + c1 / 3 adds w / 3 to the inward neighbour and 3 w to diag,
    a Neumann ghost drops w), in f64: rhs + sum_n w_n phi_n - diag phi is
    the plain residual whatever phi holds beyond the boundary, and (rhs +
    sum_n w_n phi_n) / diag is a colour pass's value."""
    shape = (6, 5, 7) if len(lo) == 3 else (7, 5)
    args = _cell_args("cpu", shape, lo, hi, a, torch.float64)
    phi, rhs, alpha, beta, a, b, dx, lo, hi = args
    dim, bv = len(shape), float(b)
    garbage = 1e3 * torch.as_tensor(np.random.RandomState(5).randn(*shape))
    dg = a * alpha if a else torch.zeros(shape, dtype=torch.float64)
    acc = rhs.clone()
    for d in range(dim):
        n, per = shape[d], lo[d] == P
        idx = torch.arange(n).reshape([-1 if e == d else 1 for e in range(dim)])
        blo, bhi = (idx == 0) & (not per), (idx == n - 1) & (not per)
        dl, dh = blo & (lo[d] == D), bhi & (hi[d] == D)
        wl = bv * beta[d].narrow(d, 0, n) / dx[d] ** 2
        wh = bv * beta[d].narrow(d, 1, n) / dx[d] ** 2
        dg = dg + torch.where(blo, 3 * wl * dl, wl) + torch.where(bhi, 3 * wh * dh, wh)
        w_lo = torch.where(blo, 0 * wl, wl) + wh / 3 * dh
        w_hi = torch.where(bhi, 0 * wh, wh) + wl / 3 * dl
        dn, up = torch.roll(phi, 1, d), torch.roll(phi, -1, d)
        if not per:
            dn, up = torch.where(blo, garbage, dn), torch.where(bhi, garbage, up)
        acc = acc + w_lo * dn + w_hi * up
    ref = mk.cell_smooth_ref(*args, 0, True)[1]
    assert float((acc - dg * phi - ref).abs().max()) <= 1e-14 * float(ref.abs().max())
    red = mk.cell_smooth_ref(*args, 0, False, colour=0)[0]
    mask = checkerboard(shape, 0, torch.float64) > 0
    assert float((acc / dg - red)[mask].abs().max()) <= 1e-14 * float(red.abs().max())


@pytest.mark.parametrize("lo,hi", NODAL_BCS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_nodal_diag_mask_formula_matches_plain(lo, hi, dtype):
    cshape = (5, 4, 6) if len(lo) == 3 else (7, 5)
    _, sigma, _, dx, _, _ = _nodal_case("cpu", cshape, lo, hi, dtype)
    bc = mn.NodalBC(lo, hi)
    diag, mask = mk.nodal_diag_mask(sigma, dx, lo, hi)
    assert torch.equal(diag, mn.nodal_diag(sigma, dx, bc))
    assert torch.equal(mask, mn._dirichlet_mask(diag.shape, bc, dtype, "cpu"))


@pytest.mark.parametrize("where", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_wrappers_refuse_bad_input(where):
    """The wrappers check their arguments on either device (the CPU path
    too, so the CPU tests catch what the kernel would refuse)."""
    if where == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    phi = torch.zeros(8, 8, 8, device=where)
    beta = tuple(torch.ones(*[8 + (1 if e == d else 0) for e in range(3)], device=where)
                 for d in range(3))
    with pytest.raises(ValueError):  # a non-contiguous phi
        mk.cell_smooth(phi.transpose(0, 1), phi, None, beta, 0.0, 1.0, (0.1,) * 3,
                       (P,) * 3, (P,) * 3, 1, False)
    with pytest.raises(ValueError):  # dtype mismatch
        mk.cell_smooth(phi, phi.double(), None, beta, 0.0, 1.0, (0.1,) * 3,
                       (P,) * 3, (P,) * 3, 1, False)
    nphi = torch.zeros(9, 9, 9, device=where)
    with pytest.raises(ValueError):  # sigma must have one cell fewer than nodes per dim
        mk.nodal_jacobi(nphi, nphi, nphi, (0.1,) * 3, (NP,) * 3, (NP,) * 3, 0, True)
    with pytest.raises(ValueError):  # upd without mask
        mk.nodal_jacobi(nphi, phi, nphi, (0.1,) * 3, (NP,) * 3, (NP,) * 3, 1, True, upd=nphi)
