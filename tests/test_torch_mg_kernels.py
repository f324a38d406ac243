"""The port's CUDA multigrid kernels against their plain PyTorch versions on
the card (iamr_tpu_torch/ops/mg_kernels.py). Skipped without a CUDA device,
except the wrappers' argument checks, which run on the CPU too.

mg_cell_gsrb (K4: 2 sweeps + residual; K5: one colour, the residual) and
mg_nodal_jacobi (K6: one sweep, the residual; K7: 3 sweeps + residual; K8:
the same with caller-given upd and mask), 2D and 3D, every BC kind. The
kernels follow the plain path's operation order (built with -fmad=false)
and make no thresholded pick, so they agree to 1e-6 (f32) and 1e-12 (f64)
of max|plain|; on the H100 they agree bit for bit.
"""

import numpy as np
import pytest
import torch

from iamr_tpu_torch.ops import mg, mg_kernels as mk, mg_nodal as mn

torch.set_num_threads(2)
TOL = {torch.float32: 1e-6, torch.float64: 1e-12}
P, D, N = mg.PERIODIC, mg.DIRICHLET, mg.NEUMANN
CELL_BCS = [((P, P, P), (P, P, P)), ((D, D, D), (D, D, D)), ((N, D, P), (D, N, P)),
            ((D, P), (N, P))]
NP, NN, ND = mn.N_PERIODIC, mn.N_NEUMANN, mn.N_DIRICHLET
NODAL_BCS = [((NP, NP, NP), (NP, NP, NP)), ((NN, NN, NN), (NN, NN, NN)),
             ((ND, NN, NP), (NN, ND, NP)), ((NN, NP), (ND, NP))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _agree(pairs, dtype):
    for got, ref in pairs:
        assert (got is None) == (ref is None)
        if ref is not None:
            scale = max(float(ref.abs().max()), 1e-300)
            assert float((got - ref).abs().max()) <= TOL[dtype] * scale


@pytest.mark.cuda
@pytest.mark.parametrize("lo,hi", CELL_BCS)
@pytest.mark.parametrize("a", [1.0, 0.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cell_kernel(cuda, lo, hi, a, dtype):
    shape = (24, 16, 20) if len(lo) == 3 else (48, 32)
    rng = np.random.RandomState(0)
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=cuda)
    beta = []
    for d in range(len(shape)):
        b = 0.5 + rng.rand(*[x + (1 if e == d else 0) for e, x in enumerate(shape)])
        if lo[d] == P:
            b[tuple(-1 if e == d else slice(None) for e in range(len(shape)))] = \
                b[tuple(0 if e == d else slice(None) for e in range(len(shape)))]
        beta.append(t(b))
    dx = tuple(1.0 / (x * (1.0 + 0.1 * d)) for d, x in enumerate(shape))
    alpha = t(0.5 + rng.rand(*shape))
    b = t(0.7).reshape(()) if a else 0.7
    diag = mg._diag(alpha if a else torch.zeros_like(alpha), beta, a, b, dx,
                    mg.PoissonBC(lo, hi), shape, dtype)
    args = (t(rng.randn(*shape)), t(rng.randn(*shape)), alpha if a else None, tuple(beta),
            diag, a, b, dx, lo, hi)
    before = mk.LAUNCHES["mg_cell_gsrb"]
    for kw in ({"nsweeps": 2, "want_resid": True}, {"nsweeps": 0, "want_resid": True},
               {"nsweeps": 0, "want_resid": False, "colour": 0},
               {"nsweeps": 0, "want_resid": False, "colour": 1}):
        _agree(zip(mk.cell_smooth(*args, **kw), mk.cell_smooth_ref(*args, **kw)), dtype)
    assert mk.LAUNCHES["mg_cell_gsrb"] == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize("lo,hi", NODAL_BCS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_nodal_kernel(cuda, lo, hi, dtype):
    cshape = (16, 12, 20) if len(lo) == 3 else (40, 24)
    rng = np.random.RandomState(1)
    nshape = tuple(c + 1 for c in cshape)
    phi, rhs = rng.randn(*nshape), rng.randn(*nshape)
    for d in range(len(cshape)):
        if lo[d] == NP:
            for x in (phi, rhs):
                x[tuple(-1 if e == d else slice(None) for e in range(len(cshape)))] = \
                    x[tuple(0 if e == d else slice(None) for e in range(len(cshape)))]
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=cuda)
    dx = tuple(1.0 / (c * (1.0 + 0.1 * d)) for d, c in enumerate(cshape))
    sigma = t(0.5 + rng.rand(*cshape))
    lev = mn.build_nodal_hierarchy(sigma, dx, mn.NodalBC(lo, hi))[0]
    base = (t(phi), sigma, t(rhs), dx, lo, hi)
    upd = lev.omega * lev.mask / lev.diag
    before = mk.LAUNCHES["mg_nodal_jacobi"]
    for args, kw in (((1, False, lev.mask), {"omega": lev.omega, "diag": lev.diag}),
                     ((0, True, lev.mask), {}),
                     ((3, True, lev.mask), {"omega": lev.omega, "diag": lev.diag}),
                     ((3, True, lev.mask), {"upd": upd})):
        _agree(zip(mk.nodal_jacobi(*base, *args, **kw), mk.nodal_jacobi_ref(*base, *args, **kw)),
               dtype)
    assert mk.LAUNCHES["mg_nodal_jacobi"] == before + 4


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
        mk.cell_smooth(phi.transpose(0, 1), phi, None, beta, phi + 1, 0.0, 1.0, (0.1,) * 3,
                       (P,) * 3, (P,) * 3, 1, False)
    with pytest.raises(ValueError):  # dtype mismatch
        mk.cell_smooth(phi, phi.double(), None, beta, phi + 1, 0.0, 1.0, (0.1,) * 3,
                       (P,) * 3, (P,) * 3, 1, False)
    nphi = torch.zeros(9, 9, 9, device=where)
    with pytest.raises(ValueError):  # sigma must have one cell fewer than nodes per dim
        mk.nodal_jacobi(nphi, nphi, nphi, (0.1,) * 3, (NP,) * 3, (NP,) * 3, 0, True, nphi)
