"""Parity of the port's cell multigrid (iamr_tpu_torch/ops/mg.py and the
plain version of the mg_cell_gsrb kernel) with the JAX package's, on the CPU.

  * f64: apply_op, _smooth_rb and _residual against iamr_tpu.ops.mg's XLA
    path, to 1e-13 of max|ref| (same arithmetic, same operation order).
  * f32: the kernel's plain version (mg_kernels.cell_smooth_ref) against the
    TPU kernels run in Pallas interpret mode, as tests/test_pallas_mg.py and
    tests/test_pallas_fused.py run them: cell_sweep (K5: one colour, and the
    residual) and cell_smooth_fused in "whole" mode (K4: 2 sweeps plus the
    residual), to 1e-5 of max|ref| (the TPU kernels multiply by 1/dx^2 and
    fold a and b into the arrays, so they round differently).
  * mg_solve at 32^3 f64, 4 fixed V-cycles and tolerance 1e-11, periodic,
    Dirichlet (with boundary values) and Neumann: phi to 1e-10 of max|ref|
    and equal cycle counts.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from iamr_tpu.ops import mg as jmg
from iamr_tpu.ops import pallas_fused as jpf
from iamr_tpu.ops import pallas_mg as jpm
from iamr_tpu.ops.stencil import checkerboard as jcheckerboard
from iamr_tpu_torch.ops import mg as tmg
from iamr_tpu_torch.ops import mg_kernels as tk
from iamr_tpu_torch.ops.stencil import checkerboard as tcheckerboard

torch.set_num_threads(2)
P, D, N = tmg.PERIODIC, tmg.DIRICHLET, tmg.NEUMANN
BCS = {
    "periodic": ((P, P, P), (P, P, P)),
    "dirichlet": ((D, D, D), (D, D, D)),
    "mixed": ((N, D, P), (D, N, P)),
    "2d": ((D, P), (N, P)),
}


def _close(ref, got, tol):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(ref - got).max())
    assert err <= tol * scale, (err, scale)


def _case(bcname, a, dtype=np.float64, seed=0):
    """Random phi, rhs, alpha, face coefficients (a periodic dim's last face
    equals its first) and dx, as numpy arrays."""
    lo, hi = BCS[bcname]
    shape = (12, 16) if len(lo) == 2 else (12, 16, 8)
    rng = np.random.RandomState(seed)
    beta = []
    for d in range(len(shape)):
        b = 0.5 + 1.5 * rng.rand(*[x + (1 if e == d else 0) for e, x in enumerate(shape)])
        if lo[d] == P:
            b[tuple(-1 if e == d else slice(None) for e in range(len(shape)))] = \
                b[tuple(0 if e == d else slice(None) for e in range(len(shape)))]
        beta.append(b.astype(dtype))
    dx = tuple(1.0 / (x * (1.0 + 0.1 * d)) for d, x in enumerate(shape))
    return dict(
        phi=rng.randn(*shape).astype(dtype), rhs=rng.randn(*shape).astype(dtype),
        alpha=(0.5 + rng.rand(*shape)).astype(dtype) if a else np.zeros(shape, dtype),
        beta=beta, a=a, b=0.7, dx=dx, lo=lo, hi=hi, shape=shape,
    )


def _levels(c):
    jlev = jmg.build_hierarchy(jnp.asarray(c["alpha"]), tuple(map(jnp.asarray, c["beta"])),
                               c["a"], c["b"], c["dx"], jmg.PoissonBC(c["lo"], c["hi"]))[0]
    tlev = tmg.build_hierarchy(torch.as_tensor(c["alpha"]),
                               tuple(map(torch.as_tensor, c["beta"])), c["a"], c["b"],
                               c["dx"], tmg.PoissonBC(c["lo"], c["hi"]))[0]
    return jlev, tlev


@pytest.mark.parametrize("bcname", list(BCS))
@pytest.mark.parametrize("a", [1.0, 0.0])
def test_operator_smoother_residual_f64(bcname, a):
    c = _case(bcname, a)
    jbc, tbc = jmg.PoissonBC(c["lo"], c["hi"]), tmg.PoissonBC(c["lo"], c["hi"])
    jlev, tlev = _levels(c)
    _close(jlev.diag, tlev.diag, 1e-13)
    jphi, tphi = jnp.asarray(c["phi"]), torch.as_tensor(c["phi"])
    jrhs, trhs = jnp.asarray(c["rhs"]), torch.as_tensor(c["rhs"])
    _close(jmg.apply_op(jmg._pad_phi(jphi, jbc), jlev.alpha, jlev.beta, c["a"], c["b"],
                        c["dx"], c["shape"]),
           tmg.apply_op(tmg._pad_phi(tphi, tbc), tlev.alpha, tlev.beta, c["a"], c["b"],
                        c["dx"], c["shape"]), 1e-13)
    _close(jmg._smooth_rb(jphi, jrhs, jlev, c["a"], c["b"], jbc, 2),
           tmg._smooth_rb(tphi, trhs, tlev, c["a"], c["b"], tbc, 2), 1e-13)
    _close(jmg._residual(jphi, jrhs, jlev, c["a"], c["b"], jbc),
           tmg._residual(tphi, trhs, tlev, c["a"], c["b"], tbc), 1e-13)


def test_checkerboard():
    for shape in ((4, 6, 2), (5, 3)):
        for parity in (0, 1):
            np.testing.assert_array_equal(
                np.asarray(jcheckerboard(shape, parity, jnp.float64)),
                tcheckerboard(shape, parity, torch.float64).numpy())


@pytest.mark.parametrize("bcname", list(BCS))
@pytest.mark.parametrize("a", [1.0, 0.0])
def test_plain_sweep_matches_tpu_kernels_f32(bcname, a):
    """K5 (cell_sweep: one colour, then the residual) and K4
    (cell_smooth_fused: 2 sweeps + residual) in interpret mode against the
    port's plain cell_smooth_ref, f32."""
    c = _case(bcname, a, np.float32)
    jbc = jmg.PoissonBC(c["lo"], c["hi"])
    jlev, tlev = _levels(c)
    jphi, tphi = jnp.asarray(c["phi"]), torch.as_tensor(c["phi"])
    jrhs, trhs = jnp.asarray(c["rhs"]), torch.as_tensor(c["rhs"])
    t_alpha = tlev.alpha if a else None
    args = (tphi, trhs, t_alpha, tlev.beta, c["a"], c["b"], c["dx"], c["lo"], c["hi"])
    phip = jmg._pad_phi(jphi, jbc)
    for colour in (0, 1):
        mask = jcheckerboard(c["shape"], colour, jnp.float32)
        ref = jpm.cell_sweep(phip, jrhs, c["a"] * jlev.alpha, jlev.diag, jlev.beta, mask,
                             c["b"], c["dx"], update=True, interpret=True)
        got, _ = tk.cell_smooth_ref(*args, 0, False, colour=colour)
        _close(ref, got, 1e-5)
    ref_r = jpm.cell_sweep(phip, jrhs, c["a"] * jlev.alpha, jlev.diag, jlev.beta,
                           jcheckerboard(c["shape"], 0, jnp.float32), c["b"], c["dx"],
                           update=False, interpret=True)
    _close(ref_r, tk.cell_smooth_ref(*args, 0, True)[1], 1e-5)
    pf, rf = jpf.cell_smooth_fused(jphi, jrhs, jlev.alpha if a else None, jlev.beta, c["a"],
                                   c["b"], c["dx"], c["lo"], c["hi"], 2, True,
                                   interpret=True, mode="whole")
    got_p, got_r = tk.cell_smooth_ref(*args, 2, True)
    _close(pf, got_p, 1e-5)
    _close(rf, got_r, 1e-5)


SOLVES = {
    # name: (bc lo, bc hi, a, bvals)
    "periodic": ((P, P, P), (P, P, P), 0.0, None),
    "dirichlet": ((D, D, P), (D, D, P), 0.0, {(0, 0): 1.0, (1, 1): -0.5}),
    "neumann": ((N, N, N), (N, N, N), 1.0, None),
}


@pytest.mark.parametrize("name", list(SOLVES))
@pytest.mark.parametrize("fixed", [4, None])
def test_mg_solve_32(name, fixed):
    lo, hi, a, bvals = SOLVES[name]
    n = (32, 32, 32)
    rng = np.random.RandomState(5)
    dx = (1.0 / 32,) * 3
    rhs = rng.randn(*n)
    alpha = 1.0 + rng.rand(*n)
    beta = []
    for d in range(3):
        b = 0.5 + rng.rand(*[x + (1 if e == d else 0) for e, x in enumerate(n)])
        if lo[d] == P:
            b[tuple(-1 if e == d else slice(None) for e in range(3))] = \
                b[tuple(0 if e == d else slice(None) for e in range(3))]
        beta.append(b)
    b_coef = 1.0 if a == 0.0 else 1e-3
    jphi, jres, jit = jmg.mg_solve(
        jnp.asarray(rhs), jnp.asarray(alpha), tuple(map(jnp.asarray, beta)), a, b_coef, dx,
        jmg.PoissonBC(lo, hi), bvals=bvals, rtol=1e-11, fixed_cycles=fixed, mixed=False)
    tphi, tres, tit = tmg.mg_solve(
        torch.as_tensor(rhs), torch.as_tensor(alpha), tuple(map(torch.as_tensor, beta)), a,
        b_coef, dx, tmg.PoissonBC(lo, hi), bvals=bvals, rtol=1e-11, fixed_cycles=fixed)
    _close(jphi, tphi, 1e-10)
    assert int(jit) == int(tit)
    assert np.isfinite(float(tres)) and np.isfinite(float(jres))
