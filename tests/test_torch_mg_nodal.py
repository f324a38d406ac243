"""Parity of the port's nodal multigrid (iamr_tpu_torch/ops/mg_nodal.py and
the plain version of the mg_nodal_jacobi kernel) with the JAX package's, on
the CPU.

  * f64: apply_nodal, _jacobi and _nodal_residual against
    iamr_tpu.ops.mg_nodal's XLA path, to 1e-13 of max|ref|.
  * f32: the kernel's plain version (mg_kernels.nodal_jacobi_ref) against
    the TPU kernels in Pallas interpret mode: nodal_sweep (K6: one sweep,
    and the masked residual), nodal_smooth_fused in "whole" mode (K7:
    sweeps plus the residual) and nodal_smooth_sr (K8: caller-given upd and
    mask), to 1e-5 of max|ref| (the TPU kernels sum the stencil by corner).
  * nodal_solve at 32^3 cells f64, 4 fixed V-cycles and tolerance 1e-11,
    periodic, walled (Neumann) and outflow (Dirichlet): phi to 1e-10 of
    max|ref| and equal cycle counts.
  * The numpy f64 oracle (ops/np_nodal.py), on which chip_smoke.py's
    rtol-1e-11 check rests: np_apply_nodal against both packages'
    apply_nodal to 1e-12 at 17^3 nodes, periodic and walled.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from iamr_tpu.ops import mg_nodal as jn
from iamr_tpu.ops import pallas_fused as jpf
from iamr_tpu.ops import pallas_mg as jpm
from iamr_tpu_torch.ops import mg_kernels as tk
from iamr_tpu_torch.ops import mg_nodal as tn
from iamr_tpu_torch.ops import np_nodal

torch.set_num_threads(2)
P, NM, DI = tn.N_PERIODIC, tn.N_NEUMANN, tn.N_DIRICHLET
BCS = {
    "periodic": ((P, P, P), (P, P, P)),
    "walls": ((NM, NM, NM), (NM, NM, NM)),
    "outflow": ((DI, NM, P), (NM, DI, P)),
    "2d": ((NM, P), (DI, P)),
}


def _close(ref, got, tol):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(ref - got).max())
    assert err <= tol * scale, (err, scale)


def _case(bcname, cshape=None, dtype=np.float64, seed=1):
    """Random sigma (cells), phi and rhs (nodes; a periodic dim's last node
    equals its first) and dx, as numpy arrays."""
    lo, hi = BCS[bcname]
    dim = len(lo)
    if cshape is None:
        cshape = (16, 8) if dim == 2 else (8, 12, 16)
    rng = np.random.RandomState(seed)
    nshape = tuple(c + 1 for c in cshape)
    phi, rhs = rng.randn(*nshape), rng.randn(*nshape)
    for d in range(dim):
        if lo[d] == P:
            for a in (phi, rhs):
                a[tuple(-1 if e == d else slice(None) for e in range(dim))] = \
                    a[tuple(0 if e == d else slice(None) for e in range(dim))]
    dx = tuple(1.0 / (c * (1.0 + 0.1 * d)) for d, c in enumerate(cshape))
    return dict(phi=phi.astype(dtype), rhs=rhs.astype(dtype),
                sigma=(0.5 + rng.rand(*cshape)).astype(dtype), dx=dx, lo=lo, hi=hi)


def _levels(c):
    jbc, tbc = jn.NodalBC(c["lo"], c["hi"]), tn.NodalBC(c["lo"], c["hi"])
    jlev = jn.build_nodal_hierarchy(jnp.asarray(c["sigma"]), c["dx"], jbc)[0]
    tlev = tn.build_nodal_hierarchy(torch.as_tensor(c["sigma"]), c["dx"], tbc)[0]
    return jbc, tbc, jlev, tlev


@pytest.mark.parametrize("bcname", list(BCS))
def test_operator_jacobi_residual_f64(bcname):
    c = _case(bcname)
    jbc, tbc, jlev, tlev = _levels(c)
    assert jlev.omega == tlev.omega
    _close(jlev.diag, tlev.diag, 1e-13)
    _close(jlev.mask, tlev.mask, 0.0)
    jphi, tphi = jnp.asarray(c["phi"]), torch.as_tensor(c["phi"])
    jrhs, trhs = jnp.asarray(c["rhs"]), torch.as_tensor(c["rhs"])
    _close(jn.apply_nodal(jphi, jlev.sigma, c["dx"], jbc),
           tn.apply_nodal(tphi, tlev.sigma, c["dx"], tbc), 1e-13)
    _close(jn._jacobi(jphi, jrhs, jlev, jbc, 3), tn._jacobi(tphi, trhs, tlev, tbc, 3), 1e-13)
    _close(jn._nodal_residual(jphi, jrhs, jlev, jbc),
           tn._nodal_residual(tphi, trhs, tlev, tbc), 1e-13)
    _close(jn._restrict_node(jrhs, jbc), tn._restrict_node(trhs, tbc), 1e-13)
    ec = jn._restrict_node(jrhs, jbc)
    _close(jn._prolong_node(ec, len(c["lo"])),
           tn._prolong_node(torch.as_tensor(np.array(ec)), len(c["lo"])), 1e-13)


def _sigp(sigma, bc):
    """The padded cells nodal_sweep reads (tests/test_pallas_mg.py)."""
    sp = jn._pad_cells(sigma, bc, sigma.ndim)
    return jnp.pad(sp, [(0, 1)] * sigma.ndim, mode="edge")


@pytest.mark.parametrize("bcname", list(BCS))
def test_plain_sweep_matches_tpu_kernels_f32(bcname):
    # the shapes of tests/test_pallas_fused.py's cases (nodal_smooth_sr tiles)
    c = _case(bcname, (16, 16) if bcname == "2d" else (24, 16, 16), dtype=np.float32)
    jbc, tbc, jlev, tlev = _levels(c)
    jphi, tphi = jnp.asarray(c["phi"]), torch.as_tensor(c["phi"])
    jrhs, trhs = jnp.asarray(c["rhs"]), torch.as_tensor(c["rhs"])
    base = (tphi, tlev.sigma, trhs, c["dx"], c["lo"], c["hi"])
    vol = float(np.prod(c["dx"]))
    K = jpm.fem_K_table(c["dx"])
    jupd = tlev.omega * jlev.mask / jlev.diag
    phip, sigp = jn._pad_nodes(jphi, jbc), _sigp(jlev.sigma, jbc)
    # K6: one sweep, and the masked residual
    ref = jpm.nodal_sweep(phip, sigp, jrhs, jupd, K, vol, update=True, interpret=True)
    got, _ = tk.nodal_jacobi_ref(*base, 1, False, omega=tlev.omega)
    _close(ref, got, 1e-5)
    ref = jpm.nodal_sweep(phip, sigp, jrhs, jlev.mask, K, vol, update=False, interpret=True)
    _close(ref, tk.nodal_jacobi_ref(*base, 0, True)[1], 1e-5)
    # K7: 2 sweeps + residual, omega * mask / diag formed in the kernel
    pf, rf = jpf.nodal_smooth_fused(jphi, jlev.sigma, jrhs, c["dx"], c["lo"], c["hi"],
                                    tlev.omega, 2, True, interpret=True, mode="whole")
    got_p, got_r = tk.nodal_jacobi_ref(*base, 2, True, omega=tlev.omega)
    _close(pf, got_p, 1e-5)
    _close(rf, got_r, 1e-5)
    # K8: the same with upd and mask given as arrays (3D tiles only)
    if len(c["lo"]) == 3:
        tupd = torch.as_tensor(np.array(jupd))
        pf, rf = jpf.nodal_smooth_sr(jphi, jlev.sigma, jrhs, jupd, jlev.mask, c["dx"],
                                     c["lo"], 2, True, interpret=True)
        got_p, got_r = tk.nodal_jacobi_ref(*base, 2, True, upd=tupd, mask=tlev.mask)
        _close(pf, got_p, 1e-5)
        _close(rf, got_r, 1e-5)


SOLVES = ["periodic", "walls", "outflow"]


@pytest.mark.parametrize("bcname", SOLVES)
@pytest.mark.parametrize("fixed", [4, None])
def test_nodal_solve_32(bcname, fixed):
    c = _case(bcname, cshape=(32, 32, 32), seed=4)
    lo, hi = BCS[bcname]
    jbc, tbc = jn.NodalBC(lo, hi), tn.NodalBC(lo, hi)
    # a solvable rhs: the nodal divergence of a random cell field
    u = tuple(np.random.RandomState(9).rand(32, 32, 32) - 0.5 for _ in range(3))
    rhs = np.array(jn.div_cell_to_node(tuple(map(jnp.asarray, u)), c["dx"], jbc))
    jphi, _, jit = jn.nodal_solve(jnp.asarray(rhs), jnp.asarray(c["sigma"]), c["dx"], jbc,
                                  rtol=1e-11, fixed_cycles=fixed, mixed=False)
    tphi, tres, tit = tn.nodal_solve(torch.as_tensor(rhs), torch.as_tensor(c["sigma"]),
                                     c["dx"], tbc, rtol=1e-11, fixed_cycles=fixed)
    _close(jphi, tphi, 1e-10)
    assert int(jit) == int(tit)
    assert np.isfinite(float(tres))


@pytest.mark.parametrize("bcname", ["periodic", "walls"])
def test_np_oracle_matches_apply_nodal(bcname):
    c = _case(bcname, cshape=(16, 16, 16), seed=2)
    jbc, tbc = jn.NodalBC(c["lo"], c["hi"]), tn.NodalBC(c["lo"], c["hi"])
    ref = np_nodal.np_apply_nodal(c["phi"], c["sigma"], c["dx"], tbc)
    _close(ref, jn.apply_nodal(jnp.asarray(c["phi"]), jnp.asarray(c["sigma"]), c["dx"], jbc),
           1e-12)
    _close(ref, tn.apply_nodal(torch.as_tensor(c["phi"]), torch.as_tensor(c["sigma"]),
                               c["dx"], tbc), 1e-12)
    r = np_nodal.np_residual_nodal(c["phi"], c["rhs"], c["sigma"], None, c["dx"], tbc)
    _close(r, c["rhs"] - ref, 1e-12)
