"""Parity of the port's spectral solvers and the projection/diffusion
branches that use them with the JAX package (f64 on the CPU; tolerance
1e-12 of max|ref|; the FFTs differ only by roundoff)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from iamr_tpu.core.bc import DomainBC, PhysBC, make_bcrec, SCALAR_BC
from iamr_tpu.ops import mg_nodal as jn
from iamr_tpu.solvers import diffusion as jd
from iamr_tpu.solvers import mac as jm
from iamr_tpu.solvers import nodal_proj as jp
from iamr_tpu.solvers import spectral as js
from iamr_tpu_torch.ops import mg_nodal as tn
from iamr_tpu_torch.solvers import diffusion as td
from iamr_tpu_torch.solvers import mac as tm
from iamr_tpu_torch.solvers import nodal_proj as tp
from iamr_tpu_torch.solvers import spectral as ts

torch.set_num_threads(2)
N = (12, 16, 20)
DX = (1.0 / 12, 1.0 / 16, 1.0 / 20)
DOM = DomainBC(phys_lo=(PhysBC.Interior,) * 3, phys_hi=(PhysBC.Interior,) * 3)
NBC = jn.NodalBC((jn.N_PERIODIC,) * 3, (jn.N_PERIODIC,) * 3)
TBC = tn.NodalBC((tn.N_PERIODIC,) * 3, (tn.N_PERIODIC,) * 3)


def _rng(seed=0):
    return np.random.RandomState(seed)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _close(ref, got, tol=1e-12):
    ref = np.asarray(ref)
    got = got.numpy()
    assert ref.shape == got.shape
    scale = max(float(np.abs(ref).max()), 1e-300)
    assert float(np.abs(ref - got).max()) <= tol * scale


def _nodes(a):
    """Periodic node array: wrap the n^3 values to (n+1)^3."""
    return np.pad(a, [(0, 1)] * 3, mode="wrap")


@pytest.mark.parametrize("a_alpha0", [0.0, 3.5])
def test_solve_cell_helmholtz(a_alpha0):
    rhs = _rng().randn(*N)
    ref = js.solve_cell_helmholtz(jnp.asarray(rhs), a_alpha0, 0.7, DX)
    got = ts.solve_cell_helmholtz(_t(rhs), torch.tensor(a_alpha0, dtype=torch.float64),
                                  0.7, DX)
    _close(ref, got)


def test_solve_nodal_poisson():
    rhs = _nodes(_rng(1).randn(*N))
    _close(js.solve_nodal_poisson(jnp.asarray(rhs), 1.3, DX),
           ts.solve_nodal_poisson(_t(rhs), 1.3, DX))


def test_node_cell_operators():
    rng = _rng(2)
    u = [rng.randn(*N) for _ in range(3)]
    _close(jn.div_cell_to_node(tuple(jnp.asarray(x) for x in u), DX, NBC),
           tn.div_cell_to_node(tuple(_t(x) for x in u), DX, TBC))
    phi = _nodes(rng.randn(*N))
    for r, g in zip(jn.grad_node_to_cell(jnp.asarray(phi), DX),
                    tn.grad_node_to_cell(_t(phi), DX)):
        _close(r, g)
    _close(jn.avg_cell_to_node(jnp.asarray(u[0]), NBC), tn.avg_cell_to_node(_t(u[0]), TBC))


def test_mac_project_spectral():
    rng = _rng(3)
    umac = []
    for d in range(3):
        u = rng.randn(*[n + (1 if e == d else 0) for e, n in enumerate(N)])
        hi = tuple(slice(None) if e != d else -1 for e in range(3))
        lo = tuple(slice(None) if e != d else 0 for e in range(3))
        u[hi] = u[lo]
        umac.append(u)
    rho = np.full(N, 1.25)
    ju, jphi, _ = jm.mac_project(tuple(jnp.asarray(u) for u in umac), jnp.asarray(rho),
                                 DOM, DX, spectral_beta0=1.0 / 1.25)
    tu, tphi, _ = tm.mac_project(tuple(_t(u) for u in umac), _t(rho), DOM, DX,
                                 spectral_beta0=torch.tensor(1.0 / 1.25, dtype=torch.float64))
    _close(jphi, tphi)
    for d in range(3):
        _close(ju[d], tu[d])


def test_level_project_spectral():
    rng = _rng(4)
    vel = rng.randn(3, *N)
    gradp = rng.randn(3, *N)
    p = _nodes(rng.randn(*N))
    rho = np.full(N, 0.8)
    ref = jp.level_project(jnp.asarray(vel), jnp.asarray(rho), jnp.asarray(p),
                           jnp.asarray(gradp), 0.01, DOM, DX, spectral_sigma0=1.25)
    got = tp.level_project(_t(vel), _t(rho), _t(p), _t(gradp),
                           torch.tensor(0.01, dtype=torch.float64), DOM, DX,
                           spectral_sigma0=torch.tensor(1.25, dtype=torch.float64))
    for r, g in zip(ref[:3], got[:3]):
        _close(r, g)


@pytest.mark.parametrize("theta", [0.0, 0.5])
def test_diffuse_scalar(theta):
    rng = _rng(5)
    s_star, s_old = rng.randn(*N), rng.randn(*N)
    alpha = np.full(N, 2.0)
    beta = [np.full([n + (1 if e == d else 0) for e, n in enumerate(N)], 0.3)
            for d in range(3)]
    rec = make_bcrec(DOM.phys_lo, DOM.phys_hi, SCALAR_BC)
    ref = jd.diffuse_scalar(jnp.asarray(s_star), jnp.asarray(s_old), jnp.asarray(alpha),
                            jnp.asarray(alpha), tuple(jnp.asarray(b) for b in beta), 0.01,
                            DX, rec, theta=theta, spectral=(2.0, 0.3))[0]
    got = td.diffuse_scalar(_t(s_star), _t(s_old), _t(alpha), _t(alpha),
                            tuple(_t(b) for b in beta), 0.01, DX, rec, theta=theta,
                            spectral=(torch.tensor(2.0, dtype=torch.float64), 0.3))[0]
    _close(ref, got)
    _close(jd.visc_terms_component(jnp.asarray(s_old), tuple(jnp.asarray(b) for b in beta),
                                   DX, rec),
           td.visc_terms_component(_t(s_old), tuple(_t(b) for b in beta), DX, rec))


def test_spectral_eligible():
    from iamr_tpu_torch.ns.state import NSConfig
    from iamr_tpu.core.geometry import Geometry

    geom = Geometry(ncell=N, prob_lo=(0.0,) * 3, prob_hi=(1.0,) * 3, periodic=(True,) * 3)
    cfg = NSConfig(geom=geom, dom=DOM)
    assert ts.spectral_eligible(cfg, torch.ones(N))
    assert not ts.spectral_eligible(cfg, _t(_rng().rand(*N)))
    walls = DomainBC(phys_lo=(PhysBC.NoSlipWall,) * 3, phys_hi=(PhysBC.NoSlipWall,) * 3)
    assert not ts.spectral_eligible(NSConfig(geom=geom, dom=walls), torch.ones(N))
