"""LES in the port against the JAX package, f64 on the CPU: the Smagorinsky
(2D and 3D) and Sigma (3D) eddy viscosities and their face average
(ns/les.py), the tensor cross terms and fluxes, the explicit tensor
viscous terms and the implicit tensor solve (solvers/tensor.py, fixed
V-cycles and to tolerance), each to 1e-12 of max|ref| on seeded velocity
fields, periodic and walled; and the Sigma model refused in 2D by both
packages. The HIT LES step pairs are in tests/test_torch_les_rz_steps.py.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from iamr_tpu.ns import les as jles
from iamr_tpu.ns.advance import make_step as jmake_step
from iamr_tpu.ns.bcprovider import PhysBCProvider as JBCP
from iamr_tpu.ns.probs import init_state as jinit_state
from iamr_tpu.solvers import tensor as jtensor
from iamr_tpu_torch.ns import les as tles
from iamr_tpu_torch.ns.advance import make_step as tmake_step
from iamr_tpu_torch.ns.bcprovider import PhysBCProvider as TBCP
from iamr_tpu_torch.ns.probs import init_state as tinit_state
from iamr_tpu_torch.solvers import tensor as ttensor
from torch_parity import close, configs, example_text

torch.set_num_threads(2)

# a box with no-slip walls in x and slip walls in y (periodic in z), or
# periodic on every side
BOX = """
amr.n_cell = {cells}
ns.vel_visc_coef = 1e-3
ns.do_LES = 1
ns.LES_model = {model}
geometry.prob_lo = {lo}
geometry.prob_hi = {hi}
geometry.is_periodic = {per}
ns.lo_bc = {bc_lo}
ns.hi_bc = {bc_hi}
prob.probtype = 1
"""


def _text(dim, walled, model):
    three = dim == 3
    if walled:
        per, bc_lo, bc_hi = ("0 0 1", "5 4 0", "5 4 0") if three else ("0 0", "5 4", "5 4")
    else:
        per, bc_lo, bc_hi = ("1 1 1", "0 0 0", "0 0 0") if three else ("1 1", "0 0", "0 0")
    return BOX.format(cells="8 6 5" if three else "8 6", model=model,
                      lo="0 0 0" if three else "0 0", hi="1 0.75 0.625" if three else "1 0.75",
                      per=per, bc_lo=bc_lo, bc_hi=bc_hi)


def _both(dim, walled, model, seed=0):
    """The two packages' configs and BC providers, and a seeded velocity
    field and face viscosity in each."""
    jcfg, tcfg = configs(_text(dim, walled, model), dim=dim)
    rng = np.random.RandomState(seed)
    n = tuple(jcfg.geom.ncell)
    vel = rng.randn(dim, *n)
    mu = [1e-3 + 1e-3 * rng.rand(*[x + (e == d) for e, x in enumerate(n)]) for d in range(dim)]
    return ((jcfg, JBCP(jcfg), jnp.asarray(vel), tuple(jnp.asarray(m) for m in mu)),
            (tcfg, TBCP(tcfg), torch.as_tensor(vel), tuple(torch.as_tensor(m) for m in mu)))


CASES = [pytest.param(dim, walled, model, id=f"{dim}d-{'walled' if walled else 'periodic'}-{model}")
         for dim in (2, 3) for walled in (False, True)
         for model in (("Smagorinsky", "Sigma") if dim == 3 else ("Smagorinsky",))]


@pytest.mark.parametrize("dim,walled,model", CASES)
def test_eddy_viscosity_matches(dim, walled, model):
    (jcfg, jbcp, jvel, _), (tcfg, tbcp, tvel, _) = _both(dim, walled, model)
    if model == "Sigma":
        close(jles.mut_sigma(jcfg, jbcp, jvel, 1.5), tles.mut_sigma(tcfg, tbcp, tvel, 1.5),
              1e-12)
    else:
        close(jles.mut_smagorinsky(jcfg, jbcp, jvel, 0.18),
              tles.mut_smagorinsky(tcfg, tbcp, tvel, 0.18), 1e-12)
    for a, b in zip(jles.eddy_viscosity_faces(jcfg, jbcp, jvel),
                    tles.eddy_viscosity_faces(tcfg, tbcp, tvel)):
        close(a, b, 1e-12)


@pytest.mark.parametrize("dim,walled", [(2, False), (2, True), (3, False), (3, True)])
def test_tensor_terms_match(dim, walled):
    """tensor_cross_terms, tensor_cross_fluxes and tensor_visc_terms."""
    (jcfg, jbcp, jvel, jmu), (tcfg, tbcp, tvel, tmu) = _both(dim, walled, "Smagorinsky", 1)
    close(jles.tensor_cross_terms(jcfg, jbcp, jvel, jmu),
          tles.tensor_cross_terms(tcfg, tbcp, tvel, tmu), 1e-12)
    for fj, ft in zip(jles.tensor_cross_fluxes(jcfg, jbcp, jvel, jmu),
                      tles.tensor_cross_fluxes(tcfg, tbcp, tvel, tmu)):
        for a, b in zip(fj, ft):
            close(a, b, 1e-12)
    close(jtensor.tensor_visc_terms(jcfg, jbcp, jvel, jmu),
          ttensor.tensor_visc_terms(tcfg, tbcp, tvel, tmu), 1e-12)


@pytest.mark.parametrize("dim,walled,fixed", [(2, True, None), (3, False, 1), (3, True, 1)])
def test_diffuse_tensor_velocity_matches(dim, walled, fixed):
    """The segregated CN tensor solve with alpha = rho_half, b = theta dt:
    one V-cycle per inner solve (the step's fixed-cycle count) or to
    tolerance."""
    (jcfg, jbcp, jvel, jmu), (tcfg, tbcp, tvel, tmu) = _both(dim, walled, "Smagorinsky", 2)
    rng = np.random.RandomState(5)
    star = 0.1 * rng.randn(*jvel.shape) + np.asarray(jvel)
    rho = 1.0 + 0.5 * rng.rand(*jvel.shape[1:])
    dt = 0.01

    def jsolve(vs, vo, a):
        return jtensor.diffuse_tensor_velocity(jcfg, jbcp, vs, vo, a, jmu, dt, 0.5,
                                               fixed_cycles=fixed)

    ref = jax.jit(jsolve)(jnp.asarray(star), jvel, jnp.asarray(rho))
    got = ttensor.diffuse_tensor_velocity(
        tcfg, tbcp, torch.as_tensor(star), tvel, torch.as_tensor(rho), tmu,
        torch.tensor(dt, dtype=torch.float64), 0.5, fixed_cycles=fixed)
    close(ref, got, 1e-12)


def test_sigma_refused_in_2d():
    """Sigma is 3D-only: both packages refuse it in 2D when the step forms
    the eddy viscosity (the reference aborts)."""
    text = example_text("inputs.2d.lid_driven_cavity", "amr.n_cell = 8 8", "ns.do_LES = 1",
                        "ns.LES_model = Sigma")
    jcfg, tcfg = configs(text)
    jst = jinit_state(jcfg)._replace(dt=jnp.asarray(1e-3))
    with pytest.raises(AssertionError, match="3D-only"):
        jmake_step(jcfg, 1)(jst)
    tst = tinit_state(tcfg, "cpu")._replace(dt=torch.tensor(1e-3, dtype=torch.float64))
    with pytest.raises(ValueError, match="3D-only"):
        tmake_step(tcfg, 1)(tst)
