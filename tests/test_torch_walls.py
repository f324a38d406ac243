"""Walled and variable-density runs end to end: the port's entry points
(config_from_inputs -> driver.initialize -> driver.run) against the JAX
package's, f64 on the CPU, in tolerance and in fixed-cycle mode.

  * Rayleigh-Taylor (probtype 10) 2D 32x64 (examples/inputs.2d.rayleigh_taylor:
    the JAX package's RT settings of tests/test_rt_convergence.py with
    viscosity and diffusivity 1e-4) and 3D at 8x8x16
    (examples/inputs.3d.rayleigh_taylor): gravity, the hydrostatic initial
    pressure, slip walls in the vertical;
  * the lid-driven cavity (examples/inputs.2d.lid_driven_cavity) at 32^2:
    no-slip walls and the moving lid's ext_dir value.

Each case goes through tests/torch_parity.py::run_both: initialize
without pressure iterations, compared; a seeded 1e-3 velocity
perturbation fed to both packages (a fluid at rest sits on Riemann ties);
driver.run for 2 steps, compared. Tolerance 1e-10 of max|ref| on every
state field.
"""

import pytest
import torch

from iamr_tpu_torch.config.parmparse import ParmParse as TParmParse
from iamr_tpu_torch.ns import driver as tdriver
from iamr_tpu_torch.ns import state as tstate
from torch_parity import CPU, example_text, run_both

torch.set_num_threads(2)
RT2D = example_text("inputs.2d.rayleigh_taylor")
RT3D = example_text("inputs.3d.rayleigh_taylor", "amr.n_cell = 8 8 16")
LID = """
amr.n_cell = 32 32
geometry.prob_lo = 0.0 0.0
geometry.prob_hi = 1.0 1.0
geometry.is_periodic = 0 0
ns.cfl = 0.7
ns.init_shrink = 0.1
ns.init_dt = 0.014
ns.vel_visc_coef = 0.01
ns.scal_diff_coefs = 0.0
ns.lo_bc = 5 5
ns.hi_bc = 5 5
yhi.velocity = 1.0 0.0
prob.probtype = 1
prob.density_ic = 1.0
"""


# tolerance mode in 3D and on the cavity: the same code as rt2d-tolerance
# and the fixed-cycle cases, so only the slow tier runs them
SLOW = pytest.mark.slow


@pytest.mark.parametrize("text,fixed", [
    pytest.param(RT2D, None, id="rt2d-tolerance"), pytest.param(RT2D, 4, id="rt2d-fixed4"),
    pytest.param(RT3D, None, id="rt3d-tolerance", marks=SLOW),
    pytest.param(RT3D, 4, id="rt3d-fixed4"),
    pytest.param(LID, None, id="lid-tolerance", marks=SLOW), pytest.param(LID, 4, id="lid-fixed4"),
])
def test_walled_runs_match(text, fixed):
    _, tst = run_both(text, fixed)
    assert bool(torch.isfinite(tst.vel).all())


def test_rt_initialize_is_hydrostatic():
    """The initial pressure balances gravity over each column: mean Gp_y =
    g mean(rho) to 1%, mean Gp_x = 0, with the config's pressure iteration
    (an advance from rest) included."""
    tcfg = tstate.config_from_inputs(TParmParse.from_string(RT2D), device="cpu")
    st = tdriver.initialize(tcfg, device="cpu")
    weight = tcfg.gravity * float(st.rho.mean())
    assert abs(float(st.gradp[1].mean()) - weight) < 1e-2 * abs(weight)
    assert abs(float(st.gradp[0].mean())) < 1e-12 * abs(weight)
    assert float(st.vel.abs().max()) == 0.0


@pytest.mark.parametrize("cells", [(16, 16, 32), (32, 64)], ids=["3d", "2d"])
def test_mg_calls_per_step_follow_the_formula(cells, monkeypatch):
    """chip_smoke.py holds the card's launches a step to 1 + k(2(L-1)+1) per
    solve with L from its copy of the hierarchy rule: on the CPU the MG
    wrappers are called that often on a walled, non-cubic box, and the rule
    gives the port's own hierarchy depth."""
    import chip_smoke as cs
    from iamr_tpu_torch.ns import advance as tadvance
    from iamr_tpu_torch.ops import mg, mg_kernels, mg_nodal

    calls = {"mg_cell_gsrb": 0, "mg_nodal_jacobi": 0}
    for name, key in (("cell_smooth", "mg_cell_gsrb"), ("nodal_jacobi", "mg_nodal_jacobi")):
        orig = getattr(mg_kernels, name)

        def counted(*a, _orig=orig, _key=key, **k):
            calls[_key] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(mg_kernels, name, counted)
    cfg = cs.rt_config(cells, "float64", CPU)
    st = tdriver.initialize(cfg, fixed_mg_cycles=4, device="cpu", init_iters=0)
    calls.update({k: 0 for k in calls})
    tadvance.advance(st, cfg, 4)
    assert calls == cs.expected_mg_launches(cells, 4, cs.cn_solves(cfg))
    for shape in (cells, (64, 64, 128), (1024, 2048)):
        dim = len(shape)
        ones = torch.ones(shape, dtype=torch.float64)
        faces = [torch.ones([x + (e == d) for e, x in enumerate(shape)], dtype=torch.float64)
                 for d in range(dim)]
        walls = (mg.PERIODIC,) * (dim - 1) + (mg.NEUMANN,)
        lc = mg.build_hierarchy(ones, faces, 0.0, 1.0, (1.0,) * dim, mg.PoissonBC(walls, walls),
                                stop_dofs=mg.DENSE_BOTTOM_DOFS)
        nbc = mg_nodal.NodalBC((mg_nodal.N_PERIODIC,) * (dim - 1) + (mg_nodal.N_NEUMANN,),
                               (mg_nodal.N_PERIODIC,) * (dim - 1) + (mg_nodal.N_NEUMANN,))
        ln = mg_nodal.build_nodal_hierarchy(ones, (1.0,) * dim, nbc,
                                            stop_dofs=mg_nodal.NODAL_DENSE_BOTTOM_DOFS)
        assert len(lc) == cs.mg_levels(shape, mg.DENSE_BOTTOM_DOFS, 0)
        assert len(ln) == cs.mg_levels(shape, mg_nodal.NODAL_DENSE_BOTTOM_DOFS, 1)
