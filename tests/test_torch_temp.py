"""The temperature path end to end: the port's entry points against the
JAX package's, f64 on the CPU, on HotSpot 2D 32^2 (tests/test_temp.py:
probtype 6 hot bubble, do_temp with conduction and its thermal divergence
source, no-slip bottom, outflow top with gravity) in tolerance and in
fixed-cycle mode, and on HotSpot 3D at 8^3 (examples/inputs.3d.hotspot) in
both modes: there T is the multi-field Godunov path's last field,
convective with no force row.

Each case goes through tests/torch_parity.py::run_both: initialize
without pressure iterations, compared; a seeded 1e-3 velocity perturbation
fed to both; driver.run for 2 steps, compared to 1e-10 of max|ref| (dsdt
included).
"""

import pytest
import torch

from torch_parity import example_text, run_both

torch.set_num_threads(2)
HOTSPOT = """
amr.n_cell = 32 32
ns.cfl = 0.5
ns.init_iter = 1
ns.init_dt = 0.002
ns.do_temp = 1
ns.temp_cond_coef = 1.e-4
ns.vel_visc_coef = 0.001
ns.scal_diff_coefs = 0.001
ns.gravity = -9.8
geometry.prob_lo = -0.5 0.
geometry.prob_hi = 0.5 1.
geometry.is_periodic = 1 0
ns.lo_bc = 0 5
ns.hi_bc = 0 2
prob.probtype = 6
prob.blob_center = 0.0 0.35
prob.blob_radius = 0.2
prob.density_ic = 2.0
prob.interface_width = 0.05
"""


HOTSPOT3D = example_text("inputs.3d.hotspot", "amr.n_cell = 8 8 8")


@pytest.mark.parametrize("text,fixed", [
    pytest.param(HOTSPOT, None, id="tolerance"), pytest.param(HOTSPOT, 4, id="fixed4"),
    pytest.param(HOTSPOT3D, None, id="3d-tolerance"), pytest.param(HOTSPOT3D, 4, id="3d-fixed4"),
])
def test_hotspot_matches(text, fixed):
    tcfg, tst = run_both(text, fixed)
    assert tcfg.do_temp and tst.dsdt is not None
    # the hot bubble: T = 1/rho > 1 inside
    assert float(tst.temp.max()) > 1.5
