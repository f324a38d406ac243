"""The step's switches end to end: the port's entry points against the JAX
package's, f64 on the CPU, on Rayleigh-Taylor (examples/inputs.2d.rayleigh_taylor,
32x64: the JAX package's RT settings of tests/test_rt_convergence.py with
viscosity and diffusivity 1e-4) with ns.do_mom_diff = 1 (rho U advected
conservatively), ns.do_denminmax = 1 (rho clamped to its old
neighbourhood) and ns.do_mac_proj = 0 (advection with the unprojected MAC
velocities), one case each, and on its 3D form at 8x8x16
(examples/inputs.3d.rayleigh_taylor) with do_mom_diff and do_denminmax
together (fixed-cycle mode): there the advected fields go to the
multi-field Godunov path, rho U as conservative rows with force rows. The
2D cases run in tolerance and in fixed-cycle mode.

Each case goes through tests/torch_parity.py::run_both: initialize
without pressure iterations, compared; a seeded 1e-3 velocity perturbation
fed to both; driver.run for 2 steps, compared to 1e-10 of max|ref|. The
switches do not enter initialize, so the 2D cases of one mode share the
JAX package's initialize (made once per module).
"""

import pytest
import torch

from iamr_tpu.ns import driver as jdriver
from torch_parity import configs, example_text, run_both

torch.set_num_threads(2)


RT2D = "inputs.2d.rayleigh_taylor"
SWITCHES = {"mom_diff": "ns.do_mom_diff = 1", "denminmax": "ns.do_denminmax = 1",
            "no_mac_proj": "ns.do_mac_proj = 0"}


@pytest.fixture(scope="module")
def rt2d_init():
    """The JAX package's initialize of RT 2D (no pressure iterations), by
    mode, made on first use."""
    made = {}

    def get(fixed):
        if fixed not in made:
            jcfg, _ = configs(example_text(RT2D))
            made[fixed] = jdriver.initialize(jcfg, fixed_mg_cycles=fixed, init_iters=0)
        return made[fixed]

    return get


@pytest.mark.parametrize("switch,fixed", [
    pytest.param(line, fixed, id=name + ("" if fixed else "-tolerance"))
    for fixed in (4, None) for name, line in SWITCHES.items()])
def test_step_switches_match(switch, fixed, rt2d_init):
    tcfg, tst = run_both(example_text(RT2D, switch), fixed, jinit=rt2d_init(fixed))
    assert bool(torch.isfinite(tst.vel).all())


def test_rt3d_mom_diff_denminmax_matches():
    text = example_text("inputs.3d.rayleigh_taylor", "amr.n_cell = 8 8 16",
                        "ns.do_mom_diff = 1", "ns.do_denminmax = 1")
    tcfg, tst = run_both(text, 4)
    assert tcfg.do_mom_diff and bool(torch.isfinite(tst.vel).all())
