"""The advection variants' steps in the port against the JAX package, f64
on the CPU: Rayleigh-Taylor 8x8x16 (examples/inputs.3d.rayleigh_taylor)
with Godunov_PPM, BDS and use_forces_in_trans, and RT 2D 16x32 with BDS,
initialize + 2 steps through tests/torch_parity.py::run_both to 1e-10 (the
scheme does not enter initialize: the 3D cases share the JAX package's);
and an unknown ns.advection_scheme, which both packages run as
Godunov_PLM, bit for bit within each package. The functions these steps
run are held one by one in tests/test_torch_advection_variants.py. (Few
cases a file: pytest-xdist's loadfile queue runs files with more cases
first, and these step pairs would then run ahead of the longest file.)
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from iamr_tpu.ns import driver as jdriver
from iamr_tpu.ns.advance import make_step as jmake_step
from iamr_tpu_torch import convert
from iamr_tpu_torch.ns import advance as tadvance
from torch_parity import close, configs, example_text, run_both, CPU

torch.set_num_threads(2)

RT3D = "inputs.3d.rayleigh_taylor"


@pytest.fixture(scope="module")
def rt3d_init():
    """The JAX package's initialize of RT 8x8x16 (fixed cycles, no pressure
    iterations): the advection scheme does not enter it."""
    jcfg, _ = configs(example_text(RT3D, "amr.n_cell = 8 8 16"))
    return jdriver.initialize(jcfg, fixed_mg_cycles=4, init_iters=0)


@pytest.mark.parametrize("name,line", [
    pytest.param(name, line, id=name) for name, line in (
        ("rt3d-ppm", "ns.advection_scheme = Godunov_PPM"),
        ("rt3d-bds", "ns.advection_scheme = BDS"),
        ("rt3d-uft", "godunov.use_forces_in_trans = 1"),
        ("rt2d-bds", "ns.advection_scheme = BDS"))])
def test_scheme_steps_match(name, line, rt3d_init):
    if name.startswith("rt3d"):
        tcfg, tst = run_both(example_text(RT3D, "amr.n_cell = 8 8 16", line), 4,
                             jinit=rt3d_init)
    else:
        tcfg, tst = run_both(example_text("inputs.2d.rayleigh_taylor", "amr.n_cell = 16 32",
                                          line), 4)
    assert bool(torch.isfinite(tst.vel).all())


def test_unknown_scheme_runs_as_plm(rt3d_init):
    """The repaired fault: an unknown ns.advection_scheme runs as
    Godunov_PLM in both packages (iamr_tpu maps unknown names to PLM), bit
    for bit with the PLM run of the same package, and the packages agree
    to 1e-10."""
    runs = {}
    for scheme in ("Godunov_PLM", "Godunov_Fancy"):
        jcfg, tcfg = configs(example_text(RT3D, "amr.n_cell = 8 8 16",
                                          f"ns.advection_scheme = {scheme}"))
        jst = rt3d_init._replace(vel=rt3d_init.vel + 1e-3 * jnp.asarray(
            np.random.RandomState(3).randn(*rt3d_init.vel.shape)))
        tst = convert.state_from_numpy(
            {k: None if v is None else np.asarray(v) for k, v in jst._asdict().items()}, CPU)
        runs[scheme] = (jmake_step(jcfg, 4)(jst), tadvance.make_step(tcfg, 4)(tst))
    (jplm, tplm), (jfancy, tfancy) = runs["Godunov_PLM"], runs["Godunov_Fancy"]
    for k in ("vel", "rho", "trac", "p", "gradp", "dt"):
        assert np.array_equal(np.asarray(getattr(jplm, k)), np.asarray(getattr(jfancy, k))), k
        assert torch.equal(getattr(tplm, k), getattr(tfancy, k)), k
        close(getattr(jplm, k), getattr(tplm, k))
