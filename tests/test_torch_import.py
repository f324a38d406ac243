"""The PyTorch port imports neither JAX nor the JAX package: every
iamr_tpu_torch module (the output modules io.*, ns.derive, plugins,
utils.fileio, the __main__ of `python -m iamr_tpu_torch`, ops.bds,
ns.les, solvers.tensor, the EB modules eb.geom and eb.redist and the AMR
modules amr.hierarchy, amr.sync, amr.multilevel and amr.tagging among
them), and
chip_smoke.py, load in a fresh interpreter with no 'jax', 'jax.*',
'iamr_tpu' or 'iamr_tpu.*' module in sys.modules (the GPU machine has no
JAX installed; the port keeps its own copies of the plain Python modules it
needs). Those copies (config.parmparse, core.geometry,
core.bc) parse and build examples/inputs.3d.hit_forced, the 2D lid-driven
cavity, HotSpot-RZ and walled, inflow, outflow and thermal inputs as the JAX package's
do, down to the velocity, scalar and temperature BC records. chip_smoke.py
also refuses to run without a CUDA device."""

import dataclasses
import os
import subprocess
import sys

import pytest

from iamr_tpu.config.parmparse import ParmParse as JParmParse
from iamr_tpu.core import bc as jbc
from iamr_tpu.ns import state as jstate
from iamr_tpu_torch.config.parmparse import ParmParse as TParmParse
from iamr_tpu_torch.core import bc as tbc
from iamr_tpu_torch.ns import state as tstate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FOREIGN = """
bad = sorted(m for m in sys.modules
             if m in ("jax", "iamr_tpu") or m.startswith(("jax.", "iamr_tpu.")))
assert not bad, bad
"""
IMPORT_ALL = """
import importlib, pkgutil, sys
import iamr_tpu_torch
names = [m.name for m in pkgutil.walk_packages(iamr_tpu_torch.__path__, "iamr_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert len(names) >= 53, names
for name in ("ns.checks", "ns.derive", "plugins", "io.vismf", "io.plotfile", "io.checkpoint",
             "io.amrex_chk", "utils.fileio", "__main__", "ops.bds", "ns.les",
             "solvers.tensor", "eb.geom", "eb.redist", "amr.hierarchy", "amr.sync",
             "amr.multilevel", "amr.tagging"):
    assert "iamr_tpu_torch." + name in names, (name, names)
""" + FOREIGN

IMPORT_SMOKE = """
import sys
import chip_smoke
""" + FOREIGN


def _run(args, cwd=ROOT):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("code", [IMPORT_ALL, IMPORT_SMOKE], ids=["package", "chip_smoke"])
def test_port_imports_no_jax(code):
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_refuses_without_cuda():
    proc = _run(["-c", "import torch; assert not torch.cuda.is_available()"])
    if proc.returncode != 0:
        pytest.skip("a CUDA device is present; the chip run itself covers this")
    proc = _run([os.path.join(ROOT, "chip_smoke.py")])
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_port_copies_build_the_same_config():
    path = os.path.join(ROOT, "examples", "inputs.3d.hit_forced")
    with open(path) as f:
        text = f.read()
    jpp, tpp = JParmParse.from_string(text), TParmParse.from_string(text)
    assert type(tpp).__module__ == "iamr_tpu_torch.config.parmparse"
    for key in ("amr.n_cell", "geometry.prob_lo", "geometry.prob_hi", "geometry.is_periodic",
                "ns.lo_bc", "ns.hi_bc", "prob.probtype", "turb.nmodes"):
        assert jpp.queryarr(key) == tpp.queryarr(key), key
    jcfg = jstate.config_from_inputs(jpp)
    tcfg = tstate.config_from_inputs(tpp, device="cpu")
    assert type(tcfg.geom).__module__ == "iamr_tpu_torch.core.geometry"
    assert type(tcfg.dom).__module__ == "iamr_tpu_torch.core.bc"
    assert dataclasses.asdict(jcfg.geom) == dataclasses.asdict(tcfg.geom)
    assert dataclasses.asdict(jcfg.dom) == dataclasses.asdict(tcfg.dom)
    assert jcfg.geom.dx == tcfg.geom.dx
    for comp in range(3):
        jr = jbc.velocity_bcrec(jcfg.dom.phys_lo, jcfg.dom.phys_hi, comp)
        tr = tbc.velocity_bcrec(tcfg.dom.phys_lo, tcfg.dom.phys_hi, comp)
        assert (jr.lo, jr.hi) == (tr.lo, tr.hi)
    jr = jbc.make_bcrec(jcfg.dom.phys_lo, jcfg.dom.phys_hi, jbc.SCALAR_BC)
    tr = tbc.make_bcrec(tcfg.dom.phys_lo, tcfg.dom.phys_hi, tbc.SCALAR_BC)
    assert (jr.lo, jr.hi) == (tr.lo, tr.hi)


WALLED = """
amr.n_cell = 8 8 16
geometry.prob_lo = 0. 0. 0.
geometry.prob_hi = 0.5 0.5 1.0
geometry.is_periodic = 1 0 0
ns.lo_bc = 0 1 5
ns.hi_bc = 0 2 4
ns.do_temp = 1
ns.scal_diff_coefs = 1e-4 2e-4
ylo.velocity = 0.0 1.0 0.0
ylo.temp = 2.0
zhi.type = pressure_outflow
"""


@pytest.mark.parametrize("source", ["inputs.2d.lid_driven_cavity", "inputs.2d.hotspot_rz",
                                    "walled"])
def test_port_copies_build_the_same_walled_config(source):
    if source == "walled":
        text = WALLED
    else:
        with open(os.path.join(ROOT, "examples", source)) as f:
            text = f.read()
    jcfg = jstate.config_from_inputs(JParmParse.from_string(text))
    tcfg = tstate.config_from_inputs(TParmParse.from_string(text), device="cpu")
    assert dataclasses.asdict(jcfg.geom) == dataclasses.asdict(tcfg.geom)
    assert dataclasses.asdict(jcfg.dom) == dataclasses.asdict(tcfg.dom)
    assert (jcfg.ntrac, jcfg.do_temp, jcfg.dim) == (tcfg.ntrac, tcfg.do_temp, tcfg.dim)
    keys = ("do_les", "les_model", "smago_cs", "sigma_cs", "advection_scheme",
            "use_forces_in_trans", "vel_visc_coef")
    assert [getattr(jcfg, k) for k in keys] == [getattr(tcfg, k) for k in keys]
    for comp in range(jcfg.dim):
        jr = jbc.velocity_bcrec(jcfg.dom.phys_lo, jcfg.dom.phys_hi, comp)
        tr = tbc.velocity_bcrec(tcfg.dom.phys_lo, tcfg.dom.phys_hi, comp)
        assert (jr.lo, jr.hi) == (tr.lo, tr.hi)
    for jt, tt in ((jbc.SCALAR_BC, tbc.SCALAR_BC), (jbc.TEMP_BC, tbc.TEMP_BC)):
        jr = jbc.make_bcrec(jcfg.dom.phys_lo, jcfg.dom.phys_hi, jt)
        tr = tbc.make_bcrec(tcfg.dom.phys_lo, tcfg.dom.phys_hi, tt)
        assert (jr.lo, jr.hi) == (tr.lo, tr.hi)
