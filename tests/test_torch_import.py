"""The PyTorch port imports neither JAX nor the JAX package: every
iamr_tpu_torch module, and chip_smoke.py, load in a fresh interpreter with
no 'jax', 'jax.*', 'iamr_tpu' or 'iamr_tpu.*' module in sys.modules (the GPU
machine has no JAX installed; the port keeps its own copies of the plain
Python modules it needs). Those copies (config.parmparse, core.geometry,
core.bc) parse and build examples/inputs.3d.hit_forced as the JAX package's
do. chip_smoke.py also refuses to run without a CUDA device."""

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
assert len(names) >= 25, names
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
