"""The PyTorch port imports no JAX: every iamr_tpu_torch module, and
chip_smoke.py, load in a fresh interpreter with 'jax' absent from
sys.modules (the GPU machine has no JAX installed). chip_smoke.py also
refuses to run without a CUDA device."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IMPORT_ALL = """
import importlib, pkgutil, sys
import iamr_tpu_torch
names = [m.name for m in pkgutil.walk_packages(iamr_tpu_torch.__path__, "iamr_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert len(names) >= 20, names
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
assert not bad, bad
print(len(names))
"""

IMPORT_SMOKE = """
import sys
import chip_smoke
assert "jax" not in sys.modules
"""


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
