"""Shared steps of the walled-run parity tests (tests/test_torch_walls.py,
test_torch_temp.py, test_torch_switches.py, test_torch_bc_ops.py): the JAX
package on the CPU in x64 against the port with device="cpu", f64, from the
same inputs.

A fluid at rest puts every face on a Riemann tie, where roundoff picks
differently in the two packages (tests/test_torch_advance.py). run_both
therefore compares driver.initialize without pressure iterations, feeds
both packages the same seeded 1e-3 velocity perturbation, and compares
driver.run's steps from there.
"""

import os

import numpy as np
import torch
import jax.numpy as jnp

from iamr_tpu.config.parmparse import ParmParse as JParmParse
from iamr_tpu.ns import driver as jdriver
from iamr_tpu.ns import state as jstate
from iamr_tpu_torch import convert
from iamr_tpu_torch.config.parmparse import ParmParse as TParmParse
from iamr_tpu_torch.ns import driver as tdriver
from iamr_tpu_torch.ns import state as tstate

CPU = torch.device("cpu")
FIELDS = ("vel", "rho", "trac", "temp", "p", "gradp", "dt", "time", "dsdt")
EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "examples")


def example_text(name, *overrides):
    """The inputs text of examples/<name>, then the `key = value` lines
    given (a later line wins)."""
    with open(os.path.join(EXAMPLES, name)) as f:
        return f.read() + "".join(f"\n{line}" for line in overrides) + "\n"


def close(ref, got, tol=1e-10):
    """max|ref - got| <= tol max|ref|; both None passes."""
    assert (ref is None) == (got is None)
    if ref is None:
        return
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(ref - got).max())
    assert err <= tol * scale, (err, scale)


def configs(text, dim=None):
    """The JAX package's and the port's (CPU, f64) configs of one inputs text."""
    return (jstate.config_from_inputs(JParmParse.from_string(text), dim_hint=dim),
            tstate.config_from_inputs(TParmParse.from_string(text), dim_hint=dim,
                                      device="cpu"))


def run_both(text, fixed, steps=2, perturb=1e-3):
    """initialize (no pressure iterations), compared; the perturbation;
    driver.run for `steps` steps, compared to 1e-10 of max|ref| on every
    state field. Returns the port's config and final state."""
    jcfg, tcfg = configs(text)
    jst = jdriver.initialize(jcfg, fixed_mg_cycles=fixed, init_iters=0)
    tst = tdriver.initialize(tcfg, fixed_mg_cycles=fixed, device="cpu", init_iters=0)
    for k in FIELDS:
        close(getattr(jst, k), getattr(tst, k))
    noise = perturb * np.random.RandomState(3).randn(*jst.vel.shape)
    jst = jst._replace(vel=jst.vel + jnp.asarray(noise))
    tst = convert.state_from_numpy(
        {k: None if v is None else np.asarray(v) for k, v in jst._asdict().items()}, CPU)
    jst = jdriver.run(jcfg, jst, max_steps=steps, fixed_mg_cycles=fixed)
    tst = tdriver.run(tcfg, tst, max_steps=steps, fixed_mg_cycles=fixed)
    for k in FIELDS:
        close(getattr(jst, k), getattr(tst, k))
    return tcfg, tst
