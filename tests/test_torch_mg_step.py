"""The multigrid slice end to end: the port's step and initialisation
against the JAX package's, f64 on the CPU, from the same state (carried
across by iamr_tpu_torch.convert).

  * forced HIT (probtype 100) 32^3 with 256 tracer particles and
    ns.fft_solve = 0: 2 steps of make_step_with_particles with
    fixed_mg_cycles=4, and 1 step in tolerance mode. A seeded 1e-3
    velocity perturbation, fed to both packages, keeps face states off
    Riemann ties (tests/test_torch_advance.py).
  * driver.initialize (initial velocity projection, first dt, one
    pressure iteration) on the same config, then one driver.run step from
    it (the port's run starting from state=None).

Tolerance 1e-10 of max|ref| on vel, rho, p, gradp, dt and particle
positions (the two differ by reduction roundoff only).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from iamr_tpu.config.parmparse import ParmParse as JParmParse
from iamr_tpu.ns import advance as ja
from iamr_tpu.ns import driver as jdriver
from iamr_tpu.ns import particles as jpart
from iamr_tpu.ns import probs as jprobs
from iamr_tpu.ns import state as jstate
from iamr_tpu_torch import convert
from iamr_tpu_torch.config.parmparse import ParmParse as TParmParse
from iamr_tpu_torch.ns import advance as ta
from iamr_tpu_torch.ns import driver as tdriver
from iamr_tpu_torch.ns import state as tstate

torch.set_num_threads(2)
CPU = torch.device("cpu")
HIT = """
amr.n_cell = 32 32 32
ns.init_iter = {init_iter}
ns.fft_solve = 0
ns.scal_diff_coefs = 0.0
geometry.is_periodic = 1 1 1
ns.lo_bc = 0 0 0
ns.hi_bc = 0 0 0
ns.cfl = 0.7
ns.vel_visc_coef = 1.e-4
geometry.prob_lo = -0.5 -0.5 -0.5
geometry.prob_hi = 0.5 0.5 0.5
prob.probtype = 100
turb.nmodes = 4
turb.div_free_force = 1
"""
FIELDS = ("vel", "rho", "p", "gradp", "dt", "time")


def _configs(init_iter=0):
    text = HIT.format(init_iter=init_iter)
    jcfg = jstate.config_from_inputs(JParmParse.from_string(text))
    tcfg = tstate.config_from_inputs(TParmParse.from_string(text), device="cpu")
    return jcfg, tcfg


def _to_port(jst):
    return convert.state_from_numpy(
        {k: None if v is None else np.asarray(v) for k, v in jst._asdict().items()}, CPU)


def _close(ref, got, tol=1e-10):
    ref = np.asarray(ref)
    got = got.numpy()
    assert ref.shape == got.shape
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(ref - got).max())
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("fixed,steps", [(4, 2), (None, 1)], ids=["fixed4", "tolerance"])
def test_hit_mg_steps_with_particles(fixed, steps):
    jcfg, tcfg = _configs()
    jst = jprobs.init_state(jcfg)._replace(dt=jnp.asarray(5e-3, jnp.float64))
    noise = 1e-3 * np.random.RandomState(3).randn(*jst.vel.shape)
    jst = jst._replace(vel=jst.vel + jnp.asarray(noise))
    tst = _to_port(jst)
    pos = np.random.RandomState(7).rand(256, 3) - 0.5
    jparts = jpart.from_positions(jnp.asarray(pos))
    tparts = convert.particles_from_numpy(pos, CPU)
    jstep = ja.make_step_with_particles(jcfg, fixed, spectral=False)
    tstep = ta.make_step_with_particles(tcfg, fixed, spectral=False)
    for _ in range(steps):
        jst, jparts = jstep(jst, jparts)
        tst, tparts = tstep(tst, tparts)
    for k in FIELDS:
        _close(getattr(jst, k), getattr(tst, k))
    _close(jparts.pos, tparts.pos)
    assert bool(tparts.alive.all())


def test_initialize_then_run():
    jcfg, tcfg = _configs(init_iter=1)
    jst = jdriver.initialize(jcfg, fixed_mg_cycles=4)
    tst = tdriver.initialize(tcfg, fixed_mg_cycles=4, device="cpu")
    for k in FIELDS:
        _close(getattr(jst, k), getattr(tst, k))
    jst = jdriver.run(jcfg, jst, max_steps=1, fixed_mg_cycles=4)
    tst = tdriver.run(tcfg, None, max_steps=1, fixed_mg_cycles=4, device="cpu")
    for k in FIELDS:
        _close(getattr(jst, k), getattr(tst, k))
