"""The slice end to end: the port's timestep against the JAX package's, f64
on the CPU, from the same state (carried across by iamr_tpu_torch.convert).

  * Taylor-Green (probtype 11) 32^3: 2 steps of advance (make_step). The
    exactly symmetric TG field puts face states on Riemann ties
    (ul + ur = 0), where FFT roundoff picks differently in the two
    packages; a seeded 1e-3 velocity perturbation, fed to both, moves the
    state off those ties.
  * forced HIT (probtype 100) 32^3 with 256 tracer particles: 2 steps of
    make_step_with_particles on the JAX side, driver.run on the port's.

Tolerance 1e-10 of max|ref| on vel, rho, trac, p, gradp, dt and particle
positions (the two differ by FFT and reduction roundoff only).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from iamr_tpu.config.parmparse import ParmParse as JParmParse
from iamr_tpu.ns import advance as ja
from iamr_tpu.ns import particles as jpart
from iamr_tpu.ns import probs as jprobs
from iamr_tpu.ns import state as jstate
from iamr_tpu.solvers.spectral import spectral_eligible as j_eligible
from iamr_tpu_torch import convert
from iamr_tpu_torch.config.parmparse import ParmParse as TParmParse
from iamr_tpu_torch.ns import advance as ta
from iamr_tpu_torch.ns import driver as tdriver
from iamr_tpu_torch.ns import state as tstate
from iamr_tpu_torch.solvers.spectral import spectral_eligible as t_eligible

torch.set_num_threads(2)
CPU = torch.device("cpu")
COMMON = """
amr.n_cell = 32 32 32
ns.init_iter = 0
ns.scal_diff_coefs = 0.0
geometry.is_periodic = 1 1 1
ns.lo_bc = 0 0 0
ns.hi_bc = 0 0 0
"""
TG = COMMON + """
ns.cfl = 0.5
ns.vel_visc_coef = 1.e-3
geometry.prob_lo = 0. 0. 0.
geometry.prob_hi = 1. 1. 1.
prob.probtype = 11
prob.velocity_factor = 1.0
"""
HIT = COMMON + """
ns.cfl = 0.7
ns.vel_visc_coef = 1.e-4
geometry.prob_lo = -0.5 -0.5 -0.5
geometry.prob_hi = 0.5 0.5 0.5
prob.probtype = 100
turb.nmodes = 4
turb.div_free_force = 1
"""
FIELDS = ("vel", "rho", "trac", "p", "gradp", "dt", "time")


def _setup(text, dt, perturb=0.0):
    jcfg = jstate.config_from_inputs(JParmParse.from_string(text))
    jst = jprobs.init_state(jcfg)._replace(dt=jnp.asarray(dt, jnp.float64))
    if perturb:
        noise = perturb * np.random.RandomState(3).randn(*jst.vel.shape)
        jst = jst._replace(vel=jst.vel + jnp.asarray(noise))
    tcfg = tstate.config_from_inputs(TParmParse.from_string(text), device="cpu")
    tst = convert.state_from_numpy(
        {k: None if v is None else np.asarray(v) for k, v in jst._asdict().items()}, CPU
    )
    assert j_eligible(jcfg, np.asarray(jst.rho)) and t_eligible(tcfg, tst.rho)
    return jcfg, jst, tcfg, tst


def _close(ref, got, tol=1e-10):
    ref = np.asarray(ref)
    got = got.numpy()
    assert ref.shape == got.shape
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(ref - got).max())
    assert err <= tol * scale, (err, scale)


def test_taylor_green_two_steps():
    jcfg, jst, tcfg, tst = _setup(TG, 0.01, perturb=1e-3)
    jstep = ja.make_step(jcfg, spectral=True)
    tstep = ta.make_step(tcfg, spectral=True)
    for _ in range(2):
        jst = jstep(jst)
        tst = tstep(tst)
    for k in FIELDS:
        _close(getattr(jst, k), getattr(tst, k))


def test_hit_two_steps_with_particles():
    jcfg, jst, tcfg, tst = _setup(HIT, 5e-3)
    pos = np.random.RandomState(7).rand(256, 3) - 0.5
    jparts = jpart.from_positions(jnp.asarray(pos))
    jstep = ja.make_step_with_particles(jcfg, spectral=True)
    for _ in range(2):
        jst, jparts = jstep(jst, jparts)
    tst, tparts = tdriver.run(tcfg, tst, max_steps=2,
                              particles=convert.particles_from_numpy(pos, CPU))
    for k in FIELDS:
        _close(getattr(jst, k), getattr(tst, k))
    _close(jparts.pos, tparts.pos)
    assert bool(tparts.alive.all())
