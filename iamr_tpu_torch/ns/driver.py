"""Single-level time loop (counterpart of iamr_tpu/ns/driver.py::run).

The caller supplies the initial state (init_state plus a dt): the JAX
package's driver.initialize starts with a nodal-multigrid velocity
projection, which is not ported yet. Plotfiles, checkpoints (and with them
restarts), ns.debug checks and particle output files are not ported either.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from iamr_tpu_torch.ns.advance import make_step, make_step_with_particles
from iamr_tpu_torch.ns.state import NSConfig, NSState
from iamr_tpu_torch.solvers.spectral import spectral_eligible


def steady_norm(prev: NSState, new: NSState):
    """max over cells of | ||U^{n+1}||_2 - ||U^n||_2 | (the
    stop_when_steady test, NavierStokesBase::steadyState)."""
    mag_new = torch.sqrt(torch.sum(new.vel * new.vel, dim=0))
    mag_old = torch.sqrt(torch.sum(prev.vel * prev.vel, dim=0))
    return torch.max(torch.abs(mag_new - mag_old))


def run(
    cfg: NSConfig,
    state: NSState,
    max_steps: Optional[int] = None,
    callback: Optional[Callable[[int, NSState], None]] = None,
    verbose: bool = False,
    particles=None,
):
    """Advance `state` until max_step / stop_time / steady state. Returns
    the final state, or (state, particles) when particles are given (they
    advect with each step's MAC velocities)."""
    if cfg.debug:
        raise NotImplementedError("ns.debug checks are not ported")
    sp = spectral_eligible(cfg, state.rho)
    if particles is not None:
        pstep_fn = make_step_with_particles(cfg, spectral=sp)
    else:
        step_fn = make_step(cfg, spectral=sp)

    nmax = max_steps if max_steps is not None else (
        cfg.max_step if cfg.max_step >= 0 else 10**9
    )
    step = 0
    while step < nmax:
        if cfg.stop_time >= 0.0 and float(state.time) >= cfg.stop_time:
            break
        if cfg.stop_time >= 0.0:
            # clip dt to hit stop_time exactly
            state = state._replace(dt=torch.minimum(state.dt, cfg.stop_time - state.time))
        prev = state
        if particles is not None:
            state, particles = pstep_fn(state, particles)
        else:
            state = step_fn(state)
        step += 1
        if verbose:
            print(
                f"STEP {step} time {float(state.time):.6g} dt {float(state.dt):.6g} "
                f"max|u| {float(torch.max(torch.abs(state.vel))):.6g}"
            )
        if callback is not None:
            callback(step, state)
        if cfg.stop_when_steady and float(steady_norm(prev, state)) < cfg.steady_tol:
            if verbose:
                print(f"steady state reached at step {step}")
            break
        if cfg.dt_cutoff > 0.0 and float(state.dt) <= cfg.dt_cutoff:
            raise RuntimeError(
                f"dt {float(state.dt):.3e} fell below ns.dt_cutoff "
                f"{cfg.dt_cutoff:.3e} at step {step}"
            )
    if particles is not None:
        return state, particles
    return state
