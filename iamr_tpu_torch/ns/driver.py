"""Single-level initialisation and time loop (counterpart of
iamr_tpu/ns/driver.py::initialize and ::run).

initialize: initial conditions, the initial velocity projection (nodal
multigrid, init_vel_iter times), the first dt (init_dt, or init_shrink times
the CFL estimate) and init_iter pressure iterations. The hydrostatic initial
pressure of gravity runs, EB and RZ raise NotImplementedError. Plotfiles,
checkpoints (and with them restarts), ns.debug checks and particle output
files are not ported.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from iamr_tpu_torch.ns.advance import (
    advance,
    est_time_step,
    make_hit_forcing,
    make_step,
    make_step_with_particles,
)
from iamr_tpu_torch.ns.probs import init_state
from iamr_tpu_torch.ns.state import NSConfig, NSState
from iamr_tpu_torch.solvers.nodal_proj import initial_velocity_project
from iamr_tpu_torch.solvers.spectral import spectral_eligible


def initialize(cfg: NSConfig, fixed_mg_cycles=None, device=None,
               init_iters: Optional[int] = None) -> NSState:
    """The initial state on `device` (default: the card, cuda:0): ICs, the
    initial velocity projection, the first dt and the initial pressure
    iterations (each advances a trial step from the IC and keeps its p and
    Gp). init_iters overrides cfg.init_iter. The solves are multigrid, to
    the config's tolerances or with fixed_mg_cycles V-cycles, as in the JAX
    package."""
    if abs(cfg.gravity) > 1e-4:
        raise NotImplementedError("the hydrostatic initial pressure (gravity) is not ported")
    if cfg.geom.coord_sys != 0:
        raise NotImplementedError("RZ is not ported")
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    n_init_iter = cfg.init_iter if init_iters is None else init_iters
    state = init_state(cfg, device)
    if cfg.do_init_proj and cfg.init_vel_iter > 0:
        # unit sigma unless proj.rho_wgt_vel_proj (the reference's default)
        sig = state.rho if cfg.rho_wgt_vel_proj else torch.ones_like(state.rho)
        vel = state.vel
        for _ in range(cfg.init_vel_iter):
            vel, _ = initial_velocity_project(
                vel, sig, cfg.dom, cfg.geom.dx, rtol=cfg.proj_tol, atol=cfg.proj_abs_tol,
                fixed_cycles=fixed_mg_cycles,
            )
        state = state._replace(vel=vel)
    if cfg.init_dt > 0.0:
        dt0 = torch.full((), cfg.init_dt, dtype=cfg.tdtype, device=device)
    else:
        dt0 = cfg.init_shrink * est_time_step(cfg, state)
    state = state._replace(dt=dt0)
    hit = make_hit_forcing(cfg)
    for _ in range(max(0, n_init_iter)):
        trial = advance(state, cfg, fixed_mg_cycles, hit=hit)
        state = state._replace(p=trial.p, gradp=trial.gradp)
    return state


def steady_norm(prev: NSState, new: NSState):
    """max over cells of | ||U^{n+1}||_2 - ||U^n||_2 | (the
    stop_when_steady test, NavierStokesBase::steadyState)."""
    mag_new = torch.sqrt(torch.sum(new.vel * new.vel, dim=0))
    mag_old = torch.sqrt(torch.sum(prev.vel * prev.vel, dim=0))
    return torch.max(torch.abs(mag_new - mag_old))


def run(
    cfg: NSConfig,
    state: Optional[NSState] = None,
    max_steps: Optional[int] = None,
    callback: Optional[Callable[[int, NSState], None]] = None,
    verbose: bool = False,
    fixed_mg_cycles=None,
    particles=None,
    device=None,
):
    """Advance until max_step / stop_time / steady state, from `state`, or
    from initialize(cfg, fixed_mg_cycles, device) when it is None. The
    spectral solvers run where spectral_eligible allows (ns.fft_solve),
    the multigrid otherwise. Returns the final state, or (state, particles)
    when particles are given (they advect with each step's MAC
    velocities)."""
    if cfg.debug:
        raise NotImplementedError("ns.debug checks are not ported")
    if state is None:
        state = initialize(cfg, fixed_mg_cycles, device)
    sp = spectral_eligible(cfg, state.rho)
    if particles is not None:
        pstep_fn = make_step_with_particles(cfg, fixed_mg_cycles, spectral=sp)
    else:
        step_fn = make_step(cfg, fixed_mg_cycles, spectral=sp)

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
