"""Single-level initialisation, time loop and run from an inputs file
(counterpart of iamr_tpu/ns/driver.py).

initialize: initial conditions, the initial velocity projection (nodal
multigrid, init_vel_iter times), the hydrostatic initial pressure of gravity
runs, the first dt (init_dt, or init_shrink times the CFL estimate) and
init_iter pressure iterations. run: the time loop, with the per-step
self-checks of ns.debug (ns/checks.py), tracer particles, restarts from a
step and a per-step callback. run_from_inputs: the reference's executable
(main.cpp) on one inputs file: restarts from either checkpoint format,
particles.*, and IOHooks' plotfiles, checkpoints, monitors and run logs.
RZ runs project with radius weights and start without the hydrostatic
pressure, as in the JAX package; EB runs (eb2.geom_type, the geometry of
eb/geom.py) project with volume-fraction weights and keep the covered
cells' velocity 0. AMR (amr.max_level >= 1, amr.regrid_file) raises
NotImplementedError.
"""

from __future__ import annotations

import functools
import os
import subprocess
import time as _time
from typing import Callable, Optional

import numpy as np
import torch

from iamr_tpu_torch.config.parmparse import ParmParse
from iamr_tpu_torch.eb.geom import eb_from_inputs
from iamr_tpu_torch.io.amrex_chk import write_checkpoint_amrex
from iamr_tpu_torch.io.checkpoint import load_checkpoint, load_particles, save_checkpoint, save_particles
from iamr_tpu_torch.io.plotfile import write_plotfile
from iamr_tpu_torch.ns.advance import (
    advance,
    est_time_step,
    make_hit_forcing,
    make_step,
    make_step_with_particles,
    redist_geometry,
    rz_radii,
)
from iamr_tpu_torch.ns.checks import check_finite, run_debug_checks
from iamr_tpu_torch.ns.derive import (
    avg_pressure,
    derive,
    kinetic_energy,
    mag_vort,
    sum_integrated_quantities,
)
from iamr_tpu_torch.ns.particles import (
    from_positions,
    particle_count,
    read_ascii_init_file,
    timestamp,
    write_ascii_particles,
)
from iamr_tpu_torch.ns.probs import init_state
from iamr_tpu_torch.ns.state import NSConfig, NSState, config_from_inputs, dim_hint_from_path
from iamr_tpu_torch.solvers.nodal_proj import initial_pressure_project, initial_velocity_project
from iamr_tpu_torch.solvers.spectral import spectral_eligible

CUDA = torch.device("cuda", 0)
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def initialize(cfg: NSConfig, fixed_mg_cycles=None, device=None,
               init_iters: Optional[int] = None, eb=None) -> NSState:
    """The initial state on `device` (default: the card, cuda:0): ICs, the
    initial velocity projection, the first dt and the initial pressure
    iterations (each advances a trial step from the IC and keeps its p and
    Gp). init_iters overrides cfg.init_iter. The solves are multigrid, to
    the config's tolerances or with fixed_mg_cycles V-cycles, as in the JAX
    package. Gravity runs start from the hydrostatic pressure, but in RZ,
    whose initial projection is radius-weighted. eb: the level's EBData on
    `device`; the covered cells' velocity starts at 0 and the projections
    are the EB ones."""
    device = CUDA if device is None else torch.device(device)
    n_init_iter = cfg.init_iter if init_iters is None else init_iters
    state = init_state(cfg, device)
    if eb is not None:
        # covered cells carry the body state from the start
        state = state._replace(vel=state.vel * eb.fluid)
    rz = rz_radii(cfg, cfg.tdtype, device)
    if cfg.do_temp and cfg.temp_cond_coef > 0.0:
        # d(divu)/dt starts at zero
        state = state._replace(dsdt=torch.zeros_like(state.rho))
    if cfg.do_init_proj and cfg.init_vel_iter > 0:
        # unit sigma unless proj.rho_wgt_vel_proj (the reference's default)
        sig = state.rho if cfg.rho_wgt_vel_proj else torch.ones_like(state.rho)
        vel = state.vel
        for _ in range(cfg.init_vel_iter):
            vel, _ = initial_velocity_project(
                vel, sig, cfg.dom, cfg.geom.dx, rtol=cfg.proj_tol, atol=cfg.proj_abs_tol,
                fixed_cycles=fixed_mg_cycles, rz=rz, eb=eb,
            )
        state = state._replace(vel=vel)
    if abs(cfg.gravity) > 1e-4 and rz is None:
        p0, gp0 = initial_pressure_project(
            state.rho, cfg.gravity, cfg.dom, cfg.geom.dx, geom=cfg.geom, rtol=cfg.proj_tol,
            atol=cfg.proj_abs_tol, fixed_cycles=fixed_mg_cycles, eb=eb,
        )
        state = state._replace(p=p0, gradp=gp0)
    if cfg.init_dt > 0.0:
        dt0 = torch.full((), cfg.init_dt, dtype=cfg.tdtype, device=device)
    else:
        dt0 = cfg.init_shrink * est_time_step(cfg, state)
    state = state._replace(dt=dt0)
    hit, rg = make_hit_forcing(cfg), redist_geometry(cfg, eb)
    for _ in range(max(0, n_init_iter)):
        trial = advance(state, cfg, fixed_mg_cycles, hit=hit, eb=eb, eb_redist=rg)
        state = state._replace(p=trial.p, gradp=trial.gradp)
    return state


def steady_norm(prev: NSState, new: NSState):
    """max over cells of | ||U^{n+1}||_2 - ||U^n||_2 | (the
    stop_when_steady test, NavierStokesBase::steadyState)."""
    mag_new = torch.sqrt(torch.sum(new.vel * new.vel, dim=0))
    mag_old = torch.sqrt(torch.sum(prev.vel * prev.vel, dim=0))
    return torch.max(torch.abs(mag_new - mag_old))


def _host64(t):
    """A tensor as a float64 numpy array laid out in Fortran order (cast and
    transposed on its device), which the FAB writer writes as it is."""
    rev = tuple(range(t.ndim - 1, -1, -1))
    out = torch.empty(tuple(t.shape[d] for d in rev), dtype=torch.float64, device=t.device)
    return out.copy_(t.permute(rev)).cpu().numpy().T


def _plot_fields(cfg: NSConfig, state: NSState, extra=None, derives=None):
    """{name: host array} of a plotfile, in the JAX package's order: extra,
    the velocity, density, tracers, temp (do_temp), avg_pressure, mag_vort,
    energy, then the amr.derive_plot_vars not already there."""
    fields = {}
    if extra:
        fields.update({k: _host64(torch.as_tensor(v)) for k, v in extra.items()})
    for d in range(cfg.dim):
        fields[f"{'xyz'[d]}_velocity"] = _host64(state.vel[d])
    fields["density"] = _host64(state.rho)
    for t in range(state.trac.shape[0]):
        fields["tracer" if t == 0 else f"tracer{t + 1}"] = _host64(state.trac[t])
    if cfg.do_temp:
        fields["temp"] = _host64(state.temp)
    fields["avg_pressure"] = _host64(avg_pressure(state))
    fields["mag_vort"] = _host64(mag_vort(cfg, state))
    fields["energy"] = _host64(kinetic_energy(state))
    for name in derives or ():
        if name not in fields:
            fields[name] = _host64(derive(cfg, state, name))
    return fields


def write_plotfile_for_state(cfg: NSConfig, state: NSState, path: str, step: int,
                             extra=None, derives=None):
    """The state and its derived fields as an AMReX plotfile (writePlotFile;
    amr.derive_plot_vars). extra: more name -> cell arrays (the
    particle_count and the velocity time average and RMS)."""
    write_plotfile(path, cfg.geom, _plot_fields(cfg, state, extra, derives),
                   time=float(state.time), level_steps=step)


@functools.cache
def _provenance(device: torch.device):
    """The git hash, torch and CUDA versions and, on a card, its name and
    power limit, once per process."""
    try:
        rev = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True, text=True,
                             cwd=REPO, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        rev = ""
    lines = [f"iamr_tpu_torch git hash: {rev or 'unknown'}",
             f"torch version: {torch.__version__}",
             f"CUDA version: {torch.version.cuda}",
             f"device: {device}"]
    if device.type == "cuda":
        index = torch.cuda.current_device() if device.index is None else device.index
        try:
            limit = subprocess.run(
                ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
            ).stdout.strip() or "unknown"
        except (OSError, subprocess.TimeoutExpired):
            limit = "unknown"
        lines += [f"card: {torch.cuda.get_device_name(index)}", f"power limit: {limit}"]
    return lines


def write_job_info(cfg: NSConfig, path: str, pp=None, device=None):
    """The job_info provenance file of a plotfile (NavierStokes.cpp:1107-1194):
    the code, the device and the inputs."""
    os.makedirs(path, exist_ok=True)
    device = CUDA if device is None else torch.device(device)
    lines = ["==== iamr_tpu_torch job_info ====", "", *_provenance(device), "",
             "==== inputs ===="]
    if pp is not None:
        lines.append(pp.dump())
    with open(os.path.join(path, "job_info"), "w") as f:
        f.write("\n".join(lines) + "\n")


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


class IOHooks:
    """The per-step output of a run from an inputs file, as run's
    callback: plotfiles every amr.plot_int steps (with amr.derive_plot_vars,
    the particle_count of tracer particles and the ns.avg_interval velocity
    average and RMS), checkpoints every amr.check_int steps
    (amr.checkpoint_format npz or amrex, with the particles and the
    averages' sums), the monitors of ns.sum_interval, the amr.run_log and
    amr.run_log_terse lines, the ns.dump_plane slices and the
    ns.debug_nans scan. The running averages stay on the state's device
    until a write. With verbose, each write prints its size and seconds."""

    def __init__(self, cfg: NSConfig, pp=None, verbose: bool = False):
        self.cfg = cfg
        self.pp = pp
        self.verbose = verbose
        table = pp if pp is not None else ParmParse.from_string("")
        amr, ns = table.scoped("amr"), table.scoped("ns")
        self.plot_int = int(amr.query("plot_int", -1))
        self.plot_file = str(amr.query("plot_file", "plt"))
        self.derive_plot_vars = tuple(
            str(v) for v in amr.queryarr("derive_plot_vars", []) if str(v).upper() != "NONE")
        self.check_int = int(amr.query("check_int", -1))
        self.check_file = str(amr.query("check_file", "chk"))
        # npz (the default) or amrex (the reference's chk layout); restarts
        # detect the format
        self.checkpoint_format = str(amr.query("checkpoint_format", "npz"))
        self.sum_interval = int(ns.query("sum_interval", -1))
        self.run_log = str(amr.query("run_log", ""))
        self.run_log_terse = str(amr.query("run_log_terse", ""))
        # the velocity time average and RMS every ns.avg_interval steps
        # (NS_average.cpp): sums of 0.5(u^n + u^{n+1}) dt and of its square
        # times dt, and the averaging time
        self.avg_interval = int(ns.query("avg_interval", 0))
        self._avg = None
        self._prev_vel = None
        # the x-y plane of cell index ns.dump_plane, each step
        self.dump_plane = int(ns.query("dump_plane", -1))
        self.dump_plane_name = str(ns.query("dump_plane_name", "SLABS/vel-"))
        self.debug_nans = bool(int(ns.query("debug_nans", 0)))
        # set by run each step when tracer particles are on
        self.particles = None

    @property
    def active(self) -> bool:
        """Whether a run needs these hooks at all (the JAX package installs
        them for plotfiles, checkpoints and monitors)."""
        return (self.plot_int > 0 or self.check_int > 0 or self.sum_interval > 0
                or self.debug_nans)

    def time_average(self):
        """(velocity average, velocity RMS, averaging time) as tensors, or
        None before the first averaged step."""
        if self._avg is None or float(self._avg[2]) <= 0.0:
            return None
        s1, s2, t = self._avg
        avg = s1 / t
        return avg, torch.sqrt(torch.clamp(s2 / t - avg * avg, min=0.0)), t

    def _timed(self, what, path, write):
        t0 = _time.perf_counter()
        write()
        if self.verbose:
            print(f"WROTE {what} {path}: {_dir_bytes(path)} bytes in "
                  f"{_time.perf_counter() - t0:.4f} s")

    def __call__(self, step: int, state: NSState):
        cfg = self.cfg
        if self.debug_nans:
            check_finite(state, step)
        if self.avg_interval > 0:
            v = state.vel
            if self._avg is None:
                self._avg = (torch.zeros_like(v), torch.zeros_like(v), torch.zeros_like(state.dt))
                self._prev_vel = v
            if step % self.avg_interval == 0:
                s1, s2, t = self._avg
                vm = 0.5 * (self._prev_vel + v)
                self._avg = (s1 + vm * state.dt, s2 + vm * vm * state.dt, t + state.dt)
            self._prev_vel = v
        if self.plot_int > 0 and step % self.plot_int == 0:
            path = f"{self.plot_file}{step:05d}"
            extra = {}
            if self.particles is not None:
                extra["particle_count"] = particle_count(self.particles, cfg.geom)
            avg = self.time_average()
            if avg is not None:
                for d in range(cfg.dim):
                    extra[f"{'xyz'[d]}_vel_average"] = avg[0][d]
                    extra[f"{'xyz'[d]}_vel_rms"] = avg[1][d]

            def plot():
                write_plotfile_for_state(cfg, state, path, step, extra=extra,
                                         derives=self.derive_plot_vars)
                write_job_info(cfg, path, self.pp, state.rho.device)

            self._timed("plotfile", path, plot)
        if self.check_int > 0 and step % self.check_int == 0:
            path = f"{self.check_file}{step:05d}"

            def check():
                if self.checkpoint_format == "amrex":
                    write_checkpoint_amrex(path, state, cfg, step)
                else:
                    save_checkpoint(path, state, step)
                if self.particles is not None:
                    save_particles(path, self.particles)
                if self._avg is not None:
                    np.savez(os.path.join(path, "TimeAverage.npz"),
                             sum1=self._avg[0].cpu().numpy(), sum2=self._avg[1].cpu().numpy(),
                             time=float(self._avg[2]))

            self._timed(f"{self.checkpoint_format} checkpoint", path, check)
        monitor = self.sum_interval > 0 and step % self.sum_interval == 0
        if monitor or self.run_log or self.run_log_terse:
            t, dt = torch.stack([state.time, state.dt]).tolist()
        if monitor:
            q = sum_integrated_quantities(cfg, state)
            print(f"TIME= {t:.8g} MASS= {q['mass']:.12g} "
                  f"TRAC= {q.get('tracer0', 0.0):.12g} KENG= {q['kinetic_energy']:.12g}")
        if self.run_log or self.run_log_terse:
            if self.run_log:
                with open(self.run_log, "a") as f:
                    f.write(f"STEP = {step} TIME = {t:.10g} DT = {dt:.10g}\n")
            if self.run_log_terse:
                with open(self.run_log_terse, "a") as f:
                    f.write(f"{step} {t:.10g} {dt:.10g}\n")
        if self.dump_plane >= 0:
            os.makedirs(os.path.dirname(self.dump_plane_name) or ".", exist_ok=True)
            k = min(self.dump_plane, state.vel.shape[-1] - 1)
            state.vel[..., k].to(torch.float64).cpu().numpy().tofile(
                f"{self.dump_plane_name}{step:05d}.bin")


def run(
    cfg: NSConfig,
    state: Optional[NSState] = None,
    max_steps: Optional[int] = None,
    callback: Optional[Callable[[int, NSState], None]] = None,
    verbose: bool = False,
    fixed_mg_cycles=None,
    particles=None,
    device=None,
    particle_hooks=None,
    particle_out=None,
    step0: int = 0,
    eb=None,
):
    """Advance from step `step0` (a restart's) until max_step / stop_time /
    steady state, from `state`, or from initialize(cfg, fixed_mg_cycles,
    device, eb=eb) when it is None. eb: the level's EBData, on the state's
    device. The spectral solvers run where spectral_eligible allows
    (ns.fft_solve) and there is no EB, the multigrid otherwise.
    Returns the final state, or (state, particles) when particles are given:
    they advect with each step's MAC velocities, go to
    particle_hooks(step, state, particles) after each step and to the
    callback's `.particles` where it has one, and the live ones are written
    to particle_out at the end. With ns.debug (and no particles) each
    step's state and MAC velocities go through ns/checks.py::run_debug_checks.
    With verbose, each step prints its time, dt, max|u| and its seconds on
    the host clock. One level only: cfg.max_level >= 1 raises."""
    if cfg.max_level >= 1:
        raise NotImplementedError(
            f"amr.max_level = {cfg.max_level}: AMR is not ported (single level only)")
    if state is None:
        state = initialize(cfg, fixed_mg_cycles, device, eb=eb)
    sp = eb is None and spectral_eligible(cfg, state.rho)
    debug = cfg.debug and particles is None
    if particles is not None:
        pstep_fn = make_step_with_particles(cfg, fixed_mg_cycles, spectral=sp, eb=eb)
    elif debug:
        hit, rg = make_hit_forcing(cfg), redist_geometry(cfg, eb)
        step_fn = lambda s: advance(s, cfg, fixed_mg_cycles, hit=hit, return_umac=True,
                                    spectral=sp, eb=eb, eb_redist=rg)
    else:
        step_fn = make_step(cfg, fixed_mg_cycles, spectral=sp, eb=eb)

    nmax = max_steps if max_steps is not None else (
        cfg.max_step if cfg.max_step >= 0 else 10**9
    )
    step = step0
    while step < nmax:
        if cfg.stop_time >= 0.0 and float(state.time) >= cfg.stop_time:
            break
        if cfg.stop_time >= 0.0:
            # clip dt to hit stop_time exactly
            state = state._replace(dt=torch.minimum(state.dt, cfg.stop_time - state.time))
        t0 = _time.perf_counter()
        prev = state
        if particles is not None:
            state, particles = pstep_fn(state, particles)
        elif debug:
            state, umac = step_fn(state)
            run_debug_checks(cfg, state, umac, eb=eb, step=step + 1)
        else:
            state = step_fn(state)
        step += 1
        if particles is not None and particle_hooks is not None:
            particle_hooks(step, state, particles)
        if particles is not None and hasattr(callback, "particles"):
            callback.particles = particles
        if verbose:
            t, dt, umax = torch.stack(
                [state.time, state.dt, torch.max(torch.abs(state.vel))]).tolist()
            print(f"STEP {step} time {t:.6g} dt {dt:.6g} max|u| {umax:.6g} "
                  f"wall {_time.perf_counter() - t0:.6f} s")
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
        if particle_out:
            write_ascii_particles(str(particle_out), particles)
        return state, particles
    return state


def _refuse_unported(pp: ParmParse, cfg: NSConfig):
    """NotImplementedError, naming the key, for the inputs of what is not
    ported: AMR (amr.max_level >= 1, amr.regrid_file)."""
    if cfg.max_level >= 1:
        raise NotImplementedError(
            f"amr.max_level = {cfg.max_level}: AMR is not ported (single level only)")
    if pp.contains("amr.regrid_file"):
        raise NotImplementedError("amr.regrid_file: AMR grids are not ported")


def run_from_inputs(path: str, overrides=(), device=None, **kw):
    """Run one inputs file as the reference's executable does (main.cpp):
    `overrides` are `key=value` strings after the file, as on its command
    line. On `device` (default the card, cuda:0; ns.dtype, else f32 on the
    card and f64 on the CPU). eb2.geom_type builds the EB geometry
    (eb/geom.py::eb_from_inputs; a restart builds it again from the
    inputs). amr.restart names a checkpoint of either format (and its
    particles); particles.particle_init_file,
    timestamp_dir and particle_output_file drive tracer particles;
    IOHooks writes the plotfiles, checkpoints and logs. Other keyword
    arguments go to run (max_steps, verbose, fixed_mg_cycles, callback).
    Returns what run returns."""
    device = CUDA if device is None else torch.device(device)
    pp = ParmParse.from_file(path, overrides)
    cfg = config_from_inputs(pp, dim_hint=dim_hint_from_path(path), device=device)
    _refuse_unported(pp, cfg)
    restart = pp.query("amr.restart")
    restart_particles = None
    if restart:
        kw["state"], kw["step0"] = load_checkpoint(str(restart), cfg, device)
        restart_particles = load_particles(str(restart), cfg.tdtype, device)
    eb = eb_from_inputs(pp, cfg.geom, dtype=cfg.dtype, device=device)
    if eb is not None:
        kw["eb"] = eb
    hooks = IOHooks(cfg, pp, verbose=kw.get("verbose", False))
    if kw.get("callback") is None and hooks.active:
        kw["callback"] = hooks
    ppart = pp.scoped("particles")
    init_file = ppart.query("particle_init_file")
    if init_file and ppart.query_bool("do_nspc", True):
        fpath = os.path.join(os.path.dirname(os.path.abspath(path)), str(init_file))
        pos = read_ascii_init_file(fpath, cfg.dim)
        kw["particles"] = (restart_particles if restart_particles is not None
                           else from_positions(pos, device, cfg.tdtype))
        ts = ppart.query("timestamp_dir")
        if ts:
            os.makedirs(str(ts), exist_ok=True)
            kw["particle_hooks"] = lambda step, state, parts: timestamp(
                parts, os.path.join(str(ts), "Timestamp"), float(state.time))
        pout = ppart.query("particle_output_file")
        if pout:
            kw["particle_out"] = str(pout)
    return run(cfg, device=device, **kw)
