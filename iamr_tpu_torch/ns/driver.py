"""Initialisation, time loops and runs from an inputs file (counterpart of
iamr_tpu/ns/driver.py).

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
cells' velocity 0.

AMR on single-box levels: run_multilevel (two levels, amr.max_level = 1:
fixed, or tagged and regridded every amr.regrid_int steps; subcycled or
composite; EB on both levels; particles; checkpoints and restarts) and
run_hierarchy (amr.max_level >= 2, nested patches from amr.regrid_file or
centred ones). A level of more than one box raises NotImplementedError
(multi-box (union) levels are not ported): a multi-box amr.regrid_file
level, a subcycled non-EB regrid whose clustering gives several boxes, and
the dynamic regrid of amr.max_level >= 2.
"""

from __future__ import annotations

import functools
import os
import subprocess
import time as _time
from typing import Callable, Optional

import numpy as np
import torch

from iamr_tpu_torch.amr.hierarchy import LevelSpec, read_fixed_grids
from iamr_tpu_torch.amr.multilevel import (
    MLState,
    advance_hierarchy_subcycled,
    hierarchy_configs,
    init_fine_from_coarse,
    make_fine_config,
    make_two_level_step,
    make_two_level_step_with_particles,
    post_init_press_two_level,
)
from iamr_tpu_torch.amr.sync import UNION
from iamr_tpu_torch.amr.tagging import (
    apply_outflow_tag_policy,
    cluster_to_patch,
    cluster_to_patches,
    parse_refinement_indicators,
    regrid_fine_state,
    tag_cells,
)
from iamr_tpu_torch.config.parmparse import ParmParse
from iamr_tpu_torch.eb.geom import build_eb_geometry, eb_from_inputs, psi_from_inputs
from iamr_tpu_torch.io.amrex_chk import write_checkpoint_amrex, write_checkpoint_amrex_levels
from iamr_tpu_torch.io.checkpoint import (
    load_boxlists,
    load_checkpoint,
    load_checkpoint_ml,
    load_particles,
    save_checkpoint,
    save_checkpoint_ml,
    save_particles,
)
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
    advect_with_umac_levels,
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
    the host clock. One level, whatever cfg.max_level says, as the JAX
    package's run: run_multilevel and run_hierarchy run AMR."""
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


def default_fine_spec(cfg: NSConfig) -> LevelSpec:
    """The fine patch of amr.fixed_fine_patch (lo..., size...), or the
    centred patch over the central half of the domain."""
    dim, r = cfg.dim, cfg.ref_ratio
    if cfg.fine_patch and len(cfg.fine_patch) == 2 * dim:
        return LevelSpec(lo=tuple(cfg.fine_patch[:dim]), ncell=tuple(cfg.fine_patch[dim:]),
                         ratio=r)
    n = cfg.geom.ncell
    return LevelSpec(lo=tuple(r * (x // 4) for x in n), ncell=tuple(r * (x // 2) for x in n),
                     ratio=r)


def write_plotfile_for_hierarchy(cfg: NSConfig, spec: LevelSpec, ml: MLState, path: str,
                                 step: int):
    """A two-level AMR plotfile (Level_0 and Level_1)."""
    write_plotfile(path, cfg.geom, _plot_fields(cfg, ml.crse), time=float(ml.crse.time),
                   level_steps=step,
                   fine_levels=[(_plot_fields(make_fine_config(cfg, spec), ml.fine), spec.lo,
                                 spec.ratio)])


def _save_levels(cfg, path, states, specs, step, fmt, boxlists, particles):
    """A multi-level checkpoint in amr.checkpoint_format (npz, the default,
    or amrex), with the particles."""
    if fmt == "amrex":
        write_checkpoint_amrex_levels(path, states, specs, cfg, step)
    else:
        save_checkpoint_ml(path, states, specs, step, boxlists=boxlists)
    if particles is not None:
        save_particles(path, particles)


def _refuse_boxes(boxlist, what: str):
    """NotImplementedError for a level of more than one box."""
    if boxlist is not None and len(boxlist) > 1:
        raise NotImplementedError(f"{what}: {len(boxlist)} boxes on one level; {UNION}")


class HierarchyEB:
    """Each level's EB geometry from one fluid-positive implicit function
    (the reference builds EB2 per level): level0, and fine(spec), built
    again when a regrid moves the patch."""

    def __init__(self, psi, cfg: NSConfig, device):
        self.psi, self.cfg, self.device = psi, cfg, device
        self.level0 = build_eb_geometry(psi, cfg.geom, dtype=cfg.dtype, device=device)
        self._fine = {}

    def fine(self, spec: LevelSpec):
        if spec not in self._fine:
            self._fine.clear()
            self._fine[spec] = build_eb_geometry(self.psi, make_fine_config(self.cfg, spec).geom,
                                                 dtype=self.cfg.dtype, device=self.device)
        return self._fine[spec]


def fine_spec_from_tags(cfg: NSConfig, crse: NSState, error_tags=None, ebs=None,
                        subcycle: bool = False):
    """(the fine LevelSpec, its box list or None) from the coarse level's
    tags (a host read): error_tags, and with EB (ebs, a HierarchyEB) and
    refine_cutcells every cut cell, after the outflow tag policy, clustered
    by Berger-Rigoutsos. Several boxes make a union level in a subcycled
    run without EB (the box list, their bounding box as the spec), and
    their bounding box otherwise; without tags, the default patch."""
    tags = None
    if error_tags:
        tags = tag_cells(cfg, crse, error_tags).cpu().numpy()
    if ebs is not None and cfg.refine_cutcells:
        vf = ebs.level0.vfrac.cpu().numpy()
        cut = (vf > 0.0) & (vf < 1.0)
        tags = cut if tags is None else (tags | cut)
    if tags is not None:
        tags = apply_outflow_tag_policy(cfg, tags, do_refine=cfg.do_refine_outflow,
                                        do_derefine=cfg.do_derefine_outflow,
                                        nbuf=cfg.nbuf_outflow)
        boxes = cluster_to_patches(tags, cfg.ref_ratio)
        if len(boxes) > 1 and ebs is None and subcycle:
            lo = tuple(min(b.lo[d] for b in boxes) for d in range(cfg.dim))
            hi = tuple(max(b.lo[d] + b.ncell[d] for b in boxes) for d in range(cfg.dim))
            return LevelSpec(lo=lo, ncell=tuple(h - l for l, h in zip(lo, hi)),
                             ratio=cfg.ref_ratio), tuple(boxes)
        s = boxes[0] if len(boxes) == 1 else cluster_to_patch(tags, cfg.ref_ratio)
        if s is not None:
            return s, None
    return default_fine_spec(cfg), None


def initialize_multilevel(cfg: NSConfig, fixed_mg_cycles=None, device=None, error_tags=None,
                          subcycle: bool = False, fixed_spec=None, ebs=None):
    """A fresh two-level start on `device` (default the card, cuda:0):
    initialize without pressure iterations, the fine patch (fixed_spec, or
    fine_spec_from_tags; a union level raises NotImplementedError), the
    fine state interpolated from the coarse one, then the composite
    initial pressure iterations (post_init_press_two_level); with EB (ebs,
    a HierarchyEB) the single-level ones instead, the fine velocity zero in
    covered cells. Returns (MLState, spec)."""
    device = CUDA if device is None else torch.device(device)
    eb0 = ebs.level0 if ebs is not None else None
    crse = initialize(cfg, fixed_mg_cycles, device, init_iters=None if eb0 is not None else 0,
                      eb=eb0)
    spec, boxlist = ((fixed_spec, None) if fixed_spec is not None
                     else fine_spec_from_tags(cfg, crse, error_tags, ebs, subcycle))
    _refuse_boxes(boxlist, "amr.refinement_indicators (a subcycled regrid)")
    fine = init_fine_from_coarse(cfg, spec, crse)
    if eb0 is not None:
        fine = fine._replace(vel=fine.vel * ebs.fine(spec).fluid)
    else:
        crse, fine = post_init_press_two_level(cfg, spec, crse, fine, fixed_mg_cycles)
    return MLState(crse=crse, fine=fine), spec


def regrid_two_level(cfg: NSConfig, ml: MLState, spec: LevelSpec, error_tags, ebs=None,
                     subcycle: bool = False):
    """Tag the coarse level again (a host read) and move the fine state onto
    the new patch where it changed (regrid_fine_state). Returns (MLState,
    spec); a union level raises NotImplementedError."""
    new_spec, new_bl = fine_spec_from_tags(cfg, ml.crse, error_tags, ebs, subcycle)
    _refuse_boxes(new_bl, "amr.refinement_indicators (a subcycled regrid)")
    if new_spec == spec:
        return ml, spec
    return MLState(crse=ml.crse, fine=regrid_fine_state(cfg, spec, new_spec, ml.crse, ml.fine)), \
        new_spec


def run_multilevel(
    cfg: NSConfig,
    max_steps: Optional[int] = None,
    verbose: bool = False,
    fixed_mg_cycles=None,
    subcycle: bool = False,
    error_tags=None,
    regrid_int: int = 0,
    plot_int: int = -1,
    plot_file: str = "plt",
    fixed_spec=None,
    particles=None,
    particle_hooks=None,
    check_int: int = -1,
    check_file: str = "chk",
    restart=None,
    eb_psi=None,
    particle_out=None,
    device=None,
    checkpoint_format: str = "npz",
):
    """A two-level run (amr.max_level = 1) on `device` (default the card,
    cuda:0), subcycled or composite.

    A fresh start is initialize_multilevel's: the fine patch fixed_spec
    (amr.regrid_file), else from the tags (fine_spec_from_tags). With
    error_tags the patch is tagged again every regrid_int steps
    (regrid_two_level). eb_psi: the fluid-positive implicit function each
    level builds its EB geometry from (HierarchyEB); the levels then
    subcycle. Particles advect with the composite MAC velocities.
    Plotfiles every plot_int steps; checkpoints every check_int steps in
    checkpoint_format (npz or amrex; the JAX package writes npz whatever
    the format); restart: a checkpoint of either format (its grids are
    kept). Returns the MLState, or (MLState, particles)."""
    device = CUDA if device is None else torch.device(device)
    ebs = HierarchyEB(eb_psi, cfg, device) if eb_psi is not None else None
    step0 = 0
    boxlist = None
    if restart is not None:
        states_r, specs_r, step0 = load_checkpoint_ml(str(restart), cfg, device)
        if specs_r and (fixed_spec is not None or not error_tags):
            # a fixed-grid run keeps the restored patch; a tagged one tags
            # again at its regrid cadence
            fixed_spec = specs_r[0]
        if particles is not None:
            particles = load_particles(str(restart), cfg.tdtype, device) or particles
    if restart is not None and len(states_r) > 1:
        # resume on the checkpointed grids
        bl_r = load_boxlists(str(restart))
        boxlist = tuple(bl_r[0]) if bl_r is not None and bl_r[0] else None
        _refuse_boxes(boxlist, f"amr.restart={restart}")
        ml, spec = MLState(crse=states_r[0], fine=states_r[1]), specs_r[0]
    elif restart is not None:
        # a single-level checkpoint: the fine level interpolated from it
        crse = states_r[0]
        spec, boxlist = ((fixed_spec, None) if fixed_spec is not None
                         else fine_spec_from_tags(cfg, crse, error_tags, ebs, subcycle))
        _refuse_boxes(boxlist, "amr.refinement_indicators (a subcycled regrid)")
        fine = init_fine_from_coarse(cfg, spec, crse)
        if ebs is not None:
            fine = fine._replace(vel=fine.vel * ebs.fine(spec).fluid)
        else:
            crse, fine = post_init_press_two_level(cfg, spec, crse, fine, fixed_mg_cycles)
        ml = MLState(crse=crse, fine=fine)
    else:
        ml, spec = initialize_multilevel(cfg, fixed_mg_cycles, device, error_tags, subcycle,
                                         fixed_spec, ebs)
    step_cache = {}

    def get_step(s):
        if s not in step_cache:
            if particles is not None:
                if ebs is not None:
                    raise NotImplementedError("EB + particles multilevel not wired "
                                              "(as in the JAX package)")
                step_cache[s] = make_two_level_step_with_particles(cfg, s, fixed_mg_cycles,
                                                                   subcycle=subcycle)
            else:
                step_cache[s] = make_two_level_step(
                    cfg, s, fixed_mg_cycles, subcycle=subcycle,
                    ebs=[ebs.level0, ebs.fine(s)] if ebs is not None else None)
        return step_cache[s]

    nmax = max_steps if max_steps is not None else (
        cfg.max_step if cfg.max_step >= 0 else 10**9)
    step = step0
    while step < nmax:
        if cfg.stop_time >= 0.0 and float(ml.crse.time) >= cfg.stop_time:
            break
        if (error_tags and regrid_int > 0 and step > 0 and step % regrid_int == 0
                and fixed_spec is None):
            ml, new_spec = regrid_two_level(cfg, ml, spec, error_tags, ebs, subcycle)
            if new_spec != spec:
                spec = new_spec
                if verbose:
                    print(f"REGRID at step {step}: patch lo={spec.lo} n={spec.ncell} boxes=1")
        t0 = _time.perf_counter()
        if particles is not None:
            ml, particles = get_step(spec)(ml, particles)
            if particle_hooks is not None:
                particle_hooks(step + 1, ml.crse, particles)
        else:
            ml = get_step(spec)(ml)
        step += 1
        if plot_int > 0 and step % plot_int == 0:
            write_plotfile_for_hierarchy(cfg, spec, ml, f"{plot_file}{step:05d}", step)
        if check_int > 0 and step % check_int == 0:
            _save_levels(cfg, f"{check_file}{step:05d}", [ml.crse, ml.fine], [spec], step,
                         checkpoint_format, [boxlist], particles)
        if verbose:
            t, dt, u0, u1 = torch.stack([
                ml.crse.time, ml.crse.dt, torch.max(torch.abs(ml.crse.vel)),
                torch.max(torch.abs(ml.fine.vel))]).tolist()
            print(f"STEP {step} time {t:.6g} dt {dt:.6g} max|u| L0 {u0:.6g} L1 {u1:.6g} "
                  f"wall {_time.perf_counter() - t0:.6f} s")
    if particles is not None:
        if particle_out:
            write_ascii_particles(str(particle_out), particles)
        return ml, particles
    return ml


def run_hierarchy(
    cfg: NSConfig,
    max_steps: Optional[int] = None,
    verbose: bool = False,
    fixed_mg_cycles=None,
    specs=None,
    particles=None,
    particle_hooks=None,
    check_int: int = -1,
    check_file: str = "chk",
    restart=None,
    error_tags=None,
    regrid_int: int = 0,
    particle_out=None,
    boxlists=None,
    device=None,
    checkpoint_format: str = "npz",
):
    """A subcycled hierarchy of any depth (amr.max_level >= 2) of nested
    single-box patches, on `device` (default the card, cuda:0): `specs`
    (amr.regrid_file), else centred ones (each over the central half of its
    parent). The levels start from initialize and the coarse state
    interpolated down. Particles advect with the composite MAC velocities.
    Checkpoints every check_int steps (npz or amrex); restart from one.
    Returns the states, or (states, particles).

    boxlists with a level of more than one box, and error_tags with
    regrid_int > 0 (the dynamic regrid of a hierarchy, regrid_hierarchy,
    makes multi-box levels), raise NotImplementedError: multi-box (union)
    levels are not ported."""
    device = CUDA if device is None else torch.device(device)
    if error_tags and regrid_int > 0:
        raise NotImplementedError(
            f"amr.max_level = {cfg.max_level} with amr.regrid_int = {regrid_int}: the dynamic "
            f"regrid of a hierarchy (regrid_hierarchy) makes multi-box levels; {UNION}")
    for k, bl in enumerate(boxlists or []):
        _refuse_boxes(bl, f"level {k + 1}")
    r = cfg.ref_ratio
    step0 = 0
    if restart is not None:
        states_r, specs, step0 = load_checkpoint_ml(str(restart), cfg, device)
        boxlists = load_boxlists(str(restart)) or boxlists
        states = tuple(states_r)
        if particles is not None:
            particles = load_particles(str(restart), cfg.tdtype, device) or particles
    else:
        if specs is None:
            specs = []
            for lev in range(cfg.max_level):
                n = cfg.geom.ncell if lev == 0 else specs[-1].ncell
                specs.append(LevelSpec(lo=tuple(r * (x // 4) for x in n),
                                       ncell=tuple(r * (x // 2) for x in n), ratio=r))
        states = [initialize(cfg, fixed_mg_cycles, device)]
        cfgs = hierarchy_configs(cfg, specs)
        for lev, spec in enumerate(specs):
            states.append(init_fine_from_coarse(cfgs[lev], spec, states[-1]))
        states = tuple(states)
    for k, bl in enumerate(boxlists or []):
        _refuse_boxes(bl, f"amr.restart={restart}: level {k + 1}")
    cfgs = hierarchy_configs(cfg, specs)
    hit = make_hit_forcing(cfg)

    if particles is not None:
        def step_fn(sts, parts):
            out, umacs = advance_hierarchy_subcycled(sts, cfg, list(specs), fixed_mg_cycles,
                                                     hit=hit, return_umacs=True)
            levels = [(um, c.geom) for um, c in zip(umacs, cfgs)]
            return out, advect_with_umac_levels(parts, levels, sts[0].dt)
    else:
        def step_fn(sts):
            return advance_hierarchy_subcycled(sts, cfg, list(specs), fixed_mg_cycles, hit=hit)

    nmax = max_steps if max_steps is not None else (
        cfg.max_step if cfg.max_step >= 0 else 10**9)
    step = step0
    while step < nmax:
        if cfg.stop_time >= 0.0 and float(states[0].time) >= cfg.stop_time:
            break
        t0 = _time.perf_counter()
        if particles is not None:
            states, particles = step_fn(states, particles)
            if particle_hooks is not None:
                particle_hooks(step + 1, states[0], particles)
        else:
            states = step_fn(states)
        step += 1
        if check_int > 0 and step % check_int == 0:
            _save_levels(cfg, f"{check_file}{step:05d}", list(states), list(specs), step,
                         checkpoint_format, boxlists, particles)
        if verbose:
            t, dt = torch.stack([states[0].time, states[0].dt]).tolist()
            print(f"STEP {step} time {t:.6g} dt {dt:.6g} levels {len(states)} "
                  f"wall {_time.perf_counter() - t0:.6f} s")
    if particles is not None:
        if particle_out:
            write_ascii_particles(str(particle_out), particles)
        return states, particles
    return states


def _specs_from_grids(cfg: NSConfig, grids):
    """(LevelSpecs, box lists) from amr.regrid_file's per-level boxes (each
    in the coarser level's index space): specs[k] is level k + 1's bounding
    box (lo relative to the parent patch, fine index units) and
    boxlists[k] its boxes in the same units (None for a one-box level)."""
    r = cfg.ref_ratio
    dim = cfg.dim
    out, blists = [], []
    parent_lo = (0,) * dim
    for lev_boxes in grids:
        lo = tuple(min(b[0][d] for b in lev_boxes) for d in range(dim))
        hi = tuple(max(b[1][d] for b in lev_boxes) for d in range(dim))
        out.append(LevelSpec(lo=tuple(r * (lo[d] - parent_lo[d]) for d in range(dim)),
                             ncell=tuple(r * (hi[d] - lo[d]) for d in range(dim)), ratio=r))
        if len(lev_boxes) > 1:
            blists.append(tuple(
                LevelSpec(lo=tuple(r * (b[0][d] - parent_lo[d]) for d in range(dim)),
                          ncell=tuple(r * (b[1][d] - b[0][d]) for d in range(dim)), ratio=r)
                for b in lev_boxes))
        else:
            blists.append(None)
        parent_lo = tuple(r * x for x in lo)
    return out, blists


def _refuse_unported(pp: ParmParse, cfg: NSConfig, fixed_grids):
    """NotImplementedError, naming the key, for inputs that make a level of
    more than one box: an amr.regrid_file level of several boxes, and the
    dynamic regrid of amr.max_level >= 2 (amr.refinement_indicators with
    amr.regrid_int > 0)."""
    for k, grids in enumerate(fixed_grids or []):
        if len(grids) > 1:
            raise NotImplementedError(
                f"amr.regrid_file: level {k + 1} has {len(grids)} boxes; {UNION}")
    regrid_int = int(pp.scoped("amr").queryarr("regrid_int", [0])[0])
    if (cfg.max_level >= 2 and not fixed_grids and regrid_int > 0
            and parse_refinement_indicators(pp)):
        raise NotImplementedError(
            f"amr.max_level = {cfg.max_level} with amr.regrid_int = {regrid_int}: the dynamic "
            f"regrid of a hierarchy makes multi-box levels; {UNION}")


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
    Returns what run returns.

    amr.max_level >= 1 runs AMR, as the JAX package's: amr.max_level = 1
    run_multilevel (amr.subcycling_mode None is the composite step, any
    other mode subcycles; amr.refinement_indicators with amr.regrid_int, or
    the grids of amr.regrid_file; EB with eb2.*), amr.max_level >= 2
    run_hierarchy; each with the plotfiles (two levels) and checkpoints of
    amr.plot_int and amr.check_int, the particles, max_steps, verbose and
    fixed_mg_cycles. A level of more than one box raises
    NotImplementedError, naming the key."""
    device = CUDA if device is None else torch.device(device)
    pp = ParmParse.from_file(path, overrides)
    cfg = config_from_inputs(pp, dim_hint=dim_hint_from_path(path), device=device)
    base = os.path.dirname(os.path.abspath(path))
    fixed_grids = None
    rgf = pp.query("amr.regrid_file")
    if rgf:
        fixed_grids = read_fixed_grids(os.path.join(base, str(rgf)), cfg.dim)
    _refuse_unported(pp, cfg, fixed_grids)
    restart = pp.query("amr.restart")
    restart_particles = None
    if restart and cfg.max_level == 0:
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
        fpath = os.path.join(base, str(init_file))
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
    if cfg.max_level == 0:
        return run(cfg, device=device, **kw)
    amr = pp.scoped("amr")
    regrid_int = int(amr.queryarr("regrid_int", [0])[0])
    common = dict(
        max_steps=kw.get("max_steps"), verbose=kw.get("verbose", False),
        fixed_mg_cycles=kw.get("fixed_mg_cycles"), particles=kw.get("particles"),
        particle_hooks=kw.get("particle_hooks"), particle_out=kw.get("particle_out"),
        check_int=hooks.check_int, check_file=hooks.check_file, restart=restart or None,
        regrid_int=regrid_int, device=device, checkpoint_format=hooks.checkpoint_format)
    specs = _specs_from_grids(cfg, fixed_grids)[0] if fixed_grids else None
    if cfg.max_level >= 2:
        return run_hierarchy(
            cfg, specs=specs,
            error_tags=None if fixed_grids else (parse_refinement_indicators(pp) or None),
            **common)
    return run_multilevel(
        cfg, subcycle=str(amr.query("subcycling_mode", "Auto")).lower() != "none",
        error_tags=parse_refinement_indicators(pp) or None, plot_int=hooks.plot_int,
        plot_file=hooks.plot_file, fixed_spec=specs[0] if specs else None,
        eb_psi=psi_from_inputs(pp, cfg.dim) if eb is not None else None, **common)
