#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (iamr_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. the card: nvidia-smi name and power limit, torch's device name;
  2. build the CUDA kernels from iamr_tpu_torch/csrc (nvcc, sm_90a);
  3. K1 extrap_plm vs its plain PyTorch version: f32 at 128^3 with and
     without force, periodic and edge-filled ghosts (median, outlier
     fraction and max of |kernel - plain| / max|plain|, since a one-ulp
     difference can flip a thresholded upwind pick); f64 at 32^3 to 1e-12;
     then the boxes no tile divides: 80x96x112, 40x24x21, 8^3 and 5x40x70
     (dim 0 shorter than a march segment), periodic, not and Rayleigh-
     Taylor's mix (periodic in x and y only), f32 and (the small ones) f64;
     every case reports whether it is bitwise equal;
  4. K2 godunov_plm_multi vs plain in the same form: nc=5 with the slice's
     per-field flags, nc=1 (K3), nc=6 with the temperature and with rho U
     (do_mom_diff); on the ragged boxes nc = 1, 5 and 6 with mixed force
     rows, and nc = 9 (two chained launches) on 40x24x21;
  5. the slice at full width: forced HIT 256^3 f32 with 65536 tracer
     particles, init_state then dt = 5e-3, one warm-up step and 3 timed
     steps through make_step_with_particles; one wrapper call of K1 and
     one of K2 a step, none of the MG kernels; one profiled step, in which K1 and K2 must
     make one CUDA launch each; divergence diagnostics as bench.py forms
     them; K1/K2 times beside their plain versions' at 256^3, their
     registers, spills and shared memory;
  6. a HIT 32^3 f64 step with particles on the GPU against the same step on
     the CPU (plain path), to 1e-10 relative;
  7. the cell multigrid kernel mg_cell_gsrb vs its plain version: f32 at
     128^3, 80x96x112 and 512^2, periodic / all-Dirichlet / mixed Neumann-Dirichlet
     sides, a != 0 with alpha and a = 0; 2 sweeps plus the residual (K4)
     and one-colour and residual-only launches (K5); f64 at 32^3; then the
     shapes of the kernel's tiles with nsweeps 0 to 4, with and without the
     residual: 16^3 (the smallest smoothed level of the 256^3 path),
     80x96x112 and 130x70 (no tile divides them), 40x24x21 periodic (odd).
     Bound: max|kernel - plain| <= 1e-6 (f32), 1e-12 (f64) of max|plain|,
     for a residual of max|plain| or of its largest term max|diag| max|phi|,
     whichever is larger (its values may be small next to the terms it
     sums, and the kernels sum in another order);
  8. the nodal kernel mg_nodal_jacobi vs its plain version in the same
     form at 129^3, 81x97x113 and 257^2 nodes (f32) and 33^3 (f64), periodic /
     Neumann / Dirichlet (outflow) sides: one sweep and the residual alone
     (K6), 3 sweeps plus the residual with omega, mask and diag formed in
     the kernel (K7) and with caller-given upd and mask arrays (K8); then
     nsweeps 0 to 4 at 17^3 (the smallest smoothed level), 81x97x113,
     41x25x22 periodic and 131x71 nodes, the two copies of the periodic
     dims' duplicated nodes apart (each is updated from its own values);
  9. the slice on the fixed-cycle multigrid: HIT 256^3 f32 with 65536
     particles, fixed_mg_cycles=4, spectral off, 1 warm-up + 3 timed steps;
     wrapper calls per step equal across steps and to the V-cycle count;
     divergence diagnostics; one step with host syncs made errors; a
     profiled step, whose CUDA launches of each MG kernel must equal those
     its wrapper counted (one a call; one a stage for a nodal call with a
     periodic dim); both MG kernels timed beside their plain versions on
     the finest level's inputs;
 10. the entry point: driver.initialize then driver.run for 2 steps in
     tolerance mode (HIT 128^3 f32, ns.fft_solve = 0, particles); a 32^3
     f64 MG step (fixed and tolerance mode), GPU against CPU, to 1e-10;
 11. the nodal MLMG to rtol 1e-11 (bench.py's problem at 256^3, mixed
     f32/f64), its true residual recomputed in numpy f64
     (ops/np_nodal.py), and the f32/f64 nodal-divergence pair of HIT 32^3
     after 3 MG steps;
 12. the walled slice at full width: Rayleigh-Taylor 256x256x512 f32
     (examples/inputs.3d.rayleigh_taylor: slip walls in z, gravity,
     variable rho), driver.initialize
     (hydrostatic pressure), fixed_mg_cycles=4, 1 warm-up + 3 timed
     steps; wrapper calls per step equal to 1 + k(2(L-1)+1) per solve with
     L of the port's non-cubic hierarchy, and one each of K1 and K2; no
     host sync; a profiled step whose CUDA launches equal those the
     wrappers counted; divergence diagnostics; peak device memory;
 12b. the kernels on that step's own inputs (captured from one step): K1
     and K2 bit for bit with their plain versions, the finest MAC and CN
     cell calls and the nodal projection call (as captured, its periodic
     copies apart) to MG_TOL of their largest terms, each timed beside its
     plain version;
 13. the entry point: driver.initialize (1 pressure iteration) and
     driver.run for 2 steps in tolerance mode, RT 128x128x256 f32;
 14. GPU (kernels) vs CPU (plain), f64, initialize + 2 steps to 1e-10:
     RT 16x16x32 (fixed and tolerance), HotSpot 16^3 (do_temp,
     examples/inputs.3d.hotspot), RT with do_mom_diff and do_denminmax; a seeded 1e-3 velocity perturbation
     moves the fluid at rest off its Riemann ties;
 15. 2D: RT 1024x2048 f32 fixed-cycle steps (plain Godunov, MG launch
     counts, a profiled step), the 2D MG kernels vs plain on its finest
     level, the lid-driven cavity 64^2 f64 GPU vs CPU;
 15b. a fluid at rest under gravity with a lateral outflow face, 64^3, 3
     steps in f32 and f64: max|u| must stay below 2e-2 and 2e-3;
 16. the program: `python -m iamr_tpu_torch` in subprocesses, in a temporary
     directory removed at the end. (a) examples/inputs.3d.hit_forced at
     256^3 (spectral path) with 65536 particles from a seeded init file, 4
     steps, a plotfile at step 4, npz checkpoints at 2 and 4, the monitors
     every step and a run log; a second run from chk00002 to step 4 must
     write the same chk00004 (every array), particle file and plotfile
     bit for bit; the plotfile, read back by io/plotfile.read_plotfile,
     holds the state's fields and its particle_count sums to the live
     particles. (b) examples/inputs.3d.rayleigh_taylor at 128x128x256
     (tolerance mode, the only one an inputs file selects), AMReX-format
     checkpoints every step, 2 steps (beside the HIT restart, the two
     sharing the card), and a restart from chk00001 that writes chk00002
     byte for byte. Each run's kernel calls (the CLI's last
     line) must include K1 and K2 once a step, and the multigrid kernels
     where the run solves with them. Printed: each run's wall seconds, the
     step times of (a) against phase 5's s/step, the seconds, bytes and
     GB/s of the plotfile and checkpoint writes;
 17. LES at full width: phase 9's HIT 256^3 f32 state and particles with
     ns.do_LES = 1 (Smagorinsky, Cs 0.18), fixed_mg_cycles=4, stepped with
     spectral=True (the step turns the FFT solvers off under LES), 1
     warm-up + 3 timed steps; wrapper calls per step by the formula (the
     tensor solve's 3 passes of one one-cycle solve per component), no
     host sync, a profiled step whose CUDA launches equal the counted
     ones, divergence, peak memory; the cell kernel against its plain
     version on the finest tensor-solve call as captured (variable mu);
     one timed Sigma step and its eigenvalue solve (torch.linalg.eigvalsh,
     which reads its status back: a sync);
 18. the advection variants at full width: phase 12's Rayleigh-Taylor
     256x256x512 f32 state stepped with Godunov_PPM, BDS and
     use_forces_in_trans (fixed_mg_cycles=4, 1 warm-up + 2 timed steps
     each): K1/K2 wrapper calls per step 0/0, 1/0 and 0/0, the MG calls
     by the formula, a profiled step, peak memory;
 19. RZ at full width: HotSpot-RZ 1024x2048 f32
     (examples/inputs.2d.hotspot_rz), driver.initialize, fixed_mg_cycles=4,
     1 warm-up + 3 timed steps; MG calls by the formula, a profiled step,
     the RZ MAC divergence max|(1/r) d(r u)/dr + dw/dz - S| dx/umax < 1e-2
     (S the thermal source of the MAC projection); the 2D cell and nodal
     kernels against their plain versions on the captured finest calls
     (beta = 0 on the axis faces); then `python -m iamr_tpu_torch
     examples/inputs.2d.hotspot_rz amr.n_cell="128 256" max_step=2`,
     finished after phase 20, whose kernel calls must name the MG kernels;
 20. GPU (kernels) vs CPU (plain), f64, initialize + 2 steps to 1e-10:
     HIT 16^3 LES with each model, RT 16x16x32 with PPM, BDS and
     use_forces_in_trans, RT 2D 32x64 with BDS, HotSpot-RZ 32x64; an
     unknown ns.advection_scheme equal to Godunov_PLM bit for bit on each
     device;
 21. EB at full width: the 3D flow past a cylinder
     (examples/inputs.3d.flow_past_cylinder) at 512x128x128 f32: the
     cut-cell geometry built on the card (seconds, peak memory),
     driver.initialize, fixed_mg_cycles=4, 1 warm-up + 3 timed steps; K1
     once a step and K2 never (the plain Godunov with the near-wall slopes,
     as the JAX package gates its kernel), the MG calls by the formula
     (4 CN solves: 3 velocity components and the tracer), no host sync, a
     profiled step whose launches equal the counted ones, the covered
     cells' velocity exactly 0, the cut-cell MAC divergence
     max|sum_d d(afrac u)/dx_d - vfrac S| fluid dx/umax < 1e-2, device ms,
     s/step and peak memory; K1 bit for bit and the cell and nodal kernels
     to MG_TOL against their plain versions on the step's captured calls
     (alpha = covered, beta times afrac; sigma times vfrac), each timed;
     then `python -m iamr_tpu_torch examples/inputs.3d.flow_past_cylinder
     amr.n_cell="128 32 32" max_step=2`, finished after phase 22, whose
     kernel calls must name K1 and the MG kernels and not K2;
 22. EB, GPU (kernels) vs CPU (plain), f64, initialize + 2 steps to 1e-10:
     the 2D file at 32x16 and the 3D file at 16x8x8 (the cylinder widened
     so that covered cells exist), StateRedist and FluxRedist, fixed and
     tolerance mode; the geometry built on each device, equal;
 23. AMR at full width: the two-level Rayleigh-Taylor of
     examples/inputs.3d.rayleigh_taylor_amr (128x128x256 coarse, ratio 2,
     the fine patch on the density interface) f32, ns/driver.py's two-level
     start (tags, the composite pressure iteration), subcycled,
     fixed_mg_cycles=4, 1 warm-up + 4 timed coarse steps tagged again every
     2 (the patch before and after each regrid); each coarse step's wrapper
     calls by the formula (1 + r of K1 and K2; the MG calls of each level's
     advances on its own box, the mac_sync, Vsync and Ssync solves and 2 x 2
     FAC nodal solves), and before the last timed step (on the patch the
     steps before it ended on): no host sync in a step without a regrid, a
     profiled step whose CUDA launches equal the counted ones, each level's
     MAC divergence < 1e-2 of umax/dx, device ms of a coarse step beside
     phase 12's for two single-level steps (the same finest dx over the
     same time); the composite mass drift, s/step and peak memory;
 23b. K1 and K2 bit for bit and the cell and nodal kernels to MG_TOL against
     their plain versions on the fine level's captured calls (its MAC, CN
     and nodal calls, with the coarse-fine Dirichlet sides) and on a
     captured FAC sync solve, each timed;
 24. AMR, GPU (kernels) vs CPU (plain), f64, initialize + 2 coarse steps to
     1e-10 on every field of every level: RT 2D 32x64 two-level subcycled
     and composite, RT3D 16x16x32, HotSpot 3D 16^3 (do_temp), the 2D flow
     past a cylinder 32x16 with EB on both levels, HIT 16^3 with 256
     particles, RT 2D three-level with fixed nested patches, and a tagged
     RT 2D run (a seeded velocity) that regrids (run_multilevel, 4 steps);
 25. the program on AMR: `python -m iamr_tpu_torch
     examples/inputs.3d.rayleigh_taylor_amr amr.n_cell="32 32 64"
     max_step=4`, f64, AMReX two-level checkpoints at 2 and 4 and a
     two-level plotfile at 4 (run beside phase 24); its kernel calls name
     K1, K2 and both MG kernels; the restart from chk00002 writes chk00004
     and plt00004 byte for byte.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Exits non-zero, printing no result, without
a CUDA device. Imports no JAX.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HIT_INPUTS = """
max_step = 3
amr.n_cell = {n} {n} {n}
ns.dtype = {dtype}
ns.cfl = 0.7
ns.init_iter = {init_iter}
ns.fft_solve = {fft_solve}
ns.vel_visc_coef = 1.e-4
ns.scal_diff_coefs = 0.0
geometry.prob_lo = -0.5 -0.5 -0.5
geometry.prob_hi = 0.5 0.5 0.5
geometry.is_periodic = 1 1 1
ns.lo_bc = 0 0 0
ns.hi_bc = 0 0 0
prob.probtype = 100
turb.nmodes = 4
turb.div_free_force = 1
"""
# the slice's advected fields: u, v, w (forced, convective), rho
# (conservative), one passive tracer (convective)
SLICE_FLAGS = dict(
    iconservs=[False, False, False, True, False],
    force_rows=[0, 1, 2, -1, -1],
    convs=[True, True, True, False, True],
)
# six fields (ntrac = 2) with mixed force rows, and the two one-field cases
SIX_FLAGS = dict(
    iconservs=[False, False, False, True, False, True],
    force_rows=[0, 1, 2, -1, 1, -1],
    convs=[True, True, True, False, True, False],
)
# nine fields: more than one launch holds (8), so the call chains two
NINE_FLAGS = dict(
    iconservs=[False, False, False, True, False, True, False, True, False],
    force_rows=[0, 1, 2, -1, 1, -1, 2, 0, -1],
    convs=[True, True, True, False, True, False, True, False, False],
)
# the walled slice's field lists: u, v, w, rho, a tracer and the temperature
# (convective, no force row); under do_mom_diff rho U conservative with the
# velocity's force rows
TEMP_FLAGS = dict(
    iconservs=[False, False, False, True, False, False],
    force_rows=[0, 1, 2, -1, -1, -1],
    convs=[True, True, True, False, True, True],
)
MOM_DIFF_FLAGS = dict(
    iconservs=[True, True, True, True, False, False],
    force_rows=[0, 1, 2, -1, -1, -1],
    convs=[False, False, False, False, True, True],
)
RAGGED_BOXES = ((80, 96, 112), (40, 24, 21), (8, 8, 8), (5, 40, 70))
F32_MEDIAN, F32_OUTLIER_TOL, F32_OUTLIER_FRAC = 1e-6, 1e-5, 1e-3
# the multigrid kernels make no thresholded pick: one max bound each
MG_TOL = {torch.float32: 1e-6, torch.float64: 1e-12}
# operations of the multigrid kernels' arithmetic, per point and
# evaluation (the least work, where the plain versions' count overstates
# it): cell, the 7-point residual (8 per dim and 1) and the update (2), and
# the diagonal once per cell and call (5 per dim); nodal, the factored
# element matrix (in-plane transforms 2 x 8, the dim-0 butterflies 2 x 8,
# coefficient and sigma products 2 x 8, the corner sums 4 and the gather 3)
# and the residual and update (5)
CELL_OPS_PER_EVAL, CELL_DIAG_OPS = 27, 15
NODAL_OPS_PER_EVAL = 60
# published H100 SXM peaks (NVIDIA data sheet, at a 700 W limit): device
# memory rate and float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# pointwise arithmetic counted as one operation per output element
ARITH_OPS = {
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "reciprocal", "sqrt", "sign",
    "minimum", "maximum", "clamp", "where", "lt", "le", "gt", "ge", "eq", "ne",
    "logical_and", "logical_or", "logical_not", "copysign", "floor", "pow",
}


def log(msg):
    print(msg, flush=True)


def check_f32(name, pairs, gk):
    """Kernel vs plain in f32: median and outlier fraction bounded, max
    reported (tie flips move single values by ~2|u|), and whether every
    output is bitwise equal."""
    worst = {"median": 0.0, "outliers": 0.0, "max": 0.0}
    max_abs = 0.0
    pairs = list(pairs)
    bitwise = all(torch.equal(got, ref) for got, ref in pairs)
    for got, ref in pairs:
        if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)} "
                                 "or non-finite output")
        st = gk.tie_flip_stats(got, ref, F32_OUTLIER_TOL)
        worst = {k: max(worst[k], st[k]) for k in worst}
        max_abs = max(max_abs, float((got - ref).abs().max()))
    log(f"  {name}: median {worst['median']:.3e} outliers(>{F32_OUTLIER_TOL:g}) "
        f"{worst['outliers']:.3e} max {worst['max']:.3e} (of max|plain|), bitwise {bitwise}")
    if worst["median"] > F32_MEDIAN or worst["outliers"] > F32_OUTLIER_FRAC:
        raise AssertionError(f"{name}: kernel disagrees with plain: {worst}")
    return max_abs


def check_f64(name, pairs, gk):
    pairs = list(pairs)
    bitwise = all(torch.equal(got, ref) for got, ref in pairs)
    worst = max(gk.tie_flip_stats(got, ref, 1e-12)["max"] for got, ref in pairs)
    log(f"  {name}: max {worst:.3e} of max|plain| (limit 1e-12), bitwise {bitwise}")
    if not worst <= 1e-12:
        raise AssertionError(f"{name}: f64 kernel disagrees with plain: {worst}")


# Rayleigh-Taylor's mix: periodic in x and y, walls in z
MIXED = (True, True, False)


def per3(periodic):
    """Per-dim periodic flags from one flag or a tuple of three."""
    return tuple(periodic) if isinstance(periodic, tuple) else (periodic,) * 3


def pad(a, ng, periodic):
    for d, p in enumerate(per3(periodic)):
        a = np.pad(a, [(ng, ng) if e == d else (0, 0) for e in range(a.ndim)],
                   mode="wrap" if p else "edge")
    return a


def box(n):
    return (n,) * 3 if isinstance(n, int) else tuple(n)


def extrap_case(dev, dtype, n, periodic, force, seed=0):
    n = box(n)
    rng = np.random.RandomState(seed)
    vel_g = np.stack([pad(0.4 * rng.randn(*n), 3, periodic) for _ in range(3)])
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    fg = None
    if force:
        fg = t(np.stack([pad(rng.randn(*n), 1, periodic) for _ in range(3)]))
    dt = torch.tensor(0.004, dtype=dtype, device=dev)
    return (t(vel_g), fg, dt, tuple(1.0 / x for x in n), n)


def advect_case(dev, dtype, n, periodic, nc, seed=0):
    from iamr_tpu_torch.ops.godunov import grow_umac_transverse

    n = box(n)
    rng = np.random.RandomState(seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    fields = [t(pad(rng.rand(*n), 3, periodic)) for _ in range(nc)]
    umac = []
    for d in range(3):
        u = 0.3 * rng.randn(*[x + (1 if e == d else 0) for e, x in enumerate(n)])
        if per3(periodic)[d]:
            u[tuple(slice(None) if e != d else -1 for e in range(3))] = \
                u[tuple(slice(None) if e != d else 0 for e in range(3))]
        umac.append(t(u))
    umac = tuple(umac)
    ug = grow_umac_transverse(umac, per3(periodic))
    forces = [t(pad(rng.randn(*n), 1, periodic)) for _ in range(3)]
    dt = torch.tensor(0.004, dtype=dtype, device=dev)
    return fields, umac, ug, forces, dt, tuple(1.0 / x for x in n), n


def flat(out):
    return [a for fl, ao in out for a in (*fl, ao)]


def run_multi(gk, case, flags, periodic, ref=False):
    fields, umac, ug, forces, dt, dx, n = case
    fn = gk.godunov_plm_multi_ref if ref else gk.godunov_plm_multi
    return fn(fields, umac, ug, dt, dx, n, flags["iconservs"], forces,
              flags["force_rows"], flags["convs"], periodic=per3(periodic))


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_pair(kernel, plain, reps=10):
    """plain, kernel, kernel, plain within one run; the mean of each pair."""
    p1 = cuda_ms(plain, reps)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, reps)
    return 0.5 * (k1 + k2), 0.5 * (p1 + p2)


def count_ops(fn):
    """Pointwise arithmetic operations the plain version performs (one per
    output element of each arithmetic aten op), counted on this run's
    inputs."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counter(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__.rstrip("_") in ARITH_OPS:
                outs = out if isinstance(out, (tuple, list)) else (out,)
                self.ops += sum(o.numel() for o in outs if isinstance(o, torch.Tensor))
            return out

    with Counter() as c:
        fn()
    return c.ops


def tensor_bytes(*objs):
    """Bytes of each distinct tensor in objs (nested lists and tuples
    allowed) once: inputs read once, outputs written once."""
    seen, total, stack = set(), 0, list(objs)
    while stack:
        t = stack.pop()
        if isinstance(t, (list, tuple)):
            stack.extend(t)
        elif isinstance(t, torch.Tensor) and (t.data_ptr(), t.numel()) not in seen:
            seen.add((t.data_ptr(), t.numel()))
            total += t.numel() * t.element_size()
    return total


def bound(nbytes, ops):
    """The least time (ms) of the work on the card: the larger of its bytes
    over the memory rate and its operations over the f32 peak."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / F32_FLOP_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def record(name, source, replaces, launches, err, ms, plain_ms, nbytes, ops):
    b, by = bound(nbytes, ops)
    log(f"  {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b:.4f} ms by {by} "
        f"({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} Gop; {100 * b / ms:.1f}% of it), "
        f"launches {launches}")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "library_ms": None}


def ragged_dtypes(n):
    """f32 on every ragged box, f64 too on the small ones."""
    return (torch.float32, torch.float64) if n[0] <= 40 else (torch.float32,)


def phase_kernels(dev, gk):
    log("phase 3: K1 extrap_plm vs plain")
    for periodic in (True, False, MIXED):
        for force in (True, False):
            args = extrap_case(dev, torch.float32, 128, periodic, force)
            check_f32(f"K1 f32 128^3 periodic={periodic} force={force}",
                      zip(gk.extrap_plm(*args), gk.extrap_plm_ref(*args)), gk)
    for periodic in (True, False):
        args = extrap_case(dev, torch.float64, 32, periodic, True)
        check_f64(f"K1 f64 32^3 periodic={periodic}",
                  zip(gk.extrap_plm(*args), gk.extrap_plm_ref(*args)), gk)

    log("phase 3b: K1 on boxes no tile divides")
    for i, n in enumerate(RAGGED_BOXES):
        for k, periodic in enumerate((True, False, MIXED)):
            for dtype in ragged_dtypes(n):
                args = extrap_case(dev, dtype, n, periodic, (i + k) % 2 == 0, seed=2)
                check = check_f32 if dtype == torch.float32 else check_f64
                check(f"K1 {str(dtype)[6:]} {n} periodic={periodic} force={args[1] is not None}",
                      zip(gk.extrap_plm(*args), gk.extrap_plm_ref(*args)), gk)

    log("phase 4: K2 godunov_plm_multi vs plain (nc=5 slice flags; nc=1 = K3)")
    one = lambda ic, f: dict(iconservs=[ic], force_rows=[0 if f else -1], convs=[not ic])
    cases = [("nc=5", SLICE_FLAGS), ("nc=1 conservative", one(True, False)),
             ("nc=1 convective forced", one(False, True)), ("nc=6 with T", TEMP_FLAGS),
             ("nc=6 rho U", MOM_DIFF_FLAGS)]
    for periodic in (True, False, MIXED):
        for label, flags in cases:
            case = advect_case(dev, torch.float32, 128, periodic, len(flags["convs"]))
            got = flat(run_multi(gk, case, flags, periodic))
            ref = flat(run_multi(gk, case, flags, periodic, ref=True))
            check_f32(f"K2 f32 128^3 {label} periodic={periodic}", zip(got, ref), gk)
    for periodic in (True, False):
        case = advect_case(dev, torch.float64, 32, periodic, 5)
        check_f64(f"K2 f64 32^3 nc=5 periodic={periodic}",
                  zip(flat(run_multi(gk, case, SLICE_FLAGS, periodic)),
                      flat(run_multi(gk, case, SLICE_FLAGS, periodic, ref=True))), gk)
    log("phase 4b: K2 on boxes no tile divides, nc = 1, 5, 6")
    ragged = cases + [("nc=6 mixed forces", SIX_FLAGS)]
    for n in RAGGED_BOXES:
        for periodic in (True, False, MIXED):
            for dtype in ragged_dtypes(n):
                check = check_f32 if dtype == torch.float32 else check_f64
                chained = [("nc=9 chained", NINE_FLAGS)] if n == (40, 24, 21) else []
                for label, flags in ragged + chained:
                    case = advect_case(dev, dtype, n, periodic, len(flags["convs"]), seed=2)
                    check(f"K2 {str(dtype)[6:]} {n} {label} periodic={periodic}",
                          zip(flat(run_multi(gk, case, flags, periodic)),
                              flat(run_multi(gk, case, flags, periodic, ref=True))), gk)


def hit_config(n, dtype, dev, init_iter=0, fft_solve=-1):
    from iamr_tpu_torch.config.parmparse import ParmParse
    from iamr_tpu_torch.ns.state import config_from_inputs

    text = HIT_INPUTS.format(n=n, dtype=dtype, init_iter=init_iter, fft_solve=fft_solve)
    return config_from_inputs(ParmParse.from_string(text), device=dev)


def phase_slice(dev, gk, mk, card, n=256, nparticles=65536, steps=3):
    from iamr_tpu_torch.ns.advance import (
        advance, get_force, make_hit_forcing, make_step_with_particles,
    )
    from iamr_tpu_torch.ns.bcprovider import PhysBCProvider
    from iamr_tpu_torch.ns.particles import from_positions
    from iamr_tpu_torch.ns.probs import init_state
    from iamr_tpu_torch.parallel.reduce import invariant_mean
    from iamr_tpu_torch.solvers.mac import mac_project
    from iamr_tpu_torch.solvers.spectral import spectral_eligible

    log(f"phase 5: HIT {n}^3 f32, {nparticles} particles, 1 warm-up + {steps} timed steps")
    t0 = time.perf_counter()
    cfg = hit_config(n, "float32", dev)
    state = init_state(cfg, dev)
    state = state._replace(dt=torch.tensor(5e-3, dtype=cfg.tdtype, device=dev))
    rng = np.random.RandomState(7)
    parts = from_positions(rng.rand(nparticles, 3) - 0.5, dev, dtype=cfg.tdtype)
    sp = spectral_eligible(cfg, state.rho)
    if not sp:
        raise AssertionError("the HIT config must take the spectral solvers")
    step = make_step_with_particles(cfg, spectral=sp)
    torch.cuda.synchronize()
    log(f"  set-up {time.perf_counter() - t0:.3f} s")

    want = {"extrap_plm": 1, "godunov_plm_multi": 1, "mg_cell_gsrb": 0, "mg_nodal_jacobi": 0}
    (state, parts), s_step, per_step = run_steps(lambda c: step(*c), (state, parts), steps,
                                                 gk, mk)
    log(f"  launches per step: {per_step[-1]} (expected {want}; the spectral path runs no MG)")
    if any(c != want for c in per_step):
        raise AssertionError(f"launch counts per step {per_step} != {want}")
    launches = {k: sum(c[k] for c in per_step) for k in want}
    check_state(state, parts)
    if tuple(state.vel.shape) != (3, n, n, n) or tuple(parts.pos.shape) != (nparticles, 3):
        raise AssertionError("unexpected state shapes")
    log(f"  {s_step:.6f} s/step, {n**3 / s_step:.6e} cells/s on {card}")
    rows = profile_step(lambda: step(state, parts), card)
    check_profiled_launches(rows, {"extrap_plm": 1, "godunov_plm_multi": 1})

    # the MAC divergence of one more step's projected umac
    dx = cfg.geom.dx
    hit = make_hit_forcing(cfg)
    _, umac_f = advance(state, cfg, hit=hit, return_umac=True, spectral=True)
    if not divergence_report(cfg, state, umac_f)["max_mac_div_over_umax_dx"] < 1e-3:
        raise AssertionError("MAC projection left a divergence above 1e-3 umax/dx")

    log(f"phase 5b: K1/K2 at {n}^3 f32 on main-path inputs, kernel vs plain")
    from iamr_tpu_torch import native

    for line in native.ptxas_report():
        if "extrap_plm_kernelIf" in line or "godunov_plm_multi_kernelIf" in line:
            log(f"  ptxas {line}")
    for name in gk.LAUNCHES:
        log(f"  {name}: {gk.smem_bytes(name, torch.float32)} bytes of shared memory a block (f32)")
    bcp = PhysBCProvider(cfg)
    forcing = (get_force(cfg, state.rho, state.time, hit) - state.gradp) / state.rho
    vel_g = bcp.fill_vel(state.vel, 3)
    force_g = bcp.fill_force(forcing)
    n3 = cfg.geom.ncell
    k1_args = (vel_g, force_g, state.dt, dx, n3)
    k1_err = check_f32(f"K1 {n}^3", zip(gk.extrap_plm(*k1_args), gk.extrap_plm_ref(*k1_args)), gk)
    umac, _, _ = mac_project(gk.extrap_plm(*k1_args), state.rho, cfg.dom, dx,
                             spectral_beta0=1.0 / invariant_mean(state.rho))
    umac_g = bcp.grow_umac(umac)
    fields = [vel_g[c] for c in range(3)] + [bcp.fill_scal(state.rho, 3, 0),
                                            bcp.fill_scal(state.trac[0], 3, 1)]
    forces = [force_g[c] for c in range(3)]
    per = (True,) * 3
    k2_args = (fields, umac, umac_g, state.dt, dx, n3, SLICE_FLAGS["iconservs"], forces,
               SLICE_FLAGS["force_rows"], SLICE_FLAGS["convs"])
    k2_err = check_f32(f"K2 {n}^3 nc=5",
                       zip(flat(gk.godunov_plm_multi(*k2_args, periodic=per)),
                           flat(gk.godunov_plm_multi_ref(*k2_args, periodic=per))), gk)
    k1_ms, k1_plain = timed_pair(lambda: gk.extrap_plm(*k1_args),
                                 lambda: gk.extrap_plm_ref(*k1_args))
    k2_ms, k2_plain = timed_pair(lambda: gk.godunov_plm_multi(*k2_args, periodic=per),
                                 lambda: gk.godunov_plm_multi_ref(*k2_args, periodic=per))
    k3_args = ([fields[3]], umac, umac_g, state.dt, dx, n3, [True], [], [-1], [False])
    k3_ms, k3_plain = timed_pair(lambda: gk.godunov_plm_multi(*k3_args, periodic=per),
                                 lambda: gk.godunov_plm_multi_ref(*k3_args, periodic=per))
    # bytes: the kernel takes the face velocities from umac_g alone (its real
    # part is umac), so umac is not among the arrays it must read
    k3_bound, k3_by = bound(
        tensor_bytes(fields[3], umac_g, gk.godunov_plm_multi(*k3_args, periodic=per)),
        count_ops(lambda: gk.godunov_plm_multi_ref(*k3_args, periodic=per)))
    log(f"  K3 godunov nc=1 rho {k3_ms:.4f} ms, plain {k3_plain:.4f} ms, bound "
        f"{k3_bound:.4f} ms by {k3_by} ({card})")
    k1_out = gk.extrap_plm(*k1_args)
    k2_out = gk.godunov_plm_multi(*k2_args, periodic=per)
    src = "iamr_tpu_torch/csrc/godunov_plm.cu"
    return s_step, [
        record("extrap_plm", src, "iamr_tpu/ops/pallas_godunov.py:944",
               launches["extrap_plm"], k1_err, k1_ms, k1_plain,
               tensor_bytes(vel_g, force_g, k1_out),
               count_ops(lambda: gk.extrap_plm_ref(*k1_args))),
        record("godunov_plm_multi", src,
               "iamr_tpu/ops/pallas_godunov.py:557, iamr_tpu/ops/pallas_godunov.py:398",
               launches["godunov_plm_multi"], k2_err, k2_ms, k2_plain,
               tensor_bytes(fields, umac_g, forces, k2_out),
               count_ops(lambda: gk.godunov_plm_multi_ref(*k2_args, periodic=per))),
    ]


def phase_cpu_parity(dev):
    from iamr_tpu_torch.ns.advance import make_step_with_particles
    from iamr_tpu_torch.ns.particles import from_positions
    from iamr_tpu_torch.ns.probs import init_state

    log("phase 6: HIT 32^3 f64 step with 256 particles, GPU (kernels) vs CPU (plain)")
    cfg = hit_config(32, "float64", dev)
    step = make_step_with_particles(cfg, spectral=True)
    pos = np.random.RandomState(7).rand(256, 3) - 0.5
    out = {}
    for where in (torch.device("cpu"), dev):
        st = init_state(cfg, where)
        st = st._replace(dt=torch.tensor(5e-3, dtype=torch.float64, device=where))
        st, parts = step(st, from_positions(pos, where))
        out[where.type] = {"vel": st.vel, "p": st.p, "pos": parts.pos}
    for k, ref in out["cpu"].items():
        got = out["cuda"][k].cpu()
        rel = float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-300)
        log(f"  {k}: max rel diff {rel:.3e} (limit 1e-10)")
        if not rel <= 1e-10:
            raise AssertionError(f"GPU step disagrees with CPU step on {k}: {rel}")


def rel_err(got, ref):
    if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"shape {tuple(got.shape)} vs {tuple(ref.shape)} or non-finite")
    return float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-300)


def check_pairs(name, pairs, dtype, terms=(0.0, 0.0)):
    """Kernel vs plain: max|kernel - plain| over the outputs, bounded by
    MG_TOL as a share of max|plain|, or of the largest term the output sums
    where that is larger. Items alternate (phi, residual): a sweep's phi_in +
    omega r / diag sums phi_in (terms[0] = max|phi_in|), a residual terms
    of max|diag| max|phi_in| (terms[1]); on random or nearly solved inputs
    both outputs come out much smaller than those terms, and the kernels sum
    in another order than the plain versions. An item may carry the plain
    version's f64 result third: the kernel's and the plain version's
    distances to it are reported on the same scale. Returns the largest
    absolute difference."""
    worst, worst_plain, max_abs, vs64 = 0.0, 0.0, 0.0, [0.0, 0.0]
    for k, (got, ref, *exact) in enumerate(pairs):
        if ref is None:
            if got is not None:
                raise AssertionError(f"{name}: unexpected output")
            continue
        worst_plain = max(worst_plain, rel_err(got, ref))
        scale = max(float(ref.abs().max()), terms[k % 2], 1e-300)
        err = float((got - ref).abs().max())
        worst = max(worst, err / scale)
        max_abs = max(max_abs, err)
        for i, t in enumerate((got, ref)[:len(exact) * 2]):
            vs64[i] = max(vs64[i], float((t.double() - exact[0]).abs().max()) / scale)
    extra = f"; vs f64: kernel {vs64[0]:.3e}, plain {vs64[1]:.3e}" if any(vs64) else ""
    log(f"  {name}: max {worst:.3e} (of max|plain| alone {worst_plain:.3e}{extra}; limit "
        f"{MG_TOL[dtype]:g})")
    if not worst <= MG_TOL[dtype]:
        raise AssertionError(f"{name}: kernel disagrees with plain: {worst}")
    return max_abs


def as_f64(x):
    """Tensors (also inside tuples, lists and dicts) in float64."""
    if isinstance(x, torch.Tensor):
        return x.double()
    if isinstance(x, (tuple, list)):
        return type(x)(as_f64(v) for v in x)
    if isinstance(x, dict):
        return {k: as_f64(v) for k, v in x.items()}
    return x


def face_arrays(rng, shape, periodic, t):
    """Face coefficients in [0.5, 2] (+1 in their dim); a periodic dim's
    last face equals its first, as the solvers build them."""
    out = []
    for d in range(len(shape)):
        b = 0.5 + 1.5 * rng.rand(*[x + (1 if e == d else 0) for e, x in enumerate(shape)])
        if periodic[d]:
            b[tuple(-1 if e == d else slice(None) for e in range(len(shape)))] = \
                b[tuple(0 if e == d else slice(None) for e in range(len(shape)))]
        out.append(t(b))
    return tuple(out)


def cell_bcs(dim):
    from iamr_tpu_torch.ops.mg import DIRICHLET as D, NEUMANN as N, PERIODIC as P

    return {"periodic": ((P,) * dim, (P,) * dim), "dirichlet": ((D,) * dim, (D,) * dim),
            "mixed": ((N, D, N)[:dim], (D, N, D)[:dim])}


def cell_case(dev, dtype, shape, lo, hi, a, seed=0):
    """Random phi, rhs, alpha (a != 0) and beta; b is a 0-d tensor when
    a != 0 (the diffusion solves) and a float otherwise."""
    from iamr_tpu_torch.ops import mg

    rng = np.random.RandomState(seed)
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
    dx = tuple(1.0 / (x * (1.0 + 0.1 * d)) for d, x in enumerate(shape))
    phi, rhs = t(rng.randn(*shape)), t(rng.randn(*shape))
    alpha = t(0.5 + rng.rand(*shape)) if a else None
    beta = face_arrays(rng, shape, [k == mg.PERIODIC for k in lo], t)
    b = t(0.7).reshape(()) if a else 0.7
    return phi, rhs, alpha, beta, a, b, dx, lo, hi


def cell_term(mk, args):
    """The largest terms of a cell call's outputs (check_pairs): max|phi|
    and max|diag| max|phi|."""
    phi, _, alpha, beta, a, b, dx, lo, hi = args[:9]
    m = float(phi.abs().max())
    return m, float(mk.cell_diag(alpha, beta, a, b, dx, lo, hi).abs().max()) * m


def cell_contracts(mk, args, calls=None):
    """(kernel, plain) output pairs of K4's and K5's contracts, or of the
    given calls' keywords."""
    pairs = []
    for kw in calls or ({"nsweeps": 2, "want_resid": True},                  # K4
                        {"nsweeps": 0, "want_resid": False, "colour": 0},    # K5 red
                        {"nsweeps": 0, "want_resid": False, "colour": 1},    # K5 black
                        {"nsweeps": 0, "want_resid": True}):                 # K5 residual
        got = mk.cell_smooth(*args, **kw)
        ref = mk.cell_smooth_ref(*args, **kw)
        if args[0].dtype == torch.float32:
            pairs += list(zip(got, ref, mk.cell_smooth_ref(*as_f64(args), **kw)))
        else:
            pairs += list(zip(got, ref))
    return pairs


# nsweeps 0 to 4, with and without the residual (one launch holds 5 stages)
SWEEP_CALLS = [{"nsweeps": k, "want_resid": r} for k in range(5) for r in (True, False)
               if k or r]


def phase_cell_kernel(dev, mk):
    from iamr_tpu_torch.ops.mg import DIRICHLET as D, NEUMANN as N, PERIODIC as P

    log("phase 7: mg_cell_gsrb vs plain (K4: 2 sweeps + residual; K5: one colour, residual)")
    for shape in ((128, 128, 128), (80, 96, 112), (512, 512)):
        for label, (lo, hi) in cell_bcs(len(shape)).items():
            for a in (1.0, 0.0):
                args = cell_case(dev, torch.float32, shape, lo, hi, a)
                check_pairs(f"f32 {shape} {label} a={a:g}", cell_contracts(mk, args),
                            torch.float32, cell_term(mk, args))
    for label, (lo, hi) in cell_bcs(3).items():
        for a in (1.0, 0.0):
            args = cell_case(dev, torch.float64, (32, 32, 32), lo, hi, a)
            check_pairs(f"f64 (32, 32, 32) {label} a={a:g}", cell_contracts(mk, args),
                        torch.float64, cell_term(mk, args))
    log("phase 7b: mg_cell_gsrb tiles, nsweeps 0-4 with and without the residual")
    for shape, lo, hi in (((16, 16, 16), (D, N, P), (N, D, P)),
                          ((80, 96, 112), (N, D, P), (D, N, P)),
                          ((40, 24, 21), (P, P, P), (P, P, P)), ((130, 70), (D, N), (N, D))):
        args = cell_case(dev, torch.float32, shape, lo, hi, 0.0, seed=3)
        check_pairs(f"f32 {shape} lo={lo} hi={hi}", cell_contracts(mk, args, SWEEP_CALLS),
                    torch.float32, cell_term(mk, args))


def nodal_bcs(dim):
    from iamr_tpu_torch.ops.mg_nodal import N_DIRICHLET as D, N_NEUMANN as N, N_PERIODIC as P

    return {"periodic": ((P,) * dim, (P,) * dim), "neumann": ((N,) * dim, (N,) * dim),
            "outflow": ((D, N, P)[:dim], (N, D, P)[:dim])}


def nodal_case(dev, dtype, cshape, lo, hi, seed=1, apart=False):
    """Random sigma (cells), phi and rhs (nodes; the duplicated periodic
    DOF's copies equal, or differing when `apart`) and the finest level
    (mask, diag, omega)."""
    from iamr_tpu_torch.ops import mg_nodal as mn

    rng = np.random.RandomState(seed)
    dim = len(cshape)
    nshape = tuple(c + 1 for c in cshape)
    phi, rhs = rng.randn(*nshape), rng.randn(*nshape)
    for d in range(dim):
        if lo[d] == mn.N_PERIODIC and not apart:
            for a in (phi, rhs):
                a[tuple(-1 if e == d else slice(None) for e in range(dim))] = \
                    a[tuple(0 if e == d else slice(None) for e in range(dim))]
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
    dx = tuple(1.0 / (c * (1.0 + 0.1 * d)) for d, c in enumerate(cshape))
    sigma = t(0.5 + rng.rand(*cshape))
    lev = mn.build_nodal_hierarchy(sigma, dx, mn.NodalBC(tuple(lo), tuple(hi)))[0]
    return t(phi), sigma, t(rhs), dx, lo, hi, lev


def nodal_term(case):
    """The largest terms of a nodal call's outputs (check_pairs): max|phi|
    and max|diag| max|phi|."""
    m = float(case[0].abs().max())
    return m, float(case[-1].diag.abs().max()) * m


def nodal_contracts(mk, case, calls=None):
    """(kernel, plain) output pairs of K6's, K7's and K8's contracts, or of
    the given calls' keywords (with omega)."""
    phi, sigma, rhs, dx, lo, hi, lev = case
    upd = lev.omega * lev.mask / lev.diag
    base = (phi, sigma, rhs, dx, lo, hi)
    pairs = []
    for kw in [dict(c, omega=lev.omega) for c in calls] if calls else (
        {"nsweeps": 1, "want_resid": False, "omega": lev.omega},   # K6 sweep
        {"nsweeps": 0, "want_resid": True},                        # K6 residual
        {"nsweeps": 3, "want_resid": True, "omega": lev.omega},    # K7
        {"nsweeps": 3, "want_resid": True, "upd": upd, "mask": lev.mask},  # K8
    ):
        got = mk.nodal_jacobi(*base, **kw)
        ref = mk.nodal_jacobi_ref(*base, **kw)
        if phi.dtype == torch.float32:
            pairs += list(zip(got, ref, mk.nodal_jacobi_ref(*as_f64(base), **as_f64(kw))))
        else:
            pairs += list(zip(got, ref))
    return pairs


def phase_nodal_kernel(dev, mk):
    from iamr_tpu_torch.ops.mg_nodal import N_DIRICHLET as D, N_NEUMANN as N, N_PERIODIC as P

    log("phase 8: mg_nodal_jacobi vs plain (K6: one sweep, residual; K7: 3 sweeps + "
        "residual; K8: the same with upd and mask arrays)")
    for dtype, cshape in ((torch.float32, (128, 128, 128)), (torch.float32, (80, 96, 112)),
                          (torch.float32, (256, 256)), (torch.float64, (32, 32, 32))):
        for label, (lo, hi) in nodal_bcs(len(cshape)).items():
            case = nodal_case(dev, dtype, cshape, lo, hi)
            nodes = tuple(c + 1 for c in cshape)
            check_pairs(f"{str(dtype)[6:]} nodes {nodes} {label}",
                        nodal_contracts(mk, case), dtype, nodal_term(case))
    log("phase 8b: mg_nodal_jacobi tiles, nsweeps 0-4 with and without the residual, "
        "the periodic copies apart (each updated from its own values)")
    for cshape, lo, hi in (((16, 16, 16), (P, P, P), (P, P, P)),
                           ((80, 96, 112), (D, N, P), (N, D, P)),
                           ((40, 24, 21), (P, P, P), (P, P, P)), ((130, 70), (N, P), (D, P))):
        case = nodal_case(dev, torch.float32, cshape, lo, hi, seed=3, apart=True)
        nodes = tuple(c + 1 for c in cshape)
        check_pairs(f"f32 nodes {nodes} lo={lo} hi={hi}",
                    nodal_contracts(mk, case, SWEEP_CALLS), torch.float32, nodal_term(case))


def mg_hierarchy(cells, stop, nodes):
    """(levels of the MG hierarchy, the bottom level's cells (nodes)):
    ops/mg.py::build_hierarchy and ops/mg_nodal.py::build_nodal_hierarchy
    halve until an extent is odd, the smallest is <= 2, or the level has
    <= stop cells (nodes)."""
    count, shape = 1, tuple(cells)
    while not (any(x % 2 for x in shape) or min(shape) <= 2
               or int(np.prod([x + nodes for x in shape])) <= stop):
        shape = tuple(x // 2 for x in shape)
        count += 1
    return count, int(np.prod([x + nodes for x in shape]))


def mg_levels(cells, stop, nodes):
    """Levels of the MG hierarchy (mg_hierarchy)."""
    return mg_hierarchy(cells, stop, nodes)[0]


# the largest bottom level the dense (pseudo)inverse takes; a larger one
# (a patch extent that coarsens to an odd size early) is smoothed once, then
# solved by CG (ops/mg.py::_bottom_dense_inv, ops/mg_nodal.py)
DENSE_INV_MAX_DOFS = 4096


def solve_calls(cells, cycles, nodal):
    """Wrapper calls of one fixed-cycle solve on a box of `cells`: one
    residual call, then per V-cycle 2 smoother calls per level above the
    bottom, one residual call, and one smoother call at a CG bottom."""
    from iamr_tpu_torch.ops.mg import DENSE_BOTTOM_DOFS
    from iamr_tpu_torch.ops.mg_nodal import NODAL_DENSE_BOTTOM_DOFS

    levels, bottom = mg_hierarchy(cells, NODAL_DENSE_BOTTOM_DOFS if nodal else DENSE_BOTTOM_DOFS,
                                  int(nodal))
    return 1 + cycles * (2 * (levels - 1) + 1 + int(bottom > DENSE_INV_MAX_DOFS))


def expected_mg_launches(cells, cycles, cn_solves=3):
    """Wrapper calls per step of the fixed-cycle MG step on a box of `cells`
    (solve_calls per solve). Cell: the MAC solve (cycles V-cycles) and
    cn_solves CN solves (velocity components, diffusing tracers,
    temperature; max(1, cycles // 4) each); nodal: the projection (cycles
    V-cycles)."""
    return {"mg_cell_gsrb": solve_calls(cells, cycles, False)
            + cn_solves * solve_calls(cells, max(1, cycles // 4), False),
            "mg_nodal_jacobi": solve_calls(cells, cycles, True)}


def cn_solves(cfg):
    """The CN solves of a step: one per velocity component (with
    viscosity; under LES the tensor solve's N_OUTER passes of one each),
    per diffusing tracer and for the conducting temperature."""
    from iamr_tpu_torch.solvers.tensor import N_OUTER

    n = cfg.dim * N_OUTER if cfg.do_les else cfg.dim if cfg.vel_visc_coef > 0.0 else 0
    n += sum(1 for t in range(cfg.ntrac)
             if t < len(cfg.scal_diff_coefs) and cfg.scal_diff_coefs[t] > 0.0)
    return n + int(cfg.do_temp and cfg.temp_cond_coef > 0.0)


def check_state(state, parts=None):
    for k in ("vel", "rho", "trac", "p", "gradp", "dt"):
        if not bool(torch.isfinite(getattr(state, k)).all()):
            raise AssertionError(f"non-finite state.{k}")
    if parts is not None and not (bool(torch.isfinite(parts.pos).all())
                                  and bool(parts.alive.all())):
        raise AssertionError("non-finite or lost particles")


def divergence_report(cfg, state, umac=None):
    """bench.py's diagnostics over umax/dx: the nodal divergence of the cell
    velocities (with the domain's nodal BCs) and, given umac, the MAC
    divergence of the projected face velocities."""
    from iamr_tpu_torch.ops.mg_nodal import div_cell_to_node
    from iamr_tpu_torch.solvers.nodal_proj import nodal_bc

    dx = cfg.geom.dx
    scale = max(float(state.vel.abs().max()), 1e-30) / dx[0]
    max_div = float(div_cell_to_node(tuple(state.vel), dx, nodal_bc(cfg.dom)).abs().max())
    out = {"max_div_over_umax_dx": max_div / scale}
    log(f"  max_div_after_step {max_div:.6e} max_div_over_umax_dx {max_div / scale:.6e}")
    if umac is not None:
        max_mac = float(sum(torch.diff(umac[d], dim=d) / dx[d]
                            for d in range(cfg.dim)).abs().max())
        out["max_mac_div_over_umax_dx"] = max_mac / scale
        log(f"  max_mac_div {max_mac:.6e} max_mac_div_over_umax_dx {max_mac / scale:.6e}")
    return out


def profile_step(fn, card, top=12):
    """Device time of one step by kernel name (torch.profiler), and the
    device's busy share of the profiled step's wall time; returns the CUDA
    kernel rows (key, count, device time). The kernels' counts hold the
    profiled step's calls afterwards."""
    from torch.profiler import ProfilerActivity, profile

    from iamr_tpu_torch.ops import godunov_kernels as gk
    from iamr_tpu_torch.ops import mg_kernels as mk

    fn()
    torch.cuda.synchronize()
    gk.reset_launches()
    mk.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_time = lambda e: getattr(e, "self_device_time_total", 0.0)
    rows = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    dev_us = sum(dev_time(e) for e in rows)
    log(f"  profiled step: {wall * 1e3:.3f} ms wall, {dev_us / 1e3:.3f} ms device time, "
        f"{len(rows)} kernel names ({card})")
    for e in sorted(rows, key=lambda e: -dev_time(e))[:top]:
        log(f"    {dev_time(e) / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")
    return rows


def check_profiled_launches(rows, want):
    """The profiled step (rows of profile_step) made want[name] wrapper
    calls of each kernel, and the CUDA launches its wrapper counted: one a
    call (GRIDS: more where a call chains launches, as a nodal call with a
    periodic dim does, one a stage)."""
    from iamr_tpu_torch.ops import godunov_kernels as gk
    from iamr_tpu_torch.ops import mg_kernels as mk

    calls, grids = dict(gk.LAUNCHES, **mk.LAUNCHES), dict(gk.LAUNCHES, **mk.GRIDS)
    for name, n in want.items():
        mine = [e for e in rows if f"{name}_kernel" in e.key]
        launches = sum(e.count for e in mine)
        ms = sum(getattr(e, "self_device_time_total", 0.0) for e in mine) / 1e3
        log(f"  {name}: {launches} CUDA launches ({grids[name]} counted), {ms:.3f} ms device "
            f"time in the profiled step, {calls[name]} wrapper calls (expected {n})")
        if calls[name] != n or launches != grids[name]:
            raise AssertionError(f"{name}: {launches} CUDA launches, {grids[name]} counted, "
                                 f"{calls[name]} calls, {n} expected")


def cell_ops(cells, passes, want_resid):
    """The least operations of a cell call: a colour pass evaluates half the
    cells, the residual all of them, the diagonal once."""
    return cells * ((0.5 * passes + want_resid) * CELL_OPS_PER_EVAL + CELL_DIAG_OPS)


def nodal_ops(nodes, sweeps, want_resid):
    return nodes * (sweeps + want_resid) * NODAL_OPS_PER_EVAL


def phase_mg_slice(dev, gk, mk, card, n=256, nparticles=65536, steps=3, cycles=4):
    from iamr_tpu_torch.ns.advance import advance, make_hit_forcing, make_step_with_particles
    from iamr_tpu_torch.ns.bcprovider import PhysBCProvider
    from iamr_tpu_torch.ns.particles import from_positions
    from iamr_tpu_torch.ns.probs import init_state
    from iamr_tpu_torch.ops import mg, mg_nodal
    from iamr_tpu_torch.ops.mg_nodal import div_cell_to_node
    from iamr_tpu_torch.ops.stencil import mac_div
    from iamr_tpu_torch.solvers.mac import beta_from_rho

    log(f"phase 9: HIT {n}^3 f32 on the fixed-cycle multigrid (fixed_mg_cycles={cycles}), "
        f"{nparticles} particles, 1 warm-up + {steps} timed steps")
    cfg = hit_config(n, "float32", dev, fft_solve=0)
    state = init_state(cfg, dev)
    state = state._replace(dt=torch.tensor(5e-3, dtype=cfg.tdtype, device=dev))
    rng = np.random.RandomState(7)
    parts = from_positions(rng.rand(nparticles, 3) - 0.5, dev, dtype=cfg.tdtype)
    step = make_step_with_particles(cfg, cycles, spectral=False)
    want = dict(expected_mg_launches((n,) * 3, cycles), extrap_plm=1, godunov_plm_multi=1)
    (state, parts), s_step, per_step = run_steps(lambda c: step(*c), (state, parts), steps,
                                                 gk, mk)
    log(f"  launches per step: {per_step[-1]} (expected {want})")
    if any(c != want for c in per_step):
        raise AssertionError(f"launch counts per step {per_step} != {want}")
    check_state(state, parts)
    log(f"  {s_step:.6f} s/step, {n**3 / s_step:.6e} cells/s on {card}")

    torch.cuda.set_sync_debug_mode("error")
    try:
        step(state, parts)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    log("  one more step under set_sync_debug_mode('error'): no host sync")
    rows = profile_step(lambda: step(state, parts), card)
    check_profiled_launches(rows, {k: want[k] for k in ("mg_cell_gsrb", "mg_nodal_jacobi")})
    _, umac_f = advance(state, cfg, cycles, hit=make_hit_forcing(cfg), return_umac=True)
    div = divergence_report(cfg, state, umac_f)
    if not div["max_mac_div_over_umax_dx"] < 1e-2:
        raise AssertionError(f"MAC divergence after {cycles} V-cycles: {div}")

    log(f"phase 9b: MG kernels at {n}^3 f32 on the finest level's inputs, kernel vs plain")
    dx = cfg.geom.dx
    bcp = PhysBCProvider(cfg)
    mac_bc, _ = bcp.mac_bc()
    umac = gk.extrap_plm(bcp.fill_vel(state.vel, 3), None, state.dt, dx, cfg.geom.ncell)
    beta = beta_from_rho(state.rho, cfg.dom)
    lev = mg.build_hierarchy(torch.zeros_like(state.rho), beta, 0.0, 1.0, dx, mac_bc,
                             stop_dofs=mg.DENSE_BOTTOM_DOFS)[0]
    rhs = -mac_div(umac, dx)
    phi = torch.zeros_like(rhs)
    cell_args = (phi, rhs, None, lev.beta, 0.0, 1.0, lev.dx, mac_bc.lo, mac_bc.hi, 2, True)
    c_term = cell_term(mk, cell_args)
    cell_err = check_pairs(f"mg_cell_gsrb {n}^3 (MAC level 0)",
                           zip(mk.cell_smooth(*cell_args), mk.cell_smooth_ref(*cell_args)),
                           torch.float32, c_term)
    nbc, _ = bcp.nodal()
    sigma = 1.0 / state.rho
    nlev = mg_nodal.build_nodal_hierarchy(sigma, dx, nbc,
                                          stop_dofs=mg_nodal.NODAL_DENSE_BOTTOM_DOFS)[0]
    vs = tuple(state.vel[d] / state.dt + state.gradp[d] * sigma for d in range(3))
    nrhs = div_cell_to_node(vs, dx, nbc)
    nodal_args = (state.p, sigma, nrhs, dx, nbc.lo, nbc.hi, 2, True)
    nodal_kw = {"omega": nlev.omega}
    # p nearly solves the projection, so the residual is small next to its terms
    n_term = (float(state.p.abs().max()),
              float(nlev.diag.abs().max()) * float(state.p.abs().max()))
    nodal_err = check_pairs(f"mg_nodal_jacobi {n + 1}^3 nodes (projection level 0)",
                            zip(mk.nodal_jacobi(*nodal_args, **nodal_kw),
                                mk.nodal_jacobi_ref(*nodal_args, **nodal_kw)), torch.float32,
                            n_term)
    c_ms, c_plain = timed_pair(lambda: mk.cell_smooth(*cell_args),
                               lambda: mk.cell_smooth_ref(*cell_args))
    n_ms, n_plain = timed_pair(lambda: mk.nodal_jacobi(*nodal_args, **nodal_kw),
                               lambda: mk.nodal_jacobi_ref(*nodal_args, **nodal_kw))
    c_out = mk.cell_smooth(*cell_args)
    n_out = mk.nodal_jacobi(*nodal_args, **nodal_kw)
    # the other calls of the V-cycle and TPU kernels' contracts, timed on the
    # same inputs; bytes: inputs read once, outputs written once
    upd = nlev.omega * nlev.mask / nlev.diag
    cells, nodes = n**3, (n + 1)**3
    contracts = [
        ("K4 2 sweeps (post-smooth)", mk.cell_smooth, mk.cell_smooth_ref,
         cell_args[:9] + (2, False), {}, (phi, rhs, lev.beta), c_term, cell_ops(cells, 4, 0)),
        ("K5 one colour pass", mk.cell_smooth, mk.cell_smooth_ref, cell_args[:9] + (0, False),
         {"colour": 0}, (phi, rhs, lev.beta), c_term, cell_ops(cells, 1, 0)),
        ("K5 residual", mk.cell_smooth, mk.cell_smooth_ref, cell_args[:9] + (0, True), {},
         (phi, rhs, lev.beta), c_term, cell_ops(cells, 0, 1)),
        ("K7 2 sweeps (post-smooth)", mk.nodal_jacobi, mk.nodal_jacobi_ref,
         nodal_args[:6] + (2, False), nodal_kw, (state.p, sigma, nrhs), n_term,
         nodal_ops(nodes, 2, 0)),
        ("K6 residual", mk.nodal_jacobi, mk.nodal_jacobi_ref, nodal_args[:6] + (0, True), {},
         (state.p, sigma, nrhs), n_term, nodal_ops(nodes, 0, 1)),
        ("K6 one sweep, upd and mask arrays", mk.nodal_jacobi, mk.nodal_jacobi_ref,
         nodal_args[:6] + (1, False), {"upd": upd, "mask": nlev.mask},
         (state.p, sigma, nrhs, upd, nlev.mask), n_term, nodal_ops(nodes, 1, 0)),
        ("K8 2 sweeps + residual, upd and mask arrays", mk.nodal_jacobi, mk.nodal_jacobi_ref,
         nodal_args, {"upd": upd, "mask": nlev.mask}, (state.p, sigma, nrhs, upd, nlev.mask),
         n_term, nodal_ops(nodes, 2, 1)),
    ]
    for label, kern, plain, args, kw, inputs, term, ops in contracts:
        outputs = kern(*args, **kw)
        check_pairs(label, zip(outputs, plain(*args, **kw)), torch.float32, term)
        k_ms, p_ms = timed_pair(lambda: kern(*args, **kw), lambda: plain(*args, **kw))
        b_ms, by = bound(tensor_bytes(inputs, [t for t in outputs if t is not None]), ops)
        log(f"  {label}: {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms by {by}, "
            f"{100 * b_ms / k_ms:.1f}% of it ({card})")
    launches = {k: sum(c[k] for c in per_step) for k in per_step[0]}
    return [
        record("mg_cell_gsrb", "iamr_tpu_torch/csrc/mg_cell.cu",
               "iamr_tpu/ops/pallas_fused.py:351, iamr_tpu/ops/pallas_mg.py:154",
               launches["mg_cell_gsrb"], cell_err, c_ms, c_plain,
               tensor_bytes(phi, rhs, lev.beta, c_out), cell_ops(cells, 4, 1)),
        record("mg_nodal_jacobi", "iamr_tpu_torch/csrc/mg_nodal.cu",
               "iamr_tpu/ops/pallas_mg.py:265, iamr_tpu/ops/pallas_fused.py:832, "
               "iamr_tpu/ops/pallas_fused.py:665",
               launches["mg_nodal_jacobi"], nodal_err, n_ms, n_plain,
               tensor_bytes(state.p, sigma, nrhs, n_out), nodal_ops(nodes, 2, 1)),
    ], {"s_per_step": s_step, "cells_per_s": n**3 / s_step, **div}, (state, parts)


def phase_entry_point(dev, n=128, nparticles=4096):
    from iamr_tpu_torch.ns import driver
    from iamr_tpu_torch.ns.advance import make_step
    from iamr_tpu_torch.ns.particles import from_positions
    from iamr_tpu_torch.ns.probs import init_state

    log(f"phase 10: driver.initialize + driver.run (2 steps, tolerance mode, "
        f"ns.fft_solve = 0), HIT {n}^3 f32, {nparticles} particles")
    cfg = hit_config(n, "float32", dev, init_iter=1, fft_solve=0)
    t0 = time.perf_counter()
    state = driver.initialize(cfg, device=dev)
    parts = from_positions(np.random.RandomState(7).rand(nparticles, 3) - 0.5, dev,
                           dtype=cfg.tdtype)
    state, parts = driver.run(cfg, state, max_steps=2, particles=parts)
    torch.cuda.synchronize()
    check_state(state, parts)
    log(f"  initialize + 2 steps: {time.perf_counter() - t0:.3f} s, time "
        f"{float(state.time):.6e}, max|u| {float(state.vel.abs().max()):.6e}")

    log("phase 10b: HIT 32^3 f64 MG step (fixed 4 cycles, tolerance), GPU vs CPU")
    cfg = hit_config(32, "float64", dev, fft_solve=0)
    for cycles in (4, None):
        out = []
        for where in (torch.device("cpu"), dev):
            st = init_state(cfg, where)
            st = st._replace(dt=torch.tensor(5e-3, dtype=torch.float64, device=where))
            st = make_step(cfg, cycles)(st)
            out.append({"vel": st.vel, "p": st.p, "gradp": st.gradp})
        for k, ref in out[0].items():
            rel = rel_err(out[1][k].cpu(), ref)
            log(f"  fixed_mg_cycles={cycles} {k}: max rel diff {rel:.3e} (limit 1e-10)")
            if not rel <= 1e-10:
                raise AssertionError(f"GPU MG step disagrees with CPU on {k}: {rel}")


def phase_mlmg(dev, card, n=256, reps=3):
    from iamr_tpu_torch.ops.mg_nodal import N_PERIODIC, NodalBC, nodal_solve
    from iamr_tpu_torch.ops.np_nodal import np_div_cell_to_node, np_residual_nodal

    log(f"phase 11: nodal MLMG to rtol 1e-11 at {n}^3 (f64, mixed f32 V-cycles)")
    dx = (1.0 / n,) * 3
    bc = NodalBC((N_PERIODIC,) * 3, (N_PERIODIC,) * 3)
    rng = np.random.RandomState(11)
    x = (np.arange(n) + 0.5) / n
    X, Y, _ = np.meshgrid(x, x, x, indexing="ij")
    sigma = 1.0 / (1.0 + 0.5 * np.sin(2 * np.pi * X) * np.cos(2 * np.pi * Y))
    u = tuple(rng.rand(n, n, n) - 0.5 for _ in range(3))
    rhs = np_div_cell_to_node(u, dx, bc)
    own = np.ones(rhs.shape)
    own[-1] = own[:, -1] = own[:, :, -1] = 0.0
    rhs = rhs - (rhs * own).sum() / own.sum()
    rhs_t = torch.as_tensor(rhs, device=dev)
    sigma_t = torch.as_tensor(sigma, device=dev)
    solve = lambda: nodal_solve(rhs_t, sigma_t, dx, bc, rtol=1e-11, atol=0.0, mixed=True)
    solve()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        phi, res, cycles = solve()
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / reps
    r_true = np_residual_nodal(phi.cpu().numpy(), rhs, sigma, None, dx, bc)
    rel = float(np.abs(r_true).max()) / float(np.abs(rhs).max())
    log(f"  mlmg_rtol1e11_seconds {secs:.6f} cycles {cycles} true relative residual "
        f"{rel:.3e} (numpy f64 oracle; limit 1e-11) on {card}")
    if not rel <= 1e-11:
        raise AssertionError(f"nodal MLMG true residual {rel} above 1e-11")

    log("phase 11b: nodal divergence after 3 MG steps, HIT 32^3, f32 and f64")
    from iamr_tpu_torch.ns.advance import advance, make_hit_forcing
    from iamr_tpu_torch.ns.probs import init_state

    quality = {}
    for dtype in ("float32", "float64"):
        cfg = hit_config(32, dtype, dev, fft_solve=0)
        state = init_state(cfg, dev)
        state = state._replace(dt=torch.tensor(5e-3, dtype=cfg.tdtype, device=dev))
        hit = make_hit_forcing(cfg)
        for _ in range(3):
            state = advance(state, cfg, 4, hit=hit)
        quality[dtype] = divergence_report(cfg, state)["max_div_over_umax_dx"]
    ratio = quality["float32"] / quality["float64"]
    log(f"  nodal_div_norm_f32_32cubed {quality['float32']:.6e} nodal_div_norm_f64_32cubed "
        f"{quality['float64']:.6e} nodal_div_f32_over_f64 {ratio:.6e}")
    return {"mlmg_rtol1e11_seconds": secs, "mlmg_rtol1e11_cycles": int(cycles),
            "mlmg_final_rel_resid": rel, "nodal_div_f32_over_f64": ratio}


# tests/test_outflow.py's fluid at rest under gravity with a lateral outflow
# face, made 3D
REST3D = """
amr.n_cell = {n} {n} {n}
ns.dtype = {dtype}
ns.cfl = 0.5
ns.init_iter = 2
ns.gravity = -9.8
geometry.prob_lo = 0. 0. 0.
geometry.prob_hi = 1. 1. 1.
geometry.is_periodic = 0 0 0
ns.lo_bc = 4 4 5
ns.hi_bc = 2 4 4
prob.probtype = 1
"""


def inputs_config(text, dev):
    from iamr_tpu_torch.config.parmparse import ParmParse
    from iamr_tpu_torch.ns.state import config_from_inputs

    return config_from_inputs(ParmParse.from_string(text), device=dev)


def example_pp(name, *overrides):
    """The inputs of examples/<name> with `key=value` overrides."""
    from iamr_tpu_torch.config.parmparse import ParmParse

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", name)
    return ParmParse.from_file(path, overrides)


def example_config(name, dev, *overrides):
    """The config of examples/<name> with `key=value` overrides."""
    from iamr_tpu_torch.ns.state import config_from_inputs

    return config_from_inputs(example_pp(name, *overrides), device=dev)


def rt_config(cells, dtype, dev, *overrides):
    """Rayleigh-Taylor (examples/inputs.{2,3}d.rayleigh_taylor) at `cells`."""
    return example_config(f"inputs.{len(cells)}d.rayleigh_taylor", dev,
                          "amr.n_cell=" + " ".join(map(str, cells)), f"ns.dtype={dtype}",
                          *overrides)


def capture_calls(fn, targets):
    """Run fn() with each wrapper of targets ((module, name, key)) wrapped:
    key(args, kwargs) names a call worth keeping (or None); the first call
    of each name is kept, its tensors cloned. Returns {name: (args, kwargs)}."""
    kept, saved = {}, []

    def clone(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, (tuple, list)):
            return type(x)(clone(v) for v in x)
        if isinstance(x, dict):
            return {k: clone(v) for k, v in x.items()}
        return x

    for mod, name, key in targets:
        orig = getattr(mod, name)
        saved.append((mod, name, orig))

        def wrap(*args, _orig=orig, _key=key, **kwargs):
            k = _key(args, kwargs)
            if k is not None and k not in kept:
                kept[k] = (clone(args), clone(kwargs))
            return _orig(*args, **kwargs)

        setattr(mod, name, wrap)
    try:
        fn()
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)
    return kept


def step_kernel_inputs(cfg, state, cycles, gk, mk, eb=None):
    """The kernels' inputs of one fixed-cycle step from `state` (with the
    EB geometry eb): K1's, K2's, the finest level's first MAC and CN cell
    calls with sweeps and the residual, and the finest level's first nodal
    call with sweeps and the residual (the projection). The MAC solve's
    calls have a = 0, or under EB a = b = 1 (alpha the covered mask); the
    CN solves' a = 1 and b = theta or theta dt."""
    from iamr_tpu_torch.ns import advance as adv

    fine = tuple(cfg.geom.ncell)
    nodes = tuple(x + 1 for x in fine)

    def cell_key(args, kw):
        phi, a, b, nsweeps, want = args[0], args[4], args[5], args[9], args[10]
        if tuple(phi.shape) == fine and nsweeps > 0 and want:
            mac = a == 0.0 or (eb is not None and not torch.is_tensor(b) and b == 1.0)
            return "cell_mac" if mac else "cell_cn"
        return None

    def nodal_key(args, kw):
        if tuple(args[0].shape) == nodes and args[6] > 0 and args[7]:
            return "nodal"
        return None

    return capture_calls(lambda: adv.advance(state, cfg, cycles, eb=eb), [
        (gk, "extrap_plm", lambda a, k: "extrap_plm"),
        (adv, "godunov_plm_multi", lambda a, k: "godunov_plm_multi"),
        (mk, "cell_smooth", cell_key),
        (mk, "nodal_jacobi", nodal_key),
    ])


def copies_gap(args):
    """How far a nodal call's periodic copies (node n - 1 against node 0)
    of phi and rhs lie apart: a solve leaves them a rounding of the
    residual's terms apart, and the kernel, as its plain version, updates
    each from its own values."""
    from iamr_tpu_torch.ops.mg_nodal import N_PERIODIC

    gap = 0.0
    for d, kind in enumerate(args[4]):
        if kind == N_PERIODIC:
            for a in (args[0], args[2]):
                gap = max(gap, float((a.narrow(d, a.shape[d] - 1, 1) - a.narrow(d, 0, 1))
                                     .abs().max()))
    return gap


def mg_pairs_on_step(label, kept, mk, dtype, card, timed=True,
                     keys=("cell_mac", "cell_cn", "nodal")):
    """The captured MG calls (keys naming cell calls hold "cell", the others
    are nodal; by default cell MAC, cell CN, nodal) against their plain
    versions (check_pairs), and their times beside the plain versions'.
    Returns {key: (max_abs_err, ms, plain_ms, bytes)}."""
    out = {}
    for key in keys:
        if key not in kept:
            continue
        args, kw = kept[key]
        cell = "cell" in key
        if not cell:
            log(f"  {label} {key} call: the periodic copies of phi and rhs lie up to "
                f"{copies_gap(args):.3e} apart (compared as they are)")
        kern = mk.cell_smooth if cell else mk.nodal_jacobi
        plain = mk.cell_smooth_ref if cell else mk.nodal_jacobi_ref
        if cell:
            diag = mk.cell_diag(*args[2:9])
        else:
            diag = mk.nodal_diag_mask(args[1], args[3], args[4], args[5])[0]
        got, ref = kern(*args, **kw), plain(*args, **kw)
        # the residual after the sweeps sums diag * phi_out (a V-cycle's
        # pre-smooth starts from phi = 0)
        m = max(float(args[0].abs().max()), float(ref[0].abs().max()))
        err = check_pairs(f"{label} {key} {tuple(args[0].shape)}", zip(got, ref), dtype,
                          (m, float(diag.abs().max()) * m))
        if timed:
            k_ms, p_ms = timed_pair(lambda: kern(*args, **kw), lambda: plain(*args, **kw))
            nbytes = tensor_bytes(args, kw, [t for t in got if t is not None])
            b_ms = 1e3 * nbytes / HBM_BYTES_PER_S
            log(f"  {label} {key}: {k_ms:.4f} ms, plain {p_ms:.4f} ms, bytes bound "
                f"{b_ms:.4f} ms ({100 * b_ms / k_ms:.1f}% of it) ({card})")
            out[key] = (err, k_ms, p_ms, nbytes)
    return out


def run_steps(step, state, steps, gk, mk):
    """One warm-up step, then `steps` timed ones (host clock ending in a
    synchronize); the kernels' wrapper calls of each step."""
    per_step = []

    def one(st):
        gk.reset_launches()
        mk.reset_launches()
        out = step(st)
        per_step.append(dict(gk.LAUNCHES, **mk.LAUNCHES))
        return out

    t0 = time.perf_counter()
    state = one(state)
    torch.cuda.synchronize()
    log(f"  warm-up step {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    for _ in range(steps):
        state = one(state)
    torch.cuda.synchronize()
    return state, (time.perf_counter() - t0) / steps, per_step


def phase_rt3d(dev, gk, mk, card, cells=(256, 256, 512), steps=3, cycles=4):
    from iamr_tpu_torch.ns import driver
    from iamr_tpu_torch.ns.advance import advance, make_step

    log(f"phase 12: Rayleigh-Taylor {cells} f32, fixed_mg_cycles={cycles}, initialize "
        f"(hydrostatic pressure) + 1 warm-up + {steps} timed steps")
    torch.zeros((), device=dev)  # the allocator starts before its statistics reset
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = rt_config(cells, "float32", dev)
    t0 = time.perf_counter()
    state = driver.initialize(cfg, fixed_mg_cycles=cycles, device=dev, init_iters=0)
    torch.cuda.synchronize()
    log(f"  initialize {time.perf_counter() - t0:.3f} s, dt {float(state.dt):.6e}")
    step = make_step(cfg, cycles)
    want = dict(expected_mg_launches(cells, cycles, cn_solves(cfg)), extrap_plm=1,
                godunov_plm_multi=1)
    state, s_step, per_step = run_steps(step, state, steps, gk, mk)
    log(f"  launches per step: {per_step[-1]} (expected {want}; {cn_solves(cfg)} CN solves)")
    if any(c != want for c in per_step):
        raise AssertionError(f"launch counts per step {per_step} != {want}")
    check_state(state)
    ncells = int(np.prod(cells))
    log(f"  {s_step:.6f} s/step, {ncells / s_step:.6e} cells/s on {card}")
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    log("  one more step under set_sync_debug_mode('error'): no host sync")
    rows = profile_step(lambda: step(state), card, top=15)
    dev_ms = sum(getattr(e, "self_device_time_total", 0.0) for e in rows) / 1e3
    check_profiled_launches(rows, want)
    _, umac = advance(state, cfg, cycles, return_umac=True)
    div = divergence_report(cfg, state, umac)
    if not div["max_mac_div_over_umax_dx"] < 1e-2:
        raise AssertionError(f"MAC divergence after {cycles} V-cycles: {div}")
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"  max_memory_allocated {peak / 2**30:.3f} GiB, max|u| "
        f"{float(state.vel.abs().max()):.6e}, time {float(state.time):.6e}")
    return cfg, state, {"rt3d_s_per_step": s_step, "rt3d_cells_per_s": ncells / s_step,
                        "rt3d_device_ms": dev_ms, "rt3d_max_mem_gib": peak / 2**30,
                        **{f"rt3d_{k}": v for k, v in div.items()}}


def phase_rt3d_kernels(dev, gk, mk, card, cfg, state, cycles=4):
    log(f"phase 12b: the kernels on Rayleigh-Taylor {cfg.geom.ncell}'s own inputs, "
        "kernel vs plain (K1/K2 bit for bit; MG to the largest summed term)")
    kept = step_kernel_inputs(cfg, state, cycles, gk, mk)
    missing = {"extrap_plm", "godunov_plm_multi", "cell_mac", "cell_cn", "nodal"} - set(kept)
    if missing:
        raise AssertionError(f"the step made no such call: {missing}")
    out = {}
    for name, kern, plain in (("extrap_plm", gk.extrap_plm, gk.extrap_plm_ref),
                              ("godunov_plm_multi", gk.godunov_plm_multi,
                               gk.godunov_plm_multi_ref)):
        args, kw = kept[name]
        got, ref = kern(*args, **kw), plain(*args, **kw)
        pairs = list(zip(got, ref)) if name == "extrap_plm" else list(zip(flat(got), flat(ref)))
        err = check_f32(f"{name} RT {cfg.geom.ncell}", pairs, gk)
        if not all(torch.equal(g, r) for g, r in pairs):
            raise AssertionError(f"{name}: not bit for bit on Rayleigh-Taylor's inputs")
        k_ms, p_ms = timed_pair(lambda: kern(*args, **kw), lambda: plain(*args, **kw))
        # inputs the kernel reads (K2 takes the face velocities from umac_g
        # alone) and its outputs
        nbytes = tensor_bytes(args[:2] if name == "extrap_plm" else (args[0], args[2], args[7]),
                              got)
        b, by = bound(nbytes, count_ops(lambda: plain(*args, **kw)))
        log(f"  {name}: {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b:.4f} ms by {by} "
            f"({100 * b / k_ms:.1f}%), nc = {len(args[0]) if name != 'extrap_plm' else 3} "
            f"({card})")
        out[name] = (err, k_ms, p_ms)
    for key, (err, k_ms, p_ms, _) in mg_pairs_on_step("RT", kept, mk, torch.float32,
                                                     card).items():
        out[key] = (err, k_ms, p_ms)
    return {f"rt3d_{k}_ms": v[1] for k, v in out.items()}


def phase_rt3d_entry(dev, cells=(128, 128, 256)):
    from iamr_tpu_torch.ns import driver

    log(f"phase 13: driver.initialize (hydrostatic pressure, 1 pressure iteration) + "
        f"driver.run 2 steps, tolerance mode, Rayleigh-Taylor {cells} f32")
    cfg = rt_config(cells, "float32", dev)
    t0 = time.perf_counter()
    state = driver.initialize(cfg, device=dev)
    state = driver.run(cfg, state, max_steps=2)
    torch.cuda.synchronize()
    check_state(state)
    log(f"  initialize + 2 steps: {time.perf_counter() - t0:.3f} s, time "
        f"{float(state.time):.6e}, max|u| {float(state.vel.abs().max()):.6e}")


def gpu_vs_cpu(label, cfg, dev, cycles, steps=2, perturb=1e-3, ebs=(None, None)):
    """initialize (no pressure iterations) on both devices, compared; the
    CPU state with a seeded velocity perturbation on both; `steps` steps of
    make_step on both, compared: max|GPU - CPU| / max|CPU| <= 1e-10 on
    every field. ebs: the EB geometry on the CPU and on the card."""
    from iamr_tpu_torch.ns import driver
    from iamr_tpu_torch.ns.advance import make_step

    cpu = torch.device("cpu")
    init = [driver.initialize(cfg, fixed_mg_cycles=cycles, device=w, init_iters=0, eb=eb)
            for w, eb in zip((cpu, dev), ebs)]
    noise = perturb * np.random.RandomState(3).randn(*init[0].vel.shape)
    st = init[0]._replace(vel=init[0].vel + torch.as_tensor(noise))
    states = [st, type(st)(*[None if t is None else t.to(dev) for t in st])]
    steps_fn = [make_step(cfg, cycles, eb=eb) for eb in ebs]
    for _ in range(steps):
        states = [f(v) for f, v in zip(steps_fn, states)]
    worst = 0.0
    for stage, pair in (("init", init), (f"{steps} steps", states)):
        for k in pair[0]._fields:
            ref, got = getattr(pair[0], k), getattr(pair[1], k)
            if ref is None and got is None:
                continue
            rel = rel_err(got.cpu(), ref)
            worst = max(worst, rel)
            if not rel <= 1e-10:
                raise AssertionError(f"{label} {stage}: GPU disagrees with CPU on {k}: {rel}")
    log(f"  {label}, fixed_mg_cycles={cycles}: max rel diff {worst:.3e} over every field "
        "(limit 1e-10)")
    return worst


def phase_gpu_cpu_walled(dev):
    log("phase 14: walled runs, GPU (kernels) vs CPU (plain), f64, initialize + 2 steps")
    rt = rt_config((16, 16, 32), "float64", dev)
    out = {}
    for cycles in (4, None):
        out[f"rt3d_{cycles}"] = gpu_vs_cpu("RT (16, 16, 32)", rt, dev, cycles)
    out["hotspot3d"] = gpu_vs_cpu("HotSpot 16^3 (do_temp)", example_config(
        "inputs.3d.hotspot", dev, "ns.dtype=float64"), dev, 4)
    out["rt3d_mom_diff"] = gpu_vs_cpu(
        "RT (16, 16, 32) do_mom_diff do_denminmax",
        rt_config((16, 16, 32), "float64", dev, "ns.do_mom_diff=1", "ns.do_denminmax=1"),
        dev, 4)
    return max(out.values())


def phase_2d(dev, gk, mk, card, cells=(1024, 2048), steps=3, cycles=4):
    from iamr_tpu_torch.ns import driver
    from iamr_tpu_torch.ns.advance import make_step

    log(f"phase 15: Rayleigh-Taylor 2D {cells} f32, fixed_mg_cycles={cycles}, 1 warm-up + "
        f"{steps} timed steps (Godunov plain in 2D by design)")
    cfg = rt_config(cells, "float32", dev)
    state = driver.initialize(cfg, fixed_mg_cycles=cycles, device=dev, init_iters=0)
    step = make_step(cfg, cycles)
    want = dict(expected_mg_launches(cells, cycles, cn_solves(cfg)), extrap_plm=0,
                godunov_plm_multi=0)
    state, s_step, per_step = run_steps(step, state, steps, gk, mk)
    log(f"  launches per step: {per_step[-1]} (expected {want})")
    if any(c != want for c in per_step):
        raise AssertionError(f"launch counts per step {per_step} != {want}")
    check_state(state)
    ncells = int(np.prod(cells))
    log(f"  {s_step:.6f} s/step, {ncells / s_step:.6e} cells/s on {card}")
    rows = profile_step(lambda: step(state), card, top=8)
    dev_ms = sum(getattr(e, "self_device_time_total", 0.0) for e in rows) / 1e3
    check_profiled_launches(rows, want)
    log("phase 15: the 2D MG kernels vs plain on Rayleigh-Taylor 2D's finest level")
    mg_pairs_on_step("RT 2D", step_kernel_inputs(cfg, state, cycles, gk, mk), mk,
                     torch.float32, card)
    log("phase 15: the lid-driven cavity 64^2 (examples/inputs.2d.lid_driven_cavity), "
        "f64, GPU vs CPU")
    lid = example_config("inputs.2d.lid_driven_cavity", dev, "ns.dtype=float64")
    worst = max(gpu_vs_cpu("lid 64^2", lid, dev, cycles) for cycles in (4, None))
    return {"rt2d_s_per_step": s_step, "rt2d_cells_per_s": ncells / s_step,
            "rt2d_device_ms": dev_ms, "lid_gpu_cpu_rel": worst}


def phase_hydrostatic_rest(dev, n=64, steps=3):
    from iamr_tpu_torch.ns import driver

    log(f"phase 15b: fluid at rest under gravity with a lateral outflow face, {n}^3, "
        f"{steps} steps (driver.run from initialize), f32 and f64")
    out = {}
    for dtype in ("float32", "float64"):
        cfg = inputs_config(REST3D.format(n=n, dtype=dtype), dev)
        state = driver.run(cfg, max_steps=steps, device=dev)
        check_state(state)
        out[dtype] = float(state.vel.abs().max())
        log(f"  {dtype}: max|u| {out[dtype]:.6e} after {steps} steps, max|p| "
            f"{float(state.p.abs().max()):.6e}")
    # the JAX package's 2D test holds the fluid to 2e-3
    if not out["float64"] < 2e-3 or not out["float32"] < 2e-2:
        raise AssertionError(f"the fluid at rest moved: {out}")
    return {"rest_max_u_f32": out["float32"], "rest_max_u_f64": out["float64"]}


CLI_WROTE = re.compile(r"^WROTE (.+) (\S+): (\d+) bytes in ([0-9.]+) s$", re.M)
CLI_STEP = re.compile(r"^STEP (\d+) .* wall ([0-9.]+) s$", re.M)
CLI_CALLS = re.compile(r"^kernel calls: (\{.*\})$", re.M)


class CliRun:
    """`python -m iamr_tpu_torch inputs overrides...` started in cwd, on the
    card; finish() waits for it and returns its stdout, wall seconds and
    kernel calls (a non-zero exit fails); kill() stops it."""

    def __init__(self, inputs, overrides, cwd, label):
        os.makedirs(cwd, exist_ok=True)
        self.label = label
        tmp = os.path.dirname(cwd)
        self.out_path = os.path.join(tmp, os.path.basename(cwd) + ".stdout")
        self.err_path = os.path.join(tmp, os.path.basename(cwd) + ".stderr")
        env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        with open(self.out_path, "w") as out, open(self.err_path, "w") as err:
            self.t0 = time.perf_counter()
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "iamr_tpu_torch", inputs, *overrides], cwd=cwd,
                env=env, stdout=out, stderr=err, stdin=subprocess.DEVNULL)

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def finish(self, card, note="", timeout=600):
        rc = self.proc.wait(timeout=timeout)
        secs = time.perf_counter() - self.t0
        with open(self.out_path) as f:
            stdout = f.read()
        if rc != 0:
            with open(self.err_path) as f:
                raise RuntimeError(f"{self.label}: the CLI exited {rc}:\n{stdout[-3000:]}\n"
                                   f"{f.read()[-3000:]}")
        calls = json.loads(CLI_CALLS.findall(stdout)[-1])
        log(f"  {self.label}: {secs:.3f} s wall for the CLI run{note}; kernel calls {calls} "
            f"({card})")
        for what, path, nbytes, wsecs in CLI_WROTE.findall(stdout):
            log(f"    wrote {what} {path}: {int(nbytes)} bytes in {float(wsecs):.4f} s, "
                f"{int(nbytes) / float(wsecs) / 1e9:.3f} GB/s{note} ({card})")
        return stdout, secs, calls


def same_files(a, b, skip=("job_info",)):
    """The files under a and b are the same: equal bytes, and for an npz
    (whose zip entries carry their write time) equal arrays; job_info
    aside."""
    import filecmp

    def tree(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    if os.path.isfile(a):
        pairs = [(a, b)]
    elif tree(a) != tree(b):
        raise AssertionError(f"{a} and {b} hold other files: {tree(a)} vs {tree(b)}")
    else:
        pairs = [(os.path.join(a, rel), os.path.join(b, rel)) for rel in tree(a)
                 if os.path.basename(rel) not in skip]
    for fa, fb in pairs:
        if fa.endswith(".npz"):
            with np.load(fa) as za, np.load(fb) as zb:
                same = sorted(za.files) == sorted(zb.files) and all(
                    za[k].dtype == zb[k].dtype and np.array_equal(za[k], zb[k])
                    for k in za.files)
        else:
            same = filecmp.cmp(fa, fb, shallow=False)
        if not same:
            raise AssertionError(f"{fa} and {fb} differ")


def phase_cli(card, spectral_s_step, n=256, nparticles=65536, rt_cells=(128, 128, 256)):
    import shutil
    import tempfile

    from iamr_tpu_torch.io.plotfile import read_plotfile

    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    out = {}
    runs = []
    try:
        log(f"phase 16a: python -m iamr_tpu_torch, HIT {n}^3 f32 (spectral), {nparticles} "
            f"particles, 4 steps, plotfile at 4, npz checkpoints at 2 and 4; restart from 2")
        pos = np.random.RandomState(16).rand(nparticles, 3) - 0.5
        init = os.path.join(tmp, "particles.txt")
        with open(init, "w") as f:
            f.write(f"{nparticles}\n" + "".join("%.17g %.17g %.17g\n" % tuple(p) for p in pos))
        hit = os.path.join(root, "examples", "inputs.3d.hit_forced")
        over = [f"amr.n_cell={n} {n} {n}", "max_step=4", "amr.plot_int=4", "amr.check_int=2",
                "ns.sum_interval=1", "amr.run_log=runlog", f"particles.particle_init_file={init}",
                "particles.particle_output_file=particles.out"]
        a, b = os.path.join(tmp, "hit"), os.path.join(tmp, "hit_restart")
        runs.append(CliRun(hit, over, a, "HIT straight"))
        stdout, out["cli_hit_s"], calls = runs[-1].finish(card)
        want = {"extrap_plm": 4, "godunov_plm_multi": 4, "mg_cell_gsrb": 0}
        if any(calls[k] != v for k, v in want.items()) or calls["mg_nodal_jacobi"] < 1:
            raise AssertionError(f"kernel calls {calls}: want {want} and the initial "
                                 "projection's nodal calls")
        walls = [float(w) for _, w in CLI_STEP.findall(stdout)]
        log(f"  step wall seconds (host clock, each ending in the step's host read) {walls}; "
            f"phase 5: {spectral_s_step:.6f} s/step ({card})")
        out["cli_hit_step_s"] = walls

        # the HIT restart and the straight RT run share the card (the
        # figures above are the HIT run's alone)
        log(f"phase 16b: python -m iamr_tpu_torch, Rayleigh-Taylor {rt_cells} f32, tolerance "
            "mode, AMReX checkpoints every step, 2 steps, beside the HIT restart from "
            "chk00002; then the RT restart from chk00001")
        rt = os.path.join(root, "examples", "inputs.3d.rayleigh_taylor")
        rt_over = ["amr.n_cell=" + " ".join(str(c) for c in rt_cells), "max_step=2",
                   "amr.check_int=1", "amr.checkpoint_format=amrex", "ns.sum_interval=1"]
        ra, rb = os.path.join(tmp, "rt"), os.path.join(tmp, "rt_restart")
        runs.append(CliRun(hit, over + [f"amr.restart={os.path.join(a, 'chk00002')}"], b,
                           "HIT restart from chk00002"))
        runs.append(CliRun(rt, rt_over, ra, "RT straight"))
        shared = " (two CLI runs on the card)"
        _, out["cli_hit_restart_s"], calls = runs[-2].finish(card, shared)
        if calls != {"extrap_plm": 2, "godunov_plm_multi": 2, "mg_cell_gsrb": 0,
                     "mg_nodal_jacobi": 0}:
            raise AssertionError(f"restart kernel calls {calls}")
        _, out["cli_rt_s"], calls = runs[-1].finish(card, shared)
        # one pressure iteration (an advance) in initialize, then 2 steps
        if (calls["extrap_plm"], calls["godunov_plm_multi"]) != (3, 3) or min(
                calls["mg_cell_gsrb"], calls["mg_nodal_jacobi"]) < 1:
            raise AssertionError(f"kernel calls {calls}")
        runs.append(CliRun(rt, rt_over + [f"amr.restart={os.path.join(ra, 'chk00001')}"], rb,
                           "RT restart from chk00001"))

        for name in ("chk00004", "plt00004", "particles.out"):
            same_files(os.path.join(a, name), os.path.join(b, name))
        log("  HIT: the restart's chk00004 (state.npz, particles.npz, meta.json), plt00004 and "
            "particles.out equal the straight run's bit for bit")
        with np.load(os.path.join(b, "chk00004", "state.npz")) as z:
            st = {k: z[k] for k in ("vel", "rho", "trac")}
        with np.load(os.path.join(b, "chk00004", "particles.npz")) as z:
            alive = int(z["alive"].sum())
        fields, _ = read_plotfile(os.path.join(b, "plt00004"))
        for name, ref in (("x_velocity", st["vel"][0]), ("y_velocity", st["vel"][1]),
                          ("z_velocity", st["vel"][2]), ("density", st["rho"]),
                          ("tracer", st["trac"][0])):
            if not np.array_equal(fields[name], ref.astype(np.float64)):
                raise AssertionError(f"plotfile {name} is not the checkpoint's field")
        with open(os.path.join(b, "particles.out")) as f:
            written = int(f.readline())
        count = int(fields["particle_count"].sum())
        if not count == alive == written:
            raise AssertionError(f"particle_count sums to {count}; {alive} alive, "
                                 f"{written} written")
        log(f"  HIT: plotfile fields equal the checkpoint's; particle_count sums to {count} = "
            f"live particles ({card})")
        del fields, st

        _, out["cli_rt_restart_s"], calls = runs[-1].finish(card)
        if (calls["extrap_plm"], calls["godunov_plm_multi"]) != (1, 1) or min(
                calls["mg_cell_gsrb"], calls["mg_nodal_jacobi"]) < 1:
            raise AssertionError(f"restart kernel calls {calls}")
        same_files(os.path.join(ra, "chk00002"), os.path.join(rb, "chk00002"))
        log("  RT: the restart's chk00002 equals the straight run's byte for byte")
    finally:
        for run in runs:
            run.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def les_config(n, dtype, dev, model="Smagorinsky"):
    """HIT (HIT_INPUTS) at n^3 with ns.do_LES = 1 and the LES model, Cs at
    its default (Smagorinsky 0.18, Sigma 1.5)."""
    from iamr_tpu_torch.config.parmparse import ParmParse
    from iamr_tpu_torch.ns.state import config_from_inputs

    text = HIT_INPUTS.format(n=n, dtype=dtype, init_iter=0, fft_solve=-1)
    text += f"ns.do_LES = 1\nns.LES_model = {model}\n"
    return config_from_inputs(ParmParse.from_string(text), device=dev)


def phase_les(dev, gk, mk, card, start, steps=3, cycles=4):
    """start: phase 9's HIT state and particles (HIT's numpy initial
    condition at 256^3 takes seconds to build)."""
    from iamr_tpu_torch.ns import les
    from iamr_tpu_torch.ns.advance import advance, make_hit_forcing, make_step_with_particles
    from iamr_tpu_torch.ns.bcprovider import PhysBCProvider

    state, parts = start
    n, nparticles = state.rho.shape[0], parts.pos.shape[0]
    log(f"phase 17: HIT {n}^3 f32 with LES (Smagorinsky, Cs 0.18), {nparticles} particles, "
        f"fixed_mg_cycles={cycles}, from phase 9's state, 1 warm-up + {steps} timed steps")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = les_config(n, "float32", dev)
    # spectral=True on purpose: the step itself turns the FFT solvers off
    # under LES (variable viscosity), so the MG kernels must run
    step = make_step_with_particles(cfg, cycles, spectral=True)
    want = dict(expected_mg_launches((n,) * 3, cycles, cn_solves(cfg)), extrap_plm=1,
                godunov_plm_multi=1)
    (state, parts), s_step, per_step = run_steps(lambda c: step(*c), (state, parts), steps,
                                                 gk, mk)
    log(f"  launches per step: {per_step[-1]} (expected {want}; {cn_solves(cfg)} tensor-solve "
        "passes of one V-cycle each)")
    if any(c != want for c in per_step):
        raise AssertionError(f"launch counts per step {per_step} != {want}")
    check_state(state, parts)
    log(f"  {s_step:.6f} s/step, {n**3 / s_step:.6e} cells/s on {card}")
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(state, parts)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    log("  one more step under set_sync_debug_mode('error'): no host sync")
    rows = profile_step(lambda: step(state, parts), card, top=12)
    dev_ms = sum(getattr(e, "self_device_time_total", 0.0) for e in rows) / 1e3
    check_profiled_launches(rows, want)
    _, umac = advance(state, cfg, cycles, hit=make_hit_forcing(cfg), return_umac=True)
    div = divergence_report(cfg, state, umac)
    if not div["max_mac_div_over_umax_dx"] < 1e-2:
        raise AssertionError(f"MAC divergence after {cycles} V-cycles: {div}")
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"  max_memory_allocated {peak / 2**30:.3f} GiB, max|u| "
        f"{float(state.vel.abs().max()):.6e}")
    # the finest call of the first inner tensor solve (variable mu), as
    # captured (the MAC and nodal calls are phase 9's operators)
    kept = step_kernel_inputs(cfg, state, cycles, gk, mk)
    out = {f"les_{k}_ms": v[1] for k, v in mg_pairs_on_step(
        "LES", {"cell_cn": kept["cell_cn"]}, mk, torch.float32, card).items()}

    log("phase 17: one Sigma step (ns.LES_model = Sigma, Cs 1.5) and its eigenvalue solve")
    scfg = les_config(n, "float32", dev, "Sigma")
    sstep = make_step_with_particles(scfg, cycles)
    sstep(state, parts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sstate, sparts = sstep(state, parts)
    torch.cuda.synchronize()
    sigma_s = time.perf_counter() - t0
    check_state(sstate, sparts)
    G = les._cc_gradients(scfg, PhysBCProvider(scfg), state.vel)
    g = torch.stack([torch.stack([G[i][j] for j in range(3)], dim=-1) for i in range(3)], dim=-2)
    gtg = torch.einsum("...ki,...kj->...ij", g, g)
    eig_ms = cuda_ms(lambda: les.gram_eigenvalues(gtg), 3)
    log(f"  Sigma step {sigma_s:.6f} s (host clock), torch.linalg.eigvalsh of {n**3} 3x3 "
        f"f32 matrices ({les.EIG_BATCH} a call) {eig_ms:.4f} ms ({card})")
    return {"les_s_per_step": s_step, "les_device_ms": dev_ms,
            "les_max_mem_gib": peak / 2**30, "les_sigma_step_s": sigma_s,
            "les_eigvalsh_ms": eig_ms, **{f"les_{k}": v for k, v in div.items()}, **out}


# the advection variants and the Godunov kernels each step calls (K1, K2)
VARIANTS = (("Godunov_PPM", "ns.advection_scheme=Godunov_PPM", (0, 0)),
            ("BDS", "ns.advection_scheme=BDS", (1, 0)),
            ("use_forces_in_trans", "godunov.use_forces_in_trans=1", (0, 0)))


def phase_variants(dev, gk, mk, card, init, steps=2, cycles=4):
    """init: phase 12's Rayleigh-Taylor state, from which each variant
    steps."""
    from iamr_tpu_torch.ns.advance import make_step

    cells = tuple(init.rho.shape)
    log(f"phase 18: the advection variants on Rayleigh-Taylor {cells} f32, "
        f"fixed_mg_cycles={cycles}, from phase 12's state, 1 warm-up + {steps} timed "
        "steps each")
    out = {}
    ncells = int(np.prod(cells))
    for name, line, (k1, k2) in VARIANTS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        cfg = rt_config(cells, "float32", dev, line)
        step = make_step(cfg, cycles)
        want = dict(expected_mg_launches(cells, cycles, cn_solves(cfg)), extrap_plm=k1,
                    godunov_plm_multi=k2)
        state, s_step, per_step = run_steps(step, init, steps, gk, mk)
        log(f"  {name}: launches per step {per_step[-1]} (expected {want})")
        if any(c != want for c in per_step):
            raise AssertionError(f"{name}: launch counts per step {per_step} != {want}")
        check_state(state)
        rows = profile_step(lambda: step(state), card, top=8)
        dev_ms = sum(getattr(e, "self_device_time_total", 0.0) for e in rows) / 1e3
        check_profiled_launches(rows, want)
        peak = torch.cuda.max_memory_allocated(dev)
        log(f"  {name}: {s_step:.6f} s/step, {ncells / s_step:.6e} cells/s, {dev_ms:.3f} ms "
            f"device time a step, max_memory_allocated {peak / 2**30:.3f} GiB ({card})")
        out.update({f"{name}_s_per_step": s_step, f"{name}_device_ms": dev_ms,
                    f"{name}_max_mem_gib": peak / 2**30})
        del state
    return out


def rz_mac_divergence(cfg, state, umac):
    """max|(1/r) d(r u)/dr + dw/dz - S| dx / max|u| of the projected MAC
    velocities, S the MAC source of the step (the thermal divergence and
    its dt/2 dsdt centring); also without S."""
    from iamr_tpu_torch.ns.advance import _thermal_divu, rz_radii
    from iamr_tpu_torch.ns.bcprovider import PhysBCProvider

    dx = cfg.geom.dx
    r_cell, r_face = rz_radii(cfg, umac[0].dtype, umac[0].device)
    fr = r_face * umac[0]
    div = torch.diff(fr, dim=0) / dx[0] / r_cell + torch.diff(umac[1], dim=1) / dx[1]
    src = _thermal_divu(cfg, PhysBCProvider(cfg), state.temp, state.rho)
    if src is not None and state.dsdt is not None:
        src = src + 0.5 * state.dt * state.dsdt
    scale = max(float(state.vel.abs().max()), 1e-30) / dx[0]
    raw = float(div.abs().max()) / scale
    res = raw if src is None else float((div - src).abs().max()) / scale
    log(f"  RZ MAC divergence: max|div - S| dx/umax {res:.6e}, max|div| dx/umax {raw:.6e}")
    return res, raw


def phase_rz(dev, gk, mk, card, cells=(1024, 2048), steps=3, cycles=4):
    """Returns the metrics and the started CLI run (finish_rz_cli ends it)."""
    import tempfile

    from iamr_tpu_torch.ns import driver
    from iamr_tpu_torch.ns.advance import advance, make_step

    log(f"phase 19: HotSpot-RZ {cells} f32 (examples/inputs.2d.hotspot_rz), "
        f"fixed_mg_cycles={cycles}, driver.initialize + 1 warm-up + {steps} timed steps")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = example_config("inputs.2d.hotspot_rz", dev, "amr.n_cell=" + " ".join(map(str, cells)),
                         "ns.dtype=float32")
    t0 = time.perf_counter()
    state = driver.initialize(cfg, fixed_mg_cycles=cycles, device=dev, init_iters=0)
    torch.cuda.synchronize()
    log(f"  initialize {time.perf_counter() - t0:.3f} s (radius-weighted projection, no "
        f"hydrostatic pressure), dt {float(state.dt):.6e}")
    step = make_step(cfg, cycles)
    want = dict(expected_mg_launches(cells, cycles, cn_solves(cfg)), extrap_plm=0,
                godunov_plm_multi=0)
    state, s_step, per_step = run_steps(step, state, steps, gk, mk)
    log(f"  launches per step: {per_step[-1]} (expected {want}; {cn_solves(cfg)} CN solves)")
    if any(c != want for c in per_step):
        raise AssertionError(f"launch counts per step {per_step} != {want}")
    check_state(state)
    ncells = int(np.prod(cells))
    log(f"  {s_step:.6f} s/step, {ncells / s_step:.6e} cells/s on {card}")
    rows = profile_step(lambda: step(state), card, top=8)
    dev_ms = sum(getattr(e, "self_device_time_total", 0.0) for e in rows) / 1e3
    check_profiled_launches(rows, want)
    _, umac = advance(state, cfg, cycles, return_umac=True)
    res, raw = rz_mac_divergence(cfg, state, umac)
    if not res < 1e-2:
        raise AssertionError(f"RZ MAC divergence after {cycles} V-cycles: {res}")
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"  max_memory_allocated {peak / 2**30:.3f} GiB, max|u| "
        f"{float(state.vel.abs().max()):.6e}, max T {float(state.temp.max()):.6e}")
    log("phase 19: the 2D MG kernels vs plain on HotSpot-RZ's captured finest calls (the "
        "axis faces' beta = 0)")
    kept = step_kernel_inputs(cfg, state, cycles, gk, mk)
    missing = {"cell_mac", "cell_cn", "nodal"} - set(kept)
    if missing:
        raise AssertionError(f"the RZ step made no such call: {missing}")
    axis = float(kept["cell_mac"][0][3][0].narrow(0, 0, 1).abs().max())
    log(f"  the MAC call's beta on the axis faces: max {axis:.3e}")
    out = {f"rz_{k}_ms": v[1] for k, v in mg_pairs_on_step("RZ", kept, mk, torch.float32,
                                                             card).items()}
    log("phase 19: python -m iamr_tpu_torch examples/inputs.2d.hotspot_rz "
        "amr.n_cell=\"128 256\" max_step=2, started (finished after phase 20)")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rz_")
    inputs = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples",
                          "inputs.2d.hotspot_rz")
    run = CliRun(inputs, ["amr.n_cell=128 256", "max_step=2"], os.path.join(tmp, "rz"),
                 "HotSpot-RZ 128x256")
    return {"rz_s_per_step": s_step, "rz_device_ms": dev_ms, "rz_max_mem_gib": peak / 2**30,
            "rz_mac_div_over_umax_dx": res, "rz_mac_div_raw_over_umax_dx": raw, **out}, (run, tmp)


def finish_rz_cli(started, card):
    """The RZ CLI run of phase 19: its kernel calls must name the MG
    kernels (and no Godunov kernel: 2D)."""
    import shutil

    run, tmp = started
    try:
        _, secs, calls = run.finish(card, " (beside phase 20)")
        if calls["extrap_plm"] or calls["godunov_plm_multi"] or min(
                calls["mg_cell_gsrb"], calls["mg_nodal_jacobi"]) < 1:
            raise AssertionError(f"RZ CLI kernel calls {calls}")
    finally:
        run.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    return {"rz_cli_s": secs}


def phase_gpu_cpu_variants(dev):
    from iamr_tpu_torch.ns import driver
    from iamr_tpu_torch.ns.advance import make_step

    log("phase 20: the slice's variants, GPU (kernels) vs CPU (plain), f64, initialize + "
        "2 steps")
    out = {}
    for model in ("Smagorinsky", "Sigma"):
        out[f"les_{model}"] = gpu_vs_cpu(f"HIT 16^3 LES {model}",
                                         les_config(16, "float64", dev, model), dev, 4)
    for name, line, _ in VARIANTS:
        out[f"rt3d_{name}"] = gpu_vs_cpu(f"RT (16, 16, 32) {name}",
                                         rt_config((16, 16, 32), "float64", dev, line), dev, 4)
    out["rt2d_bds"] = gpu_vs_cpu("RT 2D (32, 64) BDS", rt_config(
        (32, 64), "float64", dev, "ns.advection_scheme=BDS"), dev, 4)
    out["hotspot_rz"] = gpu_vs_cpu("HotSpot-RZ (32, 64)", example_config(
        "inputs.2d.hotspot_rz", dev, "amr.n_cell=32 64", "ns.dtype=float64"), dev, 4)
    # an unknown scheme name runs as Godunov_PLM, bit for bit on each device
    for where in (torch.device("cpu"), dev):
        states = []
        for scheme in ("Godunov_PLM", "Godunov_Fancy"):
            cfg = rt_config((16, 16, 32), "float64", dev, f"ns.advection_scheme={scheme}")
            st = driver.initialize(cfg, fixed_mg_cycles=4, device=where, init_iters=0)
            noise = 1e-3 * np.random.RandomState(3).randn(*st.vel.shape)
            st = st._replace(vel=st.vel + torch.as_tensor(noise, device=where))
            step = make_step(cfg, 4)
            states.append(step(step(st)))
        for k in ("vel", "rho", "trac", "p", "gradp", "dt"):
            if not torch.equal(getattr(states[0], k), getattr(states[1], k)):
                raise AssertionError(f"unknown scheme != Godunov_PLM on {where} ({k})")
        log(f"  ns.advection_scheme=Godunov_Fancy equals Godunov_PLM bit for bit on {where}")
    return max(out.values())

FPC3D = "inputs.3d.flow_past_cylinder"


def eb_mac_divergence(cfg, state, umac, eb):
    """max|sum_d d(afrac u)/dx_d - vfrac S| over the fluid cells, dx / max|u|,
    of the projected MAC velocities (S = 0: no thermal source)."""
    from iamr_tpu_torch.ns.checks import check_div_cond

    scale = max(float(state.vel.abs().max()), 1e-30) / cfg.geom.dx[0]
    res = float(check_div_cond(umac, cfg.geom.dx, eb=eb)) / scale
    log(f"  cut-cell MAC divergence: max|div - vfrac S| fluid dx/umax {res:.6e}")
    return res


def phase_eb(dev, gk, mk, card, cells=(512, 128, 128), steps=3, cycles=4):
    """Returns the metrics and the started CLI run (finish_eb_cli ends it)."""
    import tempfile

    from iamr_tpu_torch.eb.geom import eb_from_inputs
    from iamr_tpu_torch.ns import driver
    from iamr_tpu_torch.ns.advance import advance, make_step
    from iamr_tpu_torch.ns.state import config_from_inputs

    log(f"phase 21: EB, the flow past a cylinder {cells} f32 (examples/{FPC3D}), "
        f"fixed_mg_cycles={cycles}, the geometry, driver.initialize + 1 warm-up + {steps} "
        "timed steps")
    pp = example_pp(FPC3D, "amr.n_cell=" + " ".join(map(str, cells)), "ns.dtype=float32")
    cfg = config_from_inputs(pp, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    eb = eb_from_inputs(pp, cfg.geom, dtype=cfg.dtype, device=dev)
    torch.cuda.synchronize()
    geom_s = time.perf_counter() - t0
    geom_gib = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
    ncov, ncut = (int(x) for x in torch.stack([
        eb.covered.sum(), ((eb.vfrac > 0) & (eb.vfrac < 1)).sum()]).tolist())
    log(f"  geometry (ss = 8, {int(np.prod(cells)) * 512:.3e} samples): {geom_s:.3f} s, peak "
        f"{geom_gib:.3f} GiB above the {base / 2**30:.3f} GiB held before; {ncov} covered, "
        f"{ncut} cut cells ({card})")
    if not (ncov > 0 and ncut > 0):
        raise AssertionError("the cylinder covers or cuts no cell")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = driver.initialize(cfg, fixed_mg_cycles=cycles, device=dev, eb=eb)
    torch.cuda.synchronize()
    log(f"  initialize {time.perf_counter() - t0:.3f} s (EB initial projection, "
        f"{cfg.init_iter} pressure iteration), dt {float(state.dt):.6e}")
    step = make_step(cfg, cycles, eb=eb)
    want = dict(expected_mg_launches(cells, cycles, cn_solves(cfg)), extrap_plm=1,
                godunov_plm_multi=0)
    state, s_step, per_step = run_steps(step, state, steps, gk, mk)
    log(f"  launches per step: {per_step[-1]} (expected {want}; {cn_solves(cfg)} CN solves)")
    if any(c != want for c in per_step):
        raise AssertionError(f"launch counts per step {per_step} != {want}")
    check_state(state)
    ncells = int(np.prod(cells))
    log(f"  {s_step:.6f} s/step, {ncells / s_step:.6e} cells/s on {card}")
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    log("  one more step under set_sync_debug_mode('error'): no host sync")
    rows = profile_step(lambda: step(state), card, top=15)
    dev_ms = sum(getattr(e, "self_device_time_total", 0.0) for e in rows) / 1e3
    check_profiled_launches(rows, want)
    # the steps' peak: the checks below call advance alone, which forms
    # StateRedist's geometry terms again beside those the step holds
    peak = torch.cuda.max_memory_allocated(dev)
    covered_u = float(torch.where(eb.covered > 0, state.vel.abs(), 0.0).max())
    log(f"  max|u| in covered cells {covered_u!r}")
    if covered_u != 0.0:
        raise AssertionError(f"covered cells carry velocity {covered_u}")
    _, umac = advance(state, cfg, cycles, return_umac=True, eb=eb)
    mac_div = eb_mac_divergence(cfg, state, umac, eb)
    if not mac_div < 1e-2:
        raise AssertionError(f"cut-cell MAC divergence after {cycles} V-cycles: {mac_div}")
    log(f"  max_memory_allocated {peak / 2**30:.3f} GiB, max|u| "
        f"{float(state.vel.abs().max()):.6e}, time {float(state.time):.6e}")
    log("phase 21: K1 and the MG kernels vs plain on the EB step's captured calls")
    kept = step_kernel_inputs(cfg, state, cycles, gk, mk, eb=eb)
    missing = {"extrap_plm", "cell_mac", "cell_cn", "nodal"} - set(kept)
    if missing or "godunov_plm_multi" in kept:
        raise AssertionError(f"the EB step's calls: missing {missing}, K2 "
                             f"{'godunov_plm_multi' in kept}")
    args, kw = kept["extrap_plm"]
    got, ref = gk.extrap_plm(*args, **kw), gk.extrap_plm_ref(*args, **kw)
    check_f32(f"extrap_plm EB {cells}", list(zip(got, ref)), gk)
    if not all(torch.equal(g, r) for g, r in zip(got, ref)):
        raise AssertionError("extrap_plm: not bit for bit on the EB step's inputs")
    k_ms, p_ms = timed_pair(lambda: gk.extrap_plm(*args, **kw),
                            lambda: gk.extrap_plm_ref(*args, **kw))
    log(f"  extrap_plm: {k_ms:.4f} ms, plain {p_ms:.4f} ms, bit for bit ({card})")
    alpha_mac = kept["cell_mac"][0][2]
    log(f"  the MAC call: a = {kept['cell_mac'][0][4]}, alpha in "
        f"[{float(alpha_mac.min())}, {float(alpha_mac.max())}] (the covered mask), "
        f"{int((kept['cell_mac'][0][3][0] == 0).sum())} x-faces with beta = 0")
    out = {f"eb_{k}_ms": v[1] for k, v in mg_pairs_on_step("EB", kept, mk, torch.float32,
                                                             card).items()}
    out["eb_extrap_plm_ms"] = k_ms
    log(f"phase 21: python -m iamr_tpu_torch examples/{FPC3D} amr.n_cell=\"128 32 32\" "
        "max_step=2, started (finished after phase 22)")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_eb_")
    inputs = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", FPC3D)
    run = CliRun(inputs, ["amr.n_cell=128 32 32", "max_step=2"], os.path.join(tmp, "eb"),
                 "flow past a cylinder 128x32x32")
    return {"eb_geometry_s": geom_s, "eb_geometry_gib": geom_gib, "eb_s_per_step": s_step,
            "eb_device_ms": dev_ms, "eb_max_mem_gib": peak / 2**30,
            "eb_mac_div_over_umax_dx": mac_div, **out}, (run, tmp)


def finish_eb_cli(started, card):
    """The EB CLI run of phase 21: its kernel calls must name K1 and the MG
    kernels, and not K2."""
    import shutil

    run, tmp = started
    try:
        _, secs, calls = run.finish(card, " (beside phase 22)")
        if calls["godunov_plm_multi"] or min(calls["extrap_plm"], calls["mg_cell_gsrb"],
                                             calls["mg_nodal_jacobi"]) < 1:
            raise AssertionError(f"EB CLI kernel calls {calls}")
    finally:
        run.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    return {"eb_cli_s": secs}


# the cylinder (and the tracer blob) widened so that covered cells (and a
# tracer) exist at the GPU-vs-CPU sizes, as in tests/test_torch_eb_steps.py
EB_SMALL = {2: ("amr.n_cell=32 16", "eb2.sphere_radius=0.2", "prob.blob_radius=0.2"),
            3: ("amr.n_cell=16 8 8", "eb2.cylinder_radius=0.3", "prob.blob_radius=0.2")}


def phase_gpu_cpu_eb(dev):
    from iamr_tpu_torch.eb.geom import eb_from_inputs
    from iamr_tpu_torch.ns.state import config_from_inputs

    log("phase 22: EB, GPU (kernels) vs CPU (plain), f64, initialize + 2 steps")
    out = {}
    for dim in (2, 3):
        for rtype in ("StateRedist", "FluxRedist"):
            pp = example_pp(f"inputs.{dim}d.flow_past_cylinder", *EB_SMALL[dim],
                            "ns.dtype=float64", f"ns.redistribution_type={rtype}")
            cfg = config_from_inputs(pp, device=dev)
            ebs = [eb_from_inputs(pp, cfg.geom, dtype=cfg.dtype, device=w)
                   for w in (torch.device("cpu"), dev)]
            for k, a in ebs[0]._asdict().items():
                b = getattr(ebs[1], k)
                for x, y in zip(a if isinstance(a, tuple) else (a,),
                                b if isinstance(b, tuple) else (b,)):
                    # aeb_vol takes a square root, which torch rounds
                    # correctly on the card and within an ulp on the CPU
                    same = (rel_err(y.cpu(), x) <= 1e-14 if k == "aeb_vol"
                            else torch.equal(x, y.cpu()))
                    if not same:
                        raise AssertionError(f"{dim}D geometry: the card's {k} differs from "
                                             "the CPU's")
            for cycles in (4, None):
                out[f"{dim}d_{rtype}_{cycles}"] = gpu_vs_cpu(
                    f"flow past a cylinder {dim}D {cfg.geom.ncell} {rtype}", cfg, dev,
                    cycles, ebs=ebs)
    log("  the geometry built on the card equals the CPU's, every field (aeb_vol to 1e-14)")
    return max(out.values())


# ---------------------------------------------------------------------------
# AMR on single-box levels (phases 23-25)

AMR_RT3D = "inputs.3d.rayleigh_taylor_amr"


def expected_ml_launches(cfg, spec, cycles):
    """Wrapper calls of one subcycled two-level coarse step in fixed-cycle
    mode: the coarse advance, `ratio` fine advances (each by
    expected_mg_launches on its own box), then the sync: the mac_sync cell
    solve, one Vsync CN solve per velocity component (with viscosity) and
    one Ssync solve per diffusing tracer (cycles V-cycles each, on the
    coarse level), and n_fac = 2 FAC iterations of a coarse and a fine
    nodal solve; K1 and K2 once a level advance (3D PLM)."""
    from iamr_tpu_torch.amr.multilevel import make_fine_config

    r = spec.ratio
    cfg_f = make_fine_config(cfg, spec)
    c = expected_mg_launches(cfg.geom.ncell, cycles, cn_solves(cfg))
    f = expected_mg_launches(spec.ncell, cycles, cn_solves(cfg_f))
    nsync = 1 + (cfg.dim if cfg.vel_visc_coef > 0.0 else 0) + sum(
        1 for t in range(cfg.ntrac) if t < len(cfg.scal_diff_coefs) and cfg.scal_diff_coefs[t] > 0.0)
    return {
        "mg_cell_gsrb": c["mg_cell_gsrb"] + r * f["mg_cell_gsrb"]
        + nsync * solve_calls(cfg.geom.ncell, cycles, False),
        "mg_nodal_jacobi": c["mg_nodal_jacobi"] + r * f["mg_nodal_jacobi"]
        + 2 * (solve_calls(cfg.geom.ncell, cycles, True) + solve_calls(spec.ncell, cycles, True)),
        "extrap_plm": 1 + r, "godunov_plm_multi": 1 + r}


def composite_mass(cfg, spec, ml):
    """Mass of the uncovered coarse cells and the fine level (f64 sums)."""
    from iamr_tpu_torch.amr.hierarchy import crse_region

    rc = ml.crse.rho.to(torch.float64).clone()
    rc[crse_region(spec)] = 0.0
    vc = cfg.geom.cell_volume
    return float(rc.sum() * vc + ml.fine.rho.to(torch.float64).sum() * (vc / spec.ratio**cfg.dim))


def level_mac_divergence(cfgs, states, umacs):
    """Each level's max|div u_mac| dx / max|u|."""
    out = []
    for c, st, um in zip(cfgs, states, umacs):
        dx = c.geom.dx
        div = float(sum(torch.diff(um[d], dim=d) / dx[d] for d in range(c.dim)).abs().max())
        out.append(div * dx[0] / max(float(st.vel.abs().max()), 1e-30))
    return out


def phase_amr_rt3d(dev, gk, mk, card, rt3d_device_ms, steps=4, cycles=4):
    """Returns the metrics and (cfg, MLState, spec) for phase 23b."""
    from iamr_tpu_torch.amr import multilevel as aml
    from iamr_tpu_torch.amr.tagging import parse_refinement_indicators
    from iamr_tpu_torch.ns import driver
    from iamr_tpu_torch.ns.state import config_from_inputs

    pp = example_pp(AMR_RT3D, "ns.dtype=float32")
    cfg = config_from_inputs(pp, device=dev)
    tags = parse_refinement_indicators(pp)
    regrid_int = int(pp.query("amr.regrid_int"))
    log(f"phase 23: two-level Rayleigh-Taylor {cfg.geom.ncell} x ratio {cfg.ref_ratio} f32 "
        f"(examples/{AMR_RT3D}), subcycled, fixed_mg_cycles={cycles}, ns/driver.py's two-level "
        f"start (tags, the composite pressure iteration), 1 warm-up + {steps} timed coarse "
        f"steps, tagged again every {regrid_int}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    ml, spec = driver.initialize_multilevel(cfg, cycles, dev, error_tags=tags, subcycle=True)
    torch.cuda.synchronize()
    log(f"  start {time.perf_counter() - t0:.3f} s: fine patch lo {spec.lo} n {spec.ncell} "
        f"({int(np.prod(spec.ncell))} cells over {int(np.prod(cfg.geom.ncell))} coarse), "
        f"dt {float(ml.crse.dt):.6e}")
    fns = {}

    def step_of(sp):
        if sp not in fns:
            fns[sp] = aml.make_two_level_step(cfg, sp, cycles, subcycle=True)
        return fns[sp]

    mass0, n, walls = None, 0, []

    def coarse_step(ml, spec, timed):
        nonlocal n
        t0 = time.perf_counter()
        regrid = n > 0 and n % regrid_int == 0
        if regrid:
            before = spec
            ml, spec = driver.regrid_two_level(cfg, ml, spec, tags, subcycle=True)
            log(f"  regrid before step {n + 1}: patch lo {before.lo} n {before.ncell} -> lo "
                f"{spec.lo} n {spec.ncell}")
        gk.reset_launches()
        mk.reset_launches()
        ml = step_of(spec)(ml)
        torch.cuda.synchronize()
        n += 1
        wall = time.perf_counter() - t0
        calls = dict(gk.LAUNCHES, **mk.LAUNCHES)
        want = expected_ml_launches(cfg, spec, cycles)
        log(f"  coarse step {n}{' (regrid)' if regrid else ''}: {wall:.4f} s, patch "
            f"{spec.ncell}, wrapper calls {calls} (expected {want})")
        if calls != want:
            raise AssertionError(f"coarse step {n}: calls {calls} != {want}")
        for lev in ml:
            check_state(lev)
        if timed:
            walls.append((regrid, wall, spec.ncell))
        return ml, spec

    # a warm-up and steps - 1 timed coarse steps (one regrid among them),
    # then the checks on the patch they ended on, then the last timed step,
    # which regrids again
    for k in range(steps):
        ml, spec = coarse_step(ml, spec, k > 0)
        if k == 0:
            mass0 = composite_mass(cfg, spec, ml)
    step = step_of(spec)
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(ml)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    log(f"  one more coarse step on the patch {spec.ncell} (no regrid) under "
        "set_sync_debug_mode('error'): no host sync")
    rows = profile_step(lambda: step(ml), card, top=15)
    dev_ms = sum(getattr(e, "self_device_time_total", 0.0) for e in rows) / 1e3
    check_profiled_launches(rows, expected_ml_launches(cfg, spec, cycles))
    cfgs = aml.hierarchy_configs(cfg, [spec])
    _, umacs = aml.advance_hierarchy_subcycled((ml.crse, ml.fine), cfg, [spec], cycles,
                                               return_umacs=True)
    divs = level_mac_divergence(cfgs, ml, umacs)
    log(f"  MAC divergence over umax/dx: coarse {divs[0]:.3e}, fine (subcycle average) "
        f"{divs[1]:.3e}")
    if not max(divs) < 1e-2:
        raise AssertionError(f"MAC divergence after {cycles} V-cycles: {divs}")
    log(f"  device time of a coarse step on the patch {spec.ncell}: {dev_ms:.3f} ms; phase "
        f"12's single-level RT3D (the same finest dx) {rt3d_device_ms:.3f} ms a step, "
        f"{2 * rt3d_device_ms:.3f} ms for the two steps of the same physical time ({card})")
    profiled = spec.ncell
    ml, spec = coarse_step(ml, spec, True)
    drift = (composite_mass(cfg, spec, ml) - mass0) / mass0
    plain_walls = [w for r, w, _ in walls if not r]
    s_step = sum(plain_walls) / len(plain_walls)
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"  {s_step:.6f} s per coarse step without a regrid (host clock; patches "
        f"{[c for r, _, c in walls if not r]}), with a regrid "
        f"{[(round(w, 6), c) for r, w, c in walls if r]}; composite mass drift over "
        f"{n - 1} steps {drift:.3e} (f32 state, f64 sums); max_memory_allocated "
        f"{peak / 2**30:.3f} GiB ({card})")
    return {"amr_rt3d_patch": [list(spec.lo), list(spec.ncell)], "amr_rt3d_s_per_step": s_step,
            "amr_rt3d_device_ms": dev_ms, "amr_rt3d_profiled_patch": list(profiled),
            "amr_rt3d_max_mem_gib": peak / 2**30, "amr_rt3d_mass_drift": drift,
            "amr_rt3d_mac_div": divs,
            "amr_rt3d_regrid_s": [(w, list(c)) for r, w, c in walls if r]}, (cfg, ml, spec)


def phase_amr_kernels(dev, gk, mk, card, cfg, ml, spec, cycles=4):
    from iamr_tpu_torch.amr import multilevel as aml
    from iamr_tpu_torch.ns import advance as adv

    log(f"phase 23b: the kernels on the fine level's ({spec.ncell}) captured calls and on a "
        "captured FAC sync solve, kernel vs plain (K1/K2 bit for bit; MG to MG_TOL)")
    fine = tuple(spec.ncell)
    nodes = tuple(x + 1 for x in fine)
    in_sync = [False]
    orig_fac = aml.sync_project_composite

    def fac(*a, **k):
        in_sync[0] = True
        try:
            return orig_fac(*a, **k)
        finally:
            in_sync[0] = False

    def cell_key(args, kw):
        if tuple(args[0].shape) == fine and args[9] > 0 and args[10]:
            return "fine_cell_mac" if args[4] == 0.0 else "fine_cell_cn"
        return None

    def nodal_key(args, kw):
        if tuple(args[0].shape) == nodes and args[6] > 0 and args[7]:
            return "fac_nodal" if in_sync[0] else "fine_nodal"
        return None

    aml.sync_project_composite = fac
    try:
        kept = capture_calls(lambda: aml.advance_two_level_subcycled(ml, cfg, spec, cycles), [
            (gk, "extrap_plm", lambda a, k: "extrap_plm" if tuple(a[4]) == fine else None),
            (adv, "godunov_plm_multi",
             lambda a, k: "godunov_plm_multi" if tuple(a[5]) == fine else None),
            (mk, "cell_smooth", cell_key), (mk, "nodal_jacobi", nodal_key)])
    finally:
        aml.sync_project_composite = orig_fac
    missing = {"extrap_plm", "godunov_plm_multi", "fine_cell_mac", "fine_cell_cn", "fine_nodal",
               "fac_nodal"} - set(kept)
    if missing:
        raise AssertionError(f"the coarse step made no such fine-level call: {missing}")
    out = {}
    for name, kern, plain in (("extrap_plm", gk.extrap_plm, gk.extrap_plm_ref),
                              ("godunov_plm_multi", gk.godunov_plm_multi,
                               gk.godunov_plm_multi_ref)):
        args, kw = kept[name]
        got, ref = kern(*args, **kw), plain(*args, **kw)
        pairs = list(zip(got, ref)) if name == "extrap_plm" else list(zip(flat(got), flat(ref)))
        check_f32(f"{name} fine level {fine}", pairs, gk)
        if not all(torch.equal(g, r) for g, r in pairs):
            raise AssertionError(f"{name}: not bit for bit on the fine level's inputs")
        k_ms, p_ms = timed_pair(lambda: kern(*args, **kw), lambda: plain(*args, **kw))
        log(f"  {name} fine level: {k_ms:.4f} ms, plain {p_ms:.4f} ms, bit for bit ({card})")
        out[name] = k_ms
    mac_args = kept["fine_cell_mac"][0]
    log(f"  the fine MAC call's BC kinds lo {mac_args[7]} hi {mac_args[8]} (1 = Dirichlet: "
        "the coarse-fine sides)")
    for key, (err, k_ms, p_ms, _) in mg_pairs_on_step(
            "AMR", kept, mk, torch.float32, card,
            keys=("fine_cell_mac", "fine_cell_cn", "fine_nodal", "fac_nodal")).items():
        out[key] = k_ms
    return {f"amr_{k}_ms": v for k, v in out.items()}


def ml_gpu_vs_cpu(label, cfg, dev, cycles, specs, subcycle=True, ebs=None, nparticles=0,
                  steps=2):
    """A hierarchy (specs nested from cfg's level) started on both devices
    (initialize without pressure iterations, the finer levels interpolated
    from the coarser; ebs: a HierarchyEB per device), compared; a seeded
    1e-3 velocity perturbation on every level of the CPU's, copied to the
    card; `steps` coarse steps on each (two levels: make_two_level_step,
    with nparticles particles make_two_level_step_with_particles; more:
    advance_hierarchy_subcycled), compared on every field of every level
    (and the particles) to 1e-10 of max|CPU|."""
    from iamr_tpu_torch.amr import multilevel as aml
    from iamr_tpu_torch.ns import driver
    from iamr_tpu_torch.ns.particles import from_positions

    cpu = torch.device("cpu")
    cfgs = aml.hierarchy_configs(cfg, specs)
    starts = []
    for w, e in zip((cpu, dev), ebs or (None, None)):
        sts = [driver.initialize(cfg, cycles, w, init_iters=0, eb=e.level0 if e else None)]
        for lev, sp in enumerate(specs):
            f = aml.init_fine_from_coarse(cfgs[lev], sp, sts[-1])
            sts.append(f._replace(vel=f.vel * e.fine(sp).fluid) if e else f)
        starts.append(sts)
    rng = np.random.RandomState(3)
    cpu_sts = [st._replace(vel=st.vel + torch.as_tensor(1e-3 * rng.randn(*st.vel.shape)))
               for st in starts[0]]
    to = lambda st: type(st)(*[None if t is None else t.to(dev) for t in st])
    states = [cpu_sts, [to(st) for st in cpu_sts]]
    parts = [None, None]
    if nparticles:
        pos = np.random.RandomState(5).uniform(-0.5, 0.5, (nparticles, cfg.dim))
        parts = [from_positions(pos, w, torch.float64) for w in (cpu, dev)]
    for i, e in enumerate(ebs or (None, None)):
        if len(specs) > 1:
            fn = lambda sts, _: (list(aml.advance_hierarchy_subcycled(sts, cfg, specs, cycles)),
                                 None)
        elif nparticles:
            f2 = aml.make_two_level_step_with_particles(cfg, specs[0], cycles, subcycle)
            fn = lambda sts, p, f2=f2: (lambda o: (list(o[0]), o[1]))(f2(aml.MLState(*sts), p))
        else:
            f2 = aml.make_two_level_step(cfg, specs[0], cycles, subcycle,
                                         ebs=[e.level0, e.fine(specs[0])] if e else None)
            fn = lambda sts, _, f2=f2: (list(f2(aml.MLState(*sts))), None)
        for _ in range(steps):
            states[i], parts[i] = fn(states[i], parts[i])
    worst = 0.0
    for stage, pair in (("start", starts), (f"{steps} steps", states)):
        for lev, (ref_st, got_st) in enumerate(zip(*pair)):
            for k in ref_st._fields:
                ref, got = getattr(ref_st, k), getattr(got_st, k)
                if ref is None and got is None:
                    continue
                rel = rel_err(got.cpu(), ref)
                worst = max(worst, rel)
                if not rel <= 1e-10:
                    raise AssertionError(f"{label} {stage}: level {lev} {k} differs: {rel}")
    if nparticles:
        rel = rel_err(parts[1].pos.cpu(), parts[0].pos)
        worst = max(worst, rel)
        if not (rel <= 1e-10 and torch.equal(parts[1].alive.cpu(), parts[0].alive)):
            raise AssertionError(f"{label}: the particles differ: {rel}")
    log(f"  {label}, fixed_mg_cycles={cycles}: max rel diff {worst:.3e} over every field of "
        f"{len(specs) + 1} levels (limit 1e-10)")
    return worst


SEEDED_RT = 919


def seeded_rt(cfg, X, fields):
    """Rayleigh-Taylor's density and tracer with a smooth seeded velocity
    (a few random Fourier modes): no face of the first steps on a Riemann
    tie, where the two devices' roundoff could pick differently."""
    frac = 0.5 * (1.0 + np.tanh((X[-1] - 0.5) / 0.05))
    fields["rho"][...] = 1.0 + frac
    fields["trac"][0] = frac
    rng = np.random.RandomState(11)
    L = [h - l for l, h in zip(cfg.geom.prob_lo, cfg.geom.prob_hi)]
    for d in range(cfg.dim):
        for _ in range(3):
            k = rng.randint(1, 3, size=cfg.dim)
            arg = sum(2 * np.pi * k[e] * X[e] / L[e] for e in range(cfg.dim))
            fields["vel"][d] += 0.5 * rng.randn() * np.sin(arg + 2 * np.pi * rng.rand())


def phase_gpu_cpu_amr(dev):
    from iamr_tpu_torch import plugins
    from iamr_tpu_torch.amr.hierarchy import LevelSpec
    from iamr_tpu_torch.amr.tagging import parse_refinement_indicators
    from iamr_tpu_torch.eb.geom import psi_from_inputs
    from iamr_tpu_torch.ns import driver
    from iamr_tpu_torch.ns.state import config_from_inputs

    log("phase 24: AMR, GPU (kernels) vs CPU (plain), f64, initialize + 2 coarse steps")
    out = {}
    f64 = "ns.dtype=float64"
    rt2 = rt_config((32, 64), "float64", dev, "amr.max_level=1")
    for sub in (True, False):
        out[f"rt2d_sub{int(sub)}"] = ml_gpu_vs_cpu(
            f"RT 2D 32x64 two-level {'subcycled' if sub else 'composite'}", rt2, dev, 4,
            [driver.default_fine_spec(rt2)], subcycle=sub)
    rt3 = rt_config((16, 16, 32), "float64", dev, "amr.max_level=1")
    out["rt3d"] = ml_gpu_vs_cpu("RT3D 16x16x32 two-level", rt3, dev, 4,
                                [driver.default_fine_spec(rt3)])
    hs = example_config("inputs.3d.hotspot", dev, "amr.n_cell=16 16 16", f64, "amr.max_level=1")
    out["hotspot"] = ml_gpu_vs_cpu("HotSpot 3D 16^3 two-level (do_temp)", hs, dev, 4,
                                   [driver.default_fine_spec(hs)])
    pp = example_pp("inputs.2d.flow_past_cylinder", *EB_SMALL[2], f64, "amr.max_level=1")
    fpc = config_from_inputs(pp, device=dev)
    ebs = [driver.HierarchyEB(psi_from_inputs(pp, 2), fpc, w) for w in (torch.device("cpu"), dev)]
    spec = driver.fine_spec_from_tags(fpc, None, None, ebs[0], True)[0]
    out["eb"] = ml_gpu_vs_cpu(f"flow past a cylinder 2D 32x16 two-level EB (patch {spec})", fpc,
                              dev, 4, [spec], ebs=ebs)
    hit = example_config("inputs.3d.hit_forced", dev, "amr.n_cell=16 16 16", f64,
                         "amr.max_level=1")
    out["hit_particles"] = ml_gpu_vs_cpu("HIT 16^3 two-level, 256 particles", hit, dev, 4,
                                         [driver.default_fine_spec(hit)], nparticles=256)
    rt2_3 = rt_config((32, 64), "float64", dev, "amr.max_level=2")
    specs = [LevelSpec(lo=(16, 32), ncell=(32, 64)), LevelSpec(lo=(16, 32), ncell=(32, 64))]
    out["rt2d_3lev"] = ml_gpu_vs_cpu("RT 2D 32x64 three-level (nested specs)", rt2_3, dev, 4,
                                     specs)
    # a tagged run that regrids (run_multilevel on each device)
    plugins.problem_ic(SEEDED_RT)(seeded_rt)
    try:
        pp = example_pp("inputs.2d.rayleigh_taylor", "amr.n_cell=32 64", f64, "amr.max_level=1",
                        f"prob.probtype={SEEDED_RT}", "amr.refinement_indicators=denerr",
                        "amr.denerr.field_name=density",
                        "amr.denerr.adjacent_difference_greater=0.05")
        runs = []
        for w in (torch.device("cpu"), dev):
            cfg = config_from_inputs(pp, device=w)
            runs.append(driver.run_multilevel(cfg, max_steps=4, fixed_mg_cycles=4, subcycle=True,
                                              error_tags=parse_refinement_indicators(pp),
                                              regrid_int=2, device=w))
    finally:
        plugins.PROBLEM_ICS.pop(SEEDED_RT)
    worst = 0.0
    for lev, (a, b) in enumerate(zip(*runs)):
        if a.rho.shape != b.rho.shape:
            raise AssertionError(f"tagged run: level {lev} shapes {a.rho.shape} {b.rho.shape}")
        for k in a._fields:
            if getattr(a, k) is not None:
                worst = max(worst, rel_err(getattr(b, k).cpu(), getattr(a, k)))
    if not worst <= 1e-10:
        raise AssertionError(f"tagged RT 2D run: GPU vs CPU {worst}")
    log(f"  tagged RT 2D 32x64, regrid every 2 steps, 4 steps: max rel diff {worst:.3e} "
        f"(fine patch {tuple(runs[0].fine.rho.shape)})")
    out["tagged"] = worst
    return max(out.values())


def phase_amr_cli(card, cells=(32, 32, 64)):
    """Started before phase 24; finish_amr_cli ends it."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_amr_")
    inputs = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", AMR_RT3D)
    over = ["amr.n_cell=" + " ".join(map(str, cells)), "max_step=4", "amr.check_int=2",
            "amr.plot_int=4", "amr.checkpoint_format=amrex", "ns.dtype=float64"]
    log(f"phase 25: python -m iamr_tpu_torch examples/{AMR_RT3D} {' '.join(over)} "
        "(f64: the inputs' tolerance-mode solves converge), started (beside phase 24)")
    a = os.path.join(tmp, "amr")
    return CliRun(inputs, over, a, f"two-level RT {cells}"), (inputs, over, tmp, a)


def finish_amr_cli(started, card):
    import shutil

    run, (inputs, over, tmp, a) = started
    runs = [run]
    try:
        stdout, secs, calls = run.finish(card, " (beside phase 24)")
        if min(calls["extrap_plm"], calls["godunov_plm_multi"], calls["mg_cell_gsrb"],
               calls["mg_nodal_jacobi"]) < 1:
            raise AssertionError(f"AMR CLI kernel calls {calls}")
        regrids = re.findall(r"^REGRID .*$", stdout, re.M)
        log(f"  regrids: {regrids}")
        for name in ("chk00002", "chk00004", "plt00004"):
            with open(os.path.join(a, name, "Header")) as f:
                head = f.read().split("\n")
            levels = int(head[4]) if name.startswith("chk") else int(
                head[4 + int(head[1])])
            if levels != 1:
                raise AssertionError(f"{name}: finest level {levels}, not 1")
        b = os.path.join(tmp, "amr_restart")
        runs.append(CliRun(inputs, over + [f"amr.restart={os.path.join(a, 'chk00002')}"], b,
                           "two-level RT restart from chk00002"))
        _, secs_r, calls_r = runs[-1].finish(card)
        same_files(os.path.join(a, "chk00004"), os.path.join(b, "chk00004"))
        same_files(os.path.join(a, "plt00004"), os.path.join(b, "plt00004"))
        log("  the restart's chk00004 (two levels, AMReX format) and plt00004 equal the "
            "straight run's byte for byte")
    finally:
        for r in runs:
            r.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    return {"amr_cli_s": secs, "amr_cli_restart_s": secs_r}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"phase 1: torch.cuda.get_device_name: {kind}; device_count "
        f"{torch.cuda.device_count()}; torch {torch.__version__} (CUDA {torch.version.cuda})")

    from iamr_tpu_torch import native
    from iamr_tpu_torch.ops import godunov_kernels as gk
    from iamr_tpu_torch.ops import mg_kernels as mk

    t_start = t0 = time.perf_counter()
    native.kernels()
    log(f"phase 2: kernels built in {time.perf_counter() - t0:.3f} s "
        f"(nvcc {native.BUILD_INFO['seconds']:.3f} s, cached {native.BUILD_INFO['cached']})")
    for line in native.ptxas_report():
        log(f"  ptxas {line}")

    def timed(phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        torch.cuda.synchronize()
        log(f"  {phase.__name__} took {time.perf_counter() - t0:.1f} s")
        return out

    timed(phase_kernels, dev, gk)
    spectral_s_step, records = timed(phase_slice, dev, gk, mk, smi)
    timed(phase_cpu_parity, dev)
    timed(phase_cell_kernel, dev, mk)
    timed(phase_nodal_kernel, dev, mk)
    mg_records, mg_metrics, hit_state = timed(phase_mg_slice, dev, gk, mk, smi)
    timed(phase_entry_point, dev)
    mg_metrics.update(timed(phase_mlmg, dev, smi))
    rt_cfg, rt_state, rt_metrics = timed(phase_rt3d, dev, gk, mk, smi)
    mg_metrics.update(rt_metrics)
    mg_metrics.update(timed(phase_rt3d_kernels, dev, gk, mk, smi, rt_cfg, rt_state))
    timed(phase_rt3d_entry, dev)
    mg_metrics["walled_gpu_cpu_rel"] = timed(phase_gpu_cpu_walled, dev)
    mg_metrics.update(timed(phase_2d, dev, gk, mk, smi))
    mg_metrics.update(timed(phase_hydrostatic_rest, dev))
    mg_metrics.update(timed(phase_cli, smi, spectral_s_step))
    mg_metrics.update(timed(phase_les, dev, gk, mk, smi, hit_state))
    del hit_state
    mg_metrics.update(timed(phase_variants, dev, gk, mk, smi, rt_state))
    del rt_state
    rz_metrics, rz_cli = timed(phase_rz, dev, gk, mk, smi)
    mg_metrics.update(rz_metrics)
    # the RZ CLI run shares the card with phase 20, which times nothing
    try:
        mg_metrics["variants_gpu_cpu_rel"] = timed(phase_gpu_cpu_variants, dev)
        mg_metrics.update(timed(finish_rz_cli, rz_cli, smi))
    finally:
        rz_cli[0].kill()
    eb_metrics, eb_cli = timed(phase_eb, dev, gk, mk, smi)
    mg_metrics.update(eb_metrics)
    # the EB CLI run shares the card with phase 22, which times nothing
    try:
        mg_metrics["eb_gpu_cpu_rel"] = timed(phase_gpu_cpu_eb, dev)
        mg_metrics.update(timed(finish_eb_cli, eb_cli, smi))
    finally:
        eb_cli[0].kill()
    amr_metrics, amr_state = timed(phase_amr_rt3d, dev, gk, mk, smi,
                                   mg_metrics["rt3d_device_ms"])
    mg_metrics.update(amr_metrics)
    mg_metrics.update(timed(phase_amr_kernels, dev, gk, mk, smi, *amr_state))
    del amr_state
    # the AMR CLI run shares the card with phase 24, which times nothing
    amr_cli = phase_amr_cli(smi)
    try:
        mg_metrics["amr_gpu_cpu_rel"] = timed(phase_gpu_cpu_amr, dev)
        mg_metrics.update(timed(finish_amr_cli, amr_cli, smi))
    finally:
        amr_cli[0].kill()
    log(f"metrics ({smi}): {json.dumps(mg_metrics)}")
    log(f"total {time.perf_counter() - t_start:.1f} s after the interpreter started")

    print(json.dumps({"kernels": records + mg_records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
