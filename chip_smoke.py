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
     (dim 0 shorter than a march segment), periodic and not, f32 and (the
     small ones) f64; every case reports whether it is bitwise equal;
  4. K2 godunov_plm_multi vs plain in the same form: nc=5 with the slice's
     per-field flags, and nc=1 (K3); on the ragged boxes nc = 1, 5 and 6
     with mixed force rows, and nc = 9 (two chained launches) on 40x24x21;
  5. the slice at full width: forced HIT 256^3 f32 with 65536 tracer
     particles, init_state then dt = 5e-3, one warm-up step and 3 timed
     steps through make_step_with_particles; wrapper calls of K1 and K2
     must equal the steps taken; one profiled step, in which K1 and K2 must
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
     41x25x22 periodic and 131x71 nodes;
  9. the slice on the fixed-cycle multigrid: HIT 256^3 f32 with 65536
     particles, fixed_mg_cycles=4, spectral off, 1 warm-up + 3 timed steps;
     wrapper calls per step equal across steps and to the V-cycle count;
     divergence diagnostics; one step with host syncs made errors; a
     profiled step, whose CUDA launches of each MG kernel must equal its
     wrapper calls (one launch per call); both MG kernels timed beside their
     plain versions on the finest level's inputs;
 10. the entry point: driver.initialize then driver.run for 2 steps in
     tolerance mode (HIT 128^3 f32, ns.fft_solve = 0, particles); a 32^3
     f64 MG step (fixed and tolerance mode), GPU against CPU, to 1e-10;
 11. the nodal MLMG to rtol 1e-11 (bench.py's problem at 256^3, mixed
     f32/f64), its true residual recomputed in numpy f64
     (ops/np_nodal.py), and the f32/f64 nodal-divergence pair of HIT 32^3
     after 3 MG steps.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Exits non-zero, printing no result, without
a CUDA device. Imports no JAX.
"""

import json
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
RAGGED_BOXES = ((80, 96, 112), (40, 24, 21), (8, 8, 8), (5, 40, 70))
# CUDA launches of the Godunov kernels in one step, by kernel name
GODUNOV_CUDA_LAUNCHES = {"extrap_plm_kernel": 1, "godunov_plm_multi_kernel": 1}
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


def pad(a, ng, periodic):
    return np.pad(a, ng, mode="wrap" if periodic else "edge")


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
        if periodic:
            u[tuple(slice(None) if e != d else -1 for e in range(3))] = \
                u[tuple(slice(None) if e != d else 0 for e in range(3))]
        umac.append(t(u))
    umac = tuple(umac)
    ug = grow_umac_transverse(umac, (periodic,) * 3)
    forces = [t(pad(rng.randn(*n), 1, periodic)) for _ in range(3)]
    dt = torch.tensor(0.004, dtype=dtype, device=dev)
    return fields, umac, ug, forces, dt, tuple(1.0 / x for x in n), n


def flat(out):
    return [a for fl, ao in out for a in (*fl, ao)]


def run_multi(gk, case, flags, periodic, ref=False):
    fields, umac, ug, forces, dt, dx, n = case
    fn = gk.godunov_plm_multi_ref if ref else gk.godunov_plm_multi
    return fn(fields, umac, ug, dt, dx, n, flags["iconservs"], forces,
              flags["force_rows"], flags["convs"], periodic=(periodic,) * 3)


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
    for periodic in (True, False):
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
        for k, periodic in enumerate((True, False)):
            for dtype in ragged_dtypes(n):
                args = extrap_case(dev, dtype, n, periodic, (i + k) % 2 == 0, seed=2)
                check = check_f32 if dtype == torch.float32 else check_f64
                check(f"K1 {str(dtype)[6:]} {n} periodic={periodic} force={args[1] is not None}",
                      zip(gk.extrap_plm(*args), gk.extrap_plm_ref(*args)), gk)

    log("phase 4: K2 godunov_plm_multi vs plain (nc=5 slice flags; nc=1 = K3)")
    one = lambda ic, f: dict(iconservs=[ic], force_rows=[0 if f else -1], convs=[not ic])
    cases = [("nc=5", SLICE_FLAGS), ("nc=1 conservative", one(True, False)),
             ("nc=1 convective forced", one(False, True))]
    for periodic in (True, False):
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
        for periodic in (True, False):
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

    gk.reset_launches()
    mk.reset_launches()
    t0 = time.perf_counter()
    state, parts = step(state, parts)
    torch.cuda.synchronize()
    log(f"  warm-up step {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    for _ in range(steps):
        state, parts = step(state, parts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(gk.LAUNCHES)
    mg_launches = dict(mk.LAUNCHES)
    taken = steps + 1
    log(f"  launches in the main path: {launches}, {mg_launches} over {taken} steps")
    if launches != {"extrap_plm": taken, "godunov_plm_multi": taken}:
        raise AssertionError(f"kernel launch counts {launches} != {taken} steps")
    if any(mg_launches.values()):
        raise AssertionError(f"the spectral path launched multigrid kernels: {mg_launches}")
    check_state(state, parts)
    if tuple(state.vel.shape) != (3, n, n, n) or tuple(parts.pos.shape) != (nparticles, 3):
        raise AssertionError("unexpected state shapes")
    cups = n**3 * steps / wall
    log(f"  {wall / steps:.6f} s/step, {cups:.6e} cells/s on {card}")
    rows = profile_step(lambda: step(state, parts), card)
    for name, want in GODUNOV_CUDA_LAUNCHES.items():
        mine = [e for e in rows if name in e.key]
        cuda_launches = sum(e.count for e in mine)
        dev_ms = sum(getattr(e, "self_device_time_total", 0.0) for e in mine) / 1e3
        log(f"  {name}: {cuda_launches} CUDA launches, {dev_ms:.3f} ms device time in the "
            f"profiled step (expected {want})")
        if cuda_launches != want:
            raise AssertionError(f"{name}: {cuda_launches} CUDA launches a step, not {want}")

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
    return [
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


def nodal_case(dev, dtype, cshape, lo, hi, seed=1):
    """Random sigma (cells), phi and rhs (nodes, duplicated periodic DOF
    consistent) and the finest level (mask, diag, omega)."""
    from iamr_tpu_torch.ops import mg_nodal as mn

    rng = np.random.RandomState(seed)
    dim = len(cshape)
    nshape = tuple(c + 1 for c in cshape)
    phi, rhs = rng.randn(*nshape), rng.randn(*nshape)
    for d in range(dim):
        if lo[d] == mn.N_PERIODIC:
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
    log("phase 8b: mg_nodal_jacobi tiles, nsweeps 0-4 with and without the residual")
    for cshape, lo, hi in (((16, 16, 16), (P, P, P), (P, P, P)),
                           ((80, 96, 112), (D, N, P), (N, D, P)),
                           ((40, 24, 21), (P, P, P), (P, P, P)), ((130, 70), (N, P), (D, P))):
        case = nodal_case(dev, torch.float32, cshape, lo, hi, seed=3)
        nodes = tuple(c + 1 for c in cshape)
        check_pairs(f"f32 nodes {nodes} lo={lo} hi={hi}",
                    nodal_contracts(mk, case, SWEEP_CALLS), torch.float32, nodal_term(case))


def mg_levels(cells, stop, nodes):
    """Levels of the MG hierarchy (ops/mg.py::build_hierarchy,
    ops/mg_nodal.py::build_nodal_hierarchy): halve until an extent is odd,
    the smallest is <= 2, or the level has <= stop cells (nodes)."""
    count, shape = 1, tuple(cells)
    while not (any(x % 2 for x in shape) or min(shape) <= 2
               or int(np.prod([x + nodes for x in shape])) <= stop):
        shape = tuple(x // 2 for x in shape)
        count += 1
    return count


def expected_mg_launches(n, cycles):
    """Wrapper calls per step of the fixed-cycle MG step: each solve makes
    one residual call, then per V-cycle 2 smoother calls per level above
    the dense bottom plus one residual call. Cell: the MAC solve (cycles
    V-cycles) and 3 CN velocity solves (max(1, cycles // 4) each); nodal:
    the projection (cycles V-cycles)."""
    from iamr_tpu_torch.ops.mg import DENSE_BOTTOM_DOFS
    from iamr_tpu_torch.ops.mg_nodal import NODAL_DENSE_BOTTOM_DOFS

    per = lambda levels, k: 1 + k * (2 * (levels - 1) + 1)
    lc = mg_levels((n,) * 3, DENSE_BOTTOM_DOFS, 0)
    ln = mg_levels((n,) * 3, NODAL_DENSE_BOTTOM_DOFS, 1)
    return {"mg_cell_gsrb": per(lc, cycles) + 3 * per(lc, max(1, cycles // 4)),
            "mg_nodal_jacobi": per(ln, cycles)}


def check_state(state, parts=None):
    for k in ("vel", "rho", "trac", "p", "gradp", "dt"):
        if not bool(torch.isfinite(getattr(state, k)).all()):
            raise AssertionError(f"non-finite state.{k}")
    if parts is not None and not (bool(torch.isfinite(parts.pos).all())
                                  and bool(parts.alive.all())):
        raise AssertionError("non-finite or lost particles")


def divergence_report(cfg, state, umac=None):
    """bench.py's diagnostics over umax/dx: the nodal divergence of the cell
    velocities and, given umac, the MAC divergence of the projected face
    velocities."""
    from iamr_tpu_torch.ops.mg_nodal import N_PERIODIC, NodalBC, div_cell_to_node

    dx = cfg.geom.dx
    scale = max(float(state.vel.abs().max()), 1e-30) / dx[0]
    bc = NodalBC((N_PERIODIC,) * 3, (N_PERIODIC,) * 3)
    max_div = float(div_cell_to_node(tuple(state.vel), dx, bc).abs().max())
    out = {"max_div_over_umax_dx": max_div / scale}
    log(f"  max_div_after_step {max_div:.6e} max_div_over_umax_dx {max_div / scale:.6e}")
    if umac is not None:
        max_mac = float(sum(torch.diff(umac[d], dim=d) / dx[d] for d in range(3)).abs().max())
        out["max_mac_div_over_umax_dx"] = max_mac / scale
        log(f"  max_mac_div {max_mac:.6e} max_mac_div_over_umax_dx {max_mac / scale:.6e}")
    return out


def profile_step(fn, card, top=12):
    """Device time of one step by kernel name (torch.profiler), and the
    device's busy share of the profiled step's wall time; returns the CUDA
    kernel rows (key, count, device time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
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
    want = dict(expected_mg_launches(n, cycles), extrap_plm=1, godunov_plm_multi=1)
    per_step = []

    def one(state, parts):
        gk.reset_launches()
        mk.reset_launches()
        out = step(state, parts)
        per_step.append(dict(gk.LAUNCHES, **mk.LAUNCHES))
        return out

    t0 = time.perf_counter()
    state, parts = one(state, parts)
    torch.cuda.synchronize()
    log(f"  warm-up step {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    for _ in range(steps):
        state, parts = one(state, parts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"  launches per step: {per_step[-1]} (expected {want})")
    if any(c != want for c in per_step):
        raise AssertionError(f"launch counts per step {per_step} != {want}")
    check_state(state, parts)
    log(f"  {wall / steps:.6f} s/step, {n**3 * steps / wall:.6e} cells/s on {card}")

    torch.cuda.set_sync_debug_mode("error")
    try:
        step(state, parts)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    log("  one more step under set_sync_debug_mode('error'): no host sync")
    rows = profile_step(lambda: step(state, parts), card)
    for name in ("mg_cell_gsrb", "mg_nodal_jacobi"):
        mine = [e for e in rows if f"{name}_kernel" in e.key]
        cuda_launches = sum(e.count for e in mine)
        dev_ms = sum(getattr(e, "self_device_time_total", 0.0) for e in mine) / 1e3
        log(f"  {name}: {cuda_launches} CUDA launches, {dev_ms:.3f} ms device time in the "
            f"profiled step, {want[name]} wrapper calls")
        if cuda_launches != want[name]:
            raise AssertionError(f"{name}: {cuda_launches} CUDA launches for {want[name]} calls")
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
    ], {"s_per_step": wall / steps, "cells_per_s": n**3 * steps / wall, **div}


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
    records = timed(phase_slice, dev, gk, mk, smi)
    timed(phase_cpu_parity, dev)
    timed(phase_cell_kernel, dev, mk)
    timed(phase_nodal_kernel, dev, mk)
    mg_records, mg_metrics = timed(phase_mg_slice, dev, gk, mk, smi)
    timed(phase_entry_point, dev)
    mg_metrics.update(timed(phase_mlmg, dev, smi))
    log(f"metrics ({smi}): {json.dumps(mg_metrics)}")
    log(f"total {time.perf_counter() - t_start:.1f} s after the interpreter started")

    print(json.dumps({"kernels": records + mg_records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
