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
  4. K2 godunov_plm_multi vs plain in the same form: nc=5 with the slice's
     per-field flags, and nc=1 (K3);
  5. the slice at full width: forced HIT 256^3 f32 with 65536 tracer
     particles, init_state then dt = 5e-3, one warm-up step and 3 timed
     steps through make_step_with_particles; launch counts of K1 and K2
     must equal the steps taken; divergence diagnostics as bench.py forms
     them; K1/K2 times beside their plain versions' at 256^3;
  6. a HIT 32^3 f64 step with particles on the GPU against the same step on
     the CPU (plain path), to 1e-10 relative.

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
ns.init_iter = 0
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
F32_MEDIAN, F32_OUTLIER_TOL, F32_OUTLIER_FRAC = 1e-6, 1e-5, 1e-3


def log(msg):
    print(msg, flush=True)


def check_f32(name, pairs, gk):
    """Kernel vs plain in f32: median and outlier fraction bounded, max
    reported (tie flips move single values by ~2|u|)."""
    worst = {"median": 0.0, "outliers": 0.0, "max": 0.0}
    max_abs = 0.0
    for got, ref in pairs:
        if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)} "
                                 "or non-finite output")
        st = gk.tie_flip_stats(got, ref, F32_OUTLIER_TOL)
        worst = {k: max(worst[k], st[k]) for k in worst}
        max_abs = max(max_abs, float((got - ref).abs().max()))
    log(f"  {name}: median {worst['median']:.3e} outliers(>{F32_OUTLIER_TOL:g}) "
        f"{worst['outliers']:.3e} max {worst['max']:.3e} (of max|plain|)")
    if worst["median"] > F32_MEDIAN or worst["outliers"] > F32_OUTLIER_FRAC:
        raise AssertionError(f"{name}: kernel disagrees with plain: {worst}")
    return max_abs


def check_f64(name, pairs, gk):
    worst = max(gk.tie_flip_stats(got, ref, 1e-12)["max"] for got, ref in pairs)
    log(f"  {name}: max {worst:.3e} of max|plain| (limit 1e-12)")
    if not worst <= 1e-12:
        raise AssertionError(f"{name}: f64 kernel disagrees with plain: {worst}")


def pad(a, ng, periodic):
    return np.pad(a, ng, mode="wrap" if periodic else "edge")


def extrap_case(dev, dtype, n, periodic, force, seed=0):
    rng = np.random.RandomState(seed)
    vel_g = np.stack([pad(0.4 * rng.randn(n, n, n), 3, periodic) for _ in range(3)])
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    fg = None
    if force:
        fg = t(np.stack([pad(rng.randn(n, n, n), 1, periodic) for _ in range(3)]))
    dt = torch.tensor(0.004, dtype=dtype, device=dev)
    return (t(vel_g), fg, dt, (1.0 / n,) * 3, (n, n, n))


def advect_case(dev, dtype, n, periodic, nc, seed=0):
    from iamr_tpu_torch.ops.godunov import grow_umac_transverse

    rng = np.random.RandomState(seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    fields = [t(pad(rng.rand(n, n, n), 3, periodic)) for _ in range(nc)]
    umac = []
    for d in range(3):
        u = 0.3 * rng.randn(*[n + (1 if e == d else 0) for e in range(3)])
        if periodic:
            u[tuple(slice(None) if e != d else -1 for e in range(3))] = \
                u[tuple(slice(None) if e != d else 0 for e in range(3))]
        umac.append(t(u))
    umac = tuple(umac)
    ug = grow_umac_transverse(umac, (periodic,) * 3)
    forces = [t(pad(rng.randn(n, n, n), 1, periodic)) for _ in range(3)]
    dt = torch.tensor(0.004, dtype=dtype, device=dev)
    return fields, umac, ug, forces, dt, (1.0 / n,) * 3, (n, n, n)


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


def hit_config(n, dtype, dev):
    from iamr_tpu.config.parmparse import ParmParse
    from iamr_tpu_torch.ns.state import config_from_inputs

    return config_from_inputs(ParmParse.from_string(HIT_INPUTS.format(n=n, dtype=dtype)),
                              device=dev)


def phase_slice(dev, gk, card, n=256, nparticles=65536, steps=3):
    from iamr_tpu_torch.ns.advance import (
        advance, get_force, make_hit_forcing, make_step_with_particles,
    )
    from iamr_tpu_torch.ns.bcprovider import PhysBCProvider
    from iamr_tpu_torch.ns.particles import from_positions
    from iamr_tpu_torch.ns.probs import init_state
    from iamr_tpu_torch.ops.mg_nodal import N_PERIODIC, NodalBC, div_cell_to_node
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
    taken = steps + 1
    log(f"  launches in the main path: {launches} over {taken} steps")
    if launches != {"extrap_plm": taken, "godunov_plm_multi": taken}:
        raise AssertionError(f"kernel launch counts {launches} != {taken} steps")
    for k in ("vel", "rho", "trac", "p", "gradp"):
        if not bool(torch.isfinite(getattr(state, k)).all()):
            raise AssertionError(f"non-finite state.{k}")
    if not (bool(torch.isfinite(parts.pos).all()) and bool(parts.alive.all())):
        raise AssertionError("non-finite or lost particles")
    if tuple(state.vel.shape) != (3, n, n, n) or tuple(parts.pos.shape) != (nparticles, 3):
        raise AssertionError("unexpected state shapes")
    cups = n**3 * steps / wall
    log(f"  {wall / steps:.6f} s/step, {cups:.6e} cells/s on {card}")

    # divergence diagnostics as bench.py forms them: nodal div of the cell
    # velocities, and the MAC divergence of one more step's projected umac
    dx = cfg.geom.dx
    umax = max(float(state.vel.abs().max()), 1e-30)
    bc = NodalBC((N_PERIODIC,) * 3, (N_PERIODIC,) * 3)
    max_div = float(div_cell_to_node(tuple(state.vel), dx, bc).abs().max())
    hit = make_hit_forcing(cfg)
    _, umac_f = advance(state, cfg, hit=hit, return_umac=True, spectral=True)
    mac_div = sum(torch.diff(umac_f[d], dim=d) / dx[d] for d in range(3))
    max_mac = float(mac_div.abs().max())
    log(f"  max_div_after_step {max_div:.6e} max_div_over_umax_dx "
        f"{max_div / (umax / dx[0]):.6e}")
    log(f"  max_mac_div {max_mac:.6e} max_mac_div_over_umax_dx {max_mac / (umax / dx[0]):.6e}")
    if not max_mac / (umax / dx[0]) < 1e-3:
        raise AssertionError("MAC projection left a divergence above 1e-3 umax/dx")

    log(f"phase 5b: K1/K2 at {n}^3 f32 on main-path inputs, kernel vs plain")
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
    log(f"  K1 extrap_plm       {k1_ms:.4f} ms, plain {k1_plain:.4f} ms ({card})")
    log(f"  K2 godunov nc=5     {k2_ms:.4f} ms, plain {k2_plain:.4f} ms ({card})")
    log(f"  K3 godunov nc=1 rho {k3_ms:.4f} ms, plain {k3_plain:.4f} ms ({card})")
    return [
        {"name": "extrap_plm", "route": "cuda", "source": "iamr_tpu_torch/csrc/godunov_plm.cu",
         "replaces": "iamr_tpu/ops/pallas_godunov.py:944", "launches": launches["extrap_plm"],
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "godunov_plm_multi", "route": "cuda",
         "source": "iamr_tpu_torch/csrc/godunov_plm.cu",
         "replaces": "iamr_tpu/ops/pallas_godunov.py:557",
         "launches": launches["godunov_plm_multi"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain},
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

    t0 = time.perf_counter()
    native.kernels()
    log(f"phase 2: kernels built in {time.perf_counter() - t0:.3f} s "
        f"(nvcc {native.BUILD_INFO['seconds']:.3f} s, cached {native.BUILD_INFO['cached']})")

    phase_kernels(dev, gk)
    records = phase_slice(dev, gk, smi)
    phase_cpu_parity(dev)

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
