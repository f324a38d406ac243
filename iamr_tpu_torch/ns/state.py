"""Navier-Stokes level state and solver configuration
(counterpart of iamr_tpu/ns/state.py).

NSState holds one level's tensors; NSConfig is the static configuration
with the same fields and defaults as the JAX package's, so a configuration
read from an inputs file is the same in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from iamr_tpu_torch.config.parmparse import ParmParse
from iamr_tpu_torch.core.bc import BC_NAMES, DomainBC, PhysBC
from iamr_tpu_torch.core.geometry import Geometry


class NSState(NamedTuple):
    """Single-level flow state: cell-centred velocity, density, tracers,
    temperature and pressure gradient; node-centred pressure; 0-d time and
    dt (the dt of the NEXT step) tensors. temp is carried even without
    ns.do_temp (constant ones)."""

    vel: torch.Tensor      # (dim, *ncell)
    rho: torch.Tensor      # (*ncell)
    trac: torch.Tensor     # (ntrac, *ncell)
    temp: torch.Tensor     # (*ncell)
    p: torch.Tensor        # (*ncell+1) node-centred
    gradp: torch.Tensor    # (dim, *ncell)
    time: torch.Tensor     # 0-d
    dt: torch.Tensor       # 0-d
    dsdt: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class NSConfig:
    """Static solver configuration (defaults reproduce the reference's)."""

    geom: Geometry
    dom: DomainBC
    ntrac: int = 1
    cfl: float = 0.8
    init_shrink: float = 1.0
    init_iter: int = 2
    init_vel_iter: int = 1
    init_dt: float = -1.0
    change_max: float = 1.1
    fixed_dt: float = -1.0
    dt_cutoff: float = 0.0
    gravity: float = 0.0
    vel_visc_coef: float = 0.0
    scal_diff_coefs: Tuple[float, ...] = (0.0,)
    do_temp: bool = False
    temp_cond_coef: float = 0.0
    do_les: bool = False
    les_model: str = "Smagorinsky"
    smago_cs: float = 0.18
    sigma_cs: float = 1.5
    be_cn_theta: float = 0.5
    do_init_proj: bool = True
    do_mom_diff: bool = False
    do_cons_trac: bool = False
    do_denminmax: bool = False
    fft_solve: int = -1
    do_scalminmax: bool = False
    stop_when_steady: bool = False
    steady_tol: float = 1e-10
    advection_scheme: str = "Godunov_PLM"
    redist_type: str = "StateRedist"
    use_forces_in_trans: bool = False
    visc_tol: float = 1e-10
    visc_abs_tol: float = 1e-14
    mac_tol: float = 1e-12
    mac_abs_tol: float = 1e-16
    mac_sync_tol: float = 1e-10
    proj_tol: float = 1e-12
    proj_abs_tol: float = 1e-16
    do_reflux: bool = True
    do_sync_proj: bool = True
    do_mac_proj: bool = True
    debug: bool = False
    refine_cutcells: bool = True
    do_refine_outflow: bool = False
    do_derefine_outflow: bool = True
    nbuf_outflow: int = 1
    rho_wgt_vel_proj: bool = False
    max_step: int = -1
    stop_time: float = -1.0
    probtype: int = 1
    velocity_plotfile: str = ""
    velocity_plotfile_xvel_name: str = "x_velocity"
    velocity_plotfile_scale: float = 1.0
    prob: Tuple[Tuple[str, float], ...] = ()
    forcing: str = "default"  # "default" (buoyancy) | "hit" (spectral)
    turb: Tuple[Tuple[str, float], ...] = ()  # turb.* namespace (HIT)
    max_level: int = 0
    ref_ratio: int = 2
    fine_patch: Tuple[int, ...] = ()
    dtype: str = "float64"

    @property
    def dim(self) -> int:
        return self.geom.dim

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def prob_param(self, name: str, default: float = 0.0) -> float:
        for k, v in self.prob:
            if k == name:
                return v
        return default

    def turb_param(self, name: str, default: float = 0.0) -> float:
        for k, v in self.turb:
            if k == name:
                return v
        return default


def _phys_bcs(pp: ParmParse, dim: int, periodic):
    ns = pp.scoped("ns")
    lo = ns.queryarr("lo_bc", [0] * dim)[:dim]
    hi = ns.queryarr("hi_bc", [0] * dim)[:dim]
    names = ["x", "y", "z"][:dim]
    phys_lo, phys_hi = [], []
    for d in range(dim):
        plo, phi_ = PhysBC(int(lo[d])), PhysBC(int(hi[d]))
        # string BC blocks override integer codes (xlo.type = mass_inflow...)
        for side in ("lo", "hi"):
            t = pp.scoped(f"{names[d]}{side}").query("type")
            if t is not None:
                if side == "lo":
                    plo = BC_NAMES[str(t).lower()]
                else:
                    phi_ = BC_NAMES[str(t).lower()]
        if periodic[d]:
            plo = phi_ = PhysBC.Interior
        phys_lo.append(plo)
        phys_hi.append(phi_)
    # BC values: <side>.velocity / density / tracer / temp
    bc_values = {}
    for d in range(dim):
        for s, side in ((0, "lo"), (1, "hi")):
            sc = pp.scoped(f"{names[d]}{side}")
            vals = []
            v = sc.queryarr("velocity")
            vals.extend([float(x) for x in (v[:dim] if v else [0.0] * dim)])
            vals.append(float(sc.query("density", 1.0)))
            vals.extend(float(x) for x in sc.queryarr("tracer", [0.0]))
            vals.append(float(sc.query("temp", 1.0)))
            bc_values[(d, s)] = tuple(vals)
    return tuple(phys_lo), tuple(phys_hi), bc_values


def config_from_inputs(pp: ParmParse, dim_hint: Optional[int] = None,
                       device=None) -> NSConfig:
    """Build an NSConfig from a reference-format inputs table.

    ns.dtype (float32|float64, 32|64) sets the precision; without it the
    precision follows `device` (default: the card, cuda:0): float64 on the
    CPU (reference semantics), float32 on the card, as the JAX package
    chooses by backend."""
    amr = pp.scoped("amr")
    geo = pp.scoped("geometry")
    ns = pp.scoped("ns")
    prob = pp.scoped("prob")

    ncell = [int(x) for x in amr.getarr("n_cell")]
    dim = dim_hint or len(ncell)
    ncell = ncell[:dim]
    prob_lo = [float(x) for x in geo.queryarr("prob_lo", [0.0] * dim)[:dim]]
    prob_hi = [float(x) for x in geo.queryarr("prob_hi", [1.0] * dim)[:dim]]
    periodic = [bool(int(x)) for x in geo.queryarr("is_periodic", [0] * dim)[:dim]]
    geom = Geometry(
        ncell=tuple(ncell),
        prob_lo=tuple(prob_lo),
        prob_hi=tuple(prob_hi),
        periodic=tuple(periodic),
        coord_sys=int(geo.query("coord_sys", 0)),
    )
    phys_lo, phys_hi, bc_values = _phys_bcs(pp, dim, periodic)
    dom = DomainBC(phys_lo=phys_lo, phys_hi=phys_hi, bc_values=bc_values)

    diff = ns.queryarr("scal_diff_coefs", [0.0])
    # prob.* intake: scalars pass through; list-valued keys expand to
    # per-dim names (blob_center -> blob_x/..., velocity_ic -> velocity_x/...)
    prob_params = []
    for k in prob.keys():
        if k == "probtype":
            continue
        vals = prob.getarr(k)
        if len(vals) == 1 and isinstance(vals[0], str):
            prob_params.append((k, str(vals[0])))
            continue
        if not all(isinstance(v, (int, float)) for v in vals):
            continue
        if len(vals) == 1:
            prob_params.append((k, float(vals[0])))
        else:
            base = {"blob_center": "blob", "velocity_ic": "velocity"}.get(k, k)
            for d, v in enumerate(vals[:3]):
                prob_params.append((f"{base}_{'xyz'[d]}", float(v)))
    turb = pp.scoped("turb")
    turb_params = tuple(
        (k, float(turb.get(k)))
        for k in turb.keys()
        if isinstance(turb.query(k), (int, float))
    )
    probtype = int(prob.query("probtype", 1))
    forcing = str(prob.query("forcing", "")) or (
        "hit" if (probtype == 100 or turb.contains("nmodes")) else "default"
    )

    dt_raw = str(ns.query("dtype", "")).strip()
    if dt_raw in ("32", "float32", "single"):
        dtype = "float32"
    elif dt_raw in ("64", "float64", "double"):
        dtype = "float64"
    else:
        on_cpu = device is not None and torch.device(device).type == "cpu"
        dtype = "float64" if on_cpu else "float32"
    f32 = dtype == "float32"

    return NSConfig(
        geom=geom,
        dom=dom,
        ntrac=max(1, len(diff)),
        cfl=float(ns.query("cfl", 0.8)),
        init_shrink=float(ns.query("init_shrink", 1.0)),
        init_iter=int(ns.query("init_iter", 2)),
        init_dt=float(ns.query("init_dt", -1.0)),
        change_max=float(ns.query("change_max", 1.1)),
        fixed_dt=float(ns.query("fixed_dt", -1.0)),
        dt_cutoff=float(ns.query("dt_cutoff", 0.0)),
        gravity=float(ns.query("gravity", 0.0)),
        vel_visc_coef=float(ns.query("vel_visc_coef", 0.0)),
        scal_diff_coefs=tuple(float(x) for x in diff),
        do_temp=ns.query_bool("do_temp", False),
        temp_cond_coef=float(ns.query("temp_cond_coef", 0.0)),
        do_les=ns.query_bool("do_LES", False),
        les_model=str(ns.query("LES_model", "Smagorinsky")),
        smago_cs=float(ns.query("smago_Cs_cst", 0.18)),
        sigma_cs=float(ns.query("sigma_Cs_cst", 1.5)),
        be_cn_theta=float(ns.query("be_cn_theta", 0.5)),
        do_init_proj=ns.query_bool("do_init_proj", True),
        do_mom_diff=ns.query_bool("do_mom_diff", False),
        do_cons_trac=ns.query_bool("do_cons_trac", False),
        do_denminmax=ns.query_bool("do_denminmax", False),
        fft_solve=int(ns.query("fft_solve", -1)),
        do_scalminmax=ns.query_bool("do_scalminmax", False),
        stop_when_steady=ns.query_bool("stop_when_steady", False),
        steady_tol=float(ns.query("steady_tol", 1e-10)),
        advection_scheme=str(ns.query("advection_scheme", "Godunov_PLM")),
        use_forces_in_trans=pp.scoped("godunov").query_bool("use_forces_in_trans", False),
        redist_type=str(ns.query("redistribution_type", "StateRedist")),
        velocity_plotfile=str(ns.query("velocity_plotfile", "")),
        velocity_plotfile_xvel_name=str(
            ns.query("velocity_plotfile_xvel_name", "x_velocity")
        ),
        velocity_plotfile_scale=float(ns.query("velocity_plotfile_scale", 1.0)),
        # f32 floors: an f32 run cannot reach the f64-calibrated defaults
        visc_tol=max(float(ns.query("visc_tol", 1e-10)), 3e-6 if f32 else 0.0),
        proj_tol=max(
            float(pp.scoped("proj").query("proj_tol", 1e-12)), 3e-6 if f32 else 0.0
        ),
        proj_abs_tol=max(
            float(pp.scoped("proj").query("proj_abs_tol", 1e-16)), 1e-9 if f32 else 0.0
        ),
        mac_tol=max(
            float(pp.scoped("mac").query("mac_tol", 1e-12)), 3e-6 if f32 else 0.0
        ),
        mac_abs_tol=max(
            float(pp.scoped("mac").query("mac_abs_tol", 1e-16)), 1e-9 if f32 else 0.0
        ),
        mac_sync_tol=max(
            float(pp.scoped("mac").query("mac_sync_tol", 1e-10)), 3e-6 if f32 else 0.0
        ),
        do_reflux=ns.query_bool("do_reflux", True),
        do_sync_proj=ns.query_bool("do_sync_proj", True),
        do_mac_proj=ns.query_bool("do_mac_proj", True),
        debug=ns.query_bool("debug", False),
        refine_cutcells=ns.query_bool("refine_cutcells", True),
        do_refine_outflow=ns.query_bool("do_refine_outflow", False),
        do_derefine_outflow=ns.query_bool("do_derefine_outflow", True),
        nbuf_outflow=int(ns.query("Nbuf_outflow", 1)),
        init_vel_iter=int(ns.query("init_vel_iter", 1)),
        rho_wgt_vel_proj=bool(int(pp.scoped("proj").query("rho_wgt_vel_proj", 0))),
        max_step=int(pp.query("max_step", -1)),
        stop_time=float(pp.query("stop_time", -1.0)),
        probtype=probtype,
        prob=tuple(prob_params),
        forcing=forcing,
        turb=turb_params,
        max_level=int(amr.query("max_level", 0)),
        ref_ratio=int(amr.queryarr("ref_ratio", [2])[0]),
        fine_patch=tuple(int(x) for x in amr.queryarr("fixed_fine_patch", [])),
        dtype=dtype,
    )
