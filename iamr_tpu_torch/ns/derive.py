"""Derived fields (counterpart of iamr_tpu/ns/derive.py).

The reference's Source/NS_derive.cpp: mag_vort (|curl U|), energy
(0.5 rho |U|^2), avg_pressure (node -> cell average), diveru, the plugin
derives of amr.derive_plot_vars, and the monitors of
sum_integrated_quantities (NavierStokes.cpp:1046-1079) and
printMaxVel/printMaxGp. Tensors in, tensors out, on the state's device;
the two monitors read the host once each.
"""

from __future__ import annotations

from typing import Dict

import torch

from iamr_tpu_torch import plugins
from iamr_tpu_torch.core.bc import BCRec, MathBC
from iamr_tpu_torch.core.fill import fill_ghost
from iamr_tpu_torch.ns.bcprovider import PhysBCProvider
from iamr_tpu_torch.ns.state import NSConfig, NSState
from iamr_tpu_torch.ops.stencil import avg2, sl


def _cc_grad(cfg: NSConfig, f_g, d):
    """Central-difference gradient along d of a field grown by one ghost
    cell, on the cells."""
    out = (sl(f_g, d, 2, None) - sl(f_g, d, 0, -2)) / (2.0 * cfg.geom.dx[d])
    idx = tuple(slice(None) if e == d else slice(1, -1) for e in range(f_g.ndim))
    return out[idx]


def mag_vort(cfg: NSConfig, state: NSState):
    """|curl U| by central differences over BC-filled ghosts (in 2D the
    magnitude of the one component)."""
    dim = cfg.dim
    vel_g = PhysBCProvider(cfg).fill_vel(state.vel, 1)
    g = {(c, d): _cc_grad(cfg, vel_g[c], d) for c in range(dim) for d in range(dim) if d != c}
    if dim == 2:
        return torch.abs(g[(1, 0)] - g[(0, 1)])
    wx = g[(2, 1)] - g[(1, 2)]
    wy = g[(0, 2)] - g[(2, 0)]
    wz = g[(1, 0)] - g[(0, 1)]
    return torch.sqrt(wx**2 + wy**2 + wz**2)


def kinetic_energy(state: NSState):
    """0.5 rho |U|^2 (derkeng)."""
    return 0.5 * state.rho * torch.sum(state.vel**2, dim=0)


def avg_pressure(state: NSState):
    """Node -> cell averaged pressure (deravgpres)."""
    p = state.p
    for d in range(p.ndim):
        p = avg2(p, d)
    return p


def diveru(cfg: NSConfig, state: NSState):
    """Cell-centred divergence of U by central differences (periodic ghosts
    wrap, the others copy the edge cell)."""
    kinds = tuple(MathBC.int_dir if p else MathBC.foextrap for p in cfg.geom.periodic)
    rec = BCRec(lo=kinds, hi=kinds)
    return sum(_cc_grad(cfg, fill_ghost(state.vel[d], 1, rec), d) for d in range(cfg.dim))


def derive(cfg: NSConfig, state: NSState, name: str):
    """The derived field `name`: the built-in ones, then the plugin
    registry (plugins.derive_field)."""
    if name in ("mag_vort", "magvort"):
        return mag_vort(cfg, state)
    if name in ("energy", "kinetic_energy"):
        return kinetic_energy(state)
    if name == "avg_pressure":
        return avg_pressure(state)
    if name == "diveru":
        return diveru(cfg, state)
    if name in plugins.DERIVES:
        return plugins.DERIVES[name](cfg, state)
    raise KeyError(f"unknown derived field {name!r}")


def sum_integrated_quantities(cfg: NSConfig, state: NSState) -> Dict[str, float]:
    """Volume integrals of mass, kinetic energy and each tracer, in one
    host read."""
    sums = torch.stack([torch.sum(state.rho), torch.sum(kinetic_energy(state)),
                        *torch.sum(state.trac, dim=tuple(range(1, state.trac.ndim)))])
    vals = [x * cfg.geom.cell_volume for x in sums.tolist()]
    out = {"mass": vals[0], "kinetic_energy": vals[1]}
    out.update({f"tracer{t}": v for t, v in enumerate(vals[2:])})
    return out


def max_values(state: NSState) -> Dict[str, float]:
    """printMaxVel / printMaxGp: max|u_d| and max|Gp_d|, in one host read."""
    ax = tuple(range(1, state.vel.ndim))
    vals = torch.stack([torch.amax(torch.abs(state.vel), dim=ax),
                        torch.amax(torch.abs(state.gradp), dim=ax)]).tolist()
    out = {}
    for d in range(state.vel.shape[0]):
        out[f"max|u{'xyz'[d]}|"] = vals[0][d]
        out[f"max|gp{'xyz'[d]}|"] = vals[1][d]
    return out
