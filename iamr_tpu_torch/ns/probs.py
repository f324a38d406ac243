"""Problem initial conditions (counterpart of iamr_tpu/ns/probs.py).

Ported, in 2D and 3D (reference Source/prob/prob_init.cpp):
  1    rest, rho = 1 (the lid-driven cavity and channels are driven by BCs)
  2/6  falling / rising (hot) bubble
  3    density-jump blob in a background flow
  4    constant velocity and density, tracer blob
  5    double shear layer
  7    Euler vortex tube
  8    convected vortex
  10   Rayleigh-Taylor
  11   Taylor-Green
  100  forced HIT (Tutorials/HIT/prob_init.cpp:43-86, the synthetic
       solenoidal field)
  100 with prob.ic_file: a gen_hit_ic.py spectral IC (utils/fileio.py)
Any other probtype is a user problem of the plugin registry
(plugins.problem_ic). ns.velocity_plotfile adds ns.velocity_plotfile_scale
times a plotfile's velocity, looked up by name, to the IC (the reference's
BL_USE_VELOCITY). Fields are built in numpy float64 exactly as the JAX
package builds them, then placed on `device` in cfg's dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from iamr_tpu_torch import plugins
from iamr_tpu_torch.io.plotfile import read_plotfile
from iamr_tpu_torch.ns.forcing_hit import init_hit_velocity
from iamr_tpu_torch.ns.state import NSConfig, NSState
from iamr_tpu_torch.utils.fileio import hit_velocity_from_file


def _blob_r2(X, P, dim):
    return sum((X[d] - P(f"blob_{'xyz'[d]}", 0.0)) ** 2 for d in range(dim))


def _add_plotfile_velocity(cfg: NSConfig, vel):
    """vel += ns.velocity_plotfile_scale * the plotfile's velocity, its
    components looked up by name from ns.velocity_plotfile_xvel_name
    (x_velocity -> y_velocity, z_velocity; u_vel -> v_vel, w_vel; other
    names take a y/z suffix). The plotfile's level 0 must be this grid."""
    fields_pf, _ = read_plotfile(cfg.velocity_plotfile)
    names = list(fields_pf)
    xname = cfg.velocity_plotfile_xvel_name
    if xname not in names:
        raise ValueError(f"Could not find velocity fields in supplied velocity_plotfile "
                         f"(looked for {xname!r})")
    sibling = {"x": "yz", "X": "YZ", "u": "vw", "U": "VW"}
    comp_names = [xname] + [
        sibling[xname[:1]][i] + xname[1:] if xname[:1] in sibling else xname + "yz"[i]
        for i in range(cfg.dim - 1)]
    missing = [nm for nm in comp_names if nm not in names]
    if missing:
        raise ValueError(f"velocity_plotfile is missing components {missing} (has {names})")
    for d, nm in enumerate(comp_names):
        v = fields_pf[nm]
        if v.shape != vel[d].shape:
            raise ValueError(f"velocity_plotfile grid {v.shape} != problem grid {vel[d].shape}")
        vel[d] = vel[d] + cfg.velocity_plotfile_scale * v


def init_state(cfg: NSConfig, device) -> NSState:
    geom = cfg.geom
    dim = geom.dim
    X = geom.cell_centers()
    n = geom.ncell
    vel = np.zeros((dim,) + n)
    rho = np.ones(n)
    trac = np.zeros((cfg.ntrac,) + n)
    temp = np.ones(n)
    P = cfg.prob_param
    two_pi = 2.0 * np.pi
    pt = cfg.probtype

    if pt == 1:
        pass
    elif pt == 4:
        for d, nm in enumerate(["velocity_x", "velocity_y", "velocity_z"][:dim]):
            vel[d] = P(nm, 0.0)
        rho[...] = P("density_ic", 1.0)
        trac[0] = np.where(np.sqrt(_blob_r2(X, P, dim)) < P("blob_radius", 0.1), 1.0, 0.0)
    elif pt == 3:
        for d in range(dim):
            vel[d] = P(f"velocity_{'xyz'[d]}", 0.0)
        inside = np.sqrt(_blob_r2(X, P, dim)) < P("blob_radius", 0.1)
        rho[...] = np.where(inside, P("density_ic", 2.0), 1.0)
        trac[0] = np.where(inside, 1.0, 0.0)
    elif pt in (2, 6):
        for d in range(dim):
            vel[d] = P(f"velocity_{'xyz'[d]}", 0.0)
        r = np.sqrt(_blob_r2(X, P, dim))
        radius = P("blob_radius", 0.1)
        denfact = P("density_ic", 2.0)
        if pt == 6:
            # hot (less dense) rising bubble, T = 1/rho
            w = P("interface_width", 1.0)
            rho[...] = 1.0 / denfact + 0.5 * (1.0 - 1.0 / denfact) * (
                1.0 + np.tanh(40.0 * (r - radius) / w)
            )
            temp[...] = 1.0 / rho
        else:
            inside = 0.5 * (1.0 - np.tanh(30.0 * (r - radius) / P("interface_width", 1.0)))
            rho[...] = 1.0 + (denfact - 1.0) * inside
        trac[0] = np.where(r < radius, 1.0, 0.0)
    elif pt == 5:
        rho[...] = P("density_ic", 1.0)
        pert = P("pertamp", 0.05)
        if int(P("direction", 0)) == 0:
            vel[0] = np.tanh(30.0 * (0.25 - np.abs(X[1] - 0.5)))
            vel[1] = pert * np.sin(two_pi * X[0])
        else:
            vel[1] = np.tanh(30.0 * (0.25 - np.abs(X[0] - 0.5)))
            vel[0] = pert * np.sin(two_pi * X[1])
        trac[0] = 0.5 * (1.0 + np.tanh(30.0 * (0.25 - np.abs(X[1] - 0.5))))
    elif pt == 7:
        vf = P("velocity_factor", 1.0)
        a, b = P("a", 1.0), P("b", 1.0)
        x, y = X[0], X[1]
        vel[0] = vf * np.sin(two_pi * a * x) * np.cos(two_pi * b * y)
        vel[1] = -vf * np.cos(two_pi * a * x) * np.sin(two_pi * b * y)
        trac[0] = 0.5 * (1.0 + np.cos(two_pi * x))
    elif pt == 8:
        # Gaussian vortex at (xvort, yvort), radius rvort, strength
        # forcevort, on a mean flow along meanFlowDir (+-1 x, +-2 y, +-3 both)
        dxv = X[0] - P("xvort", 0.5)
        dyv = X[1] - P("yvort", 0.5)
        d2 = dxv * dxv + dyv * dyv
        r2 = P("rvort", 0.07) ** 2
        fv = P("forcevort", 6.0)
        mdir = int(P("meanFlowDir", 1))
        mmag = P("meanFlowMag", 0.0)
        sgn = -1.0 if mdir < 0 else 1.0
        vel[0] = -fv * dyv / r2 * np.exp(-d2 / r2 / 2.0) + (
            sgn * mmag if abs(mdir) in (1, 3) else 0.0)
        vel[1] = fv * dxv / r2 * np.exp(-d2 / r2 / 2.0) + (
            sgn * mmag if abs(mdir) in (2, 3) else 0.0)
        rho[...] = P("density_ic", 1.0)
        trac[0] = np.exp(-d2 / r2 / 2.0)
    elif pt == 10:
        # heavy over light, interface perturbed by a cosine (2D) or a
        # product of cosines (3D), absolute interface_width
        rho_1, rho_2 = P("rho_1", 1.0), P("rho_2", 2.0)
        tra_1, tra_2 = P("tra_1", 0.0), P("tra_2", 1.0)
        pertamp = P("perturbation_amplitude", 1.0)
        ymid = 0.5 * (geom.prob_hi[dim - 1] + geom.prob_lo[dim - 1])
        Lx = geom.prob_hi[0] - geom.prob_lo[0]
        pert = pertamp * np.cos(two_pi * X[0] / Lx)
        if dim == 3:
            pert = pert * np.cos(two_pi * X[1] / (geom.prob_hi[1] - geom.prob_lo[1]))
        frac = 0.5 * (1.0 + np.tanh((X[dim - 1] - (ymid + pert)) / P("interface_width", 0.01)))
        rho[...] = rho_1 + (rho_2 - rho_1) * frac
        trac[0] = tra_1 + (tra_2 - tra_1) * frac
    elif pt == 11:
        vf = P("velocity_factor", 1.0)
        a, b, c = P("a", 1.0), P("b", 1.0), P("c", 1.0)
        x, y = X[0], X[1]
        z = X[2] if dim == 3 else 0.0
        cz = np.cos(c * two_pi * z) if dim == 3 else 1.0
        vel[0] = vf * np.sin(a * two_pi * x) * np.cos(b * two_pi * y) * cz
        vel[1] = -vf * np.cos(a * two_pi * x) * np.sin(b * two_pi * y) * cz
        rho[...] = P("density", 1.0)
        # the tracer carries the analytic pressure perturbation
        if dim == 2:
            trac[0] = (rho * vf * vf / 4.0) * (
                np.cos(2 * a * two_pi * x) + np.cos(2 * b * two_pi * y)
            )
        else:
            trac[0] = (rho * vf * vf / 16.0) * (2.0 + np.cos(2 * c * two_pi * z)) * (
                np.cos(2 * a * two_pi * x) + np.cos(2 * b * two_pi * y)
            )
    elif pt == 100:
        ic_file = dict(cfg.prob).get("ic_file")
        if isinstance(ic_file, str) and ic_file:
            vel[...] = hit_velocity_from_file(
                ic_file, int(P("ic_n", geom.ncell[0])), geom,
                urms_target=P("urms", 0.0) or None,
            )
        else:
            vel[...] = init_hit_velocity(
                geom, urms=P("urms", 1.0), kpeak=P("kpeak", 4.0), seed=int(P("seed", 0)),
            )
        rho[...] = P("density", 1.0)
    else:
        if pt not in plugins.PROBLEM_ICS:
            raise ValueError(f"unknown probtype {pt}")
        fields = {"vel": vel, "rho": rho, "trac": trac, "temp": temp}
        fields.update(plugins.PROBLEM_ICS[pt](cfg, X, fields) or {})
        vel, rho, trac, temp = fields["vel"], fields["rho"], fields["trac"], fields["temp"]
    if cfg.velocity_plotfile:
        _add_plotfile_velocity(cfg, vel)

    dtype = cfg.tdtype

    def T(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return NSState(
        vel=T(vel),
        rho=T(rho),
        trac=T(trac),
        temp=T(temp),
        p=torch.zeros(tuple(x + 1 for x in n), dtype=dtype, device=device),
        gradp=torch.zeros((dim,) + n, dtype=dtype, device=device),
        time=torch.zeros((), dtype=dtype, device=device),
        dt=torch.zeros((), dtype=dtype, device=device),
    )
