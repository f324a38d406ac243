"""Problem initial conditions (counterpart of iamr_tpu/ns/probs.py).

Ported: probtype 11 (Taylor-Green, reference prob_init.cpp:509-560) and
probtype 100 (forced HIT, Tutorials/HIT/prob_init.cpp:43-86, the synthetic
solenoidal field). Fields are built in numpy float64 exactly as the JAX
package builds them, then placed on `device` in cfg's dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from iamr_tpu_torch.ns.forcing_hit import init_hit_velocity
from iamr_tpu_torch.ns.state import NSConfig, NSState


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

    if pt == 11:
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
        if isinstance(dict(cfg.prob).get("ic_file"), str):
            raise NotImplementedError("prob.ic_file is not ported")
        vel[...] = init_hit_velocity(
            geom, urms=P("urms", 1.0), kpeak=P("kpeak", 4.0), seed=int(P("seed", 0)),
        )
        rho[...] = P("density", 1.0)
    else:
        raise NotImplementedError(f"probtype {pt} is not ported (11 and 100 are)")
    if cfg.velocity_plotfile:
        raise NotImplementedError("ns.velocity_plotfile is not ported")

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
