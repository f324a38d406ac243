"""Carry state and tables across from the JAX package, given as numpy arrays.

Each function takes host arrays (np.asarray of the JAX side's fields) and
returns the port's object on `device`, so a test can feed both packages the
same state. Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from iamr_tpu_torch.ns.forcing_hit import HITForcing
from iamr_tpu_torch.ns.particles import Particles, from_positions
from iamr_tpu_torch.ns.state import NSState


def state_from_numpy(fields, device, dtype: Optional[torch.dtype] = None) -> NSState:
    """NSState from a mapping or NamedTuple of array-likes with the fields of
    NSState (vel, rho, trac, temp, p, gradp, time, dt[, dsdt]). dtype
    defaults to the arrays' own."""
    if hasattr(fields, "_asdict"):
        fields = fields._asdict()

    def T(a):
        if a is None:
            return None
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    return NSState(**{k: T(fields.get(k)) for k in NSState._fields})


def hit_from_numpy(tables) -> HITForcing:
    """The port's HITForcing from another HITForcing-like object (the mode
    tables k, omega, psi, amp, phases, phases_simple, L, div_free)."""
    return HITForcing(
        k=np.asarray(tables.k), omega=np.asarray(tables.omega),
        psi=np.asarray(tables.psi), amp=np.asarray(tables.amp),
        phases=np.asarray(tables.phases),
        phases_simple=np.asarray(tables.phases_simple),
        L=tuple(float(x) for x in tables.L), div_free=bool(tables.div_free),
    )


def particles_from_numpy(pos, device, dtype=torch.float64, alive=None) -> Particles:
    """Particles from (N, dim) positions (and an optional alive mask)."""
    parts = from_positions(np.asarray(pos), device, dtype)
    if alive is None:
        return parts
    return parts._replace(
        alive=torch.as_tensor(np.asarray(alive), dtype=torch.bool, device=device))
