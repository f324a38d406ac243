"""Carry state and tables across to and from the JAX package, as numpy arrays.

The *_from_numpy functions take host arrays (np.asarray of the JAX side's
fields) and return the port's object on `device`, so a test can feed both
packages the same state; state_to_numpy goes the other way, and the
checkpoint writers use it. hierarchy_from_numpy and hierarchy_to_numpy
carry an AMR hierarchy (per-level states and the LevelSpecs nesting them)
across the same way. Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from iamr_tpu_torch.amr.hierarchy import LevelSpec
from iamr_tpu_torch.ns.forcing_hit import HITForcing
from iamr_tpu_torch.ns.particles import Particles, from_positions
from iamr_tpu_torch.ns.state import NSState


def state_from_numpy(fields, device, dtype: Optional[torch.dtype] = None) -> NSState:
    """NSState from a mapping or NamedTuple of array-likes with the fields of
    NSState (vel, rho, trac, temp, p, gradp, time, dt[, dsdt]): the
    temperature and the dsdt of do_temp runs come across with the rest, a
    missing or None dsdt stays None. dtype defaults to the arrays' own."""
    if hasattr(fields, "_asdict"):
        fields = fields._asdict()

    def T(a):
        if a is None:
            return None
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    return NSState(**{k: T(fields.get(k)) for k in NSState._fields})


def state_to_numpy(state: NSState):
    """{field: host numpy array} of an NSState, in its own dtype (time and
    dt 0-d arrays, dsdt None where the state has none): what
    state_from_numpy and the JAX package's NSState(**...) take back."""
    return {k: None if v is None else v.detach().cpu().numpy()
            for k, v in state._asdict().items()}


def spec_from_numpy(spec) -> LevelSpec:
    """The port's LevelSpec from any object or mapping with lo, ncell and
    ratio."""
    get = spec.get if isinstance(spec, dict) else lambda k: getattr(spec, k)
    return LevelSpec(lo=tuple(int(x) for x in get("lo")),
                     ncell=tuple(int(x) for x in get("ncell")), ratio=int(get("ratio")))


def hierarchy_from_numpy(states, specs, device, dtype: Optional[torch.dtype] = None):
    """(the port's per-level NSStates, LevelSpecs) from per-level states as
    state_from_numpy takes them (level 0 first) and the specs nesting level
    k + 1 in level k (objects or mappings with lo, ncell, ratio)."""
    return ([state_from_numpy(s, device, dtype) for s in states],
            [spec_from_numpy(sp) for sp in specs])


def hierarchy_to_numpy(states, specs):
    """(per-level {field: host array} as state_to_numpy gives them, per-level
    {"lo", "ncell", "ratio"} of the specs): what hierarchy_from_numpy and
    the JAX package's NSState(**...) and LevelSpec(**...) take back."""
    return ([state_to_numpy(s) for s in states],
            [{"lo": tuple(sp.lo), "ncell": tuple(sp.ncell), "ratio": sp.ratio} for sp in specs])


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
