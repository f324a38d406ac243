"""Checkpoint and restart, single level (counterpart of
iamr_tpu/io/checkpoint.py).

The npz form: a checkpoint directory holds state.npz (every NSState field
in the run's dtype) and meta.json (format version, time, dt, step), the
same arrays and meta as the JAX package writes, so either package restarts
from the other's. particles.npz rides along when tracer particles are on.
load_checkpoint also reads AMReX-format chk directories (io/amrex_chk.py).
Both write to a temporary name and rename, so a crash never leaves a
truncated file. Loading puts the state on the card unless told otherwise.
The multi-level forms and refine_checkpoint wait for the port of AMR.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from iamr_tpu_torch.convert import state_to_numpy
from iamr_tpu_torch.io.amrex_chk import is_amrex_checkpoint, read_checkpoint_amrex
from iamr_tpu_torch.ns.particles import Particles
from iamr_tpu_torch.ns.state import NSConfig, NSState
from iamr_tpu_torch.ops.mg_nodal import grad_node_to_cell

FORMAT_VERSION = 1
CUDA = torch.device("cuda", 0)


def _atomic_savez(path: str, **arrays):
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _atomic_write_text(path: str, text: str):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def save_checkpoint(path: str, state: NSState, step: int = 0):
    """Write `path`/state.npz and `path`/meta.json."""
    os.makedirs(path, exist_ok=True)
    arrays = state_to_numpy(state)
    time, dt = float(arrays.pop("time")), float(arrays.pop("dt"))
    _atomic_savez(os.path.join(path, "state.npz"),
                  **{k: v for k, v in arrays.items() if v is not None})
    meta = {"version": FORMAT_VERSION, "time": time, "dt": dt, "step": step}
    _atomic_write_text(os.path.join(path, "meta.json"), json.dumps(meta))


def load_checkpoint(path: str, cfg: NSConfig, device=None) -> Tuple[NSState, int]:
    """(state on `device`, default the card; step) from a checkpoint of
    either format. Older npz files without gradp or temp load too: Gp is
    recomputed from the nodal pressure (the reference's
    ns.gradp_in_checkpoint = 0 path) and temp is ones."""
    device = CUDA if device is None else torch.device(device)
    if is_amrex_checkpoint(path):
        return read_checkpoint_amrex(path, cfg, device)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta["version"] != FORMAT_VERSION:
        raise ValueError(f"checkpoint version {meta['version']} != {FORMAT_VERSION}")
    dtype = cfg.tdtype

    def T(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    with np.load(os.path.join(path, "state.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    p = T(arrays["p"])
    if "gradp" in arrays:
        gradp = T(arrays["gradp"])
    else:
        gradp = torch.stack(grad_node_to_cell(p, cfg.geom.dx))
    rho = T(arrays["rho"])
    state = NSState(
        vel=T(arrays["vel"]), rho=rho, trac=T(arrays["trac"]),
        temp=T(arrays["temp"]) if "temp" in arrays else torch.ones_like(rho),
        p=p, gradp=gradp, time=T(meta["time"]), dt=T(meta["dt"]),
        dsdt=T(arrays["dsdt"]) if "dsdt" in arrays else None,
    )
    return state, int(meta["step"])


def save_particles(path: str, parts: Particles):
    """The particles beside a checkpoint (the reference keeps the particle
    container under chk*/Particles)."""
    _atomic_savez(os.path.join(path, "particles.npz"), pos=parts.pos.cpu().numpy(),
                  alive=parts.alive.cpu().numpy())


def load_particles(path: str, dtype=torch.float64, device=None) -> Optional[Particles]:
    """The particles of a checkpoint on `device` (default the card), or
    None when it has none (restart_from_nonparticle_chkfile)."""
    device = CUDA if device is None else torch.device(device)
    f = os.path.join(path, "particles.npz")
    if not os.path.exists(f):
        return None
    with np.load(f) as z:
        return Particles(pos=torch.as_tensor(z["pos"], dtype=dtype, device=device),
                         alive=torch.as_tensor(z["alive"], dtype=torch.bool, device=device))
