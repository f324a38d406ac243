"""Checkpoint and restart (counterpart of iamr_tpu/io/checkpoint.py).

The npz form: a checkpoint directory holds state.npz (every NSState field
in the run's dtype) and meta.json (format version, time, dt, step), the
same arrays and meta as the JAX package writes, so either package restarts
from the other's. particles.npz rides along when tracer particles are on.
load_checkpoint also reads AMReX-format chk directories (io/amrex_chk.py).
The multi-level form (save_checkpoint_ml) holds every level's arrays in one
state.npz (keys lev<k>_<field>) and the LevelSpecs (and any box lists) in
meta.json, as the JAX package's; load_checkpoint_ml reads it, a
single-level checkpoint as a one-level hierarchy, and the AMReX format.
refine_checkpoint is the offline ConvertCheckpoint tool. All write to a
temporary name and rename, so a crash never leaves a truncated file.
Loading puts the state on the card unless told otherwise.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional, Tuple

import numpy as np
import torch

from iamr_tpu_torch.amr.hierarchy import LevelSpec
from iamr_tpu_torch.convert import state_to_numpy
from iamr_tpu_torch.io.amrex_chk import (
    is_amrex_checkpoint,
    read_checkpoint_amrex,
    read_checkpoint_amrex_levels,
)
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


def refine_checkpoint(in_path: str, out_path: str, ratio: int = 2):
    """Refine an npz checkpoint onto a grid `ratio` times finer (the
    ConvertCheckpointGrids tool): cell data piecewise constant, the nodal
    pressure multilinear; the particles are copied."""
    with open(os.path.join(in_path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(in_path, "state.npz")) as z:
        arrays = {k: z[k] for k in z.files}

    def pc(a, first=0):
        for d in range(first, a.ndim):
            a = np.repeat(a, ratio, axis=d)
        return a

    def node_refine(p):
        out = p
        for d in range(p.ndim):
            n = out.shape[d]
            fine_n = (n - 1) * ratio + 1
            xi = np.arange(fine_n) / ratio
            i0 = np.minimum(xi.astype(int), n - 2)
            shape = [1] * out.ndim
            shape[d] = fine_n
            w = (xi - i0).reshape(shape)
            out = np.take(out, i0, axis=d) * (1 - w) + np.take(out, i0 + 1, axis=d) * w
        return out

    os.makedirs(out_path, exist_ok=True)
    fields = {"vel": pc(arrays["vel"], 1), "rho": pc(arrays["rho"]),
              "trac": pc(arrays["trac"], 1), "p": node_refine(arrays["p"])}
    if "temp" in arrays:
        fields["temp"] = pc(arrays["temp"])
    if "gradp" in arrays:
        fields["gradp"] = pc(arrays["gradp"], 1)
    if "dsdt" in arrays:
        fields["dsdt"] = pc(arrays["dsdt"])
    _atomic_savez(os.path.join(out_path, "state.npz"), **fields)
    _atomic_write_text(os.path.join(out_path, "meta.json"), json.dumps(meta))
    src = os.path.join(in_path, "particles.npz")
    if os.path.exists(src):
        shutil.copy(src, os.path.join(out_path, "particles.npz"))


def _spec_json(sp: LevelSpec):
    return {"lo": list(sp.lo), "ncell": list(sp.ncell), "ratio": sp.ratio}


def _spec_from_json(s) -> LevelSpec:
    return LevelSpec(lo=tuple(s["lo"]), ncell=tuple(s["ncell"]), ratio=int(s["ratio"]))


def save_checkpoint_ml(path: str, states, specs, step: int = 0, boxlists=None):
    """A multi-level checkpoint: every level's state in one state.npz and
    the LevelSpecs (specs[k] nests level k + 1 in level k), the times, dts
    and step in meta.json (the reference writes a Level_k directory per
    level and the grids in its Header: the same content). boxlists[k]: the
    box list of level k + 1 (None for a one-box level)."""
    os.makedirs(path, exist_ok=True)
    arrays = {}
    for lev, s in enumerate(states):
        a = state_to_numpy(s)
        for k in ("vel", "rho", "trac", "temp", "p", "gradp", "dsdt"):
            if a[k] is not None:
                arrays[f"lev{lev}_{k}"] = a[k]
    _atomic_savez(os.path.join(path, "state.npz"), **arrays)
    times = torch.stack([states[0].time, states[0].dt] + [s.dt for s in states]).tolist()
    meta = {"version": FORMAT_VERSION, "nlevels": len(states), "time": times[0],
            "dt": times[1], "dts": times[2:], "step": step,
            "specs": [_spec_json(sp) for sp in specs]}
    if boxlists is not None:
        meta["boxlists"] = [None if bl is None else [_spec_json(b) for b in bl]
                            for bl in boxlists]
    _atomic_write_text(os.path.join(path, "meta.json"), json.dumps(meta))


def load_checkpoint_ml(path: str, cfg: NSConfig, device=None):
    """(every level's state on `device`, default the card; the LevelSpecs;
    step) from a multi-level checkpoint of either format; a single-level
    npz checkpoint loads as a one-level hierarchy."""
    device = CUDA if device is None else torch.device(device)
    if is_amrex_checkpoint(path):
        return read_checkpoint_amrex_levels(path, cfg, device)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta["version"] != FORMAT_VERSION:
        raise ValueError(f"checkpoint version {meta['version']} != {FORMAT_VERSION}")
    if "nlevels" not in meta:
        state, step = load_checkpoint(path, cfg, device)
        return [state], [], step
    dtype = cfg.tdtype

    def T(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    with np.load(os.path.join(path, "state.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    states = []
    for lev in range(int(meta["nlevels"])):
        g = lambda k: T(arrays[f"lev{lev}_{k}"])
        states.append(NSState(
            vel=g("vel"), rho=g("rho"), trac=g("trac"), temp=g("temp"), p=g("p"),
            gradp=g("gradp"), time=T(meta["time"]), dt=T(meta["dts"][lev]),
            dsdt=g("dsdt") if f"lev{lev}_dsdt" in arrays else None))
    return states, [_spec_from_json(s) for s in meta["specs"]], int(meta["step"])


def load_boxlists(path: str):
    """The per-level box lists save_checkpoint_ml kept, or None (older and
    AMReX-format checkpoints)."""
    mp = os.path.join(path, "meta.json")
    if not os.path.exists(mp):
        return None
    with open(mp) as f:
        raw = json.load(f).get("boxlists")
    if raw is None:
        return None
    return [None if bl is None else tuple(_spec_from_json(b) for b in bl) for bl in raw]
