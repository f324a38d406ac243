"""AMReX-format checkpoint directories (chkNNNNN/): write and restart, one
level or a hierarchy of single-box levels (counterpart of
iamr_tpu/io/amrex_chk.py).

The layout of the reference's checkpoint machinery (NavierStokesBase::
checkPoint -> AmrLevel::checkPoint -> StateData::checkPoint -> VisMF): one
text `Header` (Amr::checkPoint) and per level `Level_k/SD_i_New_MF` VisMF
MultiFabs, one per state type (NS_setup.cpp):

    SD_0  State_Type  cell  [xvel..(zvel), density, tracer.., (temp)]
    SD_1  Press_Type  node  [pressure]
    SD_2  Gradp_Type  cell  [gpx..(gpz)]
    SD_3  Dsdt        cell  (only when present)

A level k > 0 is one box whose lo is the LevelSpec's (in level k's index
space, relative to the parent's patch, as the JAX package writes it).
The writer makes the same bytes as the JAX package's for the same states.
The reader is tolerant in the same ways as the JAX package's, so that the
reference's own checkpoints restart: it keys on the fixed numeric header
lines and the self-describing VisMF headers, recomputes Gp from the nodal
pressure when SD_2 is absent (ns.gradp_in_checkpoint = 0) and takes temp
as ones when State_Type carries none. A level of several boxes is
assembled over its bounding box, as the JAX package does. Each level's
time is its State_Type's new time, as AMReX restores it, so that a
subcycled fine level (whose time accumulates over its subcycles) restarts
bit for bit; the JAX package's reader gives every level the Header's
cumulative time.
"""

from __future__ import annotations

import os
import re
from typing import List

import numpy as np
import torch

from iamr_tpu_torch.amr.hierarchy import LevelSpec
from iamr_tpu_torch.io.vismf import assemble_level, box_str, read_vismf, write_vismf
from iamr_tpu_torch.ns.state import NSState
from iamr_tpu_torch.ops.mg_nodal import grad_node_to_cell

CHK_VERSION = "CheckPointVersion_1.0"


def _state_comps(cfg) -> List[str]:
    names = ["xvel", "yvel", "zvel"][: cfg.dim] + ["density"]
    names += [f"tracer{i if i else ''}" for i in range(cfg.ntrac)]
    if cfg.do_temp:
        names.append("temp")
    return names


def _geom_str(cfg, specs=()) -> str:
    """The Geometry of the level below `specs` (the LevelSpecs of the levels
    above it) in the reference's stream form:
    (coord (offset)(cellsize))(RealBox lo hi ...)((domain box))P(periodic)."""
    g = cfg.geom
    ratio = 1
    for sp in specs:
        ratio *= sp.ratio
    dx = tuple(h / ratio for h in g.dx)
    n = tuple(c * ratio for c in g.ncell)
    cs = (f"({g.coord_sys} "
          + "(" + ",".join(str(float(v)) for v in g.prob_lo) + ")"
          + "(" + ",".join(repr(float(v)) for v in dx) + "))")
    rb = "(RealBox " + " ".join(
        f"{float(lo)} {float(hi)}" for lo, hi in zip(g.prob_lo, g.prob_hi)) + " )"
    dom = box_str((0,) * cfg.dim, tuple(x - 1 for x in n))
    per = "(" + ",".join(str(int(p)) for p in g.periodic) + ")"
    return cs + rb + dom + "P" + per


def write_checkpoint_amrex(path: str, state: NSState, cfg, step: int = 0):
    """Write a single-level chkNNNNN directory in the AMReX layout."""
    write_checkpoint_amrex_levels(path, [state], [], cfg, step)


def write_checkpoint_amrex_levels(path: str, states, specs, cfg, step: int = 0):
    """Write a chkNNNNN directory of the levels `states` (level 0 first),
    specs[k] nesting level k + 1 in level k (one box a level)."""
    dim = cfg.dim
    nlev = len(states)
    os.makedirs(path, exist_ok=True)
    hdr = [float(x) for x in torch.stack([states[0].time] + [s.dt for s in states]).tolist()]
    t0, dts = hdr[0], hdr[1:]
    lines = [
        CHK_VERSION, str(dim), repr(t0),
        str(nlev - 1),          # max_level as written (the restart's cap)
        str(nlev - 1),          # finest_level
        " ".join(_geom_str(cfg, specs[:k]) for k in range(nlev)),
        " ".join("(" + ",".join([str(specs[k].ratio)] * dim) + ")" for k in range(nlev - 1)),
        " ".join(repr(dt) for dt in dts),   # dt_level
        " ".join(repr(dt) for dt in dts),   # dt_min
        " ".join(["1"] + [str(specs[k].ratio) for k in range(nlev - 1)]),  # n_cycle
        " ".join(str(step) for _ in states),  # level_steps
        " ".join("0" for _ in states),        # level_count
    ]

    def host(a):
        return a.cpu().numpy()

    for lev, state in enumerate(states):
        lev_dir = f"Level_{lev}"
        os.makedirs(os.path.join(path, lev_dir), exist_ok=True)
        t = float(state.time)
        lo = (0,) * dim if lev == 0 else tuple(specs[lev - 1].lo)
        hi = tuple(lo[d] + state.rho.shape[d] - 1 for d in range(dim))
        state_comps = ([host(state.vel[d]) for d in range(dim)] + [host(state.rho)]
                       + [host(state.trac[i]) for i in range(state.trac.shape[0])]
                       + ([host(state.temp)] if cfg.do_temp else []))
        if len(state_comps) != len(_state_comps(cfg)):
            raise ValueError(f"{len(state_comps)} state components for {_state_comps(cfg)}")
        sds = [("SD_0", state_comps, (0,) * dim, hi),
               ("SD_1", [host(state.p)], (1,) * dim, tuple(h + 1 for h in hi)),
               ("SD_2", [host(state.gradp[d]) for d in range(dim)], (0,) * dim, hi)]
        if state.dsdt is not None:
            sds.append(("SD_3", [host(state.dsdt)], (0,) * dim, hi))
        lines += [str(lev), _geom_str(cfg, specs[:lev]), "(1 0", box_str(lo, hi), ")"]
        for name, comps, typ, hi_t in sds:
            mf_rel = f"{lev_dir}/{name}_New_MF"
            lines += [box_str(lo, hi_t, typ), "(1 0", box_str(lo, hi_t, typ), ")",
                      repr(t), repr(t), repr(t), repr(t), "1", mf_rel]
            write_vismf(os.path.join(path, mf_rel), [(comps, lo, hi_t)], len(comps), typ=typ)
    with open(os.path.join(path, "Header"), "w") as f:
        f.write("\n".join(lines) + "\n")


def _floats(s: str) -> List[float]:
    return [float(x) for x in re.findall(r"-?\d+\.?\d*(?:[eE][-+]?\d+)?", s)]


def _read_sd(path: str, lev: int, i: int):
    prefix = os.path.join(path, f"Level_{lev}", f"SD_{i}_New_MF")
    if not os.path.exists(prefix + "_H"):
        return None
    return read_vismf(prefix)


def read_checkpoint_amrex(path: str, cfg, device):
    """Restart from an AMReX chk directory -> (level 0's state on `device`,
    step)."""
    states, _, step = read_checkpoint_amrex_levels(path, cfg, device)
    return states[0], step


def read_checkpoint_amrex_levels(path: str, cfg, device):
    """Restart from an AMReX chk directory -> (every level's state on
    `device`, the LevelSpecs of the levels above 0, step). Reads the JAX
    package's and the reference's."""
    with open(os.path.join(path, "Header")) as f:
        header = [ln.rstrip("\n") for ln in f]
    if not header[0].startswith("CheckPointVersion"):
        raise ValueError(f"{path}: not an AMReX checkpoint (v: {header[0]})")
    dim = int(header[1])
    if dim != cfg.dim:
        raise ValueError(f"checkpoint is {dim}D, config is {cfg.dim}D")
    cumtime = float(header[2])
    finest = int(header[4])
    ratio_ints = [int(x) for x in re.findall(r"-?\d+", header[6])]
    # the IntVect form repeats the ratio per dim; the scalar form has one a level
    ratios = (ratio_ints[::dim] if len(ratio_ints) == finest * dim
              else (ratio_ints or [2] * finest))
    # Amr::checkPoint writes dt_level and level_steps on fixed lines after
    # the geometry: a Header laid out otherwise fails loudly
    dt_level = _floats(header[7]) or [0.0] * (finest + 1)
    if len(dt_level) < finest + 1 or any(not (d >= 0.0) for d in dt_level[: finest + 1]):
        raise ValueError(f"{path}: Header line 8 does not parse as dt_level for "
                         f"finest_level={finest} (got {dt_level!r}); unsupported "
                         f"checkpoint Header layout")
    steps = [int(x) for x in _floats(header[10])] or [0]
    if len(steps) < finest + 1 or any(s < 0 for s in steps[: finest + 1]):
        raise ValueError(f"{path}: Header line 11 does not parse as level_steps "
                         f"(got {steps!r}); unsupported checkpoint Header layout")

    dtype = cfg.tdtype

    def T(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    def level_time(lev):
        """The level's new-time stop in its State_Type entry (old start,
        old stop, new start, new stop, nsets, then the MultiFab names), as
        AMReX restores each level's time; the Header's cumulative time
        where that entry does not parse (the JAX package's reader takes
        the cumulative time for every level)."""
        name = f"Level_{lev}/SD_0_New_MF"
        for i, line in enumerate(header):
            if line.strip() == name and i >= 2:
                try:
                    return float(header[i - 2])
                except ValueError:
                    break
        return cumtime

    states, specs = [], []
    for lev in range(finest + 1):
        sd0 = _read_sd(path, lev, 0)
        if sd0 is None:
            raise IOError(f"{path}/Level_{lev}/SD_0_New_MF missing")
        boxes0, nc0 = sd0
        lo0 = tuple(min(b[0][d] for b in boxes0) for d in range(dim))
        state_arr = assemble_level(boxes0, nc0, lo0=lo0)
        shape = state_arr.shape[1:]
        n_extra = nc0 - dim - 1
        ntr_file = n_extra - (1 if cfg.do_temp and n_extra > cfg.ntrac else 0)
        ntr_file = max(0, min(ntr_file, n_extra))
        trac = state_arr[dim + 1: dim + 1 + ntr_file]
        if trac.shape[0] < cfg.ntrac:
            pad = np.zeros((cfg.ntrac - trac.shape[0],) + shape)
            trac = np.concatenate([trac, pad], 0) if trac.size else pad
        else:
            trac = trac[: cfg.ntrac]
        temp = (state_arr[dim + 1 + ntr_file] if nc0 > dim + 1 + ntr_file
                else np.ones(shape))
        sd1 = _read_sd(path, lev, 1)
        if sd1 is None:
            raise IOError(f"{path}/Level_{lev}/SD_1_New_MF missing")
        p = T(assemble_level(sd1[0], 1, lo0=lo0)[0])
        sd2 = _read_sd(path, lev, 2)
        if sd2 is not None:
            gradp = T(assemble_level(sd2[0], sd2[1], lo0=lo0))
        else:
            ratio = 1
            for r in ratios[:lev]:
                ratio *= r
            gradp = torch.stack(grad_node_to_cell(p, tuple(h / ratio for h in cfg.geom.dx)))
        sd3 = _read_sd(path, lev, 3)
        states.append(NSState(
            vel=T(state_arr[:dim]), rho=T(state_arr[dim]), trac=T(trac), temp=T(temp),
            p=p, gradp=gradp, time=T(level_time(lev)),
            dt=T(dt_level[lev] if lev < len(dt_level) else dt_level[-1]),
            dsdt=T(assemble_level(sd3[0], sd3[1], lo0=lo0)[0]) if sd3 is not None else None,
        ))
        if lev > 0:
            specs.append(LevelSpec(lo=lo0, ncell=shape, ratio=int(ratios[lev - 1])))
    return states, specs, steps[0]


def is_amrex_checkpoint(path: str) -> bool:
    hdr = os.path.join(path, "Header")
    if not os.path.exists(hdr):
        return False
    with open(hdr) as f:
        return f.readline().startswith("CheckPointVersion")
