"""AMReX-format plotfile writer and reader (the port's numpy copy of
iamr_tpu/io/plotfile.py).

Plotfiles readable by the AMReX toolchain (amrvis, fcompare, yt), so that
results compare with the reference's outputs directly (the reference's
writePlotFile, NavierStokes.cpp:1087-1223). Layout:

    pltNNNNN/Header                text header (HyperCLaw-V1.1)
    pltNNNNN/Level_k/Cell_H        MultiFab header
    pltNNNNN/Level_k/Cell_D_0000i  FAB data (native-endian float64)

The same bytes as the JAX package's writer for the same fields. The
multi-level arguments come along with the format; the port's driver writes
single-level plotfiles only.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from iamr_tpu_torch.core.geometry import Geometry
from iamr_tpu_torch.io.vismf import assemble_level, box_str, read_vismf, write_vismf


def _write_level_multi(path: str, lev: int, boxes, names):
    """One Level_k directory holding a BoxArray of grids (one FAB file per
    grid, VisMF OneFilePerFab). boxes: list of (fields, lo, hi)."""
    fabs = [([fields[k] for k in names], lo, hi) for fields, lo, hi in boxes]
    write_vismf(os.path.join(path, f"Level_{lev}", "Cell"), fabs, len(names))


def write_plotfile(path: str, geom: Geometry, fields: Dict[str, np.ndarray],
                   time: float = 0.0, level_steps: int = 0, fine_levels=None):
    """Write a plotfile (multi-level when fine_levels is given).

    fields: name -> cell array (*ncell) on the coarse level.
    fine_levels: one entry per finer level, either (fields_f, lo_idx,
    ratio) for a single-grid level (lo_idx in that level's index space) or
    (boxes, ratio) with boxes = [(fields_f, lo_idx), ...] for a multi-grid
    level."""
    dim = geom.dim
    names = list(fields.keys())
    ncomp = len(names)
    lo = (0,) * dim
    hi = tuple(x - 1 for x in geom.ncell)
    fine_levels = fine_levels or []
    nlev = 1 + len(fine_levels)

    _write_level_multi(path, 0, [(fields, lo, hi)], names)

    level_boxes = [[(lo, hi)]]
    dxs = [tuple(geom.dx)]
    ratios = []
    cum = 1
    for k, entry in enumerate(fine_levels):
        grids, ratio = ([(entry[0], entry[1])], entry[2]) if len(entry) == 3 else entry
        cum *= ratio
        lev_boxes, blist = [], []
        for ff, lo_idx in grids:
            shape = np.asarray(ff[names[0]]).shape
            lo_k = tuple(int(x) for x in lo_idx)
            hi_k = tuple(lo_k[d] + shape[d] - 1 for d in range(dim))
            lev_boxes.append((lo_k, hi_k))
            blist.append((ff, lo_k, hi_k))
        level_boxes.append(lev_boxes)
        dxs.append(tuple(h / cum for h in geom.dx))
        ratios.append(ratio)
        _write_level_multi(path, k + 1, blist, names)

    with open(os.path.join(path, "Header"), "w") as f:
        f.write("HyperCLaw-V1.1\n")
        f.write(f"{ncomp}\n")
        for k in names:
            f.write(k + "\n")
        f.write(f"{dim}\n")
        f.write(f"{time:.16e}\n")
        f.write(f"{nlev - 1}\n")  # finest_level
        f.write(" ".join(f"{v:.16e}" for v in geom.prob_lo) + "\n")
        f.write(" ".join(f"{v:.16e}" for v in geom.prob_hi) + "\n")
        f.write(" ".join(str(r) for r in ratios) + "\n")
        f.write(" ".join(box_str(b[0][0], b[-1][1]) for b in level_boxes) + "\n")
        f.write(" ".join(str(level_steps) for _ in range(nlev)) + "\n")
        for dx in dxs:
            f.write(" ".join(f"{v:.16e}" for v in dx) + "\n")
        f.write(f"{geom.coord_sys}\n")
        f.write("0\n")  # boundary width
        for k in range(nlev):
            f.write(f"{k} {len(level_boxes[k])} {time:.16e}\n")
            f.write(f"{level_steps}\n")
            for blo, bhi in level_boxes[k]:
                for d in range(dim):
                    glo = geom.prob_lo[d] + blo[d] * dxs[k][d]
                    ghi = geom.prob_lo[d] + (bhi[d] + 1) * dxs[k][d]
                    f.write(f"{glo:.16e} {ghi:.16e}\n")
            f.write(f"Level_{k}/Cell\n")


def read_plotfile(path: str):
    """Read back a plotfile's level 0 -> ({name: array}, time)."""
    with open(os.path.join(path, "Header")) as f:
        lines = [ln.rstrip("\n") for ln in f]
    if not lines[0].startswith("HyperCLaw"):
        raise ValueError(f"{path}: not a plotfile (header {lines[0]!r})")
    ncomp = int(lines[1])
    names = lines[2: 2 + ncomp]
    time = float(lines[2 + ncomp + 1])
    boxes, nc = read_vismf(os.path.join(path, "Level_0", "Cell"))
    if nc != ncomp:
        raise ValueError(f"{path}: {nc} components in Level_0, {ncomp} in the Header")
    data = assemble_level(boxes, ncomp)
    return {k: data[c] for c, k in enumerate(names)}, time
