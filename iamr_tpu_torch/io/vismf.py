"""AMReX VisMF MultiFab binary I/O (the port's numpy copy of
iamr_tpu/io/vismf.py): one `_H` text header and one `_D_0000i` FAB data file
per MultiFab.

This is the on-disk unit of both plotfiles (Level_k/Cell) and AMReX-format
checkpoints (Level_k/SD_i_New_MF) in the reference (NavierStokesBase.cpp
checkPoint via VisMF; NavierStokes.cpp writePlotFile). What matters for
fcompare/amrvis/yt and for restarts in either package:

  * the FabOnDisk offset in the _H header is the position of the FAB
    header line ("FAB ((8, ...") in the data file, not of the payload:
    AMReX's VisMF::readFAB seeks there and parses the header again. The
    reader skips the header line where it finds one, and takes older files'
    payload offsets as they are;
  * each FAB payload is component-major, Fortran-ordered (x fastest),
    native-endian float64;
  * node-centred MultiFabs (the nodal pressure) carry the box type in the
    BoxArray entries and in each FAB header.

Files are the same bytes as the JAX package writes for the same values.
A FAB's data may be one (ncomp, *shape) array or a sequence of ncomp
arrays; a Fortran-ordered float64 component is written without a copy.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Sequence, Tuple

import numpy as np

FAB_MAGIC = "FAB ((8, (64 11 52 0 1 12 0 1023)),(8, (8 7 6 5 4 3 2 1)))"


def box_str(lo, hi, typ=None) -> str:
    """An AMReX Box string `((lo) (hi) (typ))`."""
    t = typ if typ is not None else (0,) * len(lo)
    return "(" + " ".join("(" + ",".join(str(x) for x in v) + ")" for v in (lo, hi, t)) + ")"


def parse_box(s: str) -> Tuple[Tuple[int, ...], Tuple[int, ...], Tuple[int, ...]]:
    """Parse an AMReX Box string `((lo) (hi) (typ))` (typ optional)."""
    groups = re.findall(r"\(([-\d,\s]+)\)", s)
    nums = [[int(x) for x in re.findall(r"-?\d+", g)] for g in groups]
    nums = [g for g in nums if g]
    lo, hi = nums[0], nums[1]
    typ = nums[2] if len(nums) > 2 else [0] * len(lo)
    return tuple(lo), tuple(hi), tuple(typ)


def _write_fab(path: str, comps, lo, hi, typ):
    """One FAB file (one FAB a file, so its header is at offset 0): the
    header line, then each component in Fortran order."""
    with open(path, "wb") as f:
        f.write(f"{FAB_MAGIC}{box_str(lo, hi, typ)} {len(comps)}\n".encode())
        for c in comps:
            # the transpose of a Fortran-ordered array is C-contiguous: its
            # buffer is the payload
            f.write(np.asfortranarray(c).T)


def write_vismf(prefix: str, fabs: Sequence, ncomp: int,
                typ: Optional[Tuple[int, ...]] = None) -> None:
    """Write one MultiFab: `{prefix}_H` and one `{prefix}_D_0000i` per FAB.

    fabs: list of (data, lo, hi), data an (ncomp, *shape) array or a
    sequence of ncomp arrays, hi inclusive in the box's own index type."""
    dirname = os.path.dirname(prefix)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    base = os.path.basename(prefix)
    mins = [[] for _ in range(ncomp)]
    maxs = [[] for _ in range(ncomp)]
    dim = None
    for i, (data, lo, hi) in enumerate(fabs):
        comps = [np.asarray(data[c], dtype=np.float64) for c in range(ncomp)]
        dim = comps[0].ndim
        t = typ if typ is not None else (0,) * dim
        _write_fab(f"{prefix}_D_{i:05d}", comps, lo, hi, t)
        for c in range(ncomp):
            mins[c].append(float(comps[c].min()))
            maxs[c].append(float(comps[c].max()))

    t = typ if typ is not None else (0,) * (dim or 2)
    nb = len(fabs)
    with open(f"{prefix}_H", "w") as f:
        f.write("1\n")   # header version (Version_v1: FABs carry headers)
        f.write("1\n")   # how
        f.write(f"{ncomp}\n")
        f.write("0\n")   # ngrow
        f.write(f"({nb} 0\n")
        for _, lo, hi in fabs:
            f.write(box_str(lo, hi, t) + "\n")
        f.write(")\n")
        f.write(f"{nb}\n")
        for i in range(nb):
            f.write(f"FabOnDisk: {base}_D_{i:05d} 0\n")
        for bound in (mins, maxs):
            f.write("\n")
            f.write(f"{nb},{ncomp}\n")
            for i in range(nb):
                f.write(",".join(f"{bound[c][i]:.16e}" for c in range(ncomp)) + ",\n")


def read_fab_payload(path: str, offset: int, shape: Tuple[int, ...],
                     ncomp: int) -> np.ndarray:
    """Read one FAB payload -> C-order (ncomp, *shape). Seeks to `offset`;
    where the bytes there start with the FAB magic the header line is
    skipped (AMReX semantics), otherwise `offset` is the payload's start."""
    dim = len(shape)
    npts = int(np.prod(shape))
    with open(path, "rb") as f:
        f.seek(offset)
        head = f.read(4)
        f.seek(offset)
        if head == b"FAB ":
            f.readline()
        raw = np.frombuffer(f.read(8 * ncomp * npts), dtype=np.float64)
    if raw.size != ncomp * npts:
        raise IOError(f"truncated FAB payload in {path} @ {offset}")
    return np.ascontiguousarray(
        raw.reshape((ncomp,) + shape[::-1]).transpose((0,) + tuple(range(dim, 0, -1))))


def read_vismf(prefix: str):
    """Read a MultiFab -> (boxes, ncomp), boxes a list of
    (lo, hi, typ, data[ncomp, *shape])."""
    with open(f"{prefix}_H") as f:
        lines = [ln.rstrip("\n") for ln in f]
    ncomp = int(lines[2])
    # BoxArray block: "(N M", N box lines, ")"
    i = next(k for k, ln in enumerate(lines) if re.match(r"^\(\d+\s+\d+\s*$", ln.strip()))
    nb = int(lines[i].strip("( ").split()[0])
    box_lines = lines[i + 1: i + 1 + nb]
    fods = []
    for ln in lines:
        if ln.startswith("FabOnDisk:"):
            parts = ln.split()
            fods.append((parts[1], int(parts[2])))
    if len(fods) != nb:
        raise IOError(f"{prefix}_H: {len(fods)} FabOnDisk lines for {nb} boxes")
    dirname = os.path.dirname(prefix)
    out = []
    for (fname, offset), bln in zip(fods, box_lines):
        lo, hi, typ = parse_box(bln)
        shape = tuple(h - l + 1 for l, h in zip(lo, hi))
        data = read_fab_payload(os.path.join(dirname, fname), offset, shape, ncomp)
        out.append((lo, hi, typ, data))
    return out, ncomp


def assemble_level(boxes, ncomp: int, lo0=None, shape=None) -> np.ndarray:
    """Paste a list of (lo, hi, typ, data) FABs into one dense
    (ncomp, *shape) array anchored at lo0 (defaults: the BoxArray's
    bounding box)."""
    dim = len(boxes[0][0])
    if lo0 is None:
        lo0 = tuple(min(b[0][d] for b in boxes) for d in range(dim))
    if shape is None:
        hi0 = tuple(max(b[1][d] for b in boxes) for d in range(dim))
        shape = tuple(h - l + 1 for l, h in zip(lo0, hi0))
    out = np.zeros((ncomp,) + tuple(shape))
    for lo, hi, _typ, data in boxes:
        idx = tuple(slice(lo[d] - lo0[d], hi[d] - lo0[d] + 1) for d in range(dim))
        out[(slice(None),) + idx] = data
    return out
