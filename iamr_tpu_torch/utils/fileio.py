"""External-data loaders (the port's numpy copy of iamr_tpu/utils/fileio.py;
reference Source/Utilities/Utilities.cpp:13-88: read_binary / read_csv, used
by the HIT tutorial's spectral-IC file path, Tutorials/HIT/prob_init.cpp and
gen_hit_ic.py): prob.ic_file of probtype 100."""

from __future__ import annotations

import numpy as np


def read_binary(path: str, nx: int, ny: int, nz: int, ncol: int) -> np.ndarray:
    """Raw little-endian float64 stream of nx*ny*nz*ncol values ->
    (nx, ny, nz, ncol) array (row-major like the reference's flat index)."""
    data = np.fromfile(path, dtype="<f8", count=nx * ny * nz * ncol)
    if data.size != nx * ny * nz * ncol:
        raise IOError(
            f"{path}: expected {nx*ny*nz*ncol} float64 values, got {data.size}"
        )
    return data.reshape(nx, ny, nz, ncol)


def read_csv(path: str, nx: int, ny: int, nz: int) -> np.ndarray:
    """CSV with one header line and nx*ny*nz data rows (the gen_hit_ic.py
    format: columns x,y,z,u,v,w)."""
    data = np.genfromtxt(path, delimiter=",", skip_header=1)
    if data.ndim == 1:
        data = data[None, :]
    if data.shape[0] != nx * ny * nz:
        raise IOError(
            f"{path}: {data.shape[0]} rows != input resolution {nx*ny*nz}"
        )
    return data


def hit_velocity_from_file(path: str, n: int, geom, urms_target=None):
    """Load a gen_hit_ic.py spectral IC (csv: x,y,z,u,v,w on an n^3 grid)
    and interpolate (piecewise-constant / nearest) onto geom's grid."""
    rows = read_csv(path, n, n, n)
    u = rows[:, 3].reshape(n, n, n)
    v = rows[:, 4].reshape(n, n, n)
    w = rows[:, 5].reshape(n, n, n)
    vel = np.stack([u, v, w])
    # nearest-sample onto the run grid
    idx = [
        np.minimum((np.arange(geom.ncell[d]) * n) // geom.ncell[d], n - 1)
        for d in range(3)
    ]
    vel = vel[:, idx[0]][:, :, idx[1]][:, :, :, idx[2]]
    if urms_target:
        urms = float(np.sqrt(np.mean(vel**2)))
        if urms > 0:
            vel *= urms_target / urms
    return vel
