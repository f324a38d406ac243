"""Godunov-PLM kernels: CUDA wrappers and their plain PyTorch versions
(counterpart of iamr_tpu/ops/pallas_godunov.py).

  extrap_plm        K1, replaces pallas_godunov.extrap_plm_fused
  godunov_plm_multi K2, replaces pallas_godunov.godunov_plm_fused_multi
  godunov_plm       K3 (one field), replaces pallas_godunov.godunov_plm_fused;
                    it runs the K2 kernel at nc = 1

Dispatch: a CPU tensor goes to the plain version (extrap_plm_ref,
godunov_plm_multi_ref, built from ops/godunov.py); a CUDA tensor goes to the
kernel (csrc/godunov_plm.cu, f32 or f64, any extents whose field with its 3
ghosts stays below 2^31 elements, the kernels' 32-bit offsets) or raises.
Each wrapper counts its kernel launches in LAUNCHES, one per call that
launches.

The kernels' design (csrc/godunov_plm.cu): one CUDA launch per call (K2: per
8 fields), no hat scratch buffer. A block owns a tile of (dim 1, dim 2) and a
segment of dim 0 along which it marches, one thread per cell of the tile
grown by HAT_HALO; a cell's column along dim 0 (values, slopes, the dim-0 hat
and predictor states) stays in registers, what its neighbours in the plane
read (the plane with a halo of S_HALO, slopes, hat states, corrections,
fluxes) goes through shared memory, and nothing but inputs and outputs
touches device memory. Device-memory bytes bound both kernels; the design
reads each input plane once per block (halos recomputed), forms a cell's
slope once for its two faces and a cell's transverse term once for the faces
of all directions, and runs the nc fields of a tile as neighbouring blocks so
that umac_g meets in L2. What caps them on an H100 is the instruction stream
without multiply-add contraction (PERF.md). K2 reads the face velocities from
umac_g alone (its real part is umac, as grow_umac_transverse builds it), as
the TPU kernel does: a caller's umac_g must be grow_umac_transverse(umac), or
the card and the plain version (which takes the fluxes' velocities from
umac) answer differently. The windows the design rests on are checked on the CPU
(tests/test_torch_kernels.py): the plain versions evaluated on a tile with
these halos equal the full-box result bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from iamr_tpu_torch import native
from iamr_tpu_torch.core.bc import BCRec, MathBC
from iamr_tpu_torch.ops import godunov

LAUNCHES = {"extrap_plm": 0, "godunov_plm_multi": 0}
# What a tile of outputs reads beyond itself, in cells: the field (3 ghosts)
# S_HALO in every dim; force, umac_g and the hat states HAT_HALO in the
# transverse dims. A conservative field's normal-ghost d(umac)/dx also takes
# umac_g UMAC_NORMAL_HALO faces further along the normal (wrapped or the edge
# copied at the domain boundary).
S_HALO = 3
HAT_HALO = 1
UMAC_NORMAL_HALO = 1
MAX_ELEMS = 2**31  # of a field with its ghosts


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def smem_bytes(name, dtype):
    """Dynamic shared memory (bytes) of a block of kernel `name` (builds
    the library on first use)."""
    return native.kernels().godunov_plm_smem_bytes(
        list(LAUNCHES).index(name), native.DTYPES[dtype])


def _check_box(name, n):
    """Raise unless n is a 3D box the kernels' 32-bit offsets can index."""
    if len(n) != 3:
        raise ValueError(f"{name}: 3D boxes only, got {n}")
    if (n[0] + 6) * (n[1] + 6) * (n[2] + 6) >= MAX_ELEMS:
        raise ValueError(f"{name}: box {n} with 3 ghosts has 2^31 elements or more")


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*[0 if t is None else t.data_ptr() for t in ts])


def tie_flip_stats(got, ref, rel_tol):
    """Agreement of a kernel with its plain version where thresholded picks
    can flip on a one-ulp difference: |got - ref| / max|ref| summarised by
    its median, its max, and the fraction of elements above rel_tol."""
    scale = max(float(ref.abs().max()), 1e-30)
    err = (got - ref).abs().double().reshape(-1) / scale
    return {
        "median": float(err.median()),
        "outliers": float((err > rel_tol).double().mean()),
        "max": float(err.max()),
    }


def _face_shape(n, d):
    return tuple(n[e] + (1 if e == d else 0) for e in range(3))


# ---------------------------------------------------------------------------
# K1: PLM ExtrapVelToFaces


def extrap_plm_ref(vel_g, force_g, dt, dx, ncell):
    """Plain version of K1: the unpinned MAC face velocities."""
    recs = [BCRec((MathBC.int_dir,) * 3, (MathBC.int_dir,) * 3)] * 3
    zero3 = ((0.0,) * 3,) * 3
    return godunov.extrap_vel_to_faces(
        vel_g, force_g, dt, dx, ncell, recs, zero3, zero3, fused=False
    )


def extrap_plm(vel_g, force_g, dt, dx: Sequence[float], ncell: Sequence[int]):
    """K1: predicted MAC face velocities (u0, u1, u2), before BC pinning.

    vel_g: (3, n+6...) velocity with 3 ghosts; force_g: (3, n+2...) with 1
    ghost, or None; dt: scalar or 0-d tensor."""
    n = tuple(int(x) for x in ncell)
    if vel_g.device.type == "cpu":
        return extrap_plm_ref(vel_g, force_g, dt, dx, n)
    _check_box("extrap_plm", n)
    if vel_g.device.type != "cuda":
        raise ValueError(f"extrap_plm: CUDA or CPU tensors only, got {vel_g.device}")
    dtype, dev = vel_g.dtype, vel_g.device
    if dtype not in native.DTYPES:
        raise ValueError(f"extrap_plm: dtype {dtype}")
    native.check_tensor("vel_g", vel_g, (3,) + tuple(x + 6 for x in n), dtype, dev)
    if force_g is not None:
        native.check_tensor("force_g", force_g, (3,) + tuple(x + 2 for x in n), dtype, dev)
    lib = native.kernels()
    dt_t = godunov._as_dt(dt, vel_g).reshape(())
    out = [torch.empty(_face_shape(n, d), dtype=dtype, device=dev) for d in range(3)]
    forces = [None] * 3 if force_g is None else [force_g[c] for c in range(3)]
    rc = lib.extrap_plm(
        native.DTYPES[dtype], _ptrs([vel_g[c] for c in range(3)]), _ptrs(forces),
        dt_t.data_ptr(), (ctypes.c_double * 3)(*[float(h) for h in dx]),
        (ctypes.c_int * 3)(*n), _ptrs(out),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    native.check_rc(rc, "extrap_plm")
    LAUNCHES["extrap_plm"] += 1
    return tuple(out)


# ---------------------------------------------------------------------------
# K2/K3: multi-field PLM advection


def godunov_plm_multi_ref(s_gs, umac, umac_g, dt, dx, ncell, iconservs,
                          force_gs, force_rows, convs, periodic=None):
    """Plain version of K2: per field compute_edge_states +
    compute_fluxes_and_aofs. Returns [(fluxes, aofs)] per field."""
    n = tuple(int(x) for x in ncell)
    out = []
    for j, s_g in enumerate(s_gs):
        fg = force_gs[force_rows[j]] if force_rows[j] >= 0 else None
        edges = godunov.compute_edge_states(
            s_g, umac_g, dt, dx, n, bool(iconservs[j]), force_g=fg,
            periodic=periodic,
        )
        s_cc = s_g[3:-3, 3:-3, 3:-3] if convs[j] else None
        out.append(godunov.compute_fluxes_and_aofs(
            edges, umac, dx, not convs[j], s_cc=s_cc
        ))
    return out


def godunov_plm_multi(s_gs, umac, umac_g, dt, dx, ncell, iconservs, force_gs,
                      force_rows, convs, periodic=None):
    """K2: fluxes and advective tendencies of all advected fields of a step.

    s_gs: nc fields with 3 ghosts; umac: MAC velocities on the real faces;
    umac_g: grow_umac_transverse(umac); the kernel reads the face velocities
    there alone, so its real part must equal umac (only shapes are checked);
    force_gs: forces (1 ghost) of the fields that have one, force_rows[j] the
    row of field j or -1;
    iconservs/convs: per-field conservative-correction and convective-output
    flags; periodic: per-dim flags (the normal-ghost d(umac)/dx wraps when
    periodic, else copies the edge). Returns [((fx, fy, fz), aofs)]."""
    n = tuple(int(x) for x in ncell)
    nc = len(s_gs)
    if s_gs[0].device.type == "cpu":
        return godunov_plm_multi_ref(s_gs, umac, umac_g, dt, dx, n, iconservs,
                                     force_gs, force_rows, convs, periodic)
    _check_box("godunov_plm_multi", n)
    dtype, dev = s_gs[0].dtype, s_gs[0].device
    if dev.type != "cuda" or dtype not in native.DTYPES:
        raise ValueError(f"godunov_plm_multi: f32/f64 CUDA or CPU tensors only, "
                         f"got {dtype} on {dev}")
    for j, s in enumerate(s_gs):
        native.check_tensor(f"s_gs[{j}]", s, tuple(x + 6 for x in n), dtype, dev)
    for d in range(3):
        native.check_tensor(f"umac[{d}]", umac[d], _face_shape(n, d), dtype, dev)
        gshape = tuple(n[e] + (1 if e == d else 2) for e in range(3))
        native.check_tensor(f"umac_g[{d}]", umac_g[d], gshape, dtype, dev)
    for k, f in enumerate(force_gs):
        native.check_tensor(f"force_gs[{k}]", f, tuple(x + 2 for x in n), dtype, dev)
    if len(force_rows) != nc or len(iconservs) != nc or len(convs) != nc:
        raise ValueError("godunov_plm_multi: per-field flag lists must have nc entries")
    per = tuple(bool(p) for p in periodic) if periodic is not None else (False,) * 3
    lib = native.kernels()
    dt_t = godunov._as_dt(dt, s_gs[0]).reshape(())
    fx = torch.empty((nc,) + _face_shape(n, 0), dtype=dtype, device=dev)
    fy = torch.empty((nc,) + _face_shape(n, 1), dtype=dtype, device=dev)
    fz = torch.empty((nc,) + _face_shape(n, 2), dtype=dtype, device=dev)
    aofs = torch.empty((nc,) + n, dtype=dtype, device=dev)
    forces = [force_gs[r] if r >= 0 else None for r in force_rows]
    ints = lambda xs: (ctypes.c_int * len(xs))(*[int(bool(x)) for x in xs])
    rc = lib.godunov_plm_multi(
        native.DTYPES[dtype], nc, _ptrs(list(s_gs)), _ptrs(forces), _ptrs(list(umac_g)),
        dt_t.data_ptr(), ints(iconservs), ints(convs),
        ints(per), (ctypes.c_double * 3)(*[float(h) for h in dx]),
        (ctypes.c_int * 3)(*n), _ptrs(list(fx)), _ptrs(list(fy)), _ptrs(list(fz)),
        _ptrs(list(aofs)),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    native.check_rc(rc, "godunov_plm_multi")
    LAUNCHES["godunov_plm_multi"] += 1
    return [((fx[j], fy[j], fz[j]), aofs[j]) for j in range(nc)]


def godunov_plm(s_g, umac, umac_g, dt, dx, ncell, iconserv: bool,
                force_g=None, periodic=None):
    """K3: one field's ((fx, fy, fz), aofs) through the K2 kernel at nc = 1
    (convective output when not iconserv, as godunov_plm_fused)."""
    forces = [force_g] if force_g is not None else []
    rows = [0 if force_g is not None else -1]
    return godunov_plm_multi(
        [s_g], umac, umac_g, dt, dx, ncell, [iconserv], forces, rows,
        [not iconserv], periodic=periodic,
    )[0]
