"""Parity of the port's Godunov PLM path with the JAX package.

f64: the plain functions (extrap_vel_to_faces, compute_edge_states +
compute_fluxes_and_aofs, advect_field) against iamr_tpu.ops.godunov at 16^3,
periodic and edge-filled ghosts; tolerance 1e-12 of max|ref| (same
arithmetic, same operation order).

f32: the kernels' plain versions (extrap_plm_ref, godunov_plm_multi_ref at
nc=5 with the slice's flags and at nc=1) against the TPU kernels run in
Pallas interpret mode. The two round differently (the TPU kernels multiply
by 1/dx and group some products otherwise), so a thresholded pick (Burgers
Riemann / upwind signs, |speed| < 1e-14) can flip on a one-ulp difference
and move one value by ~2|u|: the check is median <= 1e-6 and at most 0.1%
of values beyond 1e-5 of max|ref|, not a single max bound.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from iamr_tpu.core.bc import BCRec, MathBC, PhysBC, velocity_bcrec
from iamr_tpu.ops import godunov as jg
from iamr_tpu.ops import pallas_godunov as jpg
from iamr_tpu_torch.ops import godunov as tg
from iamr_tpu_torch.ops import godunov_kernels as tk

torch.set_num_threads(2)
N = (16, 16, 16)
DT = 0.004
DX = tuple(1.0 / x for x in N)
SLICE_FLAGS = dict(
    iconservs=[False, False, False, True, False],
    force_rows=[0, 1, 2, -1, -1],
    convs=[True, True, True, False, True],
)


def _pad(a, ng, periodic):
    return np.pad(a, ng, mode="wrap" if periodic else "edge")


def _inputs(periodic, nc=1, dtype=np.float64, seed=0):
    rng = np.random.RandomState(seed)
    vel_g = np.stack([_pad(0.4 * rng.randn(*N), 3, periodic) for _ in range(3)])
    force_g = np.stack([_pad(rng.randn(*N), 1, periodic) for _ in range(3)])
    fields = [_pad(rng.rand(*N), 3, periodic) for _ in range(nc)]
    umac = []
    for d in range(3):
        u = 0.3 * rng.randn(*[n + (1 if e == d else 0) for e, n in enumerate(N)])
        if periodic:
            hi = tuple(slice(None) if e != d else -1 for e in range(3))
            lo = tuple(slice(None) if e != d else 0 for e in range(3))
            u[hi] = u[lo]
        umac.append(u)
    cast = lambda a: a.astype(dtype)
    return (cast(vel_g), cast(force_g), [cast(f) for f in fields],
            [cast(u) for u in umac])


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _close(ref, got, tol=1e-12):
    ref = np.asarray(ref)
    got = got.numpy()
    assert ref.shape == got.shape
    scale = max(float(np.abs(ref).max()), 1e-300)
    assert float(np.abs(ref - got).max()) <= tol * scale


def _tie_flip_ok(ref, got):
    st = tk.tie_flip_stats(got, _t(np.asarray(ref), got.dtype), 1e-5)
    assert st["median"] <= 1e-6 and st["outliers"] <= 1e-3, st


def _recs(kind):
    if kind == "wall":
        lo = hi = (PhysBC.NoSlipWall,) * 3
        return [velocity_bcrec(lo, hi, c) for c in range(3)]
    return [BCRec((MathBC.int_dir,) * 3, (MathBC.int_dir,) * 3)] * 3


@pytest.mark.parametrize("periodic,bc", [(True, "int"), (False, "int"), (False, "wall")])
def test_extrap_vel_to_faces_f64(periodic, bc):
    vel_g, force_g, _, _ = _inputs(periodic)
    recs = _recs(bc)
    bl = ((0.1, 0.2, 0.3),) * 3
    bh = ((-0.1, -0.2, -0.3),) * 3
    ref = jg.extrap_vel_to_faces(jnp.asarray(vel_g), jnp.asarray(force_g), DT, DX, N,
                                 recs, bl, bh, fused=False)
    got = tg.extrap_vel_to_faces(_t(vel_g), _t(force_g), DT, DX, N, recs, bl, bh)
    for d in range(3):
        _close(ref[d], got[d])


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("iconserv", [True, False])
@pytest.mark.parametrize("force", [True, False])
def test_edge_states_fluxes_aofs_f64(periodic, iconserv, force):
    _, force_g, fields, umac = _inputs(periodic)
    per = (periodic,) * 3
    s_g = fields[0]
    fg = force_g[0] if force else None
    s_cc = s_g[3:-3, 3:-3, 3:-3]
    jug = jg.grow_umac_transverse(tuple(jnp.asarray(u) for u in umac), per)
    tum = tuple(_t(u) for u in umac)
    tug = tg.grow_umac_transverse(tum, per)
    for d in range(3):
        _close(jug[d], tug[d], tol=0.0)
    jed = jg.compute_edge_states(jnp.asarray(s_g), jug, DT, DX, N, iconserv,
                                 force_g=None if fg is None else jnp.asarray(fg),
                                 periodic=per)
    ted = tg.compute_edge_states(_t(s_g), tug, DT, DX, N, iconserv,
                                 force_g=None if fg is None else _t(fg), periodic=per)
    for d in range(3):
        _close(jed[d], ted[d])
    jfl, ja = jg.compute_fluxes_and_aofs(jed, tuple(jnp.asarray(u) for u in umac), DX,
                                         iconserv, s_cc=jnp.asarray(s_cc))
    tfl, ta = tg.compute_fluxes_and_aofs(ted, tum, DX, iconserv, s_cc=_t(s_cc))
    for d in range(3):
        _close(jfl[d], tfl[d])
    _close(ja, ta)
    # advect_field: the 3D single-field path (K3's plain version on the CPU)
    afl, aa = tg.advect_field(_t(s_g), tum, tug, DT, DX, N, iconserv, s_cc=_t(s_cc),
                              force_g=None if fg is None else _t(fg), periodic=per)
    for d in range(3):
        _close(jfl[d], afl[d])
    _close(ja, aa)


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("force", [True, False])
def test_extrap_plm_ref_vs_pallas_f32(periodic, force):
    vel_g, force_g, _, _ = _inputs(periodic, dtype=np.float32)
    fg = force_g if force else None
    ref = jpg.extrap_plm_fused(jnp.asarray(vel_g), None if fg is None else jnp.asarray(fg),
                               DT, DX, N, interpret=True)
    got = tk.extrap_plm(_t(vel_g, torch.float32),
                        None if fg is None else _t(fg, torch.float32), DT, DX, N)
    for d in range(3):
        assert got[d].dtype == torch.float32
        _tie_flip_ok(ref[d], got[d])


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("case", ["slice_nc5", "nc1_conservative", "nc1_forced"])
def test_godunov_plm_multi_ref_vs_pallas_f32(periodic, case):
    _, force_g, fields, umac = _inputs(periodic, nc=5, dtype=np.float32)
    per = (periodic,) * 3
    jum = tuple(jnp.asarray(u) for u in umac)
    jug = jg.grow_umac_transverse(jum, per)
    tum = tuple(_t(u, torch.float32) for u in umac)
    tug = tg.grow_umac_transverse(tum, per)
    f32 = lambda a: _t(a, torch.float32)
    if case == "slice_nc5":
        fl = SLICE_FLAGS
        ref = jpg.godunov_plm_fused_multi(
            [jnp.asarray(f) for f in fields], jum, jug, DT, DX, N, fl["iconservs"],
            [jnp.asarray(force_g[c]) for c in range(3)], fl["force_rows"], fl["convs"],
            periodic=per, interpret=True,
        )
        got = tk.godunov_plm_multi(
            [f32(f) for f in fields], tum, tug, DT, DX, N, fl["iconservs"],
            [f32(force_g[c]) for c in range(3)], fl["force_rows"], fl["convs"],
            periodic=per,
        )
    else:
        iconserv = case == "nc1_conservative"
        fg = None if iconserv else force_g[0]
        ref = [jpg.godunov_plm_fused(
            jnp.asarray(fields[0]), jum, jug, DT, DX, N, iconserv,
            force_g=None if fg is None else jnp.asarray(fg), periodic=per,
            interpret=True,
        )]
        got = [tk.godunov_plm(f32(fields[0]), tum, tug, DT, DX, N, iconserv,
                              force_g=None if fg is None else f32(fg), periodic=per)]
    assert len(ref) == len(got)
    for (rfl, ra), (gfl, ga) in zip(ref, got):
        for d in range(3):
            _tie_flip_ok(rfl[d], gfl[d])
        _tie_flip_ok(ra, ga)
