"""The port's CUDA Godunov kernels against their plain PyTorch versions on the
card (iamr_tpu_torch/ops/godunov_kernels.py; those tests are skipped without
a CUDA device), and, on the CPU, the windows the kernels' tiling rests on.

f64: the kernels follow the plain path's operation order (built with
-fmad=false), so they agree to 1e-12 of max|ref|. f32: a thresholded pick
(Burgers Riemann / upwind sign tests, |speed| < 1e-14) can flip on a one-ulp
difference and move a value by ~2|u|, so the f32 comparison is by median and
outlier fraction of |kernel - plain| / max|plain| (max is reported), never by
a single max bound.
"""

import numpy as np
import pytest
import torch

from iamr_tpu_torch.ops import godunov as god
from iamr_tpu_torch.ops import godunov_kernels as gk

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pad(a, ng, periodic):
    return np.pad(a, ng, mode="wrap" if periodic else "edge")


def extrap_inputs(n, periodic, seed=0):
    rng = np.random.RandomState(seed)
    vel = 0.4 * rng.randn(3, *n)
    force = rng.randn(3, *n)
    vel_g = np.stack([_pad(vel[c], 3, periodic) for c in range(3)])
    force_g = np.stack([_pad(force[c], 1, periodic) for c in range(3)])
    return vel_g, force_g


def advect_inputs(n, periodic, nc, seed=0):
    rng = np.random.RandomState(seed)
    fields = [_pad(rng.rand(*n), 3, periodic) for _ in range(nc)]
    umac = []
    for d in range(3):
        shp = [nn + (1 if e == d else 0) for e, nn in enumerate(n)]
        u = 0.3 * rng.randn(*shp)
        if periodic:
            idx_hi = tuple(slice(None) if e != d else -1 for e in range(3))
            idx_lo = tuple(slice(None) if e != d else 0 for e in range(3))
            u[idx_hi] = u[idx_lo]
        umac.append(u)
    forces = [_pad(rng.randn(*n), 1, periodic) for _ in range(3)]
    return fields, umac, forces


# the slice's advected fields: u, v, w forced convective; rho conservative;
# one passive tracer convective
SLICE_FLAGS = dict(
    iconservs=[False, False, False, True, False],
    force_rows=[0, 1, 2, -1, -1],
    convs=[True, True, True, False, True],
)


def run_extrap(device, dtype, n, periodic, force, seed=0):
    vel_g, force_g = extrap_inputs(n, periodic, seed)
    vg = torch.as_tensor(vel_g, dtype=dtype, device=device)
    fg = torch.as_tensor(force_g, dtype=dtype, device=device) if force else None
    dt = torch.tensor(0.004, dtype=dtype, device=device)
    dx = tuple(1.0 / x for x in n)
    got = gk.extrap_plm(vg, fg, dt, dx, n)
    ref = gk.extrap_plm_ref(vg, fg, dt, dx, n)
    return got, ref


def run_advect(device, dtype, n, periodic, flags, seed=0):
    nc = len(flags["convs"])
    fields, umac, forces = advect_inputs(n, periodic, nc, seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    s_gs = [t(f) for f in fields]
    um = tuple(t(u) for u in umac)
    per = (periodic,) * 3
    ug = god.grow_umac_transverse(um, per)
    fgs = [t(f) for f in forces]
    dt = torch.tensor(0.004, dtype=dtype, device=device)
    dx = tuple(1.0 / x for x in n)
    args = (s_gs, um, ug, dt, dx, n, flags["iconservs"], fgs,
            flags["force_rows"], flags["convs"])
    got = gk.godunov_plm_multi(*args, periodic=per)
    ref = gk.godunov_plm_multi_ref(*args, periodic=per)
    flat = lambda out: [a for fl, ao in out for a in (*fl, ao)]
    return flat(got), flat(ref)


def assert_f32(got, ref):
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        st = gk.tie_flip_stats(g, r, 1e-5)
        assert st["median"] <= 1e-6 and st["outliers"] <= 1e-3, st


def assert_f64(got, ref):
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert gk.tie_flip_stats(g, r, 1e-12)["max"] <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("n", [(16, 24, 40), (32, 32, 32)])
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("force", [True, False])
def test_extrap_kernel_f32(cuda, n, periodic, force):
    assert_f32(*run_extrap(cuda, torch.float32, n, periodic, force))


@pytest.mark.cuda
@pytest.mark.parametrize("periodic", [True, False])
def test_extrap_kernel_f64(cuda, periodic):
    assert_f64(*run_extrap(cuda, torch.float64, (16, 24, 32), periodic, True))


@pytest.mark.cuda
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_godunov_multi_kernel(cuda, periodic, dtype):
    got, ref = run_advect(cuda, dtype, (16, 24, 40), periodic, SLICE_FLAGS)
    (assert_f32 if dtype == torch.float32 else assert_f64)(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("iconserv", [True, False])
@pytest.mark.parametrize("force", [True, False])
def test_godunov_single_field_kernel(cuda, iconserv, force):
    flags = dict(iconservs=[iconserv], force_rows=[0 if force else -1],
                 convs=[not iconserv])
    got, ref = run_advect(cuda, torch.float32, (24, 16, 32), True, flags)
    assert_f32(got, ref)


# boxes no tile divides: ragged in dims 1 and 2, odd, below one tile, and a
# dim 0 shorter than a march segment
RAGGED = [(80, 96, 112), (40, 24, 21), (8, 8, 8), (5, 40, 70)]
# six fields (ntrac = 2) with mixed force rows
SIX_FLAGS = dict(
    iconservs=[False, False, False, True, False, True],
    force_rows=[0, 1, 2, -1, 1, -1],
    convs=[True, True, True, False, True, False],
)
ONE_CONSERVATIVE = dict(iconservs=[True], force_rows=[-1], convs=[False])


def assert_dtype(dtype, got, ref):
    (assert_f32 if dtype == torch.float32 else assert_f64)(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("n", RAGGED)
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_extrap_kernel_ragged(cuda, n, periodic, dtype):
    for force in (True, False):
        assert_dtype(dtype, *run_extrap(cuda, dtype, n, periodic, force, seed=2))


@pytest.mark.cuda
@pytest.mark.parametrize("n", RAGGED)
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("flags", [ONE_CONSERVATIVE, SLICE_FLAGS, SIX_FLAGS],
                         ids=["nc1", "nc5", "nc6"])
def test_godunov_multi_kernel_ragged(cuda, n, periodic, flags):
    for dtype in (torch.float32, torch.float64):
        assert_dtype(dtype, *run_advect(cuda, dtype, n, periodic, flags, seed=2))


@pytest.mark.cuda
def test_kernels_bitwise_on_a_ragged_box(cuda):
    """With the plain path's operation order and no multiply-add contraction
    the kernels equal their plain versions in value, not only to the bound."""
    got, ref = run_extrap(cuda, torch.float32, (40, 24, 21), False, True, seed=4)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    got, ref = run_advect(cuda, torch.float32, (40, 24, 21), False, SIX_FLAGS, seed=4)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


# nine fields: more than one launch holds (8), so the call chains two
NINE_FLAGS = dict(
    iconservs=[False, False, False, True, False, True, False, True, False],
    force_rows=[0, 1, 2, -1, 1, -1, 2, 0, -1],
    convs=[True, True, True, False, True, False, True, False, False],
)


@pytest.mark.cuda
@pytest.mark.parametrize("periodic", [True, False])
def test_godunov_multi_kernel_chained_launches(cuda, periodic):
    for dtype in (torch.float32, torch.float64):
        assert_dtype(dtype, *run_advect(cuda, dtype, (40, 24, 21), periodic, NINE_FLAGS,
                                        seed=6))


@pytest.mark.cuda
def test_launch_counts(cuda):
    gk.reset_launches()
    run_extrap(cuda, torch.float32, (16, 16, 16), True, True)
    run_advect(cuda, torch.float32, (16, 16, 16), True, SLICE_FLAGS)
    assert gk.LAUNCHES == {"extrap_plm": 1, "godunov_plm_multi": 1}


# ---------------------------------------------------------------------------
# What the kernels' tiling assumes, checked on the CPU with the plain
# versions: a tile of outputs depends on the field within S_HALO cells, on
# force and umac_g within HAT_HALO cells in the transverse dims, and (a
# conservative field's normal-ghost d(umac)/dx) on umac_g UMAC_NORMAL_HALO
# faces further along the normal. So the plain version evaluated on such a
# window equals the crop of the full-box result bit for bit, and on a
# narrower window it does not.

BOX = (12, 10, 14)
TILES = {
    "interior": ((4, 3, 5), (4, 4, 5)),
    "lo corner": ((0, 0, 0), (5, 4, 6)),
    "hi corner": ((7, 6, 8), (5, 4, 6)),
    "one cell": ((6, 5, 7), (1, 1, 1)),
}


def _win(a, lo, w, grow, face=None, lead=0):
    """Crop a cell (or dim-`face` face) array whose index 0 is cell -grow to
    the cells lo - grow .. lo + w + grow (faces: one more along `face`)."""
    idx = [slice(None)] * lead
    for d in range(3):
        g = 0 if d == face else grow
        idx.append(slice(lo[d], lo[d] + w[d] + 2 * g + (1 if d == face else 0)))
    return a[tuple(idx)]


def _narrow(a, halo, lead=0):
    """The window with its outermost halo layer overwritten by the layer
    inside it: what a halo one cell narrower would see."""
    a = a.clone()
    for d in range(lead, a.ndim):
        lo = [slice(None)] * a.ndim
        hi = [slice(None)] * a.ndim
        lo[d], hi[d] = slice(0, 1), slice(-1, None)
        src_lo, src_hi = list(lo), list(hi)
        src_lo[d], src_hi[d] = slice(1, 2), slice(-2, -1)
        if halo > 0:
            a[tuple(lo)] = a[tuple(src_lo)]
            a[tuple(hi)] = a[tuple(src_hi)]
    return a


def _dx(n):
    return tuple(1.0 / (x * (1.0 + 0.1 * d)) for d, x in enumerate(n))


@pytest.mark.parametrize("tile", list(TILES))
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("force", [True, False])
def test_extrap_window_equals_crop(tile, periodic, force):
    lo, w = TILES[tile]
    vel_g, force_g = extrap_inputs(BOX, periodic, seed=3)
    vg = torch.as_tensor(vel_g)
    fg = torch.as_tensor(force_g) if force else None
    dt, dx = torch.tensor(0.004, dtype=torch.float64), _dx(BOX)
    full = gk.extrap_plm_ref(vg, fg, dt, dx, BOX)
    vw = _win(vg, lo, w, gk.S_HALO, lead=1).contiguous()
    fw = None if fg is None else _win(fg, lo, w, gk.HAT_HALO, lead=1).contiguous()
    got = gk.extrap_plm_ref(vw, fw, dt, dx, w)
    for d in range(3):
        assert torch.equal(got[d], _win(full[d], lo, w, 0, face=d))
    # one layer less of the velocity's halo changes the result
    bad = gk.extrap_plm_ref(_narrow(vw, gk.S_HALO, lead=1), fw, dt, dx, w)
    assert not all(torch.equal(bad[d], got[d]) for d in range(3))


def _advect_window(lo, w, periodic, iconserv, force, narrow=None):
    fields, umac, forces = advect_inputs(BOX, periodic, 1, seed=5)
    t = torch.as_tensor
    per = (periodic,) * 3
    s_g, um, fg = t(fields[0]), tuple(t(u) for u in umac), t(forces[0])
    ug = god.grow_umac_transverse(um, per)
    dt, dx = torch.tensor(0.004, dtype=torch.float64), _dx(BOX)
    flags = ([iconserv], [fg] if force else [], [0 if force else -1], [not iconserv])
    full = gk.godunov_plm_multi_ref([s_g], um, ug, dt, dx, BOX, *flags, periodic=per)[0]
    sw = _win(s_g, lo, w, gk.S_HALO).contiguous()
    fw = _win(fg, lo, w, gk.HAT_HALO).contiguous()
    umw = tuple(_win(um[d], lo, w, 0, face=d) for d in range(3))
    ugw = tuple(_win(ug[d], lo, w, gk.HAT_HALO, face=d) for d in range(3))
    if narrow == "s":
        sw = _narrow(sw, gk.S_HALO)
    if narrow == "umac_g":
        ugw = tuple(torch.zeros_like(u).copy_(u) for u in ugw)
        for d in range(3):
            e = (d + 1) % 3  # a transverse dim's ghost row
            idx = [slice(None)] * 3
            idx[e] = slice(0, 1)
            ugw[d][tuple(idx)] += 1.0
    wflags = ([iconserv], [fw] if force else [], [0 if force else -1], [not iconserv])
    # the window is no periodic box: its normal ghosts copy the edge
    got = gk.godunov_plm_multi_ref([sw], umw, ugw, dt, dx, w, *wflags,
                                   periodic=(False,) * 3)[0]
    crop = (tuple(_win(full[0][d], lo, w, 0, face=d) for d in range(3)),
            _win(full[1], lo, w, 0))
    return got, crop


@pytest.mark.parametrize("tile", list(TILES))
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("force", [True, False])
def test_advect_window_equals_crop_convective(tile, periodic, force):
    lo, w = TILES[tile]
    (fl, ao), (cfl, cao) = _advect_window(lo, w, periodic, False, force)
    for d in range(3):
        assert torch.equal(fl[d], cfl[d])
    assert torch.equal(ao, cao)


@pytest.mark.parametrize("tile", list(TILES))
@pytest.mark.parametrize("periodic", [True, False])
def test_advect_window_equals_crop_conservative(tile, periodic):
    """A conservative field's edge state also takes d(umac)/dx of the cell
    beyond a face: umac_g UMAC_NORMAL_HALO faces further along the normal,
    which the window lacks. Faces inside the window, and the window's own
    boundary faces where they are the (non-periodic) domain's, agree."""
    lo, w = TILES[tile]
    (fl, ao), (cfl, cao) = _advect_window(lo, w, periodic, True, False)
    h = gk.UMAC_NORMAL_HALO
    inner = [slice(h, None)] * 3
    for d in range(3):
        at_lo = not periodic and lo[d] == 0
        at_hi = not periodic and lo[d] + w[d] == BOX[d]
        idx = [slice(None)] * 3
        idx[d] = slice(0 if at_lo else h, None if at_hi else -h)
        assert torch.equal(fl[d][tuple(idx)], cfl[d][tuple(idx)])
        inner[d] = slice(0 if at_lo else h, None if at_hi else -h)
    assert torch.equal(ao[tuple(inner)], cao[tuple(inner)])


@pytest.mark.parametrize("iconserv", [True, False])
@pytest.mark.parametrize("narrow", ["s", "umac_g"])
def test_advect_narrower_window_differs(iconserv, narrow):
    lo, w = TILES["interior"]
    (fl, ao), _ = _advect_window(lo, w, False, iconserv, True)
    (bfl, bao), _ = _advect_window(lo, w, False, iconserv, True, narrow=narrow)
    assert not (all(torch.equal(a, b) for a, b in zip(fl, bfl)) and torch.equal(ao, bao))


@pytest.mark.parametrize("periodic", [True, False])
def test_umac_g_real_part_is_umac(periodic):
    """The K2 kernel reads the face velocities from umac_g alone, the plain
    version takes the fluxes' from umac: they agree because the real part of
    grow_umac_transverse(umac) is umac, bit for bit."""
    _, umac, _ = advect_inputs(BOX, periodic, 1, seed=8)
    um = tuple(torch.as_tensor(u) for u in umac)
    ug = god.grow_umac_transverse(um, (periodic,) * 3)
    for d in range(3):
        real = tuple(slice(None) if e == d else slice(1, -1) for e in range(3))
        assert torch.equal(ug[d][real], um[d])


def test_wrappers_raise_off_contract():
    """The wrappers raise on what the kernels do not take, before any kernel
    is built (so this runs without a card): never a fall-back."""
    vg = torch.zeros((3, 10, 10, 10), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError):
        gk.extrap_plm(vg, None, 0.1, (0.25,) * 3, (4, 4, 4))
    with pytest.raises(ValueError):
        gk.godunov_plm_multi([vg[0]], (), (), 0.1, (0.25,) * 3, (4, 4, 4), [True], [], [-1],
                             [False])
    # a box whose ghosted field the kernels' 32-bit offsets cannot index
    big = (1300, 1300, 1300)
    vg = torch.zeros((3,) + tuple(x + 6 for x in big), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="2\\^31"):
        gk.extrap_plm(vg, None, 0.1, (1.0,) * 3, big)
    with pytest.raises(ValueError, match="2\\^31"):
        gk.godunov_plm_multi([vg[0]], (), (), 0.1, (1.0,) * 3, big, [True], [], [-1], [False])
