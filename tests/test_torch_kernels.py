"""The port's CUDA Godunov kernels against their plain PyTorch versions on the
card (iamr_tpu_torch/ops/godunov_kernels.py). Skipped without a CUDA device.

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


@pytest.mark.cuda
def test_launch_counts(cuda):
    gk.reset_launches()
    run_extrap(cuda, torch.float32, (16, 16, 16), True, True)
    run_advect(cuda, torch.float32, (16, 16, 16), True, SLICE_FLAGS)
    assert gk.LAUNCHES == {"extrap_plm": 1, "godunov_plm_multi": 1}
