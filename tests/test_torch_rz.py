"""RZ (2D axisymmetric) in the port against the JAX package, f64 on the
CPU: the radius-weighted MAC projection, initial velocity projection and
nodal projection (with a divergence source) on HotSpot-RZ's geometry
(examples/inputs.2d.hotspot_rz: the axis r = 0 a symmetry side, slip
walls, an outflow top), each to 1e-12 of max|ref| in fixed-cycle and
tolerance mode, the MAC projection's RZ divergence held to roundoff; in
the slow tier HotSpot-RZ 16x32 initialize + 2 steps with fixed V-cycles
against the JAX package run eagerly, with the residuals that show why the
Tier-1 fixed-cycle pair (tests/test_torch_les_rz_steps.py) runs at 32x64;
and RZ with velocity viscosity or LES refused by both packages.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from iamr_tpu.ns.advance import make_step as jmake_step
from iamr_tpu.ns.probs import init_state as jinit_state
from iamr_tpu.solvers import mac as jmac
from iamr_tpu.solvers import nodal_proj as jnp_proj
from iamr_tpu_torch.ns.advance import make_step as tmake_step
from iamr_tpu_torch.ns.advance import rz_radii
from iamr_tpu_torch.ns.probs import init_state as tinit_state
from iamr_tpu_torch.solvers import mac as tmac
from iamr_tpu_torch.solvers import nodal_proj as tnp_proj
from torch_parity import close, configs, example_text, run_both

torch.set_num_threads(2)

RZ = "inputs.2d.hotspot_rz"


def _setup(cells, seed):
    jcfg, tcfg = configs(example_text(RZ, f"amr.n_cell = {cells[0]} {cells[1]}"))
    rc, rf = jcfg.geom.rz_radii()
    trz = rz_radii(tcfg, torch.float64, "cpu")
    np.testing.assert_array_equal(trz[0].numpy(), rc)
    np.testing.assert_array_equal(trz[1].numpy(), rf)
    return jcfg, tcfg, (jnp.asarray(rc), jnp.asarray(rf)), trz, np.random.RandomState(seed)


def _rz_div(umac, rz, dx):
    r_cell, r_face = rz
    fr = r_face * umac[0]
    return (fr[1:, :] - fr[:-1, :]) / dx[0] / r_cell + (umac[1][:, 1:] - umac[1][:, :-1]) / dx[1]


T = torch.as_tensor


@pytest.mark.parametrize("fixed", [None, 4])
def test_rz_mac_projection_matches(fixed):
    jcfg, tcfg, jrz, trz, rng = _setup((32, 64), 0)
    n, dx = tuple(jcfg.geom.ncell), jcfg.geom.dx
    umac = (rng.randn(n[0] + 1, n[1]), rng.randn(n[0], n[1] + 1))
    rho = 1.0 + rng.rand(*n)
    src = 0.1 * rng.randn(*n)

    def jproj(u0, u1, r, s):
        return jmac.mac_project((u0, u1), r, jcfg.dom, dx, divu_src=s, rz=jrz,
                                fixed_cycles=fixed)[:2]

    jun, jphi = jax.jit(jproj)(*(jnp.asarray(a) for a in umac + (rho, src)))
    tun, tphi, _ = tmac.mac_project(tuple(T(u) for u in umac), T(rho), tcfg.dom, dx,
                                    divu_src=T(src), rz=trz, fixed_cycles=fixed)
    close(jphi, tphi, 1e-12)
    for a, b in zip(jun, tun):
        close(a, b, 1e-12)
    if fixed is None:
        rzdiv = _rz_div(tuple(u.numpy() for u in tun), tuple(r.numpy() for r in trz), dx)
        assert np.abs(rzdiv - src).max() < 1e-8


@pytest.mark.parametrize("fixed", [None, 4])
def test_rz_initial_velocity_project_matches(fixed):
    jcfg, tcfg, jrz, trz, rng = _setup((32, 64), 1)
    n, dx = tuple(jcfg.geom.ncell), jcfg.geom.dx
    vel = rng.randn(2, *n)
    rho = 1.0 + rng.rand(*n)

    def jproj(v, r):
        return jnp_proj.initial_velocity_project(v, r, jcfg.dom, dx, rz=jrz,
                                                 fixed_cycles=fixed)[0]

    ref = jax.jit(jproj)(jnp.asarray(vel), jnp.asarray(rho))
    got, _ = tnp_proj.initial_velocity_project(T(vel), T(rho), tcfg.dom, dx, rz=trz,
                                               fixed_cycles=fixed)
    close(ref, got, 1e-12)


@pytest.mark.parametrize("fixed", [None, 4])
def test_rz_level_project_matches(fixed):
    """The step's nodal projection with the thermal divergence source,
    warm-started from a pressure."""
    jcfg, tcfg, jrz, trz, rng = _setup((32, 64), 2)
    n, dx = tuple(jcfg.geom.ncell), jcfg.geom.dx
    vel, gradp = rng.randn(2, *n), rng.randn(2, *n)
    rho = 1.0 + rng.rand(*n)
    p = 0.1 * rng.randn(n[0] + 1, n[1] + 1)
    src = 0.1 * rng.randn(*n)
    dt = 0.01

    def jproj(v, r, p_, g, s):
        return jnp_proj.level_project(v, r, p_, g, dt, jcfg.dom, dx, divu_src=s, rz=jrz,
                                      fixed_cycles=fixed)[:3]

    ref = jax.jit(jproj)(*(jnp.asarray(a) for a in (vel, rho, p, gradp, src)))
    got = tnp_proj.level_project(T(vel), T(rho), T(p), T(gradp),
                                 torch.tensor(dt, dtype=torch.float64), tcfg.dom, dx,
                                 divu_src=T(src), rz=trz, fixed_cycles=fixed)[:3]
    for a, b in zip(ref, got):
        close(a, b, 1e-12)


@pytest.mark.slow
def test_hotspot_rz_16x32_fixed_against_eager():
    """HotSpot-RZ 16x32 with 4 fixed V-cycles, initialize + 2 steps, against
    the JAX package run eagerly (jax.disable_jit) to 1e-10. Then the
    witness for the fixed case of test_hotspot_rz_steps_match running at
    32x64: the residual max|r| of the RZ MAC solve on seeded data after k
    fixed V-cycles, printed (-s) for the JAX package jitted and eager and
    for the port. At 16x32 (512 cells, DENSE_BOTTOM_DOFS) the hierarchy is
    one level and a V-cycle is the dense bottom solve; the eager JAX
    package and the port stay at roundoff for every k, the jitted one
    grows by orders of magnitude a cycle from k = 2."""
    with jax.disable_jit():
        run_both(example_text(RZ, "amr.n_cell = 16 32"), 4)
    jcfg, tcfg, jrz, trz, rng = _setup((16, 32), 0)
    n, dx = tuple(jcfg.geom.ncell), jcfg.geom.dx
    umac = (rng.randn(n[0] + 1, n[1]), rng.randn(n[0], n[1] + 1))
    rho = 1.0 + rng.rand(*n)
    bnorm = np.abs(_rz_div(umac, tuple(r.numpy() for r in trz), dx)).max()
    args = [jnp.asarray(a) for a in umac + (rho,)]
    for k in range(1, 9):
        def jres(u0, u1, r):
            return jmac.mac_project((u0, u1), r, jcfg.dom, dx, rz=jrz, fixed_cycles=k)[2][0]

        jitted = float(jax.jit(jres)(*args))
        with jax.disable_jit():
            eager = float(jres(*args))
        port = float(tmac.mac_project(tuple(T(u) for u in umac), T(rho), tcfg.dom, dx, rz=trz,
                                      fixed_cycles=k)[2][0])
        print(f"RZ MAC 16x32, {k} V-cycles: max|r| jitted {jitted:.3e} eager {eager:.3e} "
              f"port {port:.3e} (max|rhs| {bnorm:.3e})")
        assert max(eager, port) < 1e-13 * bnorm


@pytest.mark.parametrize("line", ["ns.vel_visc_coef = 1e-3", "ns.do_LES = 1"],
                         ids=["viscosity", "les"])
def test_rz_with_viscosity_refused(line):
    """The reference forbids RZ with viscosity; both packages refuse the
    step."""
    jcfg, tcfg = configs(example_text(RZ, "amr.n_cell = 8 16", line))
    with pytest.raises(NotImplementedError, match="RZ with viscosity"):
        jmake_step(jcfg, 1)(jinit_state(jcfg)._replace(dt=jnp.asarray(1e-3)))
    with pytest.raises(NotImplementedError, match="RZ with viscosity"):
        tmake_step(tcfg, 1)(tinit_state(tcfg, "cpu")._replace(
            dt=torch.tensor(1e-3, dtype=torch.float64)))
