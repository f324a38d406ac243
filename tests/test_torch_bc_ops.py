"""The port's boundary and setup pieces against the JAX package's, f64 on
the CPU, from the same seeded inputs:

  * core/fill.py: every MathBC ghost fill with BC values, 2D and 3D
    (1e-14);
  * ns/probs.py: every ported probtype, 2D and 3D (1e-14);
  * ns/bcprovider.py: the temperature fills and solver BCs;
  * solvers/diffusion.py: the explicit operator with ext_dir values lifted
    into the ghosts (the lid of the cavity), 2D and 3D;
  * solvers/nodal_proj.py: hydrostatic_phi_bc (and its refusal of a bottom
    outflow face), initial_pressure_project, level_project with a
    divergence source and outflow phi values; solvers/mac.py: the MAC
    projection with variable rho and a source, on walled, inflow and
    outflow boxes, 2D and 3D (1e-10);
  * ns/checks.py: the ns.debug checks, and driver.run with ns.debug;
  * an inflow/outflow channel (ns.lo_bc = 1 5, ns.hi_bc = 2 5,
    xlo.velocity) through the entry points, in tolerance and fixed-cycle
    mode (tests/torch_parity.py::run_both: initialize compared, a seeded
    1e-3 perturbation, 2 steps of driver.run compared to 1e-10 of
    max|ref|).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from iamr_tpu.core import bc as jbc
from iamr_tpu.core import fill as jfill
from iamr_tpu.core.geometry import Geometry as JGeometry
from iamr_tpu.ns import bcprovider as jbcp
from iamr_tpu.ns import checks as jchecks
from iamr_tpu.ns import probs as jprobs
from iamr_tpu.solvers import diffusion as jdiff
from iamr_tpu.solvers import mac as jmac
from iamr_tpu.solvers import nodal_proj as jnp_proj
from iamr_tpu_torch.core import bc as tbc
from iamr_tpu_torch.core import fill as tfill
from iamr_tpu_torch.core.geometry import Geometry as TGeometry
from iamr_tpu_torch.ns import bcprovider as tbcp
from iamr_tpu_torch.ns import checks as tchecks
from iamr_tpu_torch.ns import driver as tdriver
from iamr_tpu_torch.ns import probs as tprobs
from iamr_tpu_torch.solvers import diffusion as tdiff
from iamr_tpu_torch.solvers import mac as tmac
from iamr_tpu_torch.solvers import nodal_proj as tnp_proj
from torch_parity import CPU, close, configs, run_both

torch.set_num_threads(2)
SHAPES = {2: (12, 10), 3: (8, 6, 10)}


def T(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


# --- fills -----------------------------------------------------------------


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("kind", list(tbc.MathBC), ids=lambda k: k.name)
def test_fill_every_kind(kind, dim):
    rng = np.random.RandomState(int(kind) + 10 * dim)
    a = rng.randn(*SHAPES[dim])
    # the kind on every lo side and on the hi side of dim 0, the others wrap
    lo = (kind,) * dim
    hi = (kind,) + (tbc.MathBC.int_dir,) * (dim - 1)
    vlo, vhi = tuple(rng.randn(dim)), tuple(rng.randn(dim))
    for ng in (1, 3):
        ref = jfill.fill_ghost(jnp.asarray(a), ng, jbc.BCRec(lo=lo, hi=hi), vlo, vhi)
        got = tfill.fill_ghost(T(a), ng, tbc.BCRec(lo=lo, hi=hi), vlo, vhi)
        close(ref, got, 1e-14)


# --- initial conditions ------------------------------------------------------

PROB = """
amr.n_cell = {n}
geometry.prob_lo = {lo}
geometry.prob_hi = {hi}
geometry.is_periodic = {per}
ns.lo_bc = {bc}
ns.hi_bc = {bc}
ns.scal_diff_coefs = 0.0 0.0
prob.probtype = {pt}
prob.blob_center = 0.4 0.55 0.5
prob.blob_radius = 0.2
prob.density_ic = 2.0
prob.interface_width = 0.05
prob.velocity_ic = 0.3 -0.2 0.1
prob.perturbation_amplitude = 0.05
prob.direction = {direction}
prob.meanFlowDir = -3
prob.meanFlowMag = 0.5
"""


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("pt,direction", [(1, 0), (2, 0), (3, 0), (4, 0), (5, 0), (5, 1),
                                          (6, 0), (7, 0), (8, 0), (10, 0), (11, 0)])
def test_probtypes(pt, direction, dim):
    text = PROB.format(
        n=" ".join(str(x) for x in SHAPES[dim]), lo=" ".join(["0."] * dim),
        hi=" ".join(["1."] * (dim - 1) + ["2."]), per=" ".join(["1"] * (dim - 1) + ["0"]),
        bc=" ".join(["0"] * (dim - 1) + ["4"]), pt=pt, direction=direction)
    jcfg, tcfg = configs(text)
    jst, tst = jprobs.init_state(jcfg), tprobs.init_state(tcfg, CPU)
    for k in ("vel", "rho", "trac", "temp", "p", "gradp"):
        close(getattr(jst, k), getattr(tst, k), 1e-14)


def test_unported_probtype_raises():
    """A probtype neither built in nor registered (plugins.problem_ic) is
    refused with the JAX package's ValueError."""
    jcfg, tcfg = configs(PROB.format(n="8 8", lo="0. 0.", hi="1. 1.", per="1 1", bc="0 0",
                                     pt=42, direction=0))
    with pytest.raises(ValueError, match="unknown probtype 42"):
        jprobs.init_state(jcfg)
    with pytest.raises(ValueError, match="unknown probtype 42"):
        tprobs.init_state(tcfg, CPU)


# --- BC provider: temperature --------------------------------------------------

TEMP_BOX = """
amr.n_cell = {n}
geometry.is_periodic = 0 0 0
ns.lo_bc = 1 5 3
ns.hi_bc = 2 4 5
ns.do_temp = 1
ns.scal_diff_coefs = 0.0 0.0
xlo.velocity = 1.0 0.0 0.0
xlo.temp = 1.5
yhi.temp = 0.25
"""


@pytest.mark.parametrize("dim", [2, 3])
def test_temperature_fills_and_bcs(dim):
    jcfg, tcfg = configs(TEMP_BOX.format(n=" ".join(map(str, SHAPES[dim]))), dim)
    jp, tp = jbcp.PhysBCProvider(jcfg), tbcp.PhysBCProvider(tcfg)
    assert (jp._temp_rec.lo, jp._temp_rec.hi) == (tp._temp_rec.lo, tp._temp_rec.hi)
    assert jp.temp_bcvals() == tp.temp_bcvals()
    jb, jv = jp.temp_diff_bc()
    tb, tv = tp.temp_diff_bc()
    assert (jb.lo, jb.hi, jv) == (tb.lo, tb.hi, tv)
    a = 1.0 + np.random.RandomState(dim).rand(*SHAPES[dim])
    close(jp.fill_temp(jnp.asarray(a), 3), tp.fill_temp(T(a), 3), 1e-14)
    # the explicit conduction term with the ext_dir values lifted in
    beta = [0.5 + np.random.RandomState(d).rand(*[x + (e == d) for e, x in
                                                  enumerate(SHAPES[dim])]) for d in range(dim)]
    dx = tuple(1.0 / (x + 1.0) for x in SHAPES[dim])
    close(jdiff.apply_diffusion_op(jnp.asarray(a), tuple(map(jnp.asarray, beta)), dx, jb, jv),
          tdiff.apply_diffusion_op(T(a), tuple(map(T, beta)), dx, tb, tv), 1e-13)


# --- projections --------------------------------------------------------------


def _dom(lo, hi, values=None):
    return (jbc.DomainBC(phys_lo=tuple(jbc.PhysBC(p) for p in lo),
                         phys_hi=tuple(jbc.PhysBC(p) for p in hi), bc_values=values or {}),
            tbc.DomainBC(phys_lo=tuple(tbc.PhysBC(p) for p in lo),
                         phys_hi=tuple(tbc.PhysBC(p) for p in hi), bc_values=values or {}))


# (lo, hi) physical BCs per case: walls, lateral outflow, inflow + outflow
BOXES = {
    2: {"walls": ((4, 5), (5, 4)), "outflow": ((0, 5), (0, 2)), "lateral": ((2, 4), (4, 4)),
        "inflow": ((1, 5), (2, 5))},
    3: {"walls": ((4, 0, 5), (5, 0, 4)), "outflow": ((0, 0, 5), (0, 0, 2)),
        "lateral": ((2, 0, 4), (4, 0, 4)), "inflow": ((1, 5, 0), (2, 5, 0))},
}


def _geoms(dim, lo, hi):
    n = SHAPES[dim]
    per = tuple(p == 0 for p in lo)
    args = (n, (0.0,) * dim, tuple(1.0 + 0.25 * d for d in range(dim)), per, 0)
    return JGeometry(*args), TGeometry(*args)


@pytest.mark.parametrize("dim", [2, 3])
def test_hydrostatic_phi_bc_and_initial_pressure(dim):
    lo, hi = BOXES[dim]["lateral"]
    jdom, tdom = _dom(lo, hi)
    jg, tg = _geoms(dim, lo, hi)
    rho = 1.0 + np.random.RandomState(5).rand(*SHAPES[dim])
    close(jnp_proj.hydrostatic_phi_bc(jg, jdom, jnp.asarray(rho), -9.8),
          tnp_proj.hydrostatic_phi_bc(tg, tdom, T(rho), -9.8), 1e-14)
    assert tnp_proj.hydrostatic_phi_bc(tg, tdom, T(rho), 0.0) is None
    for fixed in (None, 4):
        jp, jgp = jnp_proj.initial_pressure_project(jnp.asarray(rho), -9.8, jdom, jg.dx,
                                                    geom=jg, fixed_cycles=fixed)
        tp, tgp = tnp_proj.initial_pressure_project(T(rho), -9.8, tdom, tg.dx, geom=tg,
                                                    fixed_cycles=fixed)
        close(jp, tp)
        close(jgp, tgp)
    # a bottom outflow face with gravity is refused, as the reference does
    _, bottom = _dom(lo[:-1] + (2,), hi)
    with pytest.raises(NotImplementedError):
        tnp_proj.hydrostatic_phi_bc(tg, bottom, T(rho), -9.8)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("box", ["walls", "outflow", "lateral", "inflow"])
def test_projections(box, dim):
    lo, hi = BOXES[dim][box]
    values = {(0, 0): (0.7,) + (0.0,) * (dim + 2)}
    jdom, tdom = _dom(lo, hi, values)
    jg, tg = _geoms(dim, lo, hi)
    n = SHAPES[dim]
    rng = np.random.RandomState(dim)
    rho = 1.0 + rng.rand(*n)
    src = 0.1 * rng.randn(*n)
    umac = [rng.randn(*[x + (e == d) for e, x in enumerate(n)]) for d in range(dim)]
    for fixed in (None, 4):
        ju, jphi, _ = jmac.mac_project(tuple(map(jnp.asarray, umac)), jnp.asarray(rho), jdom,
                                       jg.dx, divu_src=jnp.asarray(src), fixed_cycles=fixed)
        tu, tphi, _ = tmac.mac_project(tuple(map(T, umac)), T(rho), tdom, tg.dx,
                                       divu_src=T(src), fixed_cycles=fixed)
        close(jphi, tphi)
        for d in range(dim):
            close(ju[d], tu[d])
    vel = rng.randn(dim, *n)
    gp = rng.randn(dim, *n)
    p0 = rng.randn(*[x + 1 for x in n])
    jphi_bc = jnp_proj.hydrostatic_phi_bc(jg, jdom, jnp.asarray(rho), -9.8)
    tphi_bc = tnp_proj.hydrostatic_phi_bc(tg, tdom, T(rho), -9.8)
    for fixed in (None, 4):
        jout = jnp_proj.level_project(jnp.asarray(vel), jnp.asarray(rho), jnp.asarray(p0),
                                      jnp.asarray(gp), 0.01, jdom, jg.dx, fixed_cycles=fixed,
                                      phi_bc=jphi_bc, divu_src=jnp.asarray(src))
        tout = tnp_proj.level_project(T(vel), T(rho), T(p0), T(gp), 0.01, tdom, tg.dx,
                                      fixed_cycles=fixed, phi_bc=tphi_bc, divu_src=T(src))
        for r, g in zip(jout[:3], tout[:3]):
            close(r, g)


# --- ns.debug checks ------------------------------------------------------------


def test_debug_checks():
    rng = np.random.RandomState(2)
    n = (6, 5, 4)
    umac = [rng.randn(*[x + (e == d) for e, x in enumerate(n)]) for d in range(3)]
    src = rng.randn(*n)
    dx = (0.1, 0.2, 0.3)
    close(jchecks.check_div_cond(tuple(map(jnp.asarray, umac)), dx, jnp.asarray(src)),
          tchecks.check_div_cond(tuple(map(T, umac)), dx, T(src)), 1e-14)
    for per in ((True, False, True), (False, True, False)):
        close(jchecks.umac_periodic_mismatch(tuple(map(jnp.asarray, umac)), per),
              tchecks.umac_periodic_mismatch(tuple(map(T, umac)), per), 1e-14)
    bad = rng.randn(*n)
    bad[1, 2, 3] = np.nan
    bad[0, 0, 0] = 1e19
    flags = tchecks.scan_fields(a=T(bad), b=T(src), c=None)
    assert sorted(flags) == ["a", "b"]
    assert [bool(x) for x in flags["a"]] == [True, True]
    assert [bool(x) for x in flags["b"]] == [False, False]


DEBUG_RUN = """
amr.n_cell = 16 16
ns.debug = 1
ns.init_iter = 0
ns.vel_visc_coef = 0.01
geometry.prob_lo = 0. 0.
geometry.prob_hi = 1. 1.
geometry.is_periodic = 1 0
ns.lo_bc = 0 5
ns.hi_bc = 0 5
prob.probtype = 5
"""


def test_run_with_debug_checks(capsys):
    _, tcfg = configs(DEBUG_RUN)
    state = tdriver.run(tcfg, max_steps=2, fixed_mg_cycles=4, device="cpu")
    out = capsys.readouterr().out
    assert out.count("ns.debug step") == 2, out
    # the MAC projection enforces div(umac) = 0 to its tolerance
    div = float(out.strip().splitlines()[-1].split("=")[1].split()[0])
    assert div < 1e-8 * float(state.vel.abs().max()) / tcfg.geom.dx[0]
    umac0 = (torch.zeros(17, 16, dtype=torch.float64), torch.zeros(16, 17, dtype=torch.float64))
    with pytest.raises(FloatingPointError):
        tchecks.run_debug_checks(tcfg, state._replace(rho=state.rho * float("nan")), umac0)


# --- an inflow/outflow channel -----------------------------------------------------

CHANNEL = """
amr.n_cell = 32 16
geometry.prob_lo = 0. 0.
geometry.prob_hi = 2. 1.
geometry.is_periodic = 0 0
ns.cfl = 0.5
ns.init_iter = 1
ns.vel_visc_coef = 0.01
ns.scal_diff_coefs = 0.001
ns.lo_bc = 1 5
ns.hi_bc = 2 5
xlo.velocity = 1.0 0.0
xlo.tracer = 1.0
prob.probtype = 1
"""


@pytest.mark.parametrize("fixed", [None, 4], ids=["tolerance", "fixed4"])
def test_channel_matches(fixed):
    _, tst = run_both(CHANNEL, fixed)
    # the inflow tracer enters the channel
    assert float(tst.trac[0, 0].min()) > 0.0
