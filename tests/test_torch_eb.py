"""Embedded boundaries in the port against the JAX package, f64 on the CPU.

The geometry of every eb2.geom_type of the catalog and of a registered
plugin (ss = 8): fractions, masks and the merge tracker equal, centroids,
wall area and wall distance to 1e-14 (the port's torch.sqrt on the CPU may
differ from numpy's by an ulp). The EB functions to 1e-12 of max|ref| on
the flow past a cylinder's geometry (examples/inputs.{2,3}d.flow_past_cylinder,
the cylinder widened to radius 0.2 so that cut and covered cells exist at
the test's size): eb_aofs under NoRedist, FluxRedist and StateRedist
(conservative and convective), state_redistribute, slope4_eb and
compute_edge_states with the grown fluid mask, the EB MAC projection (with
its cut-cell divergence held to roundoff; on a closed domain, where
neither package removes the divergence's mean), the EB nodal projections and
the cut-cell check_div_cond. The port refuses RZ with EB and
use_forces_in_trans with EB, as the JAX package does.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import iamr_tpu.plugins as jplugins
import iamr_tpu_torch.plugins as tplugins
from iamr_tpu.config.parmparse import ParmParse as JParmParse
from iamr_tpu.core.geometry import Geometry as JGeometry
from iamr_tpu.eb import geom as jgeom
from iamr_tpu.eb import redist as jredist
from iamr_tpu.ns import checks as jchecks
from iamr_tpu.ops import godunov as jgod
from iamr_tpu.solvers import mac as jmac
from iamr_tpu.solvers import nodal_proj as jnodal
from iamr_tpu_torch.config.parmparse import ParmParse as TParmParse
from iamr_tpu_torch.core.geometry import Geometry as TGeometry
from iamr_tpu_torch.eb import geom as tgeom
from iamr_tpu_torch.eb import redist as tredist
from iamr_tpu_torch.ns import advance as tadvance
from iamr_tpu_torch.ns import checks as tchecks
from iamr_tpu_torch.ns.probs import init_state as tinit_state
from iamr_tpu_torch.ops import godunov as tgod
from iamr_tpu_torch.solvers import mac as tmac
from iamr_tpu_torch.solvers import nodal_proj as tnodal
from torch_parity import close, configs, ebs, example_text

torch.set_num_threads(2)
T = torch.as_tensor

CUBE = ((16, 16, 16), (0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
HALF = ((16, 16, 16), (-0.5, -0.5, -0.5), (0.5, 0.5, 0.5))
# (inputs text, cells, prob_lo, prob_hi, periodic)
GEOMETRIES = {
    "sphere": ("eb2.geom_type = sphere\neb2.sphere_center = 0.5 0.5\n"
               "eb2.sphere_radius = 0.2\neb2.sphere_has_fluid_inside = 0\n",
               (32, 32), (0.0, 0.0), (1.0, 1.0), (False, True)),
    "cylinder": ("eb2.geom_type = cylinder\neb2.cylinder_center = 0.5 0.5 0.5\n"
                 "eb2.cylinder_radius = 0.2\neb2.cylinder_direction = 2\n"
                 "eb2.cylinder_has_fluid_inside = 0\n", *CUBE, (False, False, True)),
    "capped_cylinder": ("eb2.geom_type = cylinder\neb2.cylinder_center = 0.5 0.5 0.5\n"
                        "eb2.cylinder_radius = 0.3\neb2.cylinder_height = 0.5\n"
                        "eb2.cylinder_direction = 1\n", *CUBE, (False,) * 3),
    "box": ("eb2.geom_type = box\neb2.box_lo = 0.2 0.3 0.1\neb2.box_hi = 0.7 0.8 0.6\n"
            "eb2.box_has_fluid_inside = 0\n", *CUBE, (False,) * 3),
    "plane": ("eb2.geom_type = plane\neb2.plane_point = 0.5 0.5\n"
              "eb2.plane_normal = 0.6 -0.8\n", (32, 32), (0.0, 0.0), (1.0, 1.0), (False, False)),
    "Inflow-Pipe": ("eb2.geom_type = Inflow-Pipe\npipe.direction1 = 2\npipe.direction2 = 0\n"
                    "pipe.radius1 = 0.3\npipe.radius2 = 0.12\npipe.height1 = -1\n"
                    "pipe.height2 = -1\npipe.center1 = 0.0 0.0 0.0\n"
                    "pipe.center2 = 0.0 0.35 0.0\n", *HALF, (False,) * 3),
    "Mixing-Pipe": ("eb2.geom_type = Mixing-Pipe\npipe.direction = 1\npipe.radius = 0.3\n"
                    "pipe.height = 0.8\npipe.center = 0 0 0\npipe.internal_flow = 1\n",
                    *HALF, (False,) * 3),
    "Square-Grid": ("eb2.geom_type = Square-Grid\nsquare_grid.dim_L0 = 0.5\n"
                    "square_grid.ratio_t0_L0_cross = 0.2\n", *HALF, (False,) * 3),
    "combustor": ("geometry.prob_lo = 0. 0. 0.\ngeometry.prob_hi = 1. 1. 1.\n"
                  "eb2.geom_type = combustor\ncombustor.far_wall_loc = 0.45\n"
                  "combustor.ramp_plane1_point = 0.25 0.25\n"
                  "combustor.ramp_plane2_point = 0.25 0.25\n"
                  "combustor.ramp_plane2_normal = -1. -1.\n"
                  "combustor.ramp_plane3_point = 0.4 0.\ncombustor.pipe_lo = 0.1 -1.\n"
                  "combustor.pipe_hi = 0.2 0.2\n", *CUBE, (False,) * 3),
    "Piston-Cylinder": ("eb2.geom_type = Piston-Cylinder\n", (16, 16, 16),
                        (-6.0, -6.0, -2.5), (6.0, 6.0, 3.5), (False,) * 3),
    "Line-Piston-Cylinder": ("eb2.geom_type = Line-Piston-Cylinder\n", (16, 16, 16),
                             (-0.015, -0.015, -0.00625), (0.015, 0.015, 0.00875),
                             (False,) * 3),
    "plugin": ("eb2.geom_type = test_ellipse\n", (32, 32), (0.0, 0.0), (1.0, 1.0),
               (True, False)),
}


@pytest.fixture
def ellipse_plugin():
    """A user geometry registered in both packages under one name: the
    outside of an ellipse, whose arithmetic runs on numpy arrays and torch
    tensors alike."""
    def ellipse(pp, dim):
        return lambda x, y: (x - 0.5) * (x - 0.5) / 0.09 + (y - 0.4) * (y - 0.4) / 0.04 - 1.0

    jplugins.eb_geometry("test_ellipse")(ellipse)
    tplugins.eb_geometry("test_ellipse")(ellipse)
    yield
    del jplugins.EB_GEOMETRIES["test_ellipse"], tplugins.EB_GEOMETRIES["test_ellipse"]


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_geometry_matches(name, ellipse_plugin):
    text, cells, lo, hi, periodic = GEOMETRIES[name]
    jeb = jgeom.eb_from_inputs(JParmParse.from_string(text),
                               JGeometry(cells, lo, hi, periodic, 0))
    teb = tgeom.eb_from_inputs(TParmParse.from_string(text),
                               TGeometry(cells, lo, hi, periodic, 0), device="cpu")
    vf = teb.vfrac.numpy()
    assert ((vf > 0.0) & (vf < 1.0)).any(), name  # cut cells exist
    for field in ("vfrac", "fluid", "covered", "regular", "merge_dir"):
        np.testing.assert_array_equal(np.asarray(getattr(jeb, field)),
                                      getattr(teb, field).numpy(), err_msg=field)
    assert teb.merge_dir.dtype == torch.int32
    for a, b in zip(jeb.afrac, teb.afrac):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in list(zip(jeb.cent, teb.cent)) + [(jeb.aeb_vol, teb.aeb_vol),
                                                 (jeb.d_eb, teb.d_eb)]:
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0.0, atol=1e-14)


def test_all_regular_is_no_eb():
    geom = TGeometry((8, 8), (0.0, 0.0), (1.0, 1.0), (False, False))
    for text in ("", "eb2.geom_type = all_regular"):
        assert tgeom.eb_from_inputs(TParmParse.from_string(text), geom, device="cpu") is None
    with pytest.raises(NotImplementedError, match="not implemented"):
        tgeom.eb_from_inputs(TParmParse.from_string("eb2.geom_type = teapot"), geom,
                             device="cpu")


def _fpc(dim, cells, *overrides):
    """The flow past a cylinder's configs and geometries (JAX, port) at
    `cells`, the cylinder's radius 0.2, with more `key = value` lines."""
    name = "sphere" if dim == 2 else "cylinder"
    text = example_text(f"inputs.{dim}d.flow_past_cylinder",
                        "amr.n_cell = " + " ".join(map(str, cells)),
                        f"eb2.{name}_radius = 0.2", *overrides)
    jcfg, tcfg = configs(text)
    jeb, teb = ebs(text, jcfg, tcfg)
    assert float(teb.covered.sum()) > 0 and bool(((teb.vfrac > 0) & (teb.vfrac < 1)).any())
    return jcfg, tcfg, jeb, teb


CASES = {2: (64, 16), 3: (32, 8, 8)}


def _faces(rng, n):
    return tuple(rng.randn(*[n[e] + (e == d) for e in range(len(n))]) for d in range(len(n)))


@pytest.mark.parametrize("dim", [2, 3])
def test_eb_aofs_and_redistribution_match(dim):
    """eb_aofs under each rtype, conservative and convective, and
    state_redistribute alone, on seeded fluxes and states."""
    jcfg, tcfg, jeb, teb = _fpc(dim, CASES[dim])
    n, dx, periodic = tuple(jcfg.geom.ncell), jcfg.geom.dx, tuple(jcfg.geom.periodic)
    rng = np.random.RandomState(dim)
    flux, umac, s = _faces(rng, n), _faces(rng, n), rng.randn(*n)
    dt = 0.013
    for rtype in ("NoRedist", "FluxRedist", "StateRedist"):
        for icons in (True, False):
            ref = jredist.eb_aofs(tuple(map(jnp.asarray, flux)), tuple(map(jnp.asarray, umac)),
                                  jeb, dx, icons, s_cc=jnp.asarray(s), periodic=periodic,
                                  rtype=rtype, dt=dt)
            got = tredist.eb_aofs(tuple(map(T, flux)), tuple(map(T, umac)), teb, dx, icons,
                                  s_cc=T(s), periodic=periodic, rtype=rtype,
                                  dt=torch.tensor(dt, dtype=torch.float64))
            close(ref, got, 1e-12)
    q = rng.randn(*n)
    close(jredist.state_redistribute(jnp.asarray(q), jeb, periodic),
          tredist.state_redistribute(T(q), teb, periodic), 1e-12)
    # sum vfrac q is conserved
    got = tredist.state_redistribute(T(q), teb, periodic)
    assert abs(float((teb.vfrac * (got - T(q))).sum())) < 1e-11 * float(teb.vfrac.sum())
    close(jredist.hybrid_divergence(jnp.asarray(q), jeb, periodic),
          tredist.hybrid_divergence(T(q), teb, periodic), 1e-12)


@pytest.mark.parametrize("dim", [2, 3])
def test_slope4_eb_and_edge_states_match(dim):
    """slope4_eb on a grown field and the fluid mask grown as advect_field
    grows it, then compute_edge_states with it, conservative and
    convective, and advect_field's fluxes under eb."""
    jcfg, tcfg, jeb, teb = _fpc(dim, CASES[dim])
    n, dx, periodic = tuple(jcfg.geom.ncell), jcfg.geom.dx, tuple(jcfg.geom.periodic)
    rng = np.random.RandomState(10 + dim)
    s_g = rng.randn(*[m + 6 for m in n])
    fluid_g = np.pad(np.asarray(jeb.fluid), 3, mode="constant", constant_values=1.0)
    for d in range(dim):
        close(jgod.slope4_eb(jnp.asarray(s_g), d, jnp.asarray(fluid_g)),
              tgod.slope4_eb(T(s_g), d, T(fluid_g)), 1e-12)
    umac = _faces(rng, n)
    umac_g = tgod.grow_umac_transverse(tuple(map(T, umac)), periodic)
    jumac_g = tuple(jnp.asarray(u.numpy()) for u in umac_g)
    force_g = rng.randn(*[m + 2 for m in n])
    dt = 0.02
    for icons in (True, False):
        ref = jgod.compute_edge_states(jnp.asarray(s_g), jumac_g, dt, dx, n, icons,
                                       force_g=jnp.asarray(force_g), periodic=periodic,
                                       fluid_g=jnp.asarray(fluid_g))
        got = tgod.compute_edge_states(T(s_g), umac_g, torch.tensor(dt, dtype=torch.float64),
                                       dx, n, icons, force_g=T(force_g), periodic=periodic,
                                       fluid_g=T(fluid_g))
        for a, b in zip(ref, got):
            close(a, b, 1e-12)
        jfl, _ = jgod.advect_field(jnp.asarray(s_g), tuple(map(jnp.asarray, umac)), jumac_g, dt,
                                   dx, n, icons, s_cc=jnp.asarray(s_g[(slice(3, -3),) * dim]),
                                   periodic=periodic, eb=jeb)
        tfl, _ = tgod.advect_field(T(s_g), tuple(map(T, umac)), umac_g,
                                   torch.tensor(dt, dtype=torch.float64), dx, n, icons,
                                   s_cc=T(s_g[(slice(3, -3),) * dim]), periodic=periodic,
                                   eb=teb)
        for a, b in zip(jfl, tfl):
            close(a, b, 1e-12)


@pytest.mark.parametrize("dim", [2, 3])
def test_eb_mac_projection_matches(dim):
    """The EB MAC projection with a divergence source, 8 fixed V-cycles and
    to tolerance; to tolerance its cut-cell divergence meets vfrac S, and
    check_div_cond reads it in both packages."""
    jcfg, tcfg, jeb, teb = _fpc(dim, CASES[dim])
    n, dx = tuple(jcfg.geom.ncell), jcfg.geom.dx
    rng = np.random.RandomState(20 + dim)
    umac = _faces(rng, n)
    rho = 1.0 + rng.rand(*n)
    src = 0.1 * rng.randn(*n)
    for fixed in (8, None):
        def jproj(u, r, s):
            return jmac.mac_project(u, r, jcfg.dom, dx, divu_src=s, eb=jeb,
                                    fixed_cycles=fixed)[:2]

        jun, jphi = jax.jit(jproj)(tuple(map(jnp.asarray, umac)), jnp.asarray(rho),
                                   jnp.asarray(src))
        tun, tphi, _ = tmac.mac_project(tuple(map(T, umac)), T(rho), tcfg.dom, dx,
                                        divu_src=T(src), eb=teb, fixed_cycles=fixed)
        close(jphi, tphi, 1e-12)
        for a, b in zip(jun, tun):
            close(a, b, 1e-12)
    jdiv = float(jchecks.check_div_cond(jun, dx, divu_src=jnp.asarray(src), eb=jeb))
    tdiv = float(tchecks.check_div_cond(tun, dx, divu_src=T(src), eb=teb))
    scale = max(float(np.abs(src).max()), 1.0) / min(dx)
    assert tdiv < 1e-8 * scale and abs(jdiv - tdiv) <= 1e-12 * scale


def test_eb_mac_projection_closed_domain_matches():
    """On a closed domain (slip walls all round) the EB MAC solve, with
    alpha = covered and a = 1, is not treated as singular: the mean of the
    net divergence is never removed, so its residual stays there (tolerance
    mode runs to the 100-cycle cap) and phi grows with the cycles, in both
    packages alike (ROADMAP.md, notes on the reference)."""
    jcfg, tcfg, jeb, teb = _fpc(2, (64, 16), "xlo.type = slip_wall", "xhi.type = slip_wall")
    n, dx = tuple(jcfg.geom.ncell), jcfg.geom.dx
    rng = np.random.RandomState(5)
    umac, rho = _faces(rng, n), 1.0 + rng.rand(*n)
    for fixed in (8, None):
        ref = jax.jit(lambda u, r: jmac.mac_project(u, r, jcfg.dom, dx, eb=jeb,
                                                    fixed_cycles=fixed))(
            tuple(map(jnp.asarray, umac)), jnp.asarray(rho))
        got = tmac.mac_project(tuple(map(T, umac)), T(rho), tcfg.dom, dx, eb=teb,
                               fixed_cycles=fixed)
        close(ref[1], got[1], 1e-12)
        assert int(got[2][1]) == int(ref[2][1]) == (8 if fixed else 100)
        # the residual norm of the stalled solve, to the steps' 1e-10
        res = float(got[2][0])
        assert abs(res - float(ref[2][0])) <= 1e-10 * res and res > 1.0


@pytest.mark.parametrize("dim", [2, 3])
def test_eb_nodal_projections_match(dim):
    """level_project (with a divergence source; the EB solve starts from
    zero), initial_velocity_project and initial_pressure_project under EB,
    8 fixed V-cycles; the covered cells' velocity and Gp are 0."""
    jcfg, tcfg, jeb, teb = _fpc(dim, CASES[dim])
    n, dx = tuple(jcfg.geom.ncell), jcfg.geom.dx
    rng = np.random.RandomState(30 + dim)
    vel, gradp = rng.randn(dim, *n), rng.randn(dim, *n)
    rho = 1.0 + rng.rand(*n)
    p = 0.1 * rng.randn(*[m + 1 for m in n])
    src = 0.1 * rng.randn(*n)
    dt = 0.01

    def jlevel(v, r, p_, g, s):
        return jnodal.level_project(v, r, p_, g, dt, jcfg.dom, dx, divu_src=s, eb=jeb,
                                    fixed_cycles=8)[:3]

    ref = jax.jit(jlevel)(*(jnp.asarray(a) for a in (vel, rho, p, gradp, src)))
    got = tnodal.level_project(T(vel), T(rho), T(p), T(gradp),
                               torch.tensor(dt, dtype=torch.float64), tcfg.dom, dx,
                               divu_src=T(src), eb=teb, fixed_cycles=8)[:3]
    for a, b in zip(ref, got):
        close(a, b, 1e-12)
    assert float((got[0].abs() * teb.covered).max()) == 0.0
    ref = jax.jit(lambda v, r: jnodal.initial_velocity_project(
        v, r, jcfg.dom, dx, eb=jeb, fixed_cycles=8)[0])(jnp.asarray(vel), jnp.asarray(rho))
    got = tnodal.initial_velocity_project(T(vel), T(rho), tcfg.dom, dx, eb=teb,
                                          fixed_cycles=8)[0]
    close(ref, got, 1e-12)
    ref = jax.jit(lambda r: jnodal.initial_pressure_project(
        r, -9.8, jcfg.dom, dx, eb=jeb, fixed_cycles=8))(jnp.asarray(rho))
    got = tnodal.initial_pressure_project(T(rho), -9.8, tcfg.dom, dx, eb=teb, fixed_cycles=8)
    for a, b in zip(ref, got):
        close(a, b, 1e-12)


@pytest.mark.parametrize("case", ["rz", "use_forces_in_trans"])
def test_eb_refusals(case):
    """RZ with EB and use_forces_in_trans with EB raise in the port, as in
    the JAX package (the reference aborts on the latter)."""
    if case == "rz":
        text = example_text("inputs.2d.hotspot_rz", "amr.n_cell = 8 16")
        match = "RZ \\+ EB"
    else:
        text = example_text("inputs.2d.flow_past_cylinder", "amr.n_cell = 16 8",
                            "godunov.use_forces_in_trans = 1")
        match = "use_forces_in_trans"
    _, tcfg = configs(text)
    teb = tgeom.build_eb_geometry(tgeom.sphere_if((0.25, 0.5), 0.1, False), tcfg.geom,
                                  device="cpu")
    state = tinit_state(tcfg, "cpu")._replace(dt=torch.tensor(1e-3, dtype=torch.float64))
    with pytest.raises(NotImplementedError, match=match):
        tadvance.advance(state, tcfg, 1, eb=teb)
