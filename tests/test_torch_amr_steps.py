"""AMR steps of the port against the JAX package, f64 on the CPU: a
hierarchy started by initialize without pressure iterations (compared),
the finer levels interpolated from the coarser (compared), a seeded 1e-3
velocity perturbation on every level (a fluid at rest puts faces on
Riemann ties), then 2 coarse steps of each package's step function, every
field of every level to 1e-10 of max|ref|:

  * Rayleigh-Taylor 2D 32x64 on two levels (the default centred patch),
    subcycled (fast tier, with the composite mass, uncovered coarse cells
    plus the fine level, held to roundoff in both packages: the slip walls
    close the domain and reflux, avgDown and the conservative sync keep
    it) and composite;
  * Rayleigh-Taylor 3D 16x16x32, HotSpot 3D 16^3 with do_temp, the 2D flow
    past a cylinder 64x16 with EB on both levels (the patch from the cut
    cells, the cylinder widened to radius 0.2), forced HIT 16^3 with 256
    tracer particles, Rayleigh-Taylor 2D on three nested levels;
  * a tagged Rayleigh-Taylor 2D 32x64 run (a seeded velocity from a
    registered problem), regridded every 2 steps, driver.run_multilevel in
    both packages for 4 steps.

Every level of every solve has more than 512 cells, so the JAX package's
jitted fixed-cycle solves converge as its eager ones do (ROADMAP.md, notes
on the reference). The JAX package's two-level step compiles for half a
minute or more on the CPU, so one case is in the fast tier and the others
are `slow` (`-m slow`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iamr_tpu.plugins as jplug
import iamr_tpu_torch.plugins as tplug
from iamr_tpu.amr import hierarchy as jh
from iamr_tpu.amr import multilevel as jml
from iamr_tpu.amr.tagging import parse_refinement_indicators as jparse
from iamr_tpu.config.parmparse import ParmParse as JParmParse
from iamr_tpu.eb import geom as jgeom
from iamr_tpu.ns import driver as jdriver
from iamr_tpu.ns import particles as jpart
from iamr_tpu_torch import convert
from iamr_tpu_torch.amr import multilevel as tml
from iamr_tpu_torch.amr.tagging import parse_refinement_indicators as tparse
from iamr_tpu_torch.config.parmparse import ParmParse as TParmParse
from iamr_tpu_torch.eb import geom as tgeom
from iamr_tpu_torch.ns import driver as tdriver
from torch_parity import CPU, FIELDS, close, configs, example_text

torch.set_num_threads(2)
FIXED = 4
RT2, RT3 = "inputs.2d.rayleigh_taylor", "inputs.3d.rayleigh_taylor"
TAGS = ("amr.refinement_indicators = denerr", "amr.denerr.field_name = density",
        "amr.denerr.adjacent_difference_greater = 0.05")

# (inputs, overrides, subcycle, levels, particles)
CASES = {
    "rt2d_subcycled": (RT2, ("amr.n_cell = 32 64",), True, 2, 0),
    "rt2d_composite": (RT2, ("amr.n_cell = 32 64",), False, 2, 0),
    "rt3d_subcycled": (RT3, ("amr.n_cell = 16 16 32",), True, 2, 0),
    "hotspot3d": ("inputs.3d.hotspot", ("amr.n_cell = 16 16 16",), True, 2, 0),
    "fpc2d_eb": ("inputs.2d.flow_past_cylinder", ("amr.n_cell = 64 16", "eb2.sphere_radius = 0.2",
                                                  "prob.blob_radius = 0.2"), True, 2, 0),
    "hit3d_particles": ("inputs.3d.hit_forced", ("amr.n_cell = 16 16 16",), True, 2, 256),
    "rt2d_three_levels": (RT2, ("amr.n_cell = 32 64",), True, 3, 0),
}


def to_port(st):
    return convert.state_from_numpy({k: None if v is None else np.asarray(v)
                                     for k, v in st._asdict().items()}, CPU)


def composite_mass(states, specs, geom):
    """The mass of a two-level hierarchy: uncovered coarse cells plus the
    fine level, in f64."""
    crse = np.array(np.asarray(states[0].rho), dtype=np.float64)
    sp = specs[0]
    crse[tuple(slice(l // sp.ratio, (l + n) // sp.ratio) for l, n in zip(sp.lo, sp.ncell))] = 0.0
    vol = float(np.prod(geom.dx))
    return crse.sum() * vol + np.asarray(states[1].rho, np.float64).sum() * vol / sp.ratio ** len(
        sp.lo)


def run_pair(inputs, overrides, subcycle, levels, nparticles, steps=2):
    """Both packages' hierarchies through `steps` coarse steps; returns
    (JAX states, port states, JAX specs, JAX config, the two-level start or
    None)."""
    text = example_text(inputs, f"amr.max_level = {levels - 1}", *overrides)
    jcfg, tcfg = configs(text)
    teb = tgeom.eb_from_inputs(TParmParse.from_string(text), tcfg.geom, device="cpu")
    tebs = None
    jebs = None
    if teb is not None:
        tebs = tdriver.HierarchyEB(tgeom.psi_from_inputs(TParmParse.from_string(text), 2), tcfg,
                                   CPU)
    jst = [jdriver.initialize(jcfg, fixed_mg_cycles=FIXED, init_iters=0,
                              eb=jgeom.eb_from_inputs(JParmParse.from_string(text), jcfg.geom)
                              if tebs else None)]
    tst = [tdriver.initialize(tcfg, FIXED, "cpu", init_iters=0,
                              eb=tebs.level0 if tebs else None)]
    if tebs is not None:
        # the patch over the cut cells (refine_cutcells)
        tspecs = [tdriver.fine_spec_from_tags(tcfg, tst[0], None, tebs, subcycle)[0]]
    else:
        tspecs = [tdriver.default_fine_spec(tcfg)]
        for _ in range(levels - 2):
            n = tspecs[-1].ncell
            tspecs.append(type(tspecs[-1])(lo=tuple(2 * (x // 4) for x in n),
                                           ncell=tuple(2 * (x // 2) for x in n)))
    jspecs = [jh.LevelSpec(lo=s.lo, ncell=s.ncell, ratio=s.ratio) for s in tspecs]
    jcfgs, tcfgs = jml.hierarchy_configs(jcfg, jspecs), tml.hierarchy_configs(tcfg, tspecs)
    if tebs is not None:
        psi = jgeom.psi_from_inputs(JParmParse.from_string(text), 2)
        jebs = [jgeom.eb_from_inputs(JParmParse.from_string(text), jcfg.geom),
                jgeom.build_eb_geometry(psi, jcfgs[1].geom)]
    for lev, (js, ts) in enumerate(zip(jspecs, tspecs)):
        jst.append(jml.init_fine_from_coarse(jcfgs[lev], js, jst[-1]))
        tst.append(tml.init_fine_from_coarse(tcfgs[lev], ts, tst[-1]))
        if tebs is not None:
            jst[-1] = jst[-1]._replace(vel=jst[-1].vel * jebs[1].fluid)
            tst[-1] = tst[-1]._replace(vel=tst[-1].vel * tebs.fine(ts).fluid)
    for j, t in zip(jst, tst):
        for k in FIELDS:
            close(getattr(j, k), getattr(t, k))
    rng = np.random.RandomState(3)
    jst = [s._replace(vel=s.vel + jnp.asarray(1e-3 * rng.randn(*s.vel.shape))) for s in jst]
    tst = [to_port(s) for s in jst]
    jparts = tparts = None
    if nparticles:
        pos = np.random.RandomState(5).uniform(-0.5, 0.5, (nparticles, jcfg.dim))
        jparts = jpart.from_positions(jnp.asarray(pos))
        tparts = convert.particles_from_numpy(pos, CPU)
    if levels > 2:
        jfn = jax.jit(lambda sts: jml.advance_hierarchy_subcycled(sts, jcfg, jspecs, FIXED))
        for _ in range(steps):
            jst = list(jfn(tuple(jst)))
            tst = list(tml.advance_hierarchy_subcycled(tuple(tst), tcfg, tspecs, FIXED))
    elif nparticles:
        jfn = jml.make_two_level_step_with_particles(jcfg, jspecs[0], FIXED, subcycle)
        tfn = tml.make_two_level_step_with_particles(tcfg, tspecs[0], FIXED, subcycle)
        jm, tm = jml.MLState(*jst), tml.MLState(*tst)
        for _ in range(steps):
            jm, jparts = jfn(jm, jparts)
            tm, tparts = tfn(tm, tparts)
        jst, tst = list(jm), list(tm)
        close(jparts.pos, tparts.pos)
        assert np.array_equal(np.asarray(jparts.alive), tparts.alive.numpy())
    else:
        jfn = jml.make_two_level_step(jcfg, jspecs[0], FIXED, subcycle, ebs=jebs)
        tfn = tml.make_two_level_step(tcfg, tspecs[0], FIXED, subcycle,
                                      ebs=[tebs.level0, tebs.fine(tspecs[0])] if tebs else None)
        jm, tm = jml.MLState(*jst), tml.MLState(*tst)
        m0 = (jm, tm)
        for _ in range(steps):
            jm, tm = jfn(jm), tfn(tm)
        if not subcycle or tebs is not None:
            m0 = None
        jst, tst = list(jm), list(tm)
    for j, t in zip(jst, tst):
        for k in FIELDS:
            close(getattr(j, k), getattr(t, k))
    if tebs is not None:
        assert float(tst[1].vel[:, tebs.fine(tspecs[0]).covered > 0].abs().max()) == 0.0
    return jst, tst, jspecs, jcfg, (m0 if levels == 2 and not nparticles else None)


@pytest.mark.parametrize("case", [
    "rt2d_subcycled",
    *(pytest.param(c, marks=pytest.mark.slow) for c in sorted(CASES) if c != "rt2d_subcycled")])
def test_hierarchy_steps_match(case):
    jst, tst, jspecs, jcfg, start = run_pair(*CASES[case])
    if case == "rt2d_subcycled":
        # the composite mass over 2 subcycled steps, to roundoff in both
        jm0, tm0 = start
        for m0, m1 in ((jm0, jst), (tm0, tst)):
            a = composite_mass(list(m0), jspecs, jcfg.geom)
            b = composite_mass(m1, jspecs, jcfg.geom)
            assert abs(b - a) <= 1e-13 * abs(a), (a, b)


def seeded_rt(cfg, X, fields):
    """Rayleigh-Taylor's density and tracer with a smooth seeded velocity,
    so that no face of the first steps is on a Riemann tie."""
    frac = 0.5 * (1.0 + np.tanh((X[-1] - 0.5) / 0.05))
    fields["rho"][...] = 1.0 + frac
    fields["trac"][0] = frac
    rng = np.random.RandomState(11)
    L = [h - l for l, h in zip(cfg.geom.prob_lo, cfg.geom.prob_hi)]
    for d in range(cfg.dim):
        for _ in range(3):
            k = rng.randint(1, 3, size=cfg.dim)
            arg = sum(2 * np.pi * k[e] * X[e] / L[e] for e in range(cfg.dim))
            fields["vel"][d] += 0.5 * rng.randn() * np.sin(arg + 2 * np.pi * rng.rand())


@pytest.mark.slow
def test_tagged_run_multilevel_matches():
    for plug in (jplug, tplug):
        plug.problem_ic(918)(seeded_rt)
    try:
        text = example_text(RT2, "amr.n_cell = 32 64", "amr.max_level = 1", "prob.probtype = 918",
                            *TAGS)
        jcfg, tcfg = configs(text)
        jml_ = jdriver.run_multilevel(jcfg, max_steps=4, fixed_mg_cycles=FIXED, subcycle=True,
                                      error_tags=jparse(JParmParse.from_string(text)),
                                      regrid_int=2)
        tml_ = tdriver.run_multilevel(tcfg, max_steps=4, fixed_mg_cycles=FIXED, subcycle=True,
                                      error_tags=tparse(TParmParse.from_string(text)),
                                      regrid_int=2, device="cpu")
    finally:
        for plug in (jplug, tplug):
            plug.PROBLEM_ICS.pop(918)
    for j, t in zip(jml_, tml_):
        for k in FIELDS:
            close(getattr(j, k), getattr(t, k))
