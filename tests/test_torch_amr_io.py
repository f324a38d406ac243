"""AMR's files in the port against the JAX package, on the CPU in f64:

  * convert.py carries a hierarchy (states and LevelSpecs) both ways;
    given the same hierarchy (seeded fields on two and three nested
    levels, 2D and 3D), the multi-level plotfile writer, the npz
    multi-level checkpoint (state.npz arrays, meta.json text) and the
    AMReX multi-level checkpoint write the same bytes as the JAX
    package's; the plotfiles of the drivers (with their derived fields)
    agree to 1e-12; each package loads the other's checkpoints of both
    formats (every array, the specs, the step) and refine_checkpoint
    writes the same arrays;
  * a port restart: a tagged two-level Rayleigh-Taylor run from an inputs
    file (run_from_inputs, AMReX checkpoints at 2 and 4, a plotfile at 4),
    restarted from chk00002, writes chk00004 and plt00004 byte for byte
    (each level restores its own time from the AMReX State_Type entry);
  * the refusals of multi-box levels: an amr.regrid_file level of two
    boxes, the dynamic regrid of amr.max_level = 2, run_hierarchy with a
    two-box level;
  * slow tier: run_from_inputs of examples/inputs.3d.rayleigh_taylor_amr
    at 16x16x32 (a seeded velocity from a registered problem) against the
    JAX package's, every file to 1e-10, and the step-2 checkpoint of each
    package restarted in the other, npz and AMReX.
"""

import filecmp
import json
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import iamr_tpu.plugins as jplug
import iamr_tpu_torch.plugins as tplug
from iamr_tpu.amr import hierarchy as jh
from iamr_tpu.amr import multilevel as jml
from iamr_tpu.io import amrex_chk as jamrex
from iamr_tpu.io import checkpoint as jchk
from iamr_tpu.io import plotfile as jplot
from iamr_tpu.ns import driver as jdriver
from iamr_tpu.ns.state import NSState as JState
from iamr_tpu_torch import convert
from iamr_tpu_torch.amr import hierarchy as th
from iamr_tpu_torch.amr import multilevel as tml
from iamr_tpu_torch.io import amrex_chk as tamrex
from iamr_tpu_torch.io import checkpoint as tchk
from iamr_tpu_torch.io import plotfile as tplot
from iamr_tpu_torch.ns import driver as tdriver
from torch_parity import CPU, EXAMPLES, close, close_files, configs, example_text

torch.set_num_threads(2)
RT2 = "inputs.2d.rayleigh_taylor"
AMR3 = os.path.join(EXAMPLES, "inputs.3d.rayleigh_taylor_amr")
CASES = {
    2: (example_text(RT2, "amr.n_cell = 12 20", "amr.max_level = 2", "ns.do_temp = 1"),
        [((4, 8), (12, 20)), ((4, 4), (8, 12))]),
    3: (example_text("inputs.3d.rayleigh_taylor", "amr.n_cell = 6 8 10", "amr.max_level = 2"),
        [((2, 4, 4), (6, 8, 10)), ((2, 2, 2), (4, 6, 8))]),
}


def hierarchy(dim, seed=0):
    """(JAX config, port config, JAX states, port states, JAX specs, port
    specs) of seeded fields on three nested levels."""
    text, boxes = CASES[dim]
    jcfg, tcfg = configs(text)
    jspecs = [jh.LevelSpec(lo=lo, ncell=n) for lo, n in boxes]
    tspecs = [th.LevelSpec(lo=lo, ncell=n) for lo, n in boxes]
    rng = np.random.RandomState(seed)
    jstates = []
    for c in jml.hierarchy_configs(jcfg, jspecs):
        n = c.geom.ncell
        jstates.append(JState(
            vel=jnp.asarray(rng.randn(c.dim, *n)), rho=jnp.asarray(1.0 + rng.rand(*n)),
            trac=jnp.asarray(rng.randn(c.ntrac, *n)), temp=jnp.asarray(1.0 + rng.rand(*n)),
            p=jnp.asarray(rng.randn(*(x + 1 for x in n))), gradp=jnp.asarray(rng.randn(c.dim, *n)),
            time=jnp.asarray(0.125), dt=jnp.asarray(1.0 / (3.0 * 2 ** len(jstates))),
            dsdt=jnp.asarray(rng.randn(*n)) if c.do_temp else None))
    tstates, tsp = convert.hierarchy_from_numpy(
        [{k: None if v is None else np.asarray(v) for k, v in s._asdict().items()}
         for s in jstates], jspecs, CPU)
    assert tsp == tspecs
    # and back: the JAX package's NSState(**...) and LevelSpec(**...) take them
    back, bspecs = convert.hierarchy_to_numpy(tstates, tspecs)
    assert [jh.LevelSpec(**b) for b in bspecs] == jspecs
    for js, b in zip(jstates, back):
        for k, v in JState(**b)._asdict().items():
            assert (v is None) == (getattr(js, k) is None)
            if v is not None:
                assert np.array_equal(v, np.asarray(getattr(js, k)))
    return jcfg, tcfg, jstates, tstates, jspecs, tspecs


def tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root)
                  for f in fs)


def same_bytes(a, b):
    assert tree(a) == tree(b)
    for rel in tree(a):
        if rel.endswith(".npz"):
            with np.load(os.path.join(a, rel)) as za, np.load(os.path.join(b, rel)) as zb:
                assert list(za.files) == list(zb.files), rel
                for k in za.files:
                    assert za[k].dtype == zb[k].dtype and np.array_equal(za[k], zb[k]), (rel, k)
        else:
            assert filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel), shallow=False), rel


@pytest.mark.parametrize("dim", [2, 3])
def test_multilevel_files_match_jax(dim, tmp_path):
    jcfg, tcfg, jst, tst, jspecs, tspecs = hierarchy(dim)
    j, t = tmp_path / "j", tmp_path / "t"
    # the plotfile writer on the same fields, two levels
    fields = [{"x": np.asarray(s.vel[0]), "density": np.asarray(s.rho)} for s in jst[:2]]
    jplot.write_plotfile(str(j / "plt00005"), jcfg.geom, fields[0], time=0.5, level_steps=5,
                         fine_levels=[(fields[1], jspecs[0].lo, 2)])
    tplot.write_plotfile(str(t / "plt00005"), tcfg.geom, fields[0], time=0.5, level_steps=5,
                         fine_levels=[(fields[1], tspecs[0].lo, 2)])
    same_bytes(j / "plt00005", t / "plt00005")
    # the drivers' two-level plotfiles, with their derived fields
    jdriver.write_plotfile_for_hierarchy(jcfg, jspecs[0], jml.MLState(*jst[:2]),
                                         str(j / "plt00006"), 6)
    tdriver.write_plotfile_for_hierarchy(tcfg, tspecs[0], tml.MLState(*tst[:2]),
                                         str(t / "plt00006"), 6)
    close_files(j / "plt00006", t / "plt00006", 1e-12)
    for nlev in (2, 3):
        # npz and AMReX checkpoints, two and three levels
        jchk.save_checkpoint_ml(str(j / f"npz{nlev}"), jst[:nlev], jspecs[:nlev - 1], 7,
                                boxlists=[None] * (nlev - 1))
        tchk.save_checkpoint_ml(str(t / f"npz{nlev}"), tst[:nlev], tspecs[:nlev - 1], 7,
                                boxlists=[None] * (nlev - 1))
        same_bytes(j / f"npz{nlev}", t / f"npz{nlev}")
        jamrex.write_checkpoint_amrex(str(j / f"amrex{nlev}"), jst[:nlev], jspecs[:nlev - 1],
                                      jcfg, 7)
        tamrex.write_checkpoint_amrex_levels(str(t / f"amrex{nlev}"), tst[:nlev],
                                             tspecs[:nlev - 1], tcfg, 7)
        same_bytes(j / f"amrex{nlev}", t / f"amrex{nlev}")
        # each package loads the other's
        for fmt in ("npz", "amrex"):
            got, gspecs, step = tchk.load_checkpoint_ml(str(j / f"{fmt}{nlev}"), tcfg, CPU)
            ref, rspecs, rstep = jchk.load_checkpoint_ml(str(t / f"{fmt}{nlev}"), jcfg)
            assert step == rstep == 7
            assert [(s.lo, s.ncell, s.ratio) for s in gspecs] == [
                (s.lo, s.ncell, s.ratio) for s in rspecs] == [
                (s.lo, s.ncell, s.ratio) for s in tspecs[:nlev - 1]]
            for lev in range(nlev):
                for k in JState._fields:
                    a, b = getattr(jst[lev], k), getattr(got[lev], k)
                    if k == "temp" and fmt == "amrex" and not tcfg.do_temp:
                        assert bool((b == 1.0).all()) and bool((getattr(ref[lev], k) == 1.0).all())
                        continue
                    close(a, b, 0.0)
                    close(getattr(ref[lev], k), getattr(tst[lev], k), 0.0)
        assert tchk.load_boxlists(str(t / f"npz{nlev}")) == [None] * (nlev - 1)
    # refine_checkpoint (single-level npz)
    jchk.save_checkpoint(str(j / "one"), jst[0], 3)
    jchk.refine_checkpoint(str(j / "one"), str(j / "one_r"), 2)
    tchk.refine_checkpoint(str(j / "one"), str(t / "one_r"), 2)
    same_bytes(j / "one_r", t / "one_r")


def _amr_text(tmp_path):
    """A tagged two-level Rayleigh-Taylor 2D inputs file (32x64, the density
    interface refined, tagged again every 2 steps; the interface as in
    examples/inputs.3d.rayleigh_taylor_amr, so that its tags make one box)."""
    path = tmp_path / "inputs.2d.rt_amr"
    path.write_text(example_text(RT2, "amr.n_cell = 32 64", "amr.max_level = 1",
                                 "amr.regrid_int = 2", "amr.refinement_indicators = denerr",
                                 "amr.denerr.field_name = density",
                                 "amr.denerr.adjacent_difference_greater = 0.02",
                                 "prob.perturbation_amplitude = 0.02",
                                 "prob.interface_width = 0.04", "ns.init_iter = 1"))
    return str(path)


def test_port_amr_restart_bit_for_bit(tmp_path):
    path = _amr_text(tmp_path)
    out = {}
    for name, extra in (("straight", []), ("restart", [f"amr.restart={tmp_path}/straight/chk00002"])):
        d = tmp_path / name
        d.mkdir()
        tdriver.run_from_inputs(path, ["max_step=4", "amr.check_int=2", "amr.plot_int=4",
                                       "amr.checkpoint_format=amrex", f"amr.plot_file={d}/plt",
                                       f"amr.check_file={d}/chk", *extra], device="cpu")
        out[name] = d
    assert sorted(os.listdir(out["restart"])) == ["chk00004", "plt00004"]
    for name in ("chk00004", "plt00004"):
        same_bytes(out["straight"] / name, out["restart"] / name)
    with open(out["straight"] / "chk00004" / "Header") as f:
        assert f.read().split("\n")[4] == "1"  # finest_level


def test_multi_box_levels_refused(tmp_path):
    grids = tmp_path / "grids"
    grids.write_text("1\n2\n((4,4) (7,11) (0,0))\n((20,4) (23,11) (0,0))\n")
    text = example_text(RT2, "amr.n_cell = 32 32", "amr.max_level = 1",
                        f"amr.regrid_file = {grids}")
    path = tmp_path / "inputs.2d.two_boxes"
    path.write_text(text)
    with pytest.raises(NotImplementedError, match="amr.regrid_file.*union"):
        tdriver.run_from_inputs(str(path), ["max_step=1"], device="cpu")
    path.write_text(example_text(RT2, "amr.n_cell = 32 32", "amr.max_level = 2",
                                 "amr.regrid_int = 2", "amr.refinement_indicators = denerr",
                                 "amr.denerr.field_name = density",
                                 "amr.denerr.value_greater = 1.5"))
    with pytest.raises(NotImplementedError, match="amr.max_level.*union"):
        tdriver.run_from_inputs(str(path), ["max_step=1"], device="cpu")
    _, tcfg = configs(text)
    two = (th.LevelSpec(lo=(8, 8), ncell=(8, 16)), th.LevelSpec(lo=(40, 8), ncell=(8, 16)))
    with pytest.raises(NotImplementedError, match="union"):
        tdriver.run_hierarchy(tcfg, max_steps=1, specs=[th.LevelSpec(lo=(8, 8), ncell=(40, 16))],
                              boxlists=[two], device="cpu")
    with pytest.raises(NotImplementedError, match="union"):
        tml.advance_subtree(tml.hierarchy_configs(tcfg, [two[0]]), [two[0]], [None, None], 0,
                            None, boxes=object())


def seeded_rt(cfg, X, fields):
    """Rayleigh-Taylor's density and tracer with a smooth seeded velocity
    (no Riemann tie in the first steps)."""
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


@pytest.fixture
def seeded_problem():
    for plug in (jplug, tplug):
        plug.problem_ic(916)(seeded_rt)
    yield
    for plug in (jplug, tplug):
        plug.PROBLEM_ICS.pop(916)


@pytest.mark.slow
@pytest.mark.parametrize("fmt", ["npz", "amrex"])
def test_amr_run_from_inputs_matches_jax(seeded_problem, tmp_path, fmt):
    over = ["amr.n_cell=16 16 32", "max_step=4", "amr.check_int=2", "amr.plot_int=4",
            "prob.probtype=916", f"amr.checkpoint_format={fmt}"]
    drivers = {"jax": (jdriver, {}), "torch": (tdriver, {"device": "cpu"})}

    def run(pkg, name, *extra):
        d = tmp_path / f"{pkg}-{name}"
        d.mkdir()
        driver, kw = drivers[pkg]
        driver.run_from_inputs(AMR3, over + [f"amr.plot_file={d}/plt", f"amr.check_file={d}/chk",
                                             *extra], **kw)
        return d

    def close_chk(ref, got):
        # meta.json's dts list is compared as numbers, the rest as files
        close_files(ref, got, skip=("meta.json",))
        if (ref / "meta.json").exists():
            with open(ref / "meta.json") as f, open(got / "meta.json") as g:
                mr, mg = json.load(f), json.load(g)
            assert sorted(mr) == sorted(mg)
            for k in mr:
                if k in ("time", "dt", "dts"):
                    close(np.asarray(mr[k]), torch.as_tensor(mg[k], dtype=torch.float64))
                else:
                    assert mr[k] == mg[k], k

    jout, tout = run("jax", "straight"), run("torch", "straight")
    close_files(jout / "plt00004", tout / "plt00004")
    if fmt == "npz":
        for name in ("chk00002", "chk00004"):
            close_chk(jout / name, tout / name)
    # the JAX package writes npz checkpoints whatever amr.checkpoint_format
    # says; each package restarts from the other's step-2 checkpoint
    close_chk(tout / "chk00004", run("torch", "from-jax", f"amr.restart={jout}/chk00002")
              / "chk00004")
    jrest = run("jax", "from-torch", f"amr.restart={tout}/chk00002")
    close_files(jout / "plt00004", jrest / "plt00004")
