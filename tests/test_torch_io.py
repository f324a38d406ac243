"""The port's output and the edges of the program, on the CPU in f64:

  * the plotfile and AMReX-checkpoint writers, given the same fields,
    write the same bytes as the JAX package's (job_info aside), 2D and 3D;
    npz checkpoints hold the same arrays and the same meta.json, and the
    readers give back what was written;
  * the derived fields (mag_vort, energy, avg_pressure, diveru) and
    sum_integrated_quantities agree with the JAX package's to 1e-12 of
    max|ref| on walled boxes, 2D and 3D;
  * the particle init, Timestamp and output files are the same bytes;
  * the initial data of prob.ic_file and ns.velocity_plotfile;
  * a port restart (HIT 16^3 with particles through run_from_inputs)
    continues bit for bit, and stays on the FFT path it started on;
  * the refusals of what is not ported (a level of more than one box: an
    amr.regrid_file level of two boxes, the dynamic regrid of
    amr.max_level = 2; amr.max_level = 1 runs) and of an unknown
    eb2.geom_type (a sphere runs),
    ns.debug_nans, and the CLI's refusal to run without a card unless
    given --device=cpu.
"""

import filecmp
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from iamr_tpu.io import amrex_chk as jamrex
from iamr_tpu.io import checkpoint as jchk
from iamr_tpu.io import plotfile as jplot
from iamr_tpu.ns import derive as jderive
from iamr_tpu.ns import driver as jdriver
from iamr_tpu.ns import particles as jpart
from iamr_tpu.ns import probs as jprobs
from iamr_tpu.ns.state import NSState as JState
from iamr_tpu_torch import __main__ as tmain
from iamr_tpu_torch import convert
from iamr_tpu_torch.config.parmparse import ParmParse as TParmParse
from iamr_tpu_torch.io import amrex_chk as tamrex
from iamr_tpu_torch.io import checkpoint as tchk
from iamr_tpu_torch.io import plotfile as tplot
from iamr_tpu_torch.ns import derive as tderive
from iamr_tpu_torch.ns import driver as tdriver
from iamr_tpu_torch.ns import particles as tpart
from iamr_tpu_torch.ns import probs as tprobs
from iamr_tpu_torch.ns import state as tstate
from iamr_tpu_torch.solvers.spectral import spectral_eligible
from torch_parity import (
    CPU, EXAMPLES, HIT, close, close_files, configs, example_text, hit_overrides,
    write_particle_file,
)

torch.set_num_threads(2)
# walled boxes: Rayleigh-Taylor's slip walls in the vertical, a no-slip wall
# and an inflow side in 3D, a temperature field
CASES = {
    "2d": example_text("inputs.2d.rayleigh_taylor", "amr.n_cell = 12 20",
                       "ns.scal_diff_coefs = 1e-4 1e-4"),
    "3d": example_text("inputs.3d.rayleigh_taylor", "amr.n_cell = 6 8 10",
                       "geometry.is_periodic = 1 0 0", "ns.lo_bc = 0 1 5", "ns.hi_bc = 0 2 4",
                       "ylo.velocity = 0.0 1.0 0.0", "ns.do_temp = 1"),
}


def random_state(cfg, seed=0):
    """Numpy fields of an NSState on cfg's grid, seeded."""
    rng = np.random.RandomState(seed)
    n = cfg.geom.ncell
    return {"vel": rng.randn(cfg.dim, *n), "rho": 1.0 + rng.rand(*n),
            "trac": rng.randn(cfg.ntrac, *n), "temp": 1.0 + rng.rand(*n),
            "p": rng.randn(*(x + 1 for x in n)), "gradp": rng.randn(cfg.dim, *n),
            "time": np.float64(0.125), "dt": np.float64(1.0 / 3.0),
            "dsdt": rng.randn(*n) if cfg.do_temp else None}


def both_states(case, seed=0):
    jcfg, tcfg = configs(CASES[case])
    fields = random_state(jcfg, seed)
    jst = JState(**{k: None if v is None else jnp.asarray(v) for k, v in fields.items()})
    return jcfg, jst, tcfg, convert.state_from_numpy(fields, CPU)


def same_tree(a, b, skip=("job_info",)):
    """Every file in a is in b with the same bytes, and no other."""
    def tree(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert tree(a) == tree(b)
    for rel in tree(a):
        if os.path.basename(rel) not in skip:
            assert filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel), shallow=False), rel


@pytest.mark.parametrize("case", sorted(CASES))
def test_writers_write_the_same_bytes(case, tmp_path):
    jcfg, jst, tcfg, tst = both_states(case)
    fields = {k: np.asarray(v) for k, v in zip(("x", "y", "z"), jst.vel)}
    fields["density"] = np.asarray(jst.rho)
    for pkg, write in (("j", jplot.write_plotfile), ("t", tplot.write_plotfile)):
        write(str(tmp_path / pkg / "plt00007"), jcfg.geom if pkg == "j" else tcfg.geom,
              fields, time=0.25, level_steps=7)
    same_tree(tmp_path / "j" / "plt00007", tmp_path / "t" / "plt00007")
    back, time = tplot.read_plotfile(str(tmp_path / "t" / "plt00007"))
    assert time == 0.25 and list(back) == list(fields)
    for k in fields:
        assert np.array_equal(back[k], fields[k])
    # plotfiles of the state with its derives, through the drivers
    jdriver.write_plotfile_for_state(jcfg, jst, str(tmp_path / "j" / "plt00003"), 3,
                                     derives=("diveru",))
    tdriver.write_plotfile_for_state(tcfg, tst, str(tmp_path / "t" / "plt00003"), 3,
                                     derives=("diveru",))
    close_files(tmp_path / "j" / "plt00003", tmp_path / "t" / "plt00003", 1e-12)
    # AMReX checkpoints, and their restart in the other package
    jamrex.write_checkpoint_amrex(str(tmp_path / "j" / "chk00003"), [jst], [], jcfg, 3)
    tamrex.write_checkpoint_amrex(str(tmp_path / "t" / "chk00003"), tst, tcfg, 3)
    same_tree(tmp_path / "j" / "chk00003", tmp_path / "t" / "chk00003")
    got, step = tchk.load_checkpoint(str(tmp_path / "j" / "chk00003"), tcfg, CPU)
    ref, jstep = jchk.load_checkpoint(str(tmp_path / "t" / "chk00003"), jcfg)
    assert step == jstep == 3
    for k in JState._fields:
        if k == "temp" and not tcfg.do_temp:
            # State_Type carries temp only under do_temp: it comes back ones
            assert bool((got.temp == 1.0).all()) and bool((ref.temp == 1.0).all())
            continue
        close(getattr(jst, k), getattr(got, k), 0.0)
        close(getattr(ref, k), getattr(tst, k), 0.0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_npz_checkpoints_hold_the_same_arrays(case, tmp_path):
    jcfg, jst, tcfg, tst = both_states(case, seed=1)
    jchk.save_checkpoint(str(tmp_path / "j"), jst, step=5)
    tchk.save_checkpoint(str(tmp_path / "t"), tst, step=5)
    with open(tmp_path / "j" / "meta.json") as a, open(tmp_path / "t" / "meta.json") as b:
        assert json.load(a) == json.load(b)
    with np.load(tmp_path / "j" / "state.npz") as a, np.load(tmp_path / "t" / "state.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    back, step = tchk.load_checkpoint(str(tmp_path / "j"), tcfg, CPU)
    assert step == 5
    for k in JState._fields:
        close(getattr(jst, k), getattr(back, k), 0.0)
    # an older file without gradp and temp: Gp from the nodal pressure, temp ones
    with np.load(tmp_path / "j" / "state.npz") as z:
        np.savez(tmp_path / "j" / "state.npz", **{k: z[k] for k in ("vel", "rho", "trac", "p")})
    jold, _ = jchk.load_checkpoint(str(tmp_path / "j"), jcfg)
    told, _ = tchk.load_checkpoint(str(tmp_path / "j"), tcfg, CPU)
    for k in ("gradp", "temp", "p"):
        close(getattr(jold, k), getattr(told, k), 1e-14)


@pytest.mark.parametrize("case", sorted(CASES))
def test_derives_match(case):
    jcfg, jst, tcfg, tst = both_states(case, seed=2)
    for name in ("mag_vort", "energy", "avg_pressure", "diveru"):
        close(jderive.derive(jcfg, jst, name), tderive.derive(tcfg, tst, name), 1e-12)
    jq = jderive.sum_integrated_quantities(jcfg, jst)
    tq = tderive.sum_integrated_quantities(tcfg, tst)
    assert sorted(jq) == sorted(tq)
    for k in jq:
        assert abs(jq[k] - tq[k]) <= 1e-12 * abs(jq[k]), k
    jm, tm = jderive.max_values(jst), tderive.max_values(tst)
    assert jm == tm
    with pytest.raises(KeyError):
        tderive.derive(tcfg, tst, "no_such_field")


def test_particle_files_are_the_same_bytes(tmp_path):
    _, tcfg = configs(CASES["3d"])
    rng = np.random.RandomState(3)
    lo, hi = np.asarray(tcfg.geom.prob_lo), np.asarray(tcfg.geom.prob_hi)
    pos = lo + (hi - lo) * rng.rand(50, 3)
    init = tmp_path / "init.txt"
    with open(init, "w") as f:
        f.write("50\n" + "".join(" ".join(repr(float(x)) for x in p) + "\n" for p in pos))
    jpos = jpart.read_ascii_init_file(str(init), 3)
    tpos = tpart.read_ascii_init_file(str(init), 3)
    assert np.array_equal(jpos, tpos)
    alive = rng.rand(50) > 0.2
    jp = jpart.Particles(pos=jnp.asarray(tpos), alive=jnp.asarray(alive))
    tp = convert.particles_from_numpy(tpos, CPU, alive=alive)
    for pkg, mod, parts in (("j", jpart, jp), ("t", tpart, tp)):
        for time in (0.0, 0.03125):
            mod.timestamp(parts, str(tmp_path / f"{pkg}-Timestamp"), time)
        mod.write_ascii_particles(str(tmp_path / f"{pkg}-out"), parts)
    for name in ("Timestamp", "out"):
        assert filecmp.cmp(tmp_path / f"j-{name}", tmp_path / f"t-{name}", shallow=False)
    counts = tpart.particle_count(tp, tcfg.geom)
    assert np.array_equal(np.asarray(jpart.particle_count(jp, tcfg.geom)), counts.numpy())
    assert int(counts.sum()) == int(alive.sum())


HIT8 = """
amr.n_cell = 8 8 8
geometry.is_periodic = 1 1 1
prob.probtype = 100
"""
CAVITY = """
amr.n_cell = 8 12
geometry.is_periodic = 0 0
ns.lo_bc = 5 5
ns.hi_bc = 5 5
prob.probtype = 5
"""


@pytest.mark.parametrize("source", ["ic_file", "velocity_plotfile"])
def test_initial_data_from_files(source, tmp_path):
    """prob.ic_file (a gen_hit_ic.py csv on a 4^3 grid, sampled onto 8^3 and
    scaled to prob.urms) and ns.velocity_plotfile (a plotfile's u_vel and
    v_vel added, scaled, to a shear layer): the same initial state in both
    packages."""
    rng = np.random.RandomState(8)
    if source == "ic_file":
        n = 4
        X = np.stack(np.meshgrid(*[np.arange(n) / n] * 3, indexing="ij"), -1).reshape(-1, 3)
        np.savetxt(tmp_path / "ic.csv", np.hstack([X, rng.randn(n**3, 3)]), delimiter=",",
                   header="x,y,z,u,v,w", comments="")
        text = HIT8 + f"prob.ic_file = {tmp_path / 'ic.csv'}\nprob.ic_n = 4\nprob.urms = 0.5\n"
    else:
        _, tcfg = configs(CAVITY)
        fields = {"u_vel": rng.randn(8, 12), "v_vel": rng.randn(8, 12),
                  "density": np.ones((8, 12))}
        tplot.write_plotfile(str(tmp_path / "plt00000"), tcfg.geom, fields)
        text = CAVITY + (f"ns.velocity_plotfile = {tmp_path / 'plt00000'}\n"
                         "ns.velocity_plotfile_xvel_name = u_vel\n"
                         "ns.velocity_plotfile_scale = 0.25\n")
    jcfg, tcfg = configs(text)
    jst, tst = jprobs.init_state(jcfg), tprobs.init_state(tcfg, CPU)
    close(jst.vel, tst.vel, 1e-15)
    assert float(tst.vel.abs().max()) > 0.1


def test_spectral_path_survives_a_restart():
    """A uniform density advected through a step comes back uniform only to
    a few ulps; the auto FFT path (ns.fft_solve = -1) takes it, so that a
    restart stays on the path its run started on. A varying one is not."""
    with open(HIT) as f:
        cfg = tstate.config_from_inputs(TParmParse.from_string(f.read()), device="cpu")
    rho = torch.ones(8, 8, 8, dtype=torch.float64)
    rho[1, 2, 3] += 4 * torch.finfo(torch.float64).eps
    assert cfg.fft_solve == -1 and spectral_eligible(cfg, rho)
    rho[1, 2, 3] = 1.001
    assert not spectral_eligible(cfg, rho)


def test_port_restart_is_bit_for_bit(tmp_path):
    """A port restart from its own step-2 checkpoint writes the straight
    run's step-4 checkpoint, particle file and run-log lines bit for bit
    (HIT 16^3 with 64 particles through run_from_inputs)."""
    write_particle_file(str(tmp_path / "particles.txt"), 64, seed=5)
    straight, restart = str(tmp_path / "straight"), str(tmp_path / "restart")
    for out, chk in ((straight, None), (restart, os.path.join(straight, "chk00002"))):
        os.makedirs(out)
        tdriver.run_from_inputs(HIT, hit_overrides(out, chk), device="cpu")
    for name in ("state.npz", "particles.npz"):
        with np.load(os.path.join(straight, "chk00004", name)) as a, \
                np.load(os.path.join(restart, "chk00004", name)) as b:
            for k in a.files:
                assert np.array_equal(a[k], b[k]), (name, k)
    for rel in ("chk00004/meta.json", "particles.out", "runlog"):
        with open(os.path.join(straight, rel)) as a, open(os.path.join(restart, rel)) as b:
            want = a.read()
            got = b.read()
        if rel == "runlog":
            # the restart logs steps 3 and 4 only
            want = "".join(want.splitlines(True)[2:])
        assert got == want, rel


@pytest.mark.parametrize("override,key", [
    ("amr.max_level=1", "amr.max_level"), ("amr.regrid_file=grids.txt", "amr.regrid_file"),
    ("eb2.geom_type=sphere", "eb2.geom_type")])
def test_cli_refuses_unported_inputs(override, key, tmp_path):
    """What makes a level of more than one box is refused before any work,
    naming the key: an amr.regrid_file level of two boxes, and the dynamic
    regrid of amr.max_level = 2. AMR on single-box levels is ported: the
    CLI runs amr.max_level = 1. EB is ported: the CLI runs eb2.geom_type =
    sphere, and refuses, naming the key, only a geometry name it does not
    know."""
    extra = []
    if key == "eb2.geom_type":
        assert tmain.main([HIT, "amr.n_cell=8 8 8", override, "max_step=1",
                           "--device=cpu"]) == 0
        override = "eb2.geom_type=teapot"
    elif key == "amr.max_level":
        assert tmain.main([HIT, "amr.n_cell=8 8 8", override, "max_step=1",
                           "--device=cpu"]) == 0
        override = "amr.max_level=2"
        extra = ["amr.regrid_int=2", "amr.refinement_indicators=vort",
                 "amr.vort.vorticity_greater=1.0"]
    else:
        grids = tmp_path / "grids.txt"
        grids.write_text("1\n2\n((0,0,0) (1,1,1) (0,0,0))\n((4,4,4) (5,5,5) (0,0,0))\n")
        override = f"amr.regrid_file={grids}"
        extra = ["amr.max_level=1"]
    with pytest.raises(NotImplementedError, match=key):
        tmain.main([HIT, "amr.n_cell=8 8 8", override, *extra, "--device=cpu"])


def test_run_refuses_levels():
    """A level of more than one box (multi-box, union, levels are not
    ported) is refused before any work."""
    text = "amr.n_cell = 8 8 8\namr.max_level = 1\ngeometry.is_periodic = 1 1 1\n"
    cfg = tstate.config_from_inputs(TParmParse.from_string(text), device="cpu")
    from iamr_tpu_torch.amr.hierarchy import LevelSpec

    boxes = (LevelSpec(lo=(0, 0, 0), ncell=(4, 4, 4)), LevelSpec(lo=(8, 8, 8), ncell=(4, 4, 4)))
    with pytest.raises(NotImplementedError, match="multi-box"):
        tdriver.run_hierarchy(cfg, max_steps=1, specs=[LevelSpec(lo=(0, 0, 0), ncell=(12, 12, 12))],
                              boxlists=[boxes], device="cpu")


def test_debug_nans_names_the_field(tmp_path):
    """ns.debug_nans: the hooks scan each step's state and raise with the
    field and the step."""
    text = "amr.n_cell = 8 8 8\ngeometry.is_periodic = 1 1 1\nns.debug_nans = 1\n"
    cfg = tstate.config_from_inputs(TParmParse.from_string(text), device="cpu")
    hooks = tdriver.IOHooks(cfg, TParmParse.from_string(text))
    assert hooks.active and hooks.debug_nans
    state = tdriver.initialize(cfg, device="cpu", init_iters=0)
    hooks(1, state)
    trac = state.trac.clone()
    trac[0, 1, 2, 3] = float("nan")
    with pytest.raises(FloatingPointError, match="trac after step 7"):
        hooks(7, state._replace(trac=trac))


def test_cli_needs_a_card_or_device_cpu(monkeypatch, capsys):
    root = os.path.dirname(EXAMPLES)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tmain.main([HIT, "max_step=1"]) != 0
    assert "--device=cpu" in capsys.readouterr().err
    assert tmain.main([]) != 0
    env = dict(os.environ, PYTHONPATH=root, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "iamr_tpu_torch", HIT, "max_step=1"],
                          cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "STEP" not in proc.stdout, proc.stdout
