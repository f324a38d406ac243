"""Runs from an inputs file, the port's driver.run_from_inputs against the
JAX package's, f64 on the CPU; every written file (plotfiles, checkpoints,
run logs, particle Timestamp and output files, dumped planes; job_info
aside) agrees to 1e-10 of max|ref|:

  * forced HIT (examples/inputs.3d.hit_forced) at 16^3 with 64 tracer
    particles on the spectral path, 4 steps (tests/torch_parity.py::
    hit_overrides);
  * restarts: a step-2 checkpoint of either package, npz or AMReX format,
    restarts in the other and reaches the same step-4 checkpoint;
  * Rayleigh-Taylor (examples/inputs.2d.rayleigh_taylor) at 16x32 in
    fixed-cycle mode with a seeded random velocity, a forcing and a derive
    registered in both packages' plugin registries.

The JAX package's HIT runs are made once per module. The port's own
restart, the refusals and the CLI are in tests/test_torch_io.py.
"""

import os
import shutil

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import iamr_tpu.plugins as jplug
import iamr_tpu_torch.plugins as tplug
from iamr_tpu.config.parmparse import ParmParse as JParmParse
from iamr_tpu.io import amrex_chk as jamrex
from iamr_tpu.io import checkpoint as jchk
from iamr_tpu.ns import driver as jdriver
from iamr_tpu.ns import state as jstate
from iamr_tpu_torch.config.parmparse import ParmParse as TParmParse
from iamr_tpu_torch.io import amrex_chk as tamrex
from iamr_tpu_torch.io import checkpoint as tchk
from iamr_tpu_torch.ns import advance as tadvance
from iamr_tpu_torch.ns import driver as tdriver
from iamr_tpu_torch.ns import state as tstate
from torch_parity import (
    CPU, HIT, close_files, configs, example_text, hit_overrides, write_particle_file,
)

torch.set_num_threads(2)


class Runs:
    """The module's runs, each made once: run(pkg, name, restart) runs
    the JAX package ("jax") or the port ("torch") from HIT into
    root/<pkg>-<name>."""

    def __init__(self, root):
        self.root = root
        write_particle_file(os.path.join(root, "particles.txt"), 64, seed=5)

    def run(self, pkg, name, restart=None):
        out = os.path.join(self.root, f"{pkg}-{name}")
        if not os.path.exists(out):
            os.makedirs(out)
            if pkg == "jax":
                # the JAX package's restarts leave the FFT path in auto mode
                # (its spectral_eligible wants every density value equal):
                # hold them to the path of its straight run
                fft = ["ns.fft_solve=1"] if restart else []
                jdriver.run_from_inputs(HIT, hit_overrides(out, restart) + fft)
            else:
                tdriver.run_from_inputs(HIT, hit_overrides(out, restart), device="cpu")
        return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return Runs(str(tmp_path_factory.mktemp("cli")))


def test_run_from_inputs_matches_jax(runs):
    ref, got = runs.run("jax", "straight"), runs.run("torch", "straight")
    assert sorted(os.listdir(got)) == ["chk00002", "chk00004", "particles.out", "plt00004",
                                       "runlog", "slabs", "ts"]
    close_files(ref, got)
    with open(os.path.join(got, "plt00004", "job_info")) as f:
        assert "torch version" in f.read()


def _amrex_copy(pkg, src, dst, text):
    """Checkpoint src (npz) written again in the AMReX format by `pkg`."""
    if pkg == "jax":
        cfg = jstate.config_from_inputs(JParmParse.from_string(text))
        state, step = jchk.load_checkpoint(src, cfg)
        jamrex.write_checkpoint_amrex(dst, [state], [], cfg, step)
    else:
        cfg = tstate.config_from_inputs(TParmParse.from_string(text), device="cpu")
        state, step = tchk.load_checkpoint(src, cfg, CPU)
        tamrex.write_checkpoint_amrex(dst, state, cfg, step)
    shutil.copy(os.path.join(src, "particles.npz"), dst)


@pytest.mark.parametrize("fmt", ["npz", "amrex"])
@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_checkpoints_restart_in_the_other_package(runs, fmt, writer, reader):
    chk = os.path.join(runs.run(writer, "straight"), "chk00002")
    if fmt == "amrex":
        with open(HIT) as f:
            text = f.read() + "\namr.n_cell = 16 16 16\n"
        dst = os.path.join(runs.root, f"{writer}-amrex-chk00002")
        if not os.path.exists(dst):
            _amrex_copy(writer, chk, dst, text)
        chk = dst
    out = runs.run(reader, f"from-{writer}-{fmt}", restart=chk)
    ref = os.path.join(runs.run("jax", "straight"), "chk00004")
    close_files(ref, os.path.join(out, "chk00004"), skip=("TimeAverage.npz",))


USER_PROBTYPE = 917


def seeded_rt(cfg, X, fields):
    """Rayleigh-Taylor's heavy-over-light density and tracer with a smooth
    seeded random velocity (a few Fourier modes of random amplitude and
    phase): no face of the first steps sits on a Riemann tie, and no
    limiter on a roundoff-close choice."""
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


def hit_like_forcing(cfg):
    """A user forcing: a fixed sinusoidal body force, scaled by 1 + time."""
    X = cfg.geom.cell_centers()
    f = np.stack([0.5 * np.sin(2 * np.pi * X[1]), np.zeros_like(X[0])])

    class Forcing:
        def eval(self, geom, time, dtype):
            if isinstance(time, torch.Tensor):
                return torch.as_tensor(f, dtype=dtype, device=time.device) * (1.0 + time)
            return jnp.asarray(f, dtype=dtype) * (1.0 + time)

    return Forcing()


@pytest.fixture
def user_plugins():
    """The same user problem, forcing and derive in both registries."""
    for plug in (jplug, tplug):
        plug.problem_ic(USER_PROBTYPE)(seeded_rt)
        plug.forcing("user_sine")(hit_like_forcing)
        plug.derive_field("rho_trac")(lambda cfg, s: s.rho * s.trac[0])
    yield
    for plug in (jplug, tplug):
        plug.PROBLEM_ICS.pop(USER_PROBTYPE)
        plug.FORCINGS.pop("user_sine")
        plug.DERIVES.pop("rho_trac")


def test_walled_run_from_inputs_matches_jax(user_plugins, tmp_path):
    path = tmp_path / "inputs.2d.rt_user"
    with open(path, "w") as f:
        f.write(example_text("inputs.2d.rayleigh_taylor", "amr.n_cell = 16 32",
                             f"prob.probtype = {USER_PROBTYPE}", "prob.forcing = user_sine",
                             "ns.init_iter = 0"))
    outs = {}
    for pkg, driver, kw in (("jax", jdriver, {}), ("torch", tdriver, {"device": "cpu"})):
        out = tmp_path / pkg
        out.mkdir()
        outs[pkg] = out
        driver.run_from_inputs(str(path), [
            "max_step=2", "amr.plot_int=2", "amr.check_int=1", "amr.checkpoint_format=amrex",
            "ns.sum_interval=1", "amr.derive_plot_vars=diveru rho_trac",
            f"amr.plot_file={out}/plt", f"amr.check_file={out}/chk",
            f"amr.run_log={out}/runlog", f"amr.run_log_terse={out}/terse"],
            fixed_mg_cycles=4, **kw)
    assert sorted(os.listdir(outs["torch"])) == ["chk00001", "chk00002", "plt00002", "runlog",
                                                 "terse"]
    close_files(outs["jax"], outs["torch"])
    # the plugins took effect: a nonzero velocity from the user problem and
    # the forcing's field in the step
    _, tcfg = configs(open(path).read())
    assert tcfg.forcing == "user_sine"
    assert tadvance.make_hit_forcing(tcfg).eval(tcfg.geom, torch.zeros((), dtype=torch.float64),
                                                torch.float64).abs().max() > 0.45
