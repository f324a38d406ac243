"""Shared steps of the walled-run parity tests (tests/test_torch_walls.py,
test_torch_temp.py, test_torch_switches.py, test_torch_bc_ops.py): the JAX
package on the CPU in x64 against the port with device="cpu", f64, from the
same inputs.

A fluid at rest puts every face on a Riemann tie, where roundoff picks
differently in the two packages (tests/test_torch_advance.py). run_both
therefore compares driver.initialize without pressure iterations, feeds
both packages the same seeded 1e-3 velocity perturbation, and compares
driver.run's steps from there. close_files compares the outputs of two
runs from an inputs file (plotfiles, checkpoints, logs, particle files).
"""

import os
import re

import numpy as np
import torch
import jax.numpy as jnp

from iamr_tpu.config.parmparse import ParmParse as JParmParse
from iamr_tpu.eb import geom as jgeom
from iamr_tpu.ns import driver as jdriver
from iamr_tpu.ns import state as jstate
from iamr_tpu_torch import convert
from iamr_tpu_torch.config.parmparse import ParmParse as TParmParse
from iamr_tpu_torch.eb import geom as tgeom
from iamr_tpu_torch.ns import driver as tdriver
from iamr_tpu_torch.ns import state as tstate

CPU = torch.device("cpu")
FIELDS = ("vel", "rho", "trac", "temp", "p", "gradp", "dt", "time", "dsdt")
EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "examples")


def example_text(name, *overrides):
    """The inputs text of examples/<name>, then the `key = value` lines
    given (a later line wins)."""
    with open(os.path.join(EXAMPLES, name)) as f:
        return f.read() + "".join(f"\n{line}" for line in overrides) + "\n"


HIT = os.path.join(EXAMPLES, "inputs.3d.hit_forced")


def write_particle_file(path, n, seed):
    """A particles.particle_init_file of n seeded positions in HIT's box."""
    pos = np.random.RandomState(seed).uniform(-0.5, 0.5, (n, 3))
    with open(path, "w") as f:
        f.write(f"{n}\n" + "".join(" ".join(repr(float(x)) for x in p) + "\n" for p in pos))


def hit_overrides(out, restart=None):
    """run_from_inputs overrides of HIT at 16^3 for 4 steps (a plotfile at
    step 4, checkpoints at 2 and 4, the monitors, the velocity average, a
    run log, the particles of out/../particles.txt with their Timestamp and
    output files, a dumped plane), every output under `out`."""
    o = ["amr.n_cell=16 16 16", "max_step=4", "amr.plot_int=4", "amr.check_int=2",
         "ns.sum_interval=1", "ns.avg_interval=1", f"amr.plot_file={out}/plt",
         f"amr.check_file={out}/chk", f"amr.run_log={out}/runlog",
         f"particles.particle_init_file={out}/../particles.txt",
         f"particles.particle_output_file={out}/particles.out",
         f"particles.timestamp_dir={out}/ts", "ns.dump_plane=3",
         f"ns.dump_plane_name={out}/slabs/vel-"]
    return o + ([f"amr.restart={restart}"] if restart else [])


def close(ref, got, tol=1e-10):
    """max|ref - got| <= tol max|ref|; both None passes."""
    assert (ref is None) == (got is None)
    if ref is None:
        return
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(ref - got).max())
    assert err <= tol * scale, (err, scale)


def configs(text, dim=None):
    """The JAX package's and the port's (CPU, f64) configs of one inputs text."""
    return (jstate.config_from_inputs(JParmParse.from_string(text), dim_hint=dim),
            tstate.config_from_inputs(TParmParse.from_string(text), dim_hint=dim,
                                      device="cpu"))


def ebs(text, jcfg, tcfg):
    """The EB geometries of an inputs text's eb2.* (None without EB) in the
    JAX package and in the port (CPU, the config's dtype)."""
    return (jgeom.eb_from_inputs(JParmParse.from_string(text), jcfg.geom, dtype=jcfg.dtype),
            tgeom.eb_from_inputs(TParmParse.from_string(text), tcfg.geom, dtype=tcfg.dtype,
                                 device="cpu"))


def run_both(text, fixed, steps=2, perturb=1e-3, jinit=None):
    """initialize (no pressure iterations), compared; the perturbation;
    driver.run for `steps` steps, compared to 1e-10 of max|ref| on every
    state field; both packages build the EB geometry of eb2.* where the
    text has one. Returns the port's config and final state.

    jinit: the JAX package's initialize of this config where the caller
    has it already (the step's switches do_mom_diff, do_denminmax,
    do_mac_proj and ns.redistribution_type do not enter initialize: cases
    that differ by them share it)."""
    jcfg, tcfg = configs(text)
    jeb, teb = ebs(text, jcfg, tcfg)
    jst = jinit if jinit is not None else jdriver.initialize(jcfg, fixed_mg_cycles=fixed,
                                                              init_iters=0, eb=jeb)
    tst = tdriver.initialize(tcfg, fixed_mg_cycles=fixed, device="cpu", init_iters=0, eb=teb)
    for k in FIELDS:
        close(getattr(jst, k), getattr(tst, k))
    noise = perturb * np.random.RandomState(3).randn(*jst.vel.shape)
    jst = jst._replace(vel=jst.vel + jnp.asarray(noise))
    tst = convert.state_from_numpy(
        {k: None if v is None else np.asarray(v) for k, v in jst._asdict().items()}, CPU)
    jst = jdriver.run(jcfg, jst, max_steps=steps, fixed_mg_cycles=fixed, eb=jeb)
    tst = tdriver.run(tcfg, tst, max_steps=steps, fixed_mg_cycles=fixed, eb=teb)
    for k in FIELDS:
        close(getattr(jst, k), getattr(tst, k))
    return tcfg, tst


def _numbers(tokens):
    out = []
    for tok in tokens:
        try:
            out.append(float(tok))
        except ValueError:
            out.append(tok)
    return out


def close_files(ref_dir, got_dir, tol=1e-10, skip=("job_info",)):
    """The same files under both directories, and each agrees with its
    reference: npz float arrays and raw float64 .bin files to tol of their
    max|ref|, other npz arrays equal; FAB data files with the
    same header line and each component's payload to tol of its max|ref|;
    text files token by token, numbers to tol of the file's largest
    number, other tokens equal. Files named in `skip` are not compared."""
    def tree(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    files = tree(ref_dir)
    assert files == tree(got_dir)
    for rel in files:
        if os.path.basename(rel) in skip:
            continue
        ref_path, got_path = os.path.join(ref_dir, rel), os.path.join(got_dir, rel)
        if rel.endswith(".npz"):
            with np.load(ref_path) as zr, np.load(got_path) as zg:
                assert sorted(zr.files) == sorted(zg.files), rel
                for k in zr.files:
                    if zr[k].dtype.kind == "f":
                        close(zr[k], zg[k], tol)
                    else:
                        assert np.array_equal(zr[k], zg[k]), (rel, k)
            continue
        if rel.endswith(".bin"):
            # raw float64 (ns.dump_plane slices)
            close(np.fromfile(ref_path), np.fromfile(got_path), tol)
            continue
        with open(ref_path, "rb") as f:
            ref = f.read()
        with open(got_path, "rb") as f:
            got = f.read()
        if ref.startswith(b"FAB "):
            head_r, head_g = ref.split(b"\n", 1)[0], got.split(b"\n", 1)[0]
            assert head_r == head_g, rel
            ncomp = int(head_r.split()[-1])
            pr = np.frombuffer(ref[len(head_r) + 1:], np.float64).reshape(ncomp, -1)
            pg = np.frombuffer(got[len(head_g) + 1:], np.float64).reshape(ncomp, -1)
            for c in range(ncomp):
                close(pr[c], pg[c], tol)
            continue
        tr = _numbers(re.split(r"[\s,()]+", ref.decode()))
        tg = _numbers(re.split(r"[\s,()]+", got.decode()))
        assert len(tr) == len(tg), rel
        scale = max([abs(x) for x in tr if isinstance(x, float)] + [1e-300])
        for a, b in zip(tr, tg):
            if isinstance(a, float) and isinstance(b, float):
                assert abs(a - b) <= tol * scale, (rel, a, b)
            else:
                assert a == b, (rel, a, b)
