"""Two f32 comparisons of the port with the JAX package on the same inputs,
on the CPU (slow tier; run with `-m slow -s` to see the numbers):

  * a fluid at rest under gravity with a lateral outflow face (chip_smoke's
    REST3D at 16^3), driver.run from initialize for 3 steps: max|u| of
    both;
  * the nodal solves of Rayleigh-Taylor 8x8x16 (examples/
    inputs.3d.rayleigh_taylor) in tolerance mode, initialize and 1 step:
    each solve's inputs, captured from the port, solved by both packages
    for 12 fixed V-cycles. The f32 tolerance is clamped to 3e-6 of
    max|rhs| (ns/state.py), at f32's floor: max|r| / tol after the cycles,
    side by side, says whether the port's floor is higher.

The port may not do worse than the JAX package by more than the spread of
f32 roundoff (a factor 1.5 on max|u|, 1.25 on the mean floor).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import chip_smoke as cs
from iamr_tpu.ns import driver as jdriver
from iamr_tpu.ops import mg_nodal as jn
from iamr_tpu_torch.ns import driver as tdriver
from iamr_tpu_torch.ops import mg_nodal as tn
from iamr_tpu_torch.solvers import nodal_proj as tproj
from torch_parity import configs, example_text

torch.set_num_threads(2)


@pytest.mark.slow
def test_rest_f32_not_worse():
    jcfg, tcfg = configs(cs.REST3D.format(n=16, dtype="float32"))
    assert jcfg.dtype == tcfg.dtype == "float32"
    ju = float(jnp.max(jnp.abs(jdriver.run(jcfg, max_steps=3).vel)))
    tu = float(tdriver.run(tcfg, max_steps=3, device="cpu").vel.abs().max())
    print(f"fluid at rest 16^3 f32, 3 steps: max|u| JAX {ju:.6e}, port {tu:.6e}")
    assert tu < 2e-3 and tu <= 1.5 * ju


@pytest.mark.slow
def test_f32_nodal_floor_not_worse(monkeypatch):
    _, tcfg = configs(example_text("inputs.3d.rayleigh_taylor", "amr.n_cell = 8 8 16",
                                   "ns.dtype = float32"))
    calls = []
    orig = tn.nodal_solve

    def record(rhs, sigma, dx, bc, **kw):
        out = orig(rhs, sigma, dx, bc, **kw)
        calls.append((rhs, sigma, dx, bc, kw, int(out[2])))
        return out

    monkeypatch.setattr(tproj, "nodal_solve", record)
    tdriver.run(tcfg, max_steps=1, device="cpu")
    ratios = []
    jitted = {}
    for rhs, sigma, dx, bc, kw, its in calls:
        if not bool(rhs.abs().max() > 0):
            continue
        kw = {k: v for k, v in kw.items() if k != "fixed_cycles"}
        tol = max(kw["rtol"] * float(rhs.abs().max()), kw.get("atol", 0.0))
        _, tres, _ = orig(rhs, sigma, dx, bc, fixed_cycles=12, **kw)
        # one compiled JAX solve per mode, shared by the solves of one shape
        key = (tuple(rhs.shape), dx, tuple(bc.lo), tuple(bc.hi), kw["rtol"], kw.get("atol"))
        if key not in jitted:
            jbc = jn.NodalBC(tuple(bc.lo), tuple(bc.hi))
            jitted[key] = [jax.jit(lambda r, s, phi_bc=None, fixed=fixed: jn.nodal_solve(
                r, s, dx, jbc, rtol=kw["rtol"], atol=kw.get("atol", 1e-16), phi_bc=phi_bc,
                fixed_cycles=fixed)) for fixed in (None, 12)]
        jargs = (jnp.asarray(rhs.numpy()), jnp.asarray(sigma.numpy()))
        jphi_bc = kw.get("phi_bc")
        jphi_bc = None if jphi_bc is None else jnp.asarray(jphi_bc.numpy())
        _, jres, jits = jitted[key][0](*jargs, phi_bc=jphi_bc)
        _, jres12, _ = jitted[key][1](*jargs, phi_bc=jphi_bc)
        ratios.append((float(tres) / tol, float(jres12) / tol))
        print(f"RT 8x8x16 f32 nodal solve: V-cycles to tolerance port {its}, JAX {int(jits)}; "
              f"max|r|/tol after 12 cycles port {ratios[-1][0]:.3f}, JAX {ratios[-1][1]:.3f}")
    port, ref = np.mean(ratios, axis=0)
    print(f"mean max|r|/tol after 12 cycles over {len(ratios)} solves: port {port:.3f}, "
          f"JAX {ref:.3f}")
    assert len(ratios) >= 3 and port <= 1.25 * ref
