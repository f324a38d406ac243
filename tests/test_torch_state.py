"""Parity of the port's configuration, initial states and HIT forcing with
the JAX package (f64 on the CPU; tolerance 1e-12 of max|ref|). Each package
parses the inputs text with its own ParmParse; the port's configs are built
for the CPU (device="cpu"), since its default device is the card."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from iamr_tpu.config.parmparse import ParmParse as JParmParse
from iamr_tpu.ns import forcing_hit as j_hit
from iamr_tpu.ns import probs as j_probs
from iamr_tpu.ns import state as j_state
from iamr_tpu_torch import convert
from iamr_tpu_torch.config.parmparse import ParmParse as TParmParse
from iamr_tpu_torch.ns import forcing_hit as t_hit
from iamr_tpu_torch.ns import probs as t_probs
from iamr_tpu_torch.ns import state as t_state

torch.set_num_threads(2)
CPU = torch.device("cpu")
EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
INPUTS = ["inputs.3d.hit_forced", "inputs.3d.taylor_green"]


def _pp(name, ncell=None, extra="", pkg=TParmParse):
    with open(os.path.join(EXAMPLES, name)) as f:
        text = f.read()
    if ncell is not None:
        text += f"\namr.n_cell = {ncell}\n"
    return pkg.from_string(text + extra)


def _fields(cfg):
    """A config's fields, with the geometry and BC dataclasses as plain
    dicts (each package has its own classes)."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
    return out


def _close(ref, got, tol=1e-12):
    ref = np.asarray(ref)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape
    scale = max(float(np.abs(ref).max()), 1e-300)
    assert float(np.abs(ref - got).max()) <= tol * scale


@pytest.mark.parametrize("name", INPUTS)
def test_config_from_inputs_fields(name):
    jc = j_state.config_from_inputs(_pp(name, pkg=JParmParse))
    tc = t_state.config_from_inputs(_pp(name), device="cpu")
    jf, tf = _fields(jc), _fields(tc)
    assert jf.keys() == tf.keys()
    for k in jf:
        assert jf[k] == tf[k], k
    assert tc.tdtype == torch.float64


def test_config_dtype_follows_device():
    # no device means the card, as every entry point of the port
    assert t_state.config_from_inputs(_pp(INPUTS[0])).dtype == "float32"
    assert t_state.config_from_inputs(_pp(INPUTS[0]), device="cuda").dtype == "float32"
    assert t_state.config_from_inputs(_pp(INPUTS[0]), device="cpu").dtype == "float64"
    pp = _pp(INPUTS[0], extra="\nns.dtype = 64\n")
    assert t_state.config_from_inputs(pp, device="cuda").dtype == "float64"


@pytest.mark.parametrize("name", INPUTS)
def test_init_state(name):
    jst = j_probs.init_state(j_state.config_from_inputs(_pp(name, "16 12 20", pkg=JParmParse)))
    tst = t_probs.init_state(t_state.config_from_inputs(_pp(name, "16 12 20"), device="cpu"),
                             CPU)
    for k in ("vel", "rho", "trac", "temp", "p", "gradp", "time", "dt"):
        _close(getattr(jst, k), getattr(tst, k))
    assert tst.vel.dtype == torch.float64


@pytest.mark.parametrize("div_free", [True, False])
def test_hit_forcing(div_free):
    jgeom = j_state.config_from_inputs(_pp(INPUTS[0], "16 12 20", pkg=JParmParse)).geom
    cfg = t_state.config_from_inputs(_pp(INPUTS[0], ncell="16 12 20"), device="cpu")
    jf = j_hit.HITForcing.create(jgeom, nmodes=4, div_free=div_free)
    tf = t_hit.HITForcing.create(cfg.geom, nmodes=4, div_free=div_free)
    for k in ("k", "omega", "psi", "amp", "phases", "phases_simple"):
        np.testing.assert_array_equal(getattr(jf, k), getattr(tf, k))
    import jax.numpy as jnp

    t = 0.37
    ref = jf.eval(jgeom, jnp.asarray(t, jnp.float64), dtype=jnp.float64)
    got = convert.hit_from_numpy(jf).eval(
        cfg.geom, torch.tensor(t, dtype=torch.float64), dtype=torch.float64
    )
    _close(ref, got)
