"""User-problem plug-in seam (counterpart of iamr_tpu/plugins.py).

The reference extends problems by overriding source files in a problem
directory (prob_init.cpp, NS_getForce.cpp, NS_derive.cpp). Here a problem
registers plain functions before it builds its config and state; the
driver, the step and the plotfile writer pick them up by probtype or name.

    import iamr_tpu_torch.plugins as plug

    @plug.problem_ic(200)
    def my_ic(cfg, X, fields):
        fields["vel"][0] = np.sin(2 * np.pi * X[1])   # numpy, mutate in place

    @plug.forcing("my_jet")                 # prob.forcing = my_jet
    def make_jet(cfg):
        def eval(geom, time, dtype): ...    # -> (dim, *ncell) tensor on time's device
        return SimpleNamespace(eval=eval)

    @plug.derive_field("q_criterion")       # amr.derive_plot_vars
    def qcrit(cfg, state): ...              # -> cell tensor

    @plug.eb_geometry("my_nozzle")          # eb2.geom_type = my_nozzle
    def nozzle(pp, dim): ...                # -> implicit function psi(*x)
"""

from __future__ import annotations

from typing import Callable, Dict

PROBLEM_ICS: Dict[int, Callable] = {}
FORCINGS: Dict[str, Callable] = {}
DERIVES: Dict[str, Callable] = {}
EB_GEOMETRIES: Dict[str, Callable] = {}


def problem_ic(probtype: int):
    """Register fn(cfg, X, fields) for prob.probtype = `probtype`.

    X: the dim cell-centre coordinate arrays (numpy); fields: dict of
    mutable float64 numpy arrays (vel (dim, *n), rho, trac (ntrac, *n),
    temp) holding the quiescent defaults. Mutate them in place, or return
    a dict of replacements."""

    def deco(fn):
        PROBLEM_ICS[int(probtype)] = fn
        return fn

    return deco


def forcing(name: str):
    """Register factory(cfg) -> an object with .eval(geom, time, dtype)
    returning the (dim, *ncell) body force as a tensor on the device of
    `time` (a 0-d tensor), selected by prob.forcing = name."""

    def deco(fn):
        FORCINGS[str(name)] = fn
        return fn

    return deco


def derive_field(name: str):
    """Register fn(cfg, state) -> cell tensor under `name`, for
    amr.derive_plot_vars (ns/derive.py::derive falls through to it)."""

    def deco(fn):
        DERIVES[str(name)] = fn
        return fn

    return deco


def eb_geometry(name: str):
    """Register fn(pp, dim) -> a fluid-positive implicit function psi(*x)
    for eb2.geom_type = name (the reference's EB2 UserDefined seam). psi
    takes dim float64 torch tensors of sample coordinates that broadcast
    against each other (shapes (m, 1, 1), (1, n, 1), (1, 1, p) in 3D, on
    the geometry's device) and returns a tensor that broadcasts to their
    common shape, > 0 in the fluid and < 0 in the body
    (eb/geom.py::build_eb_geometry)."""

    def deco(fn):
        EB_GEOMETRIES[str(name)] = fn
        return fn

    return deco
