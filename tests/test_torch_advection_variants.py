"""The advection variants in the port against the JAX package, f64 on the
CPU: ppm_lr; the MAC predictor (extrap_vel_to_faces) with PPM and with
godunov.use_forces_in_trans; the scalar edge states with PPM, BDS
(ops/bds.py) and use_forces_in_trans, conservative and convective, in 2D
and 3D, periodic and walled; compute_fluxes_and_aofs with the RZ radius
weights; each to 1e-12 of max|ref| on seeded fields. Then the gates (which
kernel wrappers a step calls under each scheme). The step pairs of these
schemes are in tests/test_torch_scheme_steps.py.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from iamr_tpu.core.bc import BCRec as JBCRec, MathBC as JMathBC
from iamr_tpu.ops import godunov as jg
from iamr_tpu_torch.core.bc import BCRec as TBCRec, MathBC as TMathBC
from iamr_tpu_torch.ns import advance as tadvance
from iamr_tpu_torch.ns import driver as tdriver
from iamr_tpu_torch.ops import godunov as tg
from iamr_tpu_torch.ops import godunov_kernels as gk
from torch_parity import close, configs, example_text

torch.set_num_threads(2)

RT3D = "inputs.3d.rayleigh_taylor"
SIZES = {2: (8, 6), 3: (8, 6, 5)}
DX = {2: (1 / 8, 1 / 6), 3: (1 / 8, 1 / 6, 1 / 5)}
T = torch.as_tensor


def _dt(x):
    return torch.tensor(x, dtype=torch.float64)


@pytest.mark.parametrize("dim,d", [(2, 0), (2, 1), (3, 0), (3, 2)])
def test_ppm_lr_matches(dim, d):
    rng = np.random.RandomState(d)
    n = SIZES[dim]
    shape = [x + 6 if e == d else x + 2 for e, x in enumerate(n)]
    fshape = [x + 1 if e == d else x + 2 for e, x in enumerate(n)]
    q3 = rng.randn(*shape)
    cl, cr = 0.5 * rng.rand(*fshape), 0.5 * rng.rand(*fshape)
    for a, b in zip(jg.ppm_lr(jnp.asarray(q3), d, jnp.asarray(cl), jnp.asarray(cr)),
                    tg.ppm_lr(T(q3), d, T(cl), T(cr))):
        close(a, b, 1e-12)


def _recs(dim, walled):
    """Per-component velocity BCRecs: periodic, or an inflow (ext_dir) low
    side and a slip (reflect_odd normal) high side in dim 0."""
    out = []
    for pkg in ((JBCRec, JMathBC), (TBCRec, TMathBC)):
        rec, m = pkg
        recs = []
        for c in range(dim):
            lo, hi = [m.int_dir] * dim, [m.int_dir] * dim
            if walled:
                lo[0] = m.ext_dir
                hi[0] = m.reflect_odd if c == 0 else m.reflect_even
            recs.append(rec(tuple(lo), tuple(hi)))
        out.append(recs)
    return out


VARIANTS = [("ppm", False), ("plm", True), ("ppm", True)]


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("walled", [False, True], ids=["periodic", "walled"])
@pytest.mark.parametrize("scheme,uft", VARIANTS, ids=["ppm", "plm-uft", "ppm-uft"])
def test_extrap_vel_to_faces_matches(scheme, uft, walled, dim):
    rng = np.random.RandomState(dim)
    n = SIZES[dim]
    vel_g = rng.randn(dim, *[x + 6 for x in n])
    force_g = rng.randn(dim, *[x + 2 for x in n])
    bl = tuple(tuple(0.3 * (c + 1) for c in range(dim)) for _ in range(dim))
    jrecs, trecs = _recs(dim, walled)

    def jextrap(v, f):
        return jg.extrap_vel_to_faces(v, f, 0.02, DX[dim], n, jrecs, bl, bl,
                                      use_forces_in_trans=uft, scheme=scheme, fused=False)

    ref = jax.jit(jextrap)(jnp.asarray(vel_g), jnp.asarray(force_g))
    got = tg.extrap_vel_to_faces(T(vel_g), T(force_g), _dt(0.02), DX[dim], n, trecs, bl, bl,
                                 use_forces_in_trans=uft, scheme=scheme)
    for a, b in zip(ref, got):
        close(a, b, 1e-12)


EDGE_VARIANTS = [("ppm", False), ("bds", False), ("plm", True), ("ppm", True)]


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "walled"])
@pytest.mark.parametrize("scheme,uft", EDGE_VARIANTS, ids=["ppm", "bds", "plm-uft", "ppm-uft"])
def test_edge_states_and_fluxes_match(scheme, uft, periodic, dim):
    """compute_edge_states (both forms) and compute_fluxes_and_aofs on
    them; in 2D also with the RZ radius weights."""
    rng = np.random.RandomState(10 + dim)
    n, dx = SIZES[dim], DX[dim]
    per = (periodic,) * dim
    s_g = rng.randn(*[x + 6 for x in n])
    f_g = rng.randn(*[x + 2 for x in n])
    umac = [0.5 * rng.randn(*[x + (e == d) for e, x in enumerate(n)]) for d in range(dim)]
    rz = None
    if dim == 2:
        r_face = (np.arange(n[0] + 1) * dx[0])[:, None]
        rz = (r_face[:-1] + 0.5 * dx[0], r_face)

    def jedges(s, f, *u):
        ug = jg.grow_umac_transverse(u, per)
        out = []
        for icons in (True, False):
            e = jg.compute_edge_states(s, ug, 0.03, dx, n, icons, force_g=f, periodic=per,
                                       scheme=scheme, use_forces_in_trans=uft)
            fl = [jg.compute_fluxes_and_aofs(e, u, dx, icons, s_cc=s[(slice(3, -3),) * dim],
                                             rz=r)
                  for r in ((None,) if rz is None else (None, tuple(map(jnp.asarray, rz))))]
            out.append((e, fl))
        return out

    ref = jax.jit(jedges)(jnp.asarray(s_g), jnp.asarray(f_g), *map(jnp.asarray, umac))
    tu = tuple(T(u) for u in umac)
    ug = tg.grow_umac_transverse(tu, per)
    for icons, (jedge, jfl) in zip((True, False), ref):
        edges = tg.compute_edge_states(T(s_g), ug, _dt(0.03), dx, n, icons, force_g=T(f_g),
                                       periodic=per, scheme=scheme, use_forces_in_trans=uft)
        for a, b in zip(jedge, edges):
            close(a, b, 1e-12)
        for r, (jf, ja) in zip((None,) if rz is None else (None, rz), jfl):
            tf, ta = tg.compute_fluxes_and_aofs(
                edges, tu, dx, icons, s_cc=T(s_g)[(slice(3, -3),) * dim],
                rz=None if r is None else tuple(map(T, r)))
            close(ja, ta, 1e-12)
            for a, b in zip(jf, tf):
                close(a, b, 1e-12)


GATES = {  # scheme line -> (K1, K2, K3) wrapper calls of a 3D step
    "ns.advection_scheme = Godunov_PLM": (1, 1, 0),
    "ns.advection_scheme = Godunov_PPM": (0, 0, 0),
    "ns.advection_scheme = BDS": (1, 0, 0),
    "godunov.use_forces_in_trans = 1": (0, 0, 0),
}
NONE = {"extrap_plm": 0, "godunov_plm_multi": 0, "godunov_plm": 0}


@pytest.mark.parametrize("line", list(GATES), ids=["plm", "ppm", "bds", "uft"])
def test_scheme_gates(line, monkeypatch):
    """Which kernel wrappers a 3D step calls: K1 (extrap_plm) and K2
    (godunov_plm_multi) under PLM, K1 alone under BDS (its MAC predictor
    stays PLM), neither under PPM or use_forces_in_trans, as the JAX
    package's godunov_fused_ok / godunov_multi_ok gate its kernels (the
    one-field K3 in none); in 2D and in RZ (2D) none of them."""
    calls = dict(NONE)

    def counted(name, fn):
        def wrap(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrap

    monkeypatch.setattr(gk, "extrap_plm", counted("extrap_plm", gk.extrap_plm))
    monkeypatch.setattr(gk, "godunov_plm", counted("godunov_plm", gk.godunov_plm))
    monkeypatch.setattr(tadvance, "godunov_plm_multi",
                        counted("godunov_plm_multi", tadvance.godunov_plm_multi))
    _, tcfg = configs(example_text(RT3D, "amr.n_cell = 8 8 16", line))
    st = tdriver.initialize(tcfg, fixed_mg_cycles=2, device="cpu", init_iters=0)
    tadvance.make_step(tcfg, 2)(st)
    assert tuple(calls.values()) == GATES[line]
    for text in (example_text("inputs.2d.rayleigh_taylor", "amr.n_cell = 8 16", line),
                 example_text("inputs.2d.hotspot_rz", "amr.n_cell = 8 16", line)):
        calls.update(NONE)
        _, tcfg = configs(text)
        st = tdriver.initialize(tcfg, fixed_mg_cycles=2, device="cpu", init_iters=0)
        tadvance.make_step(tcfg, 2)(st)
        assert calls == NONE
