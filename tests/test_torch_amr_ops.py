"""AMR's functions in the port against the JAX package, f64 on the CPU,
to 1e-12 of max|ref| (integers, masks, boxes and BC kinds equal), on
seeded data:

  * amr/hierarchy.py: LevelSpec's fine geometry and domain sides,
    prolong_cell (limited and not) and the windowed prolong_patch,
    restrict_cell/_node, avg_down(_node), fill_patch_from_coarse (1 to 3
    ghosts, patches in the interior and on the domain's sides),
    reflux_correct, read_fixed_grids; 2D and 3D;
  * ns/bcprovider.py::CoarseFineBCProvider: the fills, the solvers' BC
    kinds and coarse-fine Dirichlet values, the nodal phi_bc, grow_umac
    and _prolong_face_patch, on walled, periodic and lid-driven patches;
  * ns/advance.py::advance(return_aux=True) on the coarse level and on a
    fine patch under its CoarseFineBCProvider (the state and every aux
    entry; 3D PLM, and 2D with LES, whose viscous fluxes carry the cross
    fluxes);
  * amr/sync.py and solvers/tensor.py::diffuse_vsync/ssync: every
    function of the single-box sync, 2D and 3D (the solves with 1 or 2
    fixed V-cycles);
  * amr/tagging.py: the indicators, the clustering (the port's
    Berger-Rigoutsos against the JAX package's native library, built with
    g++ for the test), coalescing, the outflow tag policy, regrid_fine_state;
  * ns/particles.py's composite MAC velocity and level advection.

The JAX package runs eagerly here (function by function), so no jitted
fixed-cycle drift on small levels enters. Eager JAX compiles each
operation for each new shape, so the provider, aux, sync and 3D hierarchy
tests take 10-56 s each alone and 100 s or more beside the other workers
of a parallel run: they are `slow` (`-m slow`). In the fast tier the
two-level step of tests/test_torch_amr_steps.py holds their 2D
composition to the JAX package; here the 2D hierarchy operators, tagging
and Berger-Rigoutsos, and the particles stay.
"""

import dataclasses
import subprocess

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from iamr_tpu import native as jnative
from iamr_tpu.amr import hierarchy as jh
from iamr_tpu.amr import multilevel as jml
from iamr_tpu.amr import sync as jsync
from iamr_tpu.amr import tagging as jtag
from iamr_tpu.config.parmparse import ParmParse as JParmParse
from iamr_tpu.ns import advance as jadv
from iamr_tpu.ns import bcprovider as jbcp
from iamr_tpu.ns import particles as jpart
from iamr_tpu.solvers import tensor as jtensor
from iamr_tpu_torch import convert
from iamr_tpu_torch.amr import hierarchy as th
from iamr_tpu_torch.amr import multilevel as tml
from iamr_tpu_torch.amr import sync as tsync
from iamr_tpu_torch.amr import tagging as ttag
from iamr_tpu_torch.config.parmparse import ParmParse as TParmParse
from iamr_tpu_torch.ns import advance as tadv
from iamr_tpu_torch.ns import bcprovider as tbcp
from iamr_tpu_torch.ns import particles as tpart
from iamr_tpu_torch.solvers import tensor as ttensor
from torch_parity import CPU, FIELDS, close, configs, example_text

torch.set_num_threads(2)


def J(a):
    return jnp.asarray(np.asarray(a))


def T(a):
    return torch.as_tensor(np.asarray(a))


def specs(lo, n, r=2):
    return jh.LevelSpec(lo=lo, ncell=n, ratio=r), th.LevelSpec(lo=lo, ncell=n, ratio=r)


def same(ref, got, tol=1e-12):
    """Nested tuples/lists/dicts of arrays (None kept) agree to tol."""
    if isinstance(ref, dict):
        assert sorted(ref) == sorted(got)
        for k in ref:
            same(ref[k], got[k], tol)
    elif isinstance(ref, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(ref) == len(got)
        for a, b in zip(ref, got):
            same(a, b, tol)
    elif ref is None or isinstance(ref, (int, float)) and not isinstance(ref, bool):
        if ref is None:
            assert got is None
        else:
            close(np.asarray(ref), torch.as_tensor(got, dtype=torch.float64), tol)
    else:
        close(ref, got, tol)


RT = {2: "inputs.2d.rayleigh_taylor", 3: "inputs.3d.rayleigh_taylor"}


@pytest.mark.parametrize("dim", [2, pytest.param(3, marks=pytest.mark.slow)])
def test_hierarchy_ops_match(dim, tmp_path):
    rng = np.random.RandomState(dim)
    nc = (12, 16) if dim == 2 else (8, 8, 12)
    crse = rng.randn(*nc)
    for limited in (True, False):
        close(jh.prolong_cell(J(crse), 2, limited), th.prolong_cell(T(crse), 2, limited))
    close(jh.prolong_cell(J(crse), 4), th.prolong_cell(T(crse), 4))
    fine = rng.randn(*(2 * n for n in nc))
    close(jh.restrict_cell(J(fine), 2), th.restrict_cell(T(fine), 2))
    node = rng.randn(*(2 * n + 1 for n in nc))
    close(jh.restrict_node(J(node), 2), th.restrict_node(T(node), 2))
    geom_j, geom_t = (c.geom for c in configs(example_text(
        RT[dim], "amr.n_cell=" + " ".join(map(str, nc))), dim))
    patches = [((4,) * dim, (8,) * dim),
               ((0,) * (dim - 1) + (8,), tuple(2 * n for n in nc[:-1]) + (8,)),
               (tuple(2 * n - 8 for n in nc), (8,) * dim)]
    for lo, n in patches:
        sj, st = specs(lo, n)
        assert dataclasses.asdict(sj.fine_geom(geom_j)) == dataclasses.asdict(
            st.fine_geom(geom_t))
        assert [sj.touches_domain(geom_j, d, s) for d in range(dim) for s in (0, 1)] == [
            st.touches_domain(geom_t, d, s) for d in range(dim) for s in (0, 1)]
        reg = tuple(slice(l, l + m) for l, m in zip(lo, n))
        close(jh.prolong_cell(J(crse), 2)[reg], th.prolong_patch(T(crse), st))
        close(jh.prolong_cell(J(crse), 2, False)[reg], th.prolong_patch(T(crse), st, False))
        f = rng.randn(*n)
        close(jh.avg_down(J(crse), J(f), sj), th.avg_down(T(crse), T(f), st))
        fp = rng.randn(*(m + 1 for m in n))
        cp = rng.randn(*(m + 1 for m in nc))
        close(jh.avg_down_node(J(cp), J(fp), sj), th.avg_down_node(T(cp), T(fp), st))
        for ng in (1, 3):
            close(jh.fill_patch_from_coarse(J(f), J(crse), sj, ng),
                  th.fill_patch_from_coarse(T(f), T(crse), st, ng))
        cflux = [rng.randn(*(m + (e == d) for e, m in enumerate(nc))) for d in range(dim)]
        fflux = [rng.randn(*(m + (e == d) for e, m in enumerate(n))) for d in range(dim)]
        dtdx = tuple(0.1 * (d + 1) for d in range(dim))
        close(jh.reflux_correct(J(crse), [J(a) for a in cflux], [J(a) for a in fflux], sj, dtdx),
              th.reflux_correct(T(crse), [T(a) for a in cflux], [T(a) for a in fflux], st,
                                dtdx))
    path = tmp_path / "grids"
    path.write_text("2\n2\n((0,0,2) (3,3,5) (0,0,0))\n((4,4,2) (7,7,5) (0,0,0))\n1\n"
                    "((2,2,6) (5,5,9) (0,0,0))\n")
    assert jh.read_fixed_grids(str(path), dim) == th.read_fixed_grids(str(path), dim)


CF_CASES = {
    # (inputs, cells, patch lo, patch size): interior in every dim (coarse-
    # fine all round), spanning the periodic dims on the bottom wall, and
    # the lid-driven cavity's patch under its moving lid (ext_dir values)
    "rt3d_interior": (RT[3], "8 8 16", (4, 4, 8), (8, 8, 12)),
    "rt3d_spanning": (RT[3], "8 8 16", (0, 0, 0), (16, 16, 12)),
    "cavity2d_lid": ("inputs.2d.lid_driven_cavity", "16 16", (8, 16), (16, 16)),
}


def _crse_fields(rng, nc, dim, ntrac):
    return {"vel": rng.randn(dim, *nc), "rho": 1.0 + rng.rand(*nc),
            "trac": rng.randn(ntrac, *nc), "temp": 1.0 + rng.rand(*nc)}


@pytest.mark.slow
def test_coarse_fine_provider_matches():
    for case in sorted(CF_CASES):
        _coarse_fine_provider(case)


def _coarse_fine_provider(case):
    inputs, cells, lo, n = CF_CASES[case]
    jcfg, tcfg = configs(example_text(inputs, f"amr.n_cell={cells}", "ns.scal_diff_coefs = 1e-3",
                                      "ns.do_temp = 1", "ns.temp_cond_coef = 1e-3"))
    dim = jcfg.dim
    sj, st = specs(lo, n)
    jcf, tcf = jml.make_fine_config(jcfg, sj), tml.make_fine_config(tcfg, st)
    assert dataclasses.asdict(jcf.geom) == dataclasses.asdict(tcf.geom)
    rng = np.random.RandomState(7)
    nc = jcfg.geom.ncell
    old, new = (_crse_fields(rng, nc, dim, jcfg.ntrac) for _ in range(2))
    p = rng.randn(*(m + 1 for m in nc))
    phi = rng.randn(*nc)
    umac = [rng.randn(*(m + (e == d) for e, m in enumerate(nc))) for d in range(dim)]
    jd = lambda f: {k: J(v) for k, v in f.items()}
    td = lambda f: {k: T(v) for k, v in f.items()}
    for with_phi in (True, False):
        jb = jbcp.CoarseFineBCProvider(jcf, sj, jcfg.geom, jd(old), jd(new), crse_p=J(p),
                                       crse_mac_phi=J(phi) if with_phi else None,
                                       crse_umac=[J(u) for u in umac])
        tb = tbcp.CoarseFineBCProvider(tcf, st, tcfg.geom, td(old), td(new), crse_p=T(p),
                                       crse_mac_phi=T(phi) if with_phi else None,
                                       crse_umac=[T(u) for u in umac])
        assert jb.cf_side == tb.cf_side
        (jbc, jbv), (tbc, tbv) = jb.mac_bc(), tb.mac_bc()
        assert (jbc.lo, jbc.hi) == (tbc.lo, tbc.hi)
        same(jbv, tbv)
    fine = _crse_fields(rng, n, dim, jcfg.ntrac)
    for ng in (1, 3):
        close(jb.fill_vel(J(fine["vel"]), ng), tb.fill_vel(T(fine["vel"]), ng))
        for scomp in (0, 1):
            f = fine["rho"] if scomp == 0 else fine["trac"][0]
            close(jb.fill_scal(J(f), ng, scomp), tb.fill_scal(T(f), ng, scomp))
        close(jb.fill_temp(J(fine["temp"]), ng), tb.fill_temp(T(fine["temp"]), ng))
    close(jb.fill_force(J(fine["vel"])), tb.fill_force(T(fine["vel"])))
    pairs = ([(jb.vel_diff_bc(c), tb.vel_diff_bc(c)) for c in range(dim)]
             + [(jb.scal_diff_bc(s), tb.scal_diff_bc(s)) for s in (0, 1)]
             + [(jb.temp_diff_bc(), tb.temp_diff_bc())])
    for (jbc, jbv), (tbc, tbv) in pairs:
        assert (jbc.lo, jbc.hi) == (tbc.lo, tbc.hi)
        same(jbv, tbv)
    (jnb, jphi), (tnb, tphi) = jb.nodal(), tb.nodal()
    assert (jnb.lo, jnb.hi) == (tnb.lo, tnb.hi)
    close(jphi, tphi)
    fu = [rng.randn(*(m + (e == d) for e, m in enumerate(n))) for d in range(dim)]
    same(jb.grow_umac([J(u) for u in fu]), tb.grow_umac([T(u) for u in fu]))
    for d in range(dim):
        close(jbcp._prolong_face_patch(J(umac[d]), d, sj),
              tbcp._prolong_face_patch(T(umac[d]), d, st))
    close(jbcp._prolong_node_patch(J(p), sj), tbcp._prolong_node_patch(T(p), st))


AUX_CASES = {
    # 3D PLM (the multi-field pass: K2's plain version here) with viscosity
    # and a diffusing tracer; 2D LES (the cross fluxes in vflux_vel)
    "rt3d": (RT[3], "amr.n_cell=8 8 16", ()),
    "les2d": (RT[2], "amr.n_cell=8 16", ("ns.do_LES = 1",)),
}


@pytest.mark.slow
@pytest.mark.parametrize("case", ["les2d", "rt3d"])
def test_advance_aux_on_fine_patch(case):
    inputs, cells, extra = AUX_CASES[case]
    jcfg, tcfg = configs(example_text(inputs, cells, "amr.max_level = 1", *extra))
    dim = jcfg.dim
    rng = np.random.RandomState(2)
    from iamr_tpu.ns import probs as jprobs

    jst = jprobs.init_state(jcfg)
    jst = jst._replace(vel=jst.vel + J(0.05 * rng.randn(*jst.vel.shape)),
                       dt=jnp.asarray(2e-3, jnp.float64))
    tst = convert.state_from_numpy({k: None if v is None else np.asarray(v)
                                    for k, v in jst._asdict().items()}, CPU)
    fixed = 1
    jnew, jaux = jadv.advance(jst, jcfg, fixed, return_aux=True)
    tnew, taux = tadv.advance(tst, tcfg, fixed, return_aux=True)
    for k in FIELDS:
        close(getattr(jnew, k), getattr(tnew, k))
    same(jaux, taux)
    nc = jcfg.geom.ncell
    sj, st = specs(tuple(n // 2 for n in nc), tuple(n for n in nc))
    jf, tf = jml.init_fine_from_coarse(jcfg, sj, jst), tml.init_fine_from_coarse(tcfg, st, tst)
    for k in FIELDS:
        close(getattr(jf, k), getattr(tf, k))
    jcf, tcf = jml.make_fine_config(jcfg, sj), tml.make_fine_config(tcfg, st)
    jb = jbcp.CoarseFineBCProvider(jcf, sj, jcfg.geom, jml._interp_states(jst, jnew, 0.0),
                                   jml._interp_states(jst, jnew, 0.5), crse_p=jnew.p,
                                   crse_mac_phi=jaux["mac_phi"], crse_umac=jaux["umac"])
    tb = tbcp.CoarseFineBCProvider(tcf, st, tcfg.geom, tml._interp_states(tst, tnew, 0.0),
                                   tml._interp_states(tst, tnew, 0.5), crse_p=tnew.p,
                                   crse_mac_phi=taux["mac_phi"], crse_umac=taux["umac"])
    jf = jf._replace(dt=jst.dt / 2)
    tf = tf._replace(dt=tst.dt / 2)
    jfn, jfa = jadv.advance(jf, jcf, fixed, bcp=jb, return_aux=True)
    tfn, tfa = tadv.advance(tf, tcf, fixed, bcp=tb, return_aux=True)
    for k in FIELDS:
        close(getattr(jfn, k), getattr(tfn, k), 1e-11)
    same(jfa, tfa, 1e-11)
    assert taux["vflux_vel"] is not None and all(v is not None for v in taux["vflux_trac"])


def _sync_case(dim):
    cells = "amr.n_cell=16 32" if dim == 2 else "amr.n_cell=8 8 16"
    jcfg, tcfg = configs(example_text(RT[dim], cells, "amr.max_level = 1"))
    nc = jcfg.geom.ncell
    lo, n = tuple(2 * (x // 4) for x in nc), tuple(2 * (x // 2) for x in nc)
    return jcfg, tcfg, nc, specs(lo, n)


@pytest.mark.slow
@pytest.mark.parametrize("dim", [2, 3])
def test_sync_functions_match(dim):
    jcfg, tcfg, nc, (sj, st) = _sync_case(dim)
    jcf, tcf = jml.make_fine_config(jcfg, sj), tml.make_fine_config(tcfg, st)
    rng = np.random.RandomState(11 + dim)
    face = lambda shape: [rng.randn(*(m + (e == d) for e, m in enumerate(shape)))
                          for d in range(dim)]
    cu, fu = face(nc), face(sj.ncell)
    for d in range(dim):
        same(jsync._restrict_face(J(fu[d]), d, sj), tsync._restrict_face(T(fu[d]), d, st))
    jdel = jsync.interface_delta_umac([J(u) for u in cu], [J(u) for u in fu], sj)
    tdel = tsync.interface_delta_umac([T(u) for u in cu], [T(u) for u in fu], st)
    same(jdel, tdel)
    rho = 1.0 + rng.rand(*nc)
    rho_f = 1.0 + rng.rand(*sj.ncell)
    (juc, (jres, _)), (tuc, (tres, _)) = (
        jsync.mac_sync_velocity(jcfg, J(rho), jdel, sj, fixed_cycles=2),
        tsync.mac_sync_velocity(tcfg, T(rho), tdel, st, fixed_cycles=2))
    same(juc, tuc)
    juc, tuc = [J(u) for u in cu], [T(u) for u in cu]
    s = rng.randn(*nc)
    vel = rng.randn(dim, *nc)
    for scomp, icons in ((0, True), (1, False), (1, True)):
        close(jsync.sync_aofs(jcfg, J(s), juc, scomp, icons),
              tsync.sync_aofs(tcfg, T(s), tuc, scomp, icons))
    close(jsync.sync_aofs_vel(jcfg, J(vel), juc), tsync.sync_aofs_vel(tcfg, T(vel), tuc))
    mom = (dataclasses.replace(jcfg, do_mom_diff=True), dataclasses.replace(tcfg, do_mom_diff=True))
    close(jsync.sync_aofs_vel(mom[0], J(vel), juc, rho=J(rho)),
          tsync.sync_aofs_vel(mom[1], T(vel), tuc, rho=T(rho)))
    dt = 3e-3
    same(jsync.sync_project(jcfg, J(vel), J(rho), dt, sj, fixed_cycles=2),
         tsync.sync_project(tcfg, T(vel), T(rho), dt, st, fixed_cycles=2))
    close(jsync.interp_cell_to_fine(J(s), sj), tsync.interp_cell_to_fine(T(s), st))
    for which in ("pc", "cellcons"):
        close(jsync.sync_interp(J(s), sj, which), tsync.sync_interp(T(s), st, which))
    close(jsync.sync_interp(J(vel), sj, "cellconslin"), tsync.sync_interp(T(vel), st, "cellconslin"))
    # a fine field some of whose values the limited increment drives negative
    ffield = 0.3 * rng.rand(*sj.ncell)
    close(jsync.sync_interp(J(s), sj, "protected", J(ffield)),
          tsync.sync_interp(T(s), st, "protected", T(ffield)))
    assert bool(((tsync.interp_cell_to_fine(T(s), st) + T(ffield)) < 0).any())
    nshape = tuple(m + 1 for m in nc)
    close(jsync._interface_node_mask(sj, jcfg.geom, nshape, jnp.float64),
          tsync._interface_node_mask(st, tcfg.geom, nshape, torch.float64, CPU))
    jb, tb = jsync._fine_sync_nodal_bc(jcf, sj, jcfg.geom), tsync._fine_sync_nodal_bc(tcf, st,
                                                                                    tcfg.geom)
    assert (jb.lo, jb.hi) == (tb.lo, tb.hi)
    vel_f = rng.randn(dim, *sj.ncell)
    jrh = jsync.sync_register_rhs(jcfg, sj, J(vel), J(vel_f), dt)
    trh = tsync.sync_register_rhs(tcfg, st, T(vel), T(vel_f), dt)
    close(jrh, trh)
    vs = 1e-3 * rng.randn(dim, *nc)
    for kw in ({"rhnd": (jrh, trh)}, {"vcorr": (J(vel_f), T(vel_f))}):
        jkw = {k: v[0] for k, v in kw.items()}
        tkw = {k: v[1] for k, v in kw.items()}
        same(jsync.sync_project_composite(jcfg, jcf, sj, J(vs), J(rho), J(rho_f), dt,
                                          fixed_cycles=2, **jkw),
             tsync.sync_project_composite(tcfg, tcf, st, T(vs), T(rho), T(rho_f), dt,
                                          fixed_cycles=2, **tkw))
    # the implicit sync diffusion, through the coarse level's physical BCs
    jp, tp = jbcp.PhysBCProvider(jcfg), tbcp.PhysBCProvider(tcfg)
    mu = 1e-2
    close(jtensor.diffuse_vsync(jcfg, jp, J(vs), J(rho), tuple(mu * x for x in jadv.mu_faces(
        dataclasses.replace(jcfg, vel_visc_coef=1.0))), dt, 0.5, fixed_cycles=1),
          ttensor.diffuse_vsync(tcfg, tp, T(vs), T(rho), tuple(mu * x for x in tadv.mu_faces(
              dataclasses.replace(tcfg, vel_visc_coef=1.0), CPU)), dt, 0.5, fixed_cycles=1))
    close(jtensor.diffuse_ssync(jcfg, jp, J(s), J(rho), jadv.beta_faces(jcfg, 1e-2), dt, 0.5, 1,
                                fixed_cycles=1),
          ttensor.diffuse_ssync(tcfg, tp, T(s), T(rho), tadv.beta_faces(tcfg, 1e-2, CPU), dt,
                                0.5, 1, fixed_cycles=1))
    with pytest.raises(NotImplementedError, match="union"):
        tsync.sync_project_composite(tcfg, tcf, st, T(vs), T(rho), T(rho_f), dt, union=(1, 1))


TAG_TEXT = """
amr.refinement_indicators = hi lo adj vort box gated
amr.hi.field_name = density
amr.hi.value_greater = 1.8 1.9
amr.lo.field_name = tracer
amr.lo.value_less = -1.5
amr.adj.field_name = x_velocity
amr.adj.adjacent_difference_greater = 0.9
amr.vort.vorticity_greater = 10.0
amr.box.in_box_lo = 0.1 0.1
amr.box.in_box_hi = 0.2 0.3
amr.gated.field_name = density
amr.gated.value_greater = 1.0
amr.gated.in_box_lo = 0.3 0.5
amr.gated.in_box_hi = 0.45 0.6
amr.gated.start_time = 0.5
amr.gated.max_level = 1
"""


@pytest.fixture
def jax_native(tmp_path, monkeypatch):
    """The JAX package's native library (its Berger-Rigoutsos), built with
    g++ (as `make -C native` builds it) into this test's directory: the
    package builds native/build on first use, and test processes running
    side by side may load that file while another one writes it."""
    so = tmp_path / "libiamr_native.so"
    subprocess.run(["g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-o", str(so), jnative._SRC],
                   check=True, capture_output=True, timeout=300)
    monkeypatch.setattr(jnative, "_SO", str(so))
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", False)
    assert jnative.available()
    return jnative


def test_tagging_and_clustering_match(jax_native):
    text = example_text(RT[2], "amr.n_cell=32 64", "amr.max_level = 1", TAG_TEXT)
    jcfg, tcfg = configs(text)
    jtags = jtag.parse_refinement_indicators(JParmParse.from_string(text))
    ttags = ttag.parse_refinement_indicators(TParmParse.from_string(text))
    assert [dataclasses.asdict(t) for t in jtags] == [dataclasses.asdict(t) for t in ttags]
    from iamr_tpu.ns import probs as jprobs

    rng = np.random.RandomState(4)
    jst = jprobs.init_state(jcfg)
    jst = jst._replace(vel=J(0.1 * rng.randn(*jst.vel.shape)),
                       trac=J(0.6 * rng.randn(*jst.trac.shape)))
    tst = convert.state_from_numpy({k: None if v is None else np.asarray(v)
                                    for k, v in jst._asdict().items()}, CPU)
    for time, level in ((0.0, 0), (0.7, 0), (0.7, 1)):
        jt = np.asarray(jtag.tag_cells(jcfg, jst._replace(time=jnp.asarray(time)), jtags, level))
        tt = ttag.tag_cells(tcfg, tst._replace(time=torch.tensor(time, dtype=torch.float64)),
                            ttags, level).numpy()
        assert jt.dtype == tt.dtype and np.array_equal(jt, tt) and jt.any()
        assert dataclasses.asdict(jtag.cluster_to_patch(jt, 2)) == dataclasses.asdict(
            ttag.cluster_to_patch(tt, 2))
    # Berger-Rigoutsos against the native library on seeded tag fields
    for seed in range(12):
        r = np.random.RandomState(seed)
        shape = (32, 48) if seed % 2 else (16, 24, 20)
        blobs = np.zeros(shape, bool)
        for _ in range(1 + seed % 4):
            lo = [r.randint(0, n - 4) for n in shape]
            hi = [l + r.randint(2, max(3, n // 3)) for l, n in zip(lo, shape)]
            blobs[tuple(slice(a, b) for a, b in zip(lo, hi))] = True
        tags = blobs | (r.rand(*shape) < 0.01 * (seed % 3))
        for min_width, min_eff in ((2, 0.7), (4, 0.5), (1, 0.9)):
            assert ttag.berger_rigoutsos(tags, min_width, min_eff) == jnative.berger_rigoutsos(
                tags, min_width, min_eff), (seed, min_width, min_eff)
        for buf in (0, 1, 2):
            assert [dataclasses.asdict(s) for s in jtag.cluster_to_patches(tags, 2, buf)] == [
                dataclasses.asdict(s) for s in ttag.cluster_to_patches(tags, 2, buf)]
    boxes = [specs((0, 0), (8, 8)), specs((8, 0), (8, 8)), specs((0, 8), (16, 8)),
             specs((32, 32), (8, 8))]
    assert [dataclasses.asdict(s) for s in jtag.coalesce_specs([b[0] for b in boxes])] == [
        dataclasses.asdict(s) for s in ttag.coalesce_specs([b[1] for b in boxes])]
    out_text = example_text(RT[2], "amr.n_cell=32 64", "ns.hi_bc = 0 2")
    for refine, derefine in ((False, True), (True, False)):
        cfgs = configs(out_text)
        t = np.zeros((32, 64), bool)
        t[10:12, 62] = True
        t[3, 5] = True
        assert np.array_equal(
            jtag.apply_outflow_tag_policy(cfgs[0], t, refine, derefine, 2),
            ttag.apply_outflow_tag_policy(cfgs[1], t, refine, derefine, 2))
    # regrid: the overlap copied from the old fine state, the rest interpolated
    sj0, st0 = specs((8, 16), (32, 64))
    jf = jml.init_fine_from_coarse(jcfg, sj0, jst)
    jf = jf._replace(rho=jf.rho + J(rng.rand(*jf.rho.shape)), p=jf.p + 1.0)
    tf = convert.state_from_numpy({k: None if v is None else np.asarray(v)
                                   for k, v in jf._asdict().items()}, CPU)
    for lo, n in (((16, 32), (32, 64)), ((48, 96), (16, 32))):
        sj1, st1 = specs(lo, n)
        jn = jtag.regrid_fine_state(jcfg, sj0, sj1, jst, jf)
        tn = ttag.regrid_fine_state(tcfg, st0, st1, tst, tf)
        for k in FIELDS:
            close(getattr(jn, k), getattr(tn, k))


def test_composite_particle_velocity_matches():
    jcfg, tcfg = configs(example_text(RT[3], "amr.n_cell=8 8 16", "amr.max_level = 2"))
    rng = np.random.RandomState(9)
    lev = [(jcfg, tcfg)]
    sps = [specs((4, 4, 8), (8, 8, 16)), specs((4, 4, 8), (8, 8, 16))]
    for sj, st in sps:
        lev.append((jml.make_fine_config(lev[-1][0], sj), tml.make_fine_config(lev[-1][1], st)))
    umacs = [[rng.randn(*(m + (e == d) for e, m in enumerate(c[0].geom.ncell)))
              for d in range(3)] for c in lev]
    jl = [([J(u) for u in um], c[0].geom) for um, c in zip(umacs, lev)]
    tl = [([T(u) for u in um], c[1].geom) for um, c in zip(umacs, lev)]
    pos = rng.uniform(0.0, 1.0, (300, 3)) * np.asarray([0.5, 0.5, 1.0])
    close(jpart._composite_mac_velocity(jl, J(pos)), tpart._composite_mac_velocity(tl, T(pos)))
    jp = jpart.Particles(pos=J(pos), alive=jnp.ones(300, bool))
    tp = convert.particles_from_numpy(pos, CPU)
    jo, to = jpart.advect_with_umac_levels(jp, jl, 1e-2), tpart.advect_with_umac_levels(tp, tl,
                                                                                         1e-2)
    close(jo.pos, to.pos)
    assert np.array_equal(np.asarray(jo.alive), to.alive.numpy()) and not to.alive.all()
