"""Boundary-condition providers: how ghost cells are filled and which BCs
the solvers see, apart from the timestep logic (counterpart of
iamr_tpu/ns/bcprovider.py).

  * PhysBCProvider: a single or coarsest level, the physical-domain fills.
  * CoarseFineBCProvider: a fine patch (one box): ghosts interpolated from
    the parent level, physical fills on the sides on the domain boundary,
    and Dirichlet values for the MAC, diffusion and nodal solves on the
    coarse-fine sides (setCoarseFineBC, MLNodeLaplacian's coarse-fine
    Dirichlet). The provider of multi-box (union) levels is not ported.

Every fill and boundary value is formed on the tensors' device; nothing is
read back to the host.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from iamr_tpu_torch.amr.hierarchy import (
    LevelSpec,
    fill_patch_from_coarse,
    prolong_patch,
)
from iamr_tpu_torch.core.bc import (
    BCRec,
    MathBC,
    SCALAR_BC,
    TEMP_BC,
    make_bcrec,
    velocity_bcrec,
)
from iamr_tpu_torch.core.fill import _ghost_block, fill_ghost
from iamr_tpu_torch.ops.godunov import grow_umac_transverse
from iamr_tpu_torch.ops.mg import DIRICHLET, PoissonBC
from iamr_tpu_torch.ops.mg_nodal import N_DIRICHLET, NodalBC
from iamr_tpu_torch.ops.stencil import sl
from iamr_tpu_torch.solvers.diffusion import bvals_from_scalar, poisson_bc_from_bcrec
from iamr_tpu_torch.solvers.mac import mac_poisson_bc
from iamr_tpu_torch.solvers.nodal_proj import nodal_bc as make_nodal_bc


class PhysBCProvider:
    """Physical-domain boundary fills (the single-level default)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.dim = cfg.dim
        self._vel_recs = [
            velocity_bcrec(cfg.dom.phys_lo, cfg.dom.phys_hi, c)
            for c in range(self.dim)
        ]
        self._scal_rec = make_bcrec(cfg.dom.phys_lo, cfg.dom.phys_hi, SCALAR_BC)
        self._temp_rec = make_bcrec(cfg.dom.phys_lo, cfg.dom.phys_hi, TEMP_BC)

    # --- ghost fills ------------------------------------------------------
    def vel_bcvals(self, comp):
        lo = tuple(self.cfg.dom.value(d, 0, comp) for d in range(self.dim))
        hi = tuple(self.cfg.dom.value(d, 1, comp) for d in range(self.dim))
        return lo, hi

    def scal_bcvals(self, scomp):
        c = self.dim + scomp
        lo = tuple(self.cfg.dom.value(d, 0, c) for d in range(self.dim))
        hi = tuple(self.cfg.dom.value(d, 1, c) for d in range(self.dim))
        return lo, hi

    def fill_vel(self, vel, ng):
        out = []
        for c in range(self.dim):
            lo, hi = self.vel_bcvals(c)
            out.append(fill_ghost(vel[c], ng, self._vel_recs[c], lo, hi))
        return torch.stack(out)

    def fill_scal(self, s, ng, scomp):
        lo, hi = self.scal_bcvals(scomp)
        return fill_ghost(s, ng, self._scal_rec, lo, hi)

    def fill_force(self, f):
        return torch.stack([fill_ghost(f[c], 1, self._vel_recs[c]) for c in range(self.dim)])

    def temp_bcvals(self):
        """ext_dir values of the temperature (bc_values after the tracers)."""
        c = self.dim + 1 + self.cfg.ntrac
        lo = tuple(self.cfg.dom.value(d, 0, c) for d in range(self.dim))
        hi = tuple(self.cfg.dom.value(d, 1, c) for d in range(self.dim))
        return lo, hi

    def fill_temp(self, s, ng):
        lo, hi = self.temp_bcvals()
        return fill_ghost(s, ng, self._temp_rec, lo, hi)

    def temp_diff_bc(self) -> Tuple[PoissonBC, Dict]:
        rec = self._temp_rec
        lo, hi = self.temp_bcvals()
        return poisson_bc_from_bcrec(rec), bvals_from_scalar(rec, lo, hi, self.dim)

    # --- BC descriptors for the advection face pinning --------------------
    def vel_bcrec(self, comp) -> BCRec:
        return self._vel_recs[comp]

    # --- solver BCs -------------------------------------------------------
    def vel_diff_bc(self, comp) -> Tuple[PoissonBC, Dict]:
        rec = self._vel_recs[comp]
        lo, hi = self.vel_bcvals(comp)
        return poisson_bc_from_bcrec(rec), bvals_from_scalar(rec, lo, hi, self.dim)

    def scal_diff_bc(self, scomp) -> Tuple[PoissonBC, Dict]:
        rec = self._scal_rec
        lo, hi = self.scal_bcvals(scomp)
        return poisson_bc_from_bcrec(rec), bvals_from_scalar(rec, lo, hi, self.dim)

    def mac_bc(self) -> Tuple[PoissonBC, Optional[Dict]]:
        return mac_poisson_bc(self.cfg.dom), None

    def nodal(self) -> Tuple[NodalBC, Optional[torch.Tensor]]:
        return make_nodal_bc(self.cfg.dom), None

    def grow_umac(self, umac):
        """MAC velocities with one transverse ghost row."""
        return grow_umac_transverse(umac, tuple(self.cfg.geom.periodic))


def _arange(start, stop, device):
    return torch.arange(start, stop, device=device)


def _lin_normal(out, f, lo, n, r, dtype):
    """Linear interpolation along dim f from coarse faces to the fine faces
    lo..lo+n (fine index units), face_linear_interp's normal part."""
    g = _arange(lo, lo + n + 1, out.device)
    c0 = torch.div(g, r, rounding_mode="floor")
    w = ((g - c0 * r).to(torch.float64) / r).to(dtype)
    c1 = torch.clamp(c0 + 1, max=out.shape[f] - 1)
    a = torch.index_select(out, f, c0)
    b = torch.index_select(out, f, c1)
    shape = [1] * out.ndim
    shape[f] = n + 1
    return a + (b - a) * w.reshape(shape)


def _pc_transverse(out, f, lo, n, r):
    """The coarse cells over the fine cells lo..lo+n-1 along dim f,
    repeated r times (piecewise constant)."""
    return torch.repeat_interleave(sl(out, f, lo // r, (lo + n) // r), r, dim=f)


def _prolong_face_patch(cu, d, spec: LevelSpec):
    """Coarse MAC face field (faces normal to d) interpolated onto the fine
    patch's face grid: linear in the normal dim, piecewise constant
    transverse (the reference's face_linear_interp)."""
    out = cu
    for f in range(cu.ndim):
        if f == d:
            out = _lin_normal(out, f, spec.lo[f], spec.ncell[f], spec.ratio, cu.dtype)
        else:
            out = _pc_transverse(out, f, spec.lo[f], spec.ncell[f], spec.ratio)
    return out


def _prolong_node_patch(crse_p, spec: LevelSpec):
    """Multilinear interpolation of the coarse nodal field onto the fine
    patch's node grid (the coarse-fine Dirichlet values of the fine
    projection). Only the coarse nodes the patch needs are refined: one
    beyond its hi corner where the array has it, so that every fine node
    takes the weights a refinement of the whole array gives it."""
    dim = crse_p.ndim
    r = spec.ratio
    out = crse_p
    for d in range(dim):
        c_lo = spec.crse_lo[d]
        out = sl(out, d, c_lo, min(c_lo + spec.crse_ncell[d] + 2, crse_p.shape[d]))
        n = out.shape[d]
        idx_f = _arange(0, (n - 1) * r + 1, out.device)
        i0 = torch.clamp(torch.div(idx_f, r, rounding_mode="floor"), max=n - 2)
        w = (idx_f - i0 * r).to(out.dtype) / r
        a = torch.index_select(out, d, i0)
        b = torch.index_select(out, d, i0 + 1)
        shape = [1] * dim
        shape[d] = idx_f.shape[0]
        out = a + (b - a) * w.reshape(shape)
    return out[tuple(slice(0, spec.ncell[d] + 1) for d in range(dim))].contiguous()


class CoarseFineBCProvider(PhysBCProvider):
    """Fine-patch provider: ghosts from the parent level, Dirichlet
    coarse-fine solver BCs from the parent's fields.

    The parent's data at its resolution:
      crse_old: {"vel": (dim, *nc), "rho", "trac", "temp"} at the start of
        the fine step (the fills);
      crse_new: the same at its end (the implicit solves' BCs);
      crse_p: the parent's nodal pressure (the fine projection);
      crse_mac_phi: the parent's MAC potential (the fine MAC solve);
      crse_umac: the parent's MAC velocities (grow_umac's ghost rows).
    The coarse-fine face values of one coarse field are formed once per
    provider."""

    def __init__(self, cfg_fine, spec: LevelSpec, crse_geom, crse_old: Dict,
                 crse_new: Dict, crse_p=None, crse_mac_phi=None, crse_umac=None):
        super().__init__(cfg_fine)
        self.spec = spec
        self.crse_geom = crse_geom
        self.crse_old = crse_old
        self.crse_new = crse_new
        self.crse_p = crse_p
        self.crse_mac_phi = crse_mac_phi
        self.crse_umac = crse_umac
        self.cf_side = {(d, s): not spec.touches_domain(crse_geom, d, s)
                        for d in range(self.dim) for s in (0, 1)}
        self._face_vals = {}

        # on coarse-fine sides the physical BC tables do not apply: int_dir
        # there, so the advection face pinning and the fill overwrites skip
        # them
        def mask_cf(rec: BCRec) -> BCRec:
            lo, hi = list(rec.lo), list(rec.hi)
            for d in range(self.dim):
                if self.cf_side[(d, 0)]:
                    lo[d] = MathBC.int_dir
                if self.cf_side[(d, 1)]:
                    hi[d] = MathBC.int_dir
            return BCRec(lo=tuple(lo), hi=tuple(hi))

        self._vel_recs = [mask_cf(r) for r in self._vel_recs]
        self._scal_rec = mask_cf(self._scal_rec)
        self._temp_rec = mask_cf(self._temp_rec)

    # --- fills: coarse interpolation, physical overwrite on domain sides --
    def _fill_from(self, fine, crse, ng, bcrec: BCRec, vals_lo, vals_hi):
        g = fill_patch_from_coarse(fine, crse, self.spec, ng)
        for d in range(self.dim):
            for s in (0, 1):
                if self.cf_side[(d, s)]:
                    continue
                # a physical side: that ghost slab rebuilt from the interior
                interior = sl(g, d, ng, g.shape[d] - ng)
                slab = _ghost_block(interior, d, s, ng, bcrec.lo[d] if s == 0 else bcrec.hi[d],
                                    vals_lo[d] if s == 0 else vals_hi[d])
                idx = [slice(None)] * self.dim
                idx[d] = slice(0, ng) if s == 0 else slice(g.shape[d] - ng, None)
                g[tuple(idx)] = slab
        return g

    def fill_vel(self, vel, ng):
        out = []
        for c in range(self.dim):
            lo, hi = self.vel_bcvals(c)
            out.append(self._fill_from(vel[c], self.crse_old["vel"][c], ng, self._vel_recs[c],
                                       lo, hi))
        return torch.stack(out)

    def _crse_scal(self, data, scomp):
        return data["rho"] if scomp == 0 else data["trac"][scomp - 1]

    def fill_scal(self, s, ng, scomp):
        lo, hi = self.scal_bcvals(scomp)
        return self._fill_from(s, self._crse_scal(self.crse_old, scomp), ng, self._scal_rec,
                               lo, hi)

    def fill_force(self, f):
        # forces are smooth: first-order extrapolation on every side (within
        # the O(dx) accuracy of the dt/2 force term)
        rec = BCRec(lo=(MathBC.foextrap,) * self.dim, hi=(MathBC.foextrap,) * self.dim)
        return torch.stack([fill_ghost(f[c], 1, rec) for c in range(self.dim)])

    def fill_temp(self, s, ng):
        lo, hi = self.temp_bcvals()
        return self._fill_from(s, self.crse_old["temp"], ng, self._temp_rec, lo, hi)

    # --- coarse-fine values on the patch boundary faces ------------------
    def _boundary_face_vals(self, crse_cc, d, side, key):
        """A coarse cell field at the fine boundary-face centres of patch
        face (d, side): the mean of the interpolated cells on both sides.
        key names the field, whose values are formed once."""
        key = (key, d, side)
        if key not in self._face_vals:
            spec = self.spec
            f_bg = fill_patch_from_coarse(
                torch.zeros(spec.ncell, dtype=crse_cc.dtype, device=crse_cc.device), crse_cc,
                spec, 1)
            a = f_bg[tuple((slice(0, 1) if side == 0 else slice(-1, None)) if e == d
                           else slice(1, -1) for e in range(self.dim))]
            # the prolonged coarse cells of the patch's first (last) coarse
            # layer along d, cut to its first (last) fine layer
            r = spec.ratio
            lo = list(spec.lo)
            n = list(spec.ncell)
            lo[d] += 0 if side == 0 else spec.ncell[d] - r
            n[d] = r
            layer = prolong_patch(crse_cc, LevelSpec(lo=tuple(lo), ncell=tuple(n), ratio=r))
            b = sl(layer, d, 0, 1) if side == 0 else sl(layer, d, r - 1, r)
            self._face_vals[key] = (0.5 * (a + b)).squeeze(d)
        return self._face_vals[key]

    def _with_cf_dirichlet(self, bc: PoissonBC, bvals: Dict, crse_cc, key) -> Tuple:
        lo, hi = list(bc.lo), list(bc.hi)
        bv = dict(bvals) if bvals else {}
        for d in range(self.dim):
            if self.cf_side[(d, 0)]:
                lo[d] = DIRICHLET
                bv[(d, 0)] = self._boundary_face_vals(crse_cc, d, 0, key)
            if self.cf_side[(d, 1)]:
                hi[d] = DIRICHLET
                bv[(d, 1)] = self._boundary_face_vals(crse_cc, d, 1, key)
        return PoissonBC(lo=tuple(lo), hi=tuple(hi)), bv

    def vel_diff_bc(self, comp):
        bc, bv = super().vel_diff_bc(comp)
        return self._with_cf_dirichlet(bc, bv, self.crse_new["vel"][comp], ("vel", comp))

    def scal_diff_bc(self, scomp):
        bc, bv = super().scal_diff_bc(scomp)
        return self._with_cf_dirichlet(bc, bv, self._crse_scal(self.crse_new, scomp),
                                       ("scal", scomp))

    def temp_diff_bc(self):
        bc, bv = super().temp_diff_bc()
        return self._with_cf_dirichlet(bc, bv, self.crse_new["temp"], "temp")

    def mac_bc(self):
        bc, _ = super().mac_bc()
        crse_phi = self.crse_mac_phi
        if crse_phi is None:
            ref = self.crse_old["rho"]
            crse_phi = torch.zeros(self.crse_geom.ncell, dtype=ref.dtype, device=ref.device)
        return self._with_cf_dirichlet(bc, {}, crse_phi, "mac_phi")

    def nodal(self):
        nb, _ = super().nodal()
        lo, hi = list(nb.lo), list(nb.hi)
        for d in range(self.dim):
            if self.cf_side[(d, 0)]:
                lo[d] = N_DIRICHLET
            if self.cf_side[(d, 1)]:
                hi[d] = N_DIRICHLET
        phi_bc = None if self.crse_p is None else _prolong_node_patch(self.crse_p, self.spec)
        return NodalBC(lo=tuple(lo), hi=tuple(hi)), phi_bc

    def grow_umac(self, umac):
        """The fine level's create_umac_grown: the transverse ghost rows on
        coarse-fine sides are face-linear interpolations of the parent's
        MAC velocities (FillPatchTwoLevels with face_linear_interp), the
        physical and periodic sides keep the single-level fill (the
        reference's divergence-preserving fix touches only the outer
        normal ghost face, which these stencils never read)."""
        if self.crse_umac is None:
            return super().grow_umac(umac)
        spec, r, dim = self.spec, self.spec.ratio, self.dim
        periodic = tuple(self.cfg.geom.periodic)

        def interp_row(d, e, side, grown_dims):
            """Coarse umac[d] at the fine ghost row just outside the patch
            along e, edge-padded along the transverse dims grown before."""
            out = self.crse_umac[d]
            for f in range(dim):
                if f == d:
                    out = _lin_normal(out, f, spec.lo[f], spec.ncell[f], r, out.dtype)
                elif f == e:
                    gcell = spec.lo[f] - 1 if side == 0 else spec.lo[f] + spec.ncell[f]
                    cc = (gcell // r) % out.shape[f]
                    out = sl(out, f, cc, cc + 1)
                else:
                    out = _pc_transverse(out, f, spec.lo[f], spec.ncell[f], r)
            for f in grown_dims:
                out = torch.cat([sl(out, f, 0, 1), out, sl(out, f, -1, None)], dim=f)
            return out

        out = []
        for d, u in enumerate(umac):
            grown = []
            for e in range(dim):
                if e == d:
                    continue
                rows = {}
                for side in (0, 1):
                    if self.cf_side[(e, side)]:
                        rows[side] = interp_row(d, e, side, grown)
                    elif periodic[e]:
                        rows[side] = sl(u, e, -1, None) if side == 0 else sl(u, e, 0, 1)
                    else:
                        rows[side] = sl(u, e, 0, 1) if side == 0 else sl(u, e, -1, None)
                u = torch.cat([rows[0], u, rows[1]], dim=e)
                grown.append(e)
            out.append(u)
        return tuple(out)
