"""Boundary-condition provider for one level's physical domain
(counterpart of iamr_tpu/ns/bcprovider.py::PhysBCProvider).

It separates how ghost cells are filled and which BCs the solvers see from
the timestep logic. The coarse-fine provider of AMR levels is not ported
yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from iamr_tpu_torch.core.bc import BCRec, SCALAR_BC, TEMP_BC, make_bcrec, velocity_bcrec
from iamr_tpu_torch.core.fill import fill_ghost
from iamr_tpu_torch.ops.godunov import grow_umac_transverse
from iamr_tpu_torch.ops.mg import PoissonBC
from iamr_tpu_torch.ops.mg_nodal import NodalBC
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
