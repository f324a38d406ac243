"""Boundary-condition types and translation tables (the port's copy of
iamr_tpu/core/bc.py).

Physical BC codes match the reference's RegType/inputs convention
(reference Source/RegType.H, inputs files `ns.lo_bc`):
  0 Interior/Periodic, 1 Inflow, 2 Outflow, 3 Symmetry, 4 SlipWall, 5 NoSlipWall

Mathematical (per-variable) BC codes follow amrex::BCType semantics; the
physical->math maps reproduce reference Source/NS_BC.H:7-55 exactly
(norm_vel_bc, tang_vel_bc, scalar_bc, press_bc, norm_gradp_bc, tang_gradp_bc,
temp_bc, divu_bc, dsdt_bc, average_bc).

String BC names accepted in inputs (`xlo.type = mass_inflow` etc.) follow
reference Source/NavierStokes.cpp:105-237 / Docs ProblemSetup.rst:141-262.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional, Sequence, Tuple


class PhysBC(enum.IntEnum):
    Interior = 0
    Inflow = 1
    Outflow = 2
    Symmetry = 3
    SlipWall = 4
    NoSlipWall = 5


# String names -> PhysBC (reference NavierStokes.cpp Initialize_bcs)
BC_NAMES: Dict[str, PhysBC] = {
    "interior": PhysBC.Interior,
    "periodic": PhysBC.Interior,
    "mass_inflow": PhysBC.Inflow,
    "inflow": PhysBC.Inflow,
    "pressure_outflow": PhysBC.Outflow,
    "outflow": PhysBC.Outflow,
    "symmetry": PhysBC.Symmetry,
    "slip_wall": PhysBC.SlipWall,
    "slipwall": PhysBC.SlipWall,
    "no_slip_wall": PhysBC.NoSlipWall,
    "noslipwall": PhysBC.NoSlipWall,
    # reference abbreviations (NavierStokes::Initialize_bcs string intake)
    "mi": PhysBC.Inflow,
    "pressure_inflow": PhysBC.Inflow,
    "pi": PhysBC.Inflow,
    "po": PhysBC.Outflow,
    "sym": PhysBC.Symmetry,
    "sw": PhysBC.SlipWall,
    "nsw": PhysBC.NoSlipWall,
}


class MathBC(enum.IntEnum):
    """amrex::BCType equivalents used by the ghost-fill machinery."""

    int_dir = 0       # periodic / interior
    ext_dir = 1       # Dirichlet value in ghost
    foextrap = 2      # first-order (copy) extrapolation
    hoextrap = 3      # higher-order extrapolation
    reflect_even = 4  # mirror
    reflect_odd = 5   # negated mirror


I, E, F, H, RE, RO = (
    MathBC.int_dir,
    MathBC.ext_dir,
    MathBC.foextrap,
    MathBC.hoextrap,
    MathBC.reflect_even,
    MathBC.reflect_odd,
)

# phys -> math tables, indexed by PhysBC value (reference NS_BC.H)
NORM_VEL_BC = (I, E, F, RO, E, E)
TANG_VEL_BC = (I, E, F, RE, H, E)
SCALAR_BC = (I, E, F, RE, F, F)
PRESS_BC = (I, F, F, RE, F, F)
NORM_GRADP_BC = (I, F, F, RO, F, F)
TANG_GRADP_BC = (I, F, F, RE, F, F)
TEMP_BC = (I, E, H, RE, RE, RE)
DIVU_BC = (I, RE, RE, RE, RE, RE)
DSDT_BC = (I, E, E, RE, RE, RE)
AVERAGE_BC = (I, I, I, I, I, I)


@dataclasses.dataclass(frozen=True)
class BCRec:
    """Math BC per (dim, side) for one variable: lo[d], hi[d]."""

    lo: Tuple[MathBC, ...]
    hi: Tuple[MathBC, ...]

    @property
    def dim(self) -> int:
        return len(self.lo)


def make_bcrec(
    phys_lo: Sequence[PhysBC], phys_hi: Sequence[PhysBC], table: Tuple[MathBC, ...]
) -> BCRec:
    return BCRec(
        lo=tuple(table[int(p)] for p in phys_lo),
        hi=tuple(table[int(p)] for p in phys_hi),
    )


def velocity_bcrec(
    phys_lo: Sequence[PhysBC], phys_hi: Sequence[PhysBC], comp: int
) -> BCRec:
    """BCRec for velocity component `comp`: normal table in dim==comp, tangential otherwise."""
    lo = tuple(
        (NORM_VEL_BC if d == comp else TANG_VEL_BC)[int(p)]
        for d, p in enumerate(phys_lo)
    )
    hi = tuple(
        (NORM_VEL_BC if d == comp else TANG_VEL_BC)[int(p)]
        for d, p in enumerate(phys_hi)
    )
    return BCRec(lo=lo, hi=hi)


def gradp_bcrec(
    phys_lo: Sequence[PhysBC], phys_hi: Sequence[PhysBC], comp: int
) -> BCRec:
    lo = tuple(
        (NORM_GRADP_BC if d == comp else TANG_GRADP_BC)[int(p)]
        for d, p in enumerate(phys_lo)
    )
    hi = tuple(
        (NORM_GRADP_BC if d == comp else TANG_GRADP_BC)[int(p)]
        for d, p in enumerate(phys_hi)
    )
    return BCRec(lo=lo, hi=hi)


@dataclasses.dataclass(frozen=True)
class DomainBC:
    """Full physical BC description for the problem domain.

    bc_values[(d, side)] maps to per-component boundary values for ext_dir
    fills (side 0 = lo, 1 = hi). Values are ordered like the state:
    velocity components first, then density, tracers, temperature — matching
    the reference's m_bc_values layout (NS_bcfill.H).
    """

    phys_lo: Tuple[PhysBC, ...]
    phys_hi: Tuple[PhysBC, ...]
    bc_values: Dict[Tuple[int, int], Tuple[float, ...]] = dataclasses.field(
        default_factory=dict
    )

    @property
    def dim(self) -> int:
        return len(self.phys_lo)

    def value(self, d: int, side: int, comp: int) -> float:
        vals = self.bc_values.get((d, side))
        if vals is None or comp >= len(vals):
            return 0.0
        return vals[comp]

    def is_periodic(self, d: int) -> bool:
        return self.phys_lo[d] == PhysBC.Interior

    def has_outflow(self) -> bool:
        return PhysBC.Outflow in self.phys_lo or PhysBC.Outflow in self.phys_hi
