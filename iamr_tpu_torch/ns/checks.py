"""Per-step self-checks of ns.debug (counterpart of iamr_tpu/ns/checks.py).

  check_div_cond          max |D(u_mac) - S| after the MAC projection
                          (MacProj::check_div_cond), which the MAC
                          projection enforces to its solver tolerance
  umac_periodic_mismatch  for each periodic dim, max |u[0] - u[n]| of the
                          MAC velocity: the first and last faces are the
                          same physical face (MacProj::test_umac_periodic)
  scan_fields             NaN and BogusValue (|x| >= BOGUS_THRESHOLD) flags
                          of the state's fields
  check_finite            the NaN and infinity scan of ns.debug_nans

The first three return 0-d tensors on the fields' device; run_debug_checks
reads them on the host once a step.
"""

from __future__ import annotations

from typing import Sequence

import torch

from iamr_tpu_torch.ops.stencil import mac_div

#: the reference's BogusValue is 1e200; f32-safe here
BOGUS_THRESHOLD = 1e18


def check_div_cond(umac, dx: Sequence[float], divu_src=None, eb=None):
    """Max |div(u_mac) - S| over the level; given the level's EBData, the
    cut-cell divergence sum_d d(afrac u)/dx_d against vfrac S over the fluid
    cells (the EB MAC projection's constraint)."""
    if eb is not None:
        div = mac_div(tuple(af * u for af, u in zip(eb.afrac, umac)), dx)
        if divu_src is not None:
            div = div - eb.vfrac * divu_src
        return torch.amax(torch.abs(div * eb.fluid))
    div = mac_div(umac, dx)
    if divu_src is not None:
        div = div - divu_src
    return torch.amax(torch.abs(div))


def umac_periodic_mismatch(umac, periodic: Sequence[bool]):
    """Max |u_d[0] - u_d[n_d]| over the periodic dims d."""
    out = torch.zeros((), dtype=umac[0].dtype, device=umac[0].device)
    for d, u in enumerate(umac):
        if periodic[d]:
            lo = u.narrow(d, 0, 1)
            hi = u.narrow(d, u.shape[d] - 1, 1)
            out = torch.maximum(out, torch.amax(torch.abs(lo - hi)))
    return out


def scan_fields(**fields):
    """{name: (has_nan, has_bogus)} 0-d bool tensors per field (None skipped)."""
    return {
        name: (torch.any(torch.isnan(a)), torch.any(torch.abs(a) >= BOGUS_THRESHOLD))
        for name, a in fields.items() if a is not None
    }


def run_debug_checks(cfg, state, umac, divu_src=None, eb=None, step=None):
    """Host-side check of one step (ns.debug = 1): raises FloatingPointError
    on NaN or BogusValue in the state, prints the MAC divergence condition
    and the periodic-face mismatch; returns both."""
    periodic = tuple(cfg.geom.periodic)
    if divu_src is None and cfg.do_temp and cfg.temp_cond_coef > 0.0:
        # thermal runs enforce div(umac) = S + dt/2 dsdt; without S there is
        # nothing to compare against
        div = float("nan")
    else:
        div = float(check_div_cond(umac, cfg.geom.dx, divu_src=divu_src, eb=eb))
    per = float(umac_periodic_mismatch(umac, periodic)) if any(periodic) else 0.0
    scans = scan_fields(vel=state.vel, rho=state.rho, trac=state.trac, p=state.p,
                        gradp=state.gradp, temp=state.temp)
    bad = []
    for name, (has_nan, has_bogus) in scans.items():
        if bool(has_nan):
            bad.append(f"{name}: NaN")
        if bool(has_bogus):
            bad.append(f"{name}: |x| >= {BOGUS_THRESHOLD:g} (BogusValue)")
    tag = f"step {step}: " if step is not None else ""
    if bad:
        raise FloatingPointError(f"ns.debug {tag}" + "; ".join(bad))
    print(f"ns.debug {tag}max|D(umac)-S| = {div:.3e}   "
          f"periodic umac mismatch = {per:.3e}")
    return div, per


def check_finite(state, step=None):
    """ns.debug_nans: raise FloatingPointError naming every field of the
    state that holds a NaN or an infinity (one host read)."""
    fields = {k: v for k, v in state._asdict().items() if v is not None}
    finite = torch.stack([torch.isfinite(v).all() for v in fields.values()]).tolist()
    bad = [k for k, ok in zip(fields, finite) if not ok]
    if bad:
        tag = f" after step {step}" if step is not None else ""
        raise FloatingPointError(f"ns.debug_nans: non-finite values in {', '.join(bad)}{tag}")
