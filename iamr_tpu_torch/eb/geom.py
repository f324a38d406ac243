"""Embedded-boundary (cut-cell) geometry (counterpart of iamr_tpu/eb/geom.py).

The AMReX EB2 geometry IAMR builds (EB2::Build over the implicit functions
sphere, cylinder, box, plane and their unions, intersections and
differences, NS_init_eb2.cpp) as dense fraction tensors of one level: the
volume fractions, the area fractions of every face, the masks, the wall
area per volume, the wall distance, the StateRedist merge tracker and the
fluid centroids. Everything in the step reads these tensors.

Conventions, as in the JAX package:
  * implicit functions are fluid-positive: psi(x) > 0 in the fluid, < 0
    in the body;
  * fractions are the share of ss sub-samples per cell and dim where
    psi > 0 (areas: ss per transverse dim on the face plane).

The implicit functions take torch tensors and use the JAX package's
arithmetic in its order, so each sample's sign is the same. The samples
are formed on the device in slabs along dim 0, each slab reduced to its
cells' counts before the next (ss^dim samples a cell do not fit at once
at full width), and the fractions and centroids are exact quotients of
those counts: for ss a power of two they equal the JAX package's bit for
bit. The geometry is built in float64 and cast to the run's dtype.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from iamr_tpu_torch import plugins
from iamr_tpu_torch.core.geometry import Geometry

F64 = torch.float64
CUDA = torch.device("cuda", 0)
# samples evaluated at once per slab (bounds the slab's temporaries:
# about ten float64 tensors of this many entries)
SLAB_SAMPLES = 1 << 27


class EBData(NamedTuple):
    """Cut-cell geometry of one level (tensors on one device).

    vfrac:     (*n) volume fraction in [0, 1]
    afrac:     per dim d the face area fractions (shape +1 in dim d)
    fluid:     (*n) 1 where vfrac > 0, else 0
    covered:   (*n) 1 where vfrac == 0
    regular:   (*n) 1 where the cell and all its faces are full
    aeb_vol:   (*n) wall area per cell volume |A_eb| / V [1/length]
    d_eb:      (*n) first-order wall distance [length]
    merge_dir: (*n) int32 StateRedist merge tracker: -1 no merge, else
               2 d + side, merging with the face neighbour at -/+ e_d
    cent:      per dim the fluid centroid's offset from the cell centre,
               in units of dx (0 in regular and covered cells)
    """

    vfrac: torch.Tensor
    afrac: Tuple[torch.Tensor, ...]
    fluid: torch.Tensor
    covered: torch.Tensor
    regular: torch.Tensor
    aeb_vol: torch.Tensor
    d_eb: torch.Tensor
    merge_dir: Optional[torch.Tensor] = None
    cent: Optional[Tuple[torch.Tensor, ...]] = None


# ---------------------------------------------------------------------------
# implicit functions (x: coordinate tensors that broadcast against each other)


def _sq(a):
    return a * a


def _scalar(x, value):
    """`value` as a 0-d tensor of x's dtype on x's device: dividing by it is
    a true division on the card too (a Python scalar divisor is a
    reciprocal multiply there)."""
    return torch.full((), value, dtype=x.dtype, device=x.device)


def sphere_if(center, radius, fluid_inside: bool) -> Callable:
    c = [float(v) for v in center]

    def psi(*x):
        r2 = sum(_sq(xi - c[d]) for d, xi in enumerate(x[: len(c)]))
        s = radius * radius - r2  # > 0 inside the sphere
        return s if fluid_inside else -s

    return psi


def cylinder_if(center, radius, height, direction: int, fluid_inside: bool):
    """Axis-aligned cylinder (EB2::CylinderIF); height <= 0 is unbounded."""
    c = [float(v) for v in center]

    def psi(*x):
        r2 = sum(_sq(xi - c[d]) for d, xi in enumerate(x) if d != direction)
        s = radius * radius - r2
        if height > 0 and direction < len(x):
            ax = torch.abs(x[direction] - c[direction]) - 0.5 * height
            s = torch.minimum(s, -ax * torch.clamp(torch.abs(s), min=1.0))  # crude cap
        return s if fluid_inside else -s

    return psi


def box_if(lo, hi, fluid_inside: bool):
    lo = [float(v) for v in lo]
    hi = [float(v) for v in hi]

    def psi(*x):
        s = None
        for d, xi in enumerate(x):
            sd = torch.minimum(xi - lo[d], hi[d] - xi)  # > 0 inside the box
            s = sd if s is None else torch.minimum(s, sd)
        return s if fluid_inside else -s

    return psi


def plane_if(point, normal):
    """Half-space: fluid where (x - p) . n < 0 (EB2::PlaneIF)."""
    p = [float(v) for v in point]
    nrm = [float(v) for v in normal]

    def psi(*x):
        return -sum((xi - p[d]) * nrm[d] for d, xi in enumerate(x))

    return psi


def union_bodies(*psis):
    """Union of bodies = intersection of fluids = min of the IFs."""

    def psi(*x):
        out = psis[0](*x)
        for p in psis[1:]:
            out = torch.minimum(out, p(*x))
        return out

    return psi


def intersect_bodies(*psis):
    """Intersection of bodies = max of the IFs."""

    def psi(*x):
        out = psis[0](*x)
        for p in psis[1:]:
            out = torch.maximum(out, p(*x))
        return out

    return psi


def difference_bodies(psi_a, psi_b):
    """Body A minus body B (EB2::makeDifference): fluid where A's fluid or
    inside B."""

    def psi(*x):
        return torch.maximum(psi_a(*x), -psi_b(*x))

    return psi


def union_fluids(*psis):
    """Fluid union = max of the IFs (= body intersection)."""
    return intersect_bodies(*psis)


def lathe_if(psi2d):
    """Revolve a 2D IF around the y axis (EB2::lathe):
    psi3d(x, y, z) = psi2d(sqrt(x^2 + z^2), y)."""

    def psi(*x):
        return psi2d(torch.sqrt(_sq(x[0]) + _sq(x[2])), x[1])

    return psi


def lathe_if_z(psi2d):
    """Revolve a 2D IF around the z axis: psi2d(sqrt(x^2 + y^2), z)."""

    def psi(*x):
        return psi2d(torch.sqrt(_sq(x[0]) + _sq(x[1])), x[2])

    return psi


def polygon_if(points, fluid_inside: bool):
    """2D closed polygon by the crossing-number test (the last point joins
    the first). Only the sign drives the fractions, so the magnitude is the
    distance to the nearest vertex."""
    pts = [(float(a), float(b)) for a, b in points]
    n = len(pts)

    def psi(x, y):
        x, y = torch.broadcast_tensors(x, y)
        inside = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
        for i in range(n):
            x1, y1 = pts[i]
            x2, y2 = pts[(i + 1) % n]
            if y2 == y1:
                continue  # no crossing: the test is false everywhere
            cond = (y1 > y) != (y2 > y)
            xin = x1 + (y - y1) * (x2 - x1) / _scalar(y, y2 - y1)
            inside ^= cond & (x < torch.where(cond, xin, float("inf")))
        d2 = None
        for px, py in pts:
            t = _sq(x - px) + _sq(y - py)
            d2 = t if d2 is None else torch.minimum(d2, t)
        mag = torch.sqrt(d2) + 1e-300
        s = torch.where(inside, mag, -mag)
        return s if fluid_inside else -s

    return psi


# the reentrant piston-bowl profile, (radius, axial) control points
# (NS_init_eb2.cpp reentrant_profile; the quadratic-spline elements are
# their control polygon)
_REENTRANT_PROFILE = [
    (3.6193, 0.78583), (3.5924, 0.77881), (3.5713, 0.75773),
    (3.5643, 0.73083), (3.53, 0.70281), (3.5421, 0.6241),
    (3.482, 0.5686), (3.0539, 0.35043), (2.9677, 0.26577),
    (2.9457, 0.147), (2.8364, -0.57632), (2.7151, -0.68407),
    (2.5694, -0.75555), (2.4035, -0.78586), (2.2358, -0.76902),
    (0.19934, 0.3464), (0.0, 0.3464),
]

# the simplified all-line profile
_LINE_PISTON_PROFILE = [
    (3.6193, 0.78583), (2.4035, -0.78586), (2.0, -0.78586),
    (0.19934, 0.3464), (0.009061, 0.3464), (0.0, 0.3464),
]


def _piston_cylinder_if(profile, scale: float):
    """The Piston-Cylinder bodies: the solid of revolution below the
    profile polyline (closed down the axis), unioned as bodies with all
    outside CylinderIF(4.8, 7.0, dir 2, centre (0, 0, -1)); lengths times
    `scale`."""
    top_r, top_z = 4.9, 0.78583
    pts = [(top_r, top_z)] + list(profile) + [(0.0, -20.0), (top_r, -20.0)]
    pts = [(scale * a, scale * b) for a, b in pts]
    piston_fluid = polygon_if(pts, fluid_inside=False)
    cyl_fluid = cylinder_if((0.0, 0.0, -1.0 * scale), 4.8 * scale, 7.0 * scale, 2,
                            fluid_inside=True)
    return union_bodies(lathe_if_z(piston_fluid), cyl_fluid)


def translate_if(psi0, shift):
    """EB2::translate: psi0 at x - shift."""
    s = [float(v) for v in shift]

    def psi(*x):
        return psi0(*(xi - s[d] for d, xi in enumerate(x)))

    return psi


# ---------------------------------------------------------------------------
# fractions


def _cell_samples(lo, h, n, ss):
    """The ss sub-sample coordinates of each of n cells, lo + (i + (k +
    0.5)/ss) h, as the JAX package forms them (float64 numpy)."""
    offs = (np.arange(ss) + 0.5) / ss
    return (lo + (np.arange(n)[:, None] + offs[None, :]) * h).reshape(-1)


def _count_samples(psi, axes, group, device, moments=False):
    """Per cell, the number of samples with psi > 0: axes[d] holds the
    samples' coordinates along d (float64 numpy), group[d] consecutive ones
    per cell. psi sees dim tensors that broadcast against each other, dim
    0 in slabs of at most SLAB_SAMPLES samples. With moments, also per dim
    the sum of (2 j + 1 - group[d]) over the cell's fluid samples (j the
    sample's index along d). Float64 tensors of exact integers."""
    dim = len(axes)
    n = [len(a) // g for a, g in zip(axes, group)]
    t_axes = [torch.as_tensor(a, dtype=F64, device=device).reshape(
        [-1 if e == d else 1 for e in range(dim)]) for d, a in enumerate(axes)]
    per_cell = group[0] * int(np.prod([len(a) for a in axes[1:]]))
    k = max(1, SLAB_SAMPLES // per_cell)
    sub_axes = tuple(2 * d + 1 for d in range(dim))
    weights = [
        (2.0 * torch.arange(g, dtype=F64, device=device) + 1.0 - g).reshape(
            [g if a == 2 * d + 1 else 1 for a in range(2 * dim)])
        for d, g in enumerate(group)
    ] if moments else []
    counts, sums = [], [[] for _ in range(dim)]
    for start in range(0, n[0], k):
        m = min(k, n[0] - start)
        xs = [t_axes[0].narrow(0, start * group[0], m * group[0])] + t_axes[1:]
        shape = [m * group[0]] + [len(a) for a in axes[1:]]
        inside = torch.broadcast_to(psi(*xs) > 0.0, shape)
        split = []
        for d in range(dim):
            split += [m if d == 0 else n[d], group[d]]
        v = inside.reshape(split).to(F64)
        counts.append(v.sum(dim=sub_axes))
        for d, w in enumerate(weights):
            sums[d].append((v * w).sum(dim=sub_axes))
    count = torch.cat(counts)
    if not moments:
        return count
    return count, [torch.cat(s) for s in sums]


def _face_fraction(psi, geom: Geometry, d: int, ss: int, device):
    """Area fraction of the faces of dim d (sampled in the face plane)."""
    axes, group = [], []
    for t in range(geom.dim):
        if t == d:
            axes.append(geom.prob_lo[d] + np.arange(geom.ncell[d] + 1) * geom.dx[d])
            group.append(1)
        else:
            axes.append(_cell_samples(geom.prob_lo[t], geom.dx[t], geom.ncell[t], ss))
            group.append(ss)
    count = _count_samples(psi, axes, group, device)
    return count / _scalar(count, float(ss ** (geom.dim - 1)))


def _cover_faces(a, d, n, cov):
    """Zero the faces of dim d that bound a covered cell."""
    a = a.clone()
    lo, hi = a.narrow(d, 0, n), a.narrow(d, 1, n)
    lo.copy_(torch.where(cov, 0.0, lo))
    hi.copy_(torch.where(cov, 0.0, hi))
    return a


def build_eb_geometry(psi, geom: Geometry, ss: int = 8, dtype="float64",
                      device=None) -> EBData:
    """Evaluate a fluid-positive implicit function into EBData on `device`
    (default: the card, cuda:0; built in float64, cast to `dtype`)."""
    device = CUDA if device is None else torch.device(device)
    dim = geom.dim
    n = geom.ncell
    axes = [_cell_samples(geom.prob_lo[d], geom.dx[d], n[d], ss) for d in range(dim)]
    count, sums = _count_samples(psi, axes, [ss] * dim, device, moments=True)
    vfrac = count / _scalar(count, float(ss ** dim))
    cents = [torch.where(vfrac > 0.0, s / _scalar(s, float(2 * ss ** (dim + 1)))
                         / torch.clamp(vfrac, min=1e-300), 0.0) for s in sums]
    # snap nearly full / empty cells (sampling noise)
    vfrac = torch.where(vfrac > 1.0 - 0.5 / ss ** dim, 1.0, vfrac)
    vfrac = torch.where(vfrac < 0.5 / ss ** dim, 0.0, vfrac)
    snapped = (vfrac == 1.0) | (vfrac == 0.0)
    cents = [torch.where(snapped, 0.0, c) for c in cents]
    cov = vfrac == 0.0
    afrac = []
    for d in range(dim):
        a = _face_fraction(psi, geom, d, ss, device)
        a = torch.where(a > 1.0 - 0.5 / ss ** (dim - 1), 1.0, a)
        a = torch.where(a < 0.5 / ss ** (dim - 1), 0.0, a)
        # the faces of covered cells are covered
        afrac.append(_cover_faces(a, d, n[d], cov))

    fluid = (vfrac > 0.0).to(F64)
    covered = 1.0 - fluid
    regular = (vfrac == 1.0).to(F64)
    s2 = torch.zeros_like(vfrac)
    for d in range(dim):
        a_lo, a_hi = afrac[d].narrow(d, 0, n[d]), afrac[d].narrow(d, 1, n[d])
        regular = regular * ((a_lo == 1.0) & (a_hi == 1.0))
        # the wall area from the divergence theorem over the cut cell:
        # A_eb n_d = (afrac_hi - afrac_lo) V / dx_d
        q = (a_hi - a_lo) / _scalar(a_hi, geom.dx[d])
        s2 = s2 + q * q
    aeb_vol = torch.sqrt(s2) * (vfrac > 0.0) * (vfrac < 1.0)
    # first-order wall distance: half a cell, shrunk in small cells
    d_eb = 0.5 * min(geom.dx) * torch.clamp(vfrac, 0.25, 1.0)

    # StateRedist merge tracker: each small cut cell (0 < vfrac < 0.5)
    # merges with its largest-volume face neighbour
    small = (vfrac > 0.0) & (vfrac < 0.5)
    merge_dir = torch.full(n, -1, dtype=torch.int32, device=device)
    best_vf = torch.zeros_like(vfrac)
    for d in range(dim):
        for side in (0, 1):
            shift = -1 if side == 0 else 1
            nb = torch.roll(vfrac, -shift, d)
            if not geom.periodic[d]:
                # the wrapped row is not a neighbour
                nb.narrow(d, n[d] - 1 if shift == 1 else 0, 1).zero_()
            better = small & (nb > best_vf) & (nb > vfrac)
            merge_dir = torch.where(better, 2 * d + side, merge_dir)
            best_vf = torch.where(better, nb, best_vf)

    td = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return EBData(
        vfrac=vfrac.to(td), afrac=tuple(a.to(td) for a in afrac), fluid=fluid.to(td),
        covered=covered.to(td), regular=regular.to(td), aeb_vol=aeb_vol.to(td),
        d_eb=d_eb.to(td), merge_dir=merge_dir, cent=tuple(c.to(td) for c in cents),
    )


def eb_from_inputs(pp, geom: Geometry, dtype="float64", ss: int = 8, device=None):
    """EBData of the eb2.* inputs on `device` (default: the card, cuda:0),
    or None without EB (eb2.geom_type absent or all_regular)."""
    psi = psi_from_inputs(pp, geom.dim)
    if psi is None:
        return None
    return build_eb_geometry(psi, geom, ss=ss, dtype=dtype, device=device)


def _floats(values):
    return [float(x) for x in values]


def psi_from_inputs(pp, dim: int):
    """The fluid-positive implicit function of the eb2.* inputs (the
    catalog of NS_init_eb2.cpp, or a name registered with
    plugins.eb_geometry), or None without EB."""
    eb2 = pp.scoped("eb2")
    gt = eb2.query("geom_type")
    if gt is None or str(gt) == "all_regular":
        return None
    gt = str(gt)
    if gt == "sphere":
        center = _floats(eb2.queryarr("sphere_center", [0.0] * dim))
        radius = float(eb2.query("sphere_radius", 0.1))
        inside = eb2.query_bool("sphere_has_fluid_inside", True)
        return sphere_if(center[:dim], radius, inside)
    if gt == "cylinder":
        center = _floats(eb2.queryarr("cylinder_center", [0.0] * dim))
        radius = float(eb2.query("cylinder_radius", 0.1))
        height = float(eb2.query("cylinder_height", -1.0))
        direction = int(eb2.query("cylinder_direction", dim - 1))
        inside = eb2.query_bool("cylinder_has_fluid_inside", True)
        return cylinder_if(center[:dim], radius, height, direction, inside)
    if gt == "box":
        lo = _floats(eb2.queryarr("box_lo", [0.0] * dim))
        hi = _floats(eb2.queryarr("box_hi", [1.0] * dim))
        inside = eb2.query_bool("box_has_fluid_inside", True)
        return box_if(lo[:dim], hi[:dim], inside)
    if gt == "plane":
        point = _floats(eb2.queryarr("plane_point", [0.0] * dim))
        normal = _floats(eb2.queryarr("plane_normal", [1.0] + [0.0] * (dim - 1)))
        return plane_if(point[:dim], normal[:dim])
    if gt == "Inflow-Pipe":
        # a fat pipe with a thinner inflow pipe bored through its wall:
        # fluid inside either cylinder
        pipe = pp.scoped("pipe")
        cyl1 = cylinder_if(_floats(pipe.getarr("center1"))[:dim],
                           float(pipe.query("radius1", 0.018)),
                           float(pipe.query("height1", 0.01)),
                           int(pipe.query("direction1", 2)), fluid_inside=True)
        cyl2 = cylinder_if(_floats(pipe.getarr("center2"))[:dim],
                           float(pipe.query("radius2", 0.007)),
                           float(pipe.query("height2", 0.01)),
                           int(pipe.query("direction2", 2)), fluid_inside=True)
        return union_fluids(cyl1, cyl2)
    if gt == "Mixing-Pipe":
        # one cylinder; internal_flow picks the fluid inside (pipe flow) or
        # outside (flow past a rod)
        pipe = pp.scoped("pipe")
        return cylinder_if(_floats(pipe.getarr("center"))[:dim],
                           float(pipe.query("radius", 0.018)),
                           float(pipe.query("height", 0.01)),
                           int(pipe.query("direction", 1)),
                           fluid_inside=pipe.query_bool("internal_flow", True))
    if gt == "Square-Grid":
        # the square-grid turbulence generator: a square frame, a big box
        # less its small-box core
        sg = pp.scoped("square_grid")
        L0 = float(sg.query("dim_L0", 0.08))
        t0 = float(sg.query("ratio_t0_L0_cross", 0.11)) * L0
        sl = t0 * float(sg.query("ratio_t0_stream_thickness", 1.0))
        pos_big, pos_small = 0.5 * (L0 + t0), 0.5 * (L0 - t0)
        big = box_if((0.0, -pos_big, -pos_big), (sl, pos_big, pos_big), fluid_inside=False)
        small = box_if((0.0, -pos_small, -pos_small), (sl, pos_small, pos_small),
                       fluid_inside=False)
        return difference_bodies(big, small)
    if gt in ("Piston-Cylinder", "Line-Piston-Cylinder"):
        # a reentrant piston bowl revolved around z inside a cylinder body;
        # 3D only, as in the reference
        if dim != 3:
            raise ValueError(f"geom_type '{gt}' only available in 3D")
        if gt == "Piston-Cylinder":
            return _piston_cylinder_if(_REENTRANT_PROFILE, scale=1.0)
        return _piston_cylinder_if(_LINE_PISTON_PROFILE, scale=0.0025)
    if gt == "combustor":
        # an axisymmetric combustor: a 2D section (far wall, ramp, pipe,
        # flat corner) revolved around the axial direction and moved to the
        # domain's centre
        cb = pp.scoped("combustor")
        fwl = float(cb.get("far_wall_loc"))
        p1 = _floats(cb.getarr("ramp_plane1_point"))
        p2 = _floats(cb.getarr("ramp_plane2_point"))
        n2 = _floats(cb.getarr("ramp_plane2_normal"))
        p3 = _floats(cb.getarr("ramp_plane3_point"))
        geo = pp.scoped("geometry")
        plo = _floats(geo.queryarr("prob_lo", [0.0] * 3))
        phi_ = _floats(geo.queryarr("prob_hi", [1.0] * 3))
        farwall = plane_if((fwl, 0.0), (1.0, 0.0))
        ramp = intersect_bodies(
            plane_if((p1[0], p1[1]), (0.0, -1.0)),
            plane_if((p2[0], p2[1]), (n2[0], n2[1])),
            plane_if((p3[0], p3[1]), (1.0, 0.0)),
        )
        k2 = abs(n2[0] / max(abs(n2[1]), 1e-300))
        secty = p2[1] + k2 * (p3[0] - p2[0])
        pipe_lo, pipe_hi = _floats(cb.getarr("pipe_lo")), _floats(cb.getarr("pipe_hi"))
        pipe = box_if((pipe_lo[0], pipe_lo[1]), (pipe_hi[0], pipe_hi[1]), fluid_inside=False)
        flat = box_if((p3[0], 0.0), (1e10, secty), fluid_inside=False)
        poly2d = union_bodies(farwall, ramp, pipe, flat)
        return translate_if(lathe_if(poly2d),
                            (0.5 * (phi_[0] - plo[0]), 0.5 * (phi_[1] - plo[1]), 0.0))
    if gt in plugins.EB_GEOMETRIES:
        # the user seam (EB2 UserDefined; plugins.eb_geometry)
        return plugins.EB_GEOMETRIES[gt](pp, dim)
    raise NotImplementedError(
        f"eb2.geom_type = {gt} not implemented (supported: all_regular, sphere, "
        "cylinder, box, plane, Inflow-Pipe, Mixing-Pipe, Square-Grid, combustor, "
        "Piston-Cylinder, Line-Piston-Cylinder, or a name registered via "
        "iamr_tpu_torch.plugins.eb_geometry)")
