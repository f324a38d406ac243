"""Error tagging and regridding of single-box levels (counterpart of
iamr_tpu/amr/tagging.py without regrid_hierarchy).

The reference's refinement machinery (NS_error.cpp): indicators from
amr.refinement_indicators (value_greater, value_less, vorticity_greater,
adjacent_difference_greater, in_box), each on a state or derived field
with optional start/end times, a max level and a RealBox. Tags go to the
host (numpy) at regrid steps only; they are clustered by Berger-Rigoutsos
(berger_rigoutsos, a numpy copy of the JAX package's native C++ clustering
that gives the same boxes), buffered by n_error_buf and aligned to the
blocking factor. regrid_fine_state moves a fine state onto a new patch
(interpolated from the coarse level, the old fine data where the patches
overlap). The dynamic regrid of hierarchies of more than two levels
(regrid_hierarchy) works on multi-box levels and is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from iamr_tpu_torch.amr.hierarchy import LevelSpec
from iamr_tpu_torch.amr.multilevel import init_fine_from_coarse
from iamr_tpu_torch.config.parmparse import ParmParse
from iamr_tpu_torch.core.bc import PhysBC
from iamr_tpu_torch.ns.derive import derive, mag_vort
from iamr_tpu_torch.ns.state import NSConfig, NSState


@dataclasses.dataclass(frozen=True)
class ErrorTag:
    """One refinement indicator (AMRErrorTag). values: per-level thresholds
    (level l takes values[min(l, len - 1)]); in_box: an optional (lo, hi)
    physical RealBox gating the tags (amr.<name>.in_box_lo/hi), which with
    test "in_box" is the indicator itself."""

    field: str
    test: str  # value_greater | value_less | adjacent_difference_greater | vorticity_greater | in_box
    values: tuple = (0.0,)
    start_time: float = -1e200
    end_time: float = 1e200
    max_level: int = 10
    in_box: tuple = ()

    @property
    def value(self) -> float:
        return self.values[0]

    def value_at(self, level: int) -> float:
        return self.values[min(level, len(self.values) - 1)]


def parse_refinement_indicators(pp: ParmParse) -> List[ErrorTag]:
    """amr.refinement_indicators = name1 name2 ...; amr.name1.field_name and
    its test, times, max_level and box."""
    tags = []
    for name in pp.scoped("amr").queryarr("refinement_indicators", []):
        sc = pp.scoped(f"amr.{name}")
        field = str(sc.query("field_name", name))
        in_box = ()
        if sc.contains("in_box_lo"):
            in_box = (tuple(float(v) for v in sc.getarr("in_box_lo")),
                      tuple(float(v) for v in sc.getarr("in_box_hi")))

        def vals(key):
            return tuple(float(v) for v in sc.getarr(key))

        if sc.contains("value_greater"):
            test, values = "value_greater", vals("value_greater")
        elif sc.contains("value_less"):
            test, values = "value_less", vals("value_less")
        elif sc.contains("adjacent_difference_greater"):
            test, values = "adjacent_difference_greater", vals("adjacent_difference_greater")
        elif sc.contains("vorticity_greater"):
            test, values = "vorticity_greater", vals("vorticity_greater")
            field = "mag_vort"
        elif in_box:
            test, values = "in_box", (0.0,)
        else:
            raise ValueError(f"refinement indicator {name}: no test given")
        tags.append(ErrorTag(
            field=field, test=test, values=values,
            start_time=float(sc.query("start_time", -1e200)),
            end_time=float(sc.query("end_time", 1e200)),
            max_level=int(sc.query("max_level", 10)), in_box=in_box))
    return tags


def _realbox_mask(cfg: NSConfig, in_box, device):
    """The cell-centre mask of a physical RealBox."""
    lo, hi = in_box
    geom = cfg.geom
    m = None
    for d in range(cfg.dim):
        x = geom.prob_lo[d] + (np.arange(geom.ncell[d]) + 0.5) * geom.dx[d]
        shape = [1] * cfg.dim
        shape[d] = geom.ncell[d]
        md = ((x >= lo[d]) & (x <= hi[d])).reshape(shape)
        m = md if m is None else m & md
    return torch.as_tensor(np.broadcast_to(m, tuple(geom.ncell)).copy(), device=device)


def _get_field(cfg: NSConfig, state: NSState, name: str):
    if name in ("density", "rho"):
        return state.rho
    if name == "tracer":
        return state.trac[0]
    if name in ("temp", "temperature"):
        return state.temp
    if name in ("x_velocity", "y_velocity", "z_velocity"):
        return state.vel["xyz".index(name[0])]
    if name == "mag_vort":
        return mag_vort(cfg, state)
    return derive(cfg, state, name)


def tag_cells(cfg: NSConfig, state: NSState, tags: List[ErrorTag], level: int = 0):
    """The boolean tag tensor over the level (errorEst), on the state's
    device. level gates each tag's max_level and picks its threshold. Reads
    the state's time back to the host."""
    dev = state.rho.device
    out = torch.zeros(cfg.geom.ncell, dtype=torch.bool, device=dev)
    t = float(state.time)
    for tag in tags:
        if not (tag.start_time <= t <= tag.end_time) or level >= tag.max_level:
            continue
        val = tag.value_at(level)
        if tag.test == "in_box":
            out = out | _realbox_mask(cfg, tag.in_box, dev)
            continue
        f = _get_field(cfg, state, tag.field)
        if tag.test in ("value_greater", "vorticity_greater"):
            m = f > val
        elif tag.test == "value_less":
            m = f < val
        elif tag.test == "adjacent_difference_greater":
            m = torch.zeros_like(out)
            for d in range(cfg.dim):
                # the differences zero-padded on each side, then compared
                df = torch.abs(torch.diff(f, dim=d))
                shp = list(df.shape)
                shp[d] = 1
                pad = torch.zeros(shp, dtype=df.dtype, device=dev)
                m = m | (torch.cat([df, pad], dim=d) > val) | (torch.cat([pad, df], dim=d) > val)
        else:
            raise ValueError(tag.test)
        if tag.in_box:
            m = m & _realbox_mask(cfg, tag.in_box, dev)
        out = out | m
    return out


def _grow_to_min(a, b, n, bf, ratio, min_size):
    """Grow [a, b) by whole blocking units (then single cells at the
    domain's ends) until it spans min_size fine cells."""
    while (b - a) * ratio < min_size:
        if a >= bf:
            a -= bf
        elif b <= n - bf:
            b += bf
        elif a > 0:
            a -= 1
        elif b < n:
            b += 1
        else:
            break
    return a, b


def cluster_to_patch(tags_np: np.ndarray, ratio: int, n_error_buf: int = 1,
                     blocking_factor: int = 4, min_size: int = 8) -> Optional[LevelSpec]:
    """Bounding-box clustering of the tagged coarse cells into one fine
    LevelSpec (None without tags), buffered, aligned to the blocking factor
    and at least min_size fine cells wide."""
    if not tags_np.any():
        return None
    dim = tags_np.ndim
    lo, hi = [], []
    bf = max(1, blocking_factor // ratio)
    for d in range(dim):
        idx = np.nonzero(tags_np.any(axis=tuple(e for e in range(dim) if e != d)))[0]
        a = max(0, int(idx[0]) - n_error_buf)
        b = min(tags_np.shape[d], int(idx[-1]) + 1 + n_error_buf)
        a = (a // bf) * bf
        b = min(-((-b) // bf) * bf, tags_np.shape[d])
        a = min(a, b - 1)
        a, b = _grow_to_min(a, b, tags_np.shape[d], bf, ratio, min_size)
        lo.append(a * ratio)
        hi.append(b * ratio)
    return LevelSpec(lo=tuple(lo), ncell=tuple(h - l for l, h in zip(lo, hi)), ratio=ratio)


def regrid_fine_state(cfg: NSConfig, old_spec: Optional[LevelSpec], new_spec: LevelSpec,
                      crse: NSState, fine_old: Optional[NSState]) -> NSState:
    """The fine state on a new patch: interpolated from the coarse level,
    then the overlap copied from the previous fine level (init(old)); time
    and dt from the old fine state."""
    new = init_fine_from_coarse(cfg, new_spec, crse)
    if fine_old is None or old_spec is None:
        return new
    dim = cfg.dim
    lo = [max(old_spec.lo[d], new_spec.lo[d]) for d in range(dim)]
    hi = [min(old_spec.lo[d] + old_spec.ncell[d], new_spec.lo[d] + new_spec.ncell[d])
          for d in range(dim)]
    if any(h <= l for l, h in zip(lo, hi)):
        return new
    src = tuple(slice(lo[d] - old_spec.lo[d], hi[d] - old_spec.lo[d]) for d in range(dim))
    dst = tuple(slice(lo[d] - new_spec.lo[d], hi[d] - new_spec.lo[d]) for d in range(dim))

    def paste(new_a, old_a, ncomp_axis=False, node=False):
        s, t = src, dst
        if node:
            s = tuple(slice(x.start, x.stop + 1) for x in s)
            t = tuple(slice(x.start, x.stop + 1) for x in t)
        if ncomp_axis:
            s, t = (slice(None),) + s, (slice(None),) + t
        out = new_a.clone()
        out[t] = old_a[s]
        return out

    return new._replace(
        vel=paste(new.vel, fine_old.vel, True), rho=paste(new.rho, fine_old.rho),
        trac=paste(new.trac, fine_old.trac, True), temp=paste(new.temp, fine_old.temp),
        gradp=paste(new.gradp, fine_old.gradp, True), p=paste(new.p, fine_old.p, node=True),
        time=fine_old.time, dt=fine_old.dt)


# ---------------------------------------------------------------------------
# Berger-Rigoutsos clustering (numpy copy of native/iamr_native.cpp's
# iamr_br_cluster, the same boxes)


def _shrink_to_tags(tags, lo, hi):
    """The bounding box of the tags inside [lo, hi] (inclusive), or None."""
    sub = tags[tuple(slice(a, b + 1) for a, b in zip(lo, hi))]
    if not sub.any():
        return None
    dim = tags.ndim
    nlo, nhi = [], []
    for d in range(dim):
        idx = np.nonzero(sub.any(axis=tuple(e for e in range(dim) if e != d)))[0]
        nlo.append(lo[d] + int(idx[0]))
        nhi.append(lo[d] + int(idx[-1]))
    return nlo, nhi


def _signature(tags, lo, hi, d):
    sub = tags[tuple(slice(a, b + 1) for a, b in zip(lo, hi))]
    return sub.sum(axis=tuple(e for e in range(tags.ndim) if e != d), dtype=np.int64)


def _br_split(tags, lo, hi, min_width, min_eff, out, depth):
    """The recursive split: a hole (zero plane) first, then the strongest
    inflection of the signature's Laplacian, then the midpoint of the
    longest side; stop when the box is efficient enough, small or deep."""
    box = _shrink_to_tags(tags, lo, hi)
    if box is None:
        return
    lo, hi = box
    dim = tags.ndim
    lens = [hi[d] - lo[d] + 1 for d in range(dim)]
    nt = int(tags[tuple(slice(a, b + 1) for a, b in zip(lo, hi))].sum(dtype=np.int64))
    eff = float(nt) / float(np.prod(lens, dtype=np.int64))
    small_enough = all(n <= 2 * min_width for n in lens)
    if eff >= min_eff or depth > 24 or small_enough:
        out.append((tuple(lo), tuple(hi)))
        return
    best_d = best_cut = -1
    # 1) a hole in a signature
    for d in range(dim):
        if best_d >= 0:
            break
        n = lens[d]
        if n < 2 * min_width:
            continue
        sig = _signature(tags, lo, hi, d)
        for c in range(min_width, n - min_width + 1):
            if sig[c] == 0:
                best_d, best_cut = d, c
                break
    # 2) the strongest inflection point of the signature's Laplacian
    if best_d < 0:
        best_mag = -1
        for d in range(dim):
            n = lens[d]
            if n < 2 * min_width:
                continue
            sig = _signature(tags, lo, hi, d)
            lap = np.zeros(n, dtype=np.int64)
            lap[1:n - 1] = sig[2:] - 2 * sig[1:n - 1] + sig[:n - 2]
            for c in range(min_width, n - min_width):
                if (lap[c] > 0 and lap[c + 1] < 0) or (lap[c] < 0 and lap[c + 1] > 0):
                    mag = abs(int(lap[c + 1]) - int(lap[c]))
                    if mag > best_mag:
                        best_mag, best_d, best_cut = mag, d, c + 1
    # 3) the midpoint of the longest splittable side
    if best_d < 0:
        longest = -1
        for d in range(dim):
            if lens[d] >= 2 * min_width and lens[d] > longest:
                longest, best_d, best_cut = lens[d], d, lens[d] // 2
    if best_d < 0:
        out.append((tuple(lo), tuple(hi)))
        return
    left_hi, right_lo = list(hi), list(lo)
    left_hi[best_d] = lo[best_d] + best_cut - 1
    right_lo[best_d] = lo[best_d] + best_cut
    _br_split(tags, lo, left_hi, min_width, min_eff, out, depth + 1)
    _br_split(tags, right_lo, hi, min_width, min_eff, out, depth + 1)


def berger_rigoutsos(tags: np.ndarray, min_width: int = 4, min_eff: float = 0.7,
                     max_boxes: int = 1024):
    """Cluster a boolean tag array (2D or 3D) into boxes covering every tag,
    each with a tagged fraction of at least min_eff where it can be split.
    Returns [(lo, hi)] index tuples, hi inclusive, at most max_boxes."""
    t = np.ascontiguousarray(tags.astype(np.uint8))
    if t.ndim not in (2, 3) or min_width < 1:
        raise ValueError("berger_rigoutsos: 2D or 3D tags and min_width >= 1")
    out = []
    _br_split(t, [0] * t.ndim, [n - 1 for n in t.shape], min_width, min_eff, out, 0)
    return out[:max_boxes]


def cluster_to_patches(tags_np, ratio: int, n_error_buf: int = 1, blocking_factor: int = 4,
                       min_size: int = 8, max_boxes: int = 8, min_eff: float = 0.7):
    """Berger-Rigoutsos clustering of the tagged coarse cells into fine
    patches (the reference's regrid box generation): the tags buffered by
    n_error_buf (without wrapping across the domain), clustered, each box
    aligned to the blocking factor and grown to min_size, duplicates
    dropped and boxes whose union is a rectangle merged (coalesce_specs).
    Returns a list of LevelSpec (empty without tags). The JAX package
    falls back to cluster_to_patch when its native library is not built;
    the port's clustering is always there."""
    if not tags_np.any():
        return []
    t = tags_np.astype(bool)

    def shift(arr, d, off):
        out = np.zeros_like(arr)
        src, dst = [slice(None)] * arr.ndim, [slice(None)] * arr.ndim
        if off > 0:
            src[d], dst[d] = slice(None, -off), slice(off, None)
        else:
            src[d], dst[d] = slice(-off, None), slice(None, off)
        out[tuple(dst)] = arr[tuple(src)]
        return out

    for d in range(t.ndim):
        for _ in range(n_error_buf):
            t = t | shift(t, d, 1) | shift(t, d, -1)
    boxes = berger_rigoutsos(t, min_width=max(2, min_size // (2 * ratio)), min_eff=min_eff,
                             max_boxes=max_boxes)
    dim = tags_np.ndim
    bf = max(1, blocking_factor // ratio)
    specs = []
    for lo, hi in boxes:
        a, b = [], []
        for d in range(dim):
            hi_d = min(-((-(hi[d] + 1)) // bf) * bf, tags_np.shape[d])
            lo_d = min((lo[d] // bf) * bf, hi_d - 1)
            lo_d, hi_d = _grow_to_min(lo_d, hi_d, tags_np.shape[d], bf, ratio, min_size)
            a.append(lo_d * ratio)
            b.append(hi_d * ratio)
        specs.append(LevelSpec(lo=tuple(a), ncell=tuple(bb - aa for aa, bb in zip(a, b)),
                               ratio=ratio))
    uniq = []
    for s in specs:
        if s not in uniq:
            uniq.append(s)
    return coalesce_specs(uniq)


def coalesce_specs(specs):
    """Merge boxes whose union is a rectangle into one box (greedy, to a
    fixpoint): one big box wherever the union allows it, so that every
    solve on the merged patch is level-wide."""
    out = list(specs)
    merged = True
    while merged and len(out) > 1:
        merged = False
        for i in range(len(out)):
            for j in range(i + 1, len(out)):
                a, b = out[i], out[j]
                if a.ratio != b.ratio:
                    continue
                diff = [d for d in range(a.dim)
                        if not (a.lo[d] == b.lo[d] and a.ncell[d] == b.ncell[d])]
                if len(diff) != 1:
                    continue
                d = diff[0]
                lo_a, hi_a = a.lo[d], a.lo[d] + a.ncell[d]
                lo_b, hi_b = b.lo[d], b.lo[d] + b.ncell[d]
                if hi_a == lo_b or hi_b == lo_a:
                    nlo, nn = list(a.lo), list(a.ncell)
                    nlo[d] = min(lo_a, lo_b)
                    nn[d] = max(hi_a, hi_b) - nlo[d]
                    out[i] = LevelSpec(lo=tuple(nlo), ncell=tuple(nn), ratio=a.ratio)
                    out.pop(j)
                    merged = True
                    break
            if merged:
                break
    return out


def apply_outflow_tag_policy(cfg, tags_np: np.ndarray, do_refine: bool = False,
                             do_derefine: bool = True, nbuf: int = 1):
    """manual_tags_placement at every outflow face: tag the whole boundary
    strip when any tag sits within one cell of it (do_refine_outflow), or
    clear the tags within nbuf cells of it (do_derefine_outflow, the
    default) so that the fine level stays off the outflow boundary."""
    out = np.array(tags_np)
    dim = out.ndim
    for d in range(dim):
        for side in (0, 1):
            kind = cfg.dom.phys_lo[d] if side == 0 else cfg.dom.phys_hi[d]
            if kind != PhysBC.Outflow:
                continue
            strip = [slice(None)] * dim
            strip[d] = slice(0, nbuf) if side == 0 else slice(-nbuf, None)
            if do_refine and not do_derefine:
                near = [slice(None)] * dim
                near[d] = slice(0, nbuf + 1) if side == 0 else slice(-(nbuf + 1), None)
                if out[tuple(near)].any():
                    out[tuple(strip)] = True
            elif do_derefine:
                out[tuple(strip)] = False
    return out
