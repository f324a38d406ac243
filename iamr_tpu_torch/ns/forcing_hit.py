"""Spectral turbulent forcing for HIT (homogeneous isotropic turbulence)
(counterpart of iamr_tpu/ns/forcing_hit.py).

Low-wavenumber modes k with |k| <= nmodes/Lmin, each with a random temporal
frequency and phase (xT = cos(omega t + psi)), random spatial phases and a
k^-2 shell-spectrum amplitude; the divergence-free variant is the curl of
A_c = FA_c * prod_d sin(2 pi k_d x_d / L_d + phi_{c,d}). Every mode term is
separable, so the sum over modes is an einsum over per-dimension 1D trig
tables. The mode tables are numpy, made exactly as the JAX package makes
them (same generator and seed), so both packages force identically.

The einsum is a library matrix product; its f32 result is exact f32 only
with TF32 off, so eval refuses to run on CUDA while
torch.backends.cuda.matmul.allow_tf32 is set.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from iamr_tpu_torch.core.geometry import Geometry


@dataclasses.dataclass(frozen=True)
class HITForcing:
    """Mode tables (host numpy)."""

    k: np.ndarray          # (nm, 3) integer wavenumbers
    omega: np.ndarray      # (nm,) temporal frequency * 2pi
    psi: np.ndarray        # (nm,) temporal phase
    amp: np.ndarray        # (nm, 3) per-component amplitude (FA)
    phases: np.ndarray     # (nm, 3, 3) phi[c, d] potential phases (div-free)
    phases_simple: np.ndarray  # (nm, 3) FPX/FPY/FPZ (non-div-free path)
    L: Tuple[float, float, float]
    div_free: bool
    # device copies of the tables per (geometry, dtype, device), made on the
    # first eval there: a host-to-device copy waits for the stream, so the
    # step makes none
    _on_device: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @classmethod
    def create(
        cls,
        geom: Geometry,
        nmodes: int = 4,
        div_free: bool = True,
        spectrum_type: int = 2,
        mode_start: int = 0,
        forcing_time_scale_min: float = 0.5,
        forcing_time_scale_max: float = 1.0,
        force_scale: float = 1.0,
        moderate_zero_modes: bool = True,
        seed: int = 111397,
    ) -> "HITForcing":
        if geom.dim != 3:
            raise ValueError("HIT forcing is 3D-only")
        L = tuple(hi - lo for lo, hi in zip(geom.prob_lo, geom.prob_hi))
        Lmin = min(L)
        kappa_max = nmodes / Lmin + 1e-8
        steps = [int(Ld / Lmin + 0.5) for Ld in L]
        nmax = [nmodes * s for s in steps]

        rng = np.random.default_rng(seed)
        ks, omegas, psis, amps, phases, phases_s = [], [], [], [], [], []
        freq_min = 1.0 / forcing_time_scale_max
        freq_diff = 1.0 / forcing_time_scale_min - freq_min
        for kz in range(mode_start * steps[2], nmax[2] + 1, steps[2]):
            for ky in range(mode_start * steps[1], nmax[1] + 1, steps[1]):
                for kx in range(mode_start * steps[0], nmax[0] + 1, steps[0]):
                    kappa = np.sqrt(
                        (kx / L[0]) ** 2 + (ky / L[1]) ** 2 + (kz / L[2]) ** 2
                    )
                    if kappa > kappa_max or kappa < 1e-6:
                        continue
                    omegas.append((freq_min + freq_diff * rng.random()) * 2 * np.pi)
                    psis.append(rng.random() * 2 * np.pi)
                    phases_s.append(rng.random(3) * 2 * np.pi)
                    phases.append(rng.random((3, 3)) * 2 * np.pi)
                    theta = rng.random() * 2 * np.pi
                    phi = rng.random() * np.pi
                    p = np.array([
                        np.cos(theta) * np.sin(phi),
                        np.sin(theta) * np.sin(phi),
                        np.cos(phi),
                    ])
                    if spectrum_type == 1:
                        ekh = 1.0 / kappa
                    elif spectrum_type == 2:
                        ekh = 1.0 / (kappa * kappa)
                    else:
                        ekh = 1.0
                    if div_free:
                        ekh /= kappa
                    if moderate_zero_modes:
                        for kk in (kx, ky, kz):
                            if kk == 0:
                                ekh /= 2.0
                    amps.append(force_scale * p * ekh / (p @ p))
                    ks.append([kx, ky, kz])
        return cls(
            k=np.asarray(ks, dtype=np.float64),
            omega=np.asarray(omegas),
            psi=np.asarray(psis),
            amp=np.asarray(amps),
            phases=np.asarray(phases),
            phases_simple=np.asarray(phases_s),
            L=L,
            div_free=div_free,
        )

    def eval(self, geom: Geometry, time, dtype=torch.float32, device=None):
        """Force field (3, nx, ny, nz) at `time` (a 0-d tensor or a float),
        on `device` (default: time's device; the card, cuda:0, for a float)."""
        if device is None:
            device = time.device if isinstance(time, torch.Tensor) else "cuda:0"
        device = torch.device(device)
        if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("HITForcing.eval needs torch.backends.cuda."
                               "matmul.allow_tf32 = False (full-f32 einsum)")

        tab = self._tables(geom, dtype, device)
        xs, karg = tab["xs"], tab["karg"]
        xT = torch.cos(tab["omega"] * time + tab["psi"])

        def trig_table(c, d, kind):
            """sin/cos(2 pi k_d x_d / L_d + phi[c,d]) as (nm, n_d)."""
            phi = tab["phases"][:, c, d] if c >= 0 else tab["phases_simple"][:, d]
            arg = karg[d][:, None] * xs[d][None, :] + phi[:, None]
            return torch.sin(arg) if kind == "s" else torch.cos(arg)

        def contract(coef, tabs):
            return torch.einsum("m,mi,mj,mk->ijk", coef, tabs[0], tabs[1], tabs[2])

        if self.div_free:
            # f = curl(A): each component is dA(c1,d1) - dA(c2,d2), both terms
            # in one einsum by concatenating their mode tables
            def dA_parts(c, d, sign):
                coef = sign * xT * tab["amp"][:, c] * karg[d]
                tabs = [trig_table(c, e, "c" if e == d else "s") for e in range(3)]
                return coef, tabs

            def curl_comp(t1, t2):
                (ca, ta), (cb, tb) = t1, t2
                coef = torch.cat([ca, cb])
                tabs = [torch.cat([ta[e], tb[e]], dim=0) for e in range(3)]
                return contract(coef, tabs)

            fx = curl_comp(dA_parts(2, 1, 1.0), dA_parts(1, 2, -1.0))
            fy = curl_comp(dA_parts(0, 2, 1.0), dA_parts(2, 0, -1.0))
            fz = curl_comp(dA_parts(1, 0, 1.0), dA_parts(0, 1, -1.0))
        else:
            def comp(c):
                coef = xT * tab["amp"][:, c]
                tabs = [trig_table(-1, e, "c" if e == c else "s") for e in range(3)]
                return contract(coef, tabs)

            fx, fy, fz = comp(0), comp(1), comp(2)
        return torch.stack([fx, fy, fz])

    def _tables(self, geom: Geometry, dtype, device):
        key = (geom.ncell, geom.prob_lo, geom.prob_hi, dtype, device)
        if key not in self._on_device:
            def T(a):
                return torch.as_tensor(a, dtype=dtype, device=device)

            self._on_device[key] = {
                "xs": [T(geom.cell_centers_1d(d)) for d in range(3)],
                "karg": [T(2.0 * np.pi * self.k[:, d] / self.L[d]) for d in range(3)],
                "omega": T(self.omega), "psi": T(self.psi), "amp": T(self.amp),
                "phases": T(self.phases), "phases_simple": T(self.phases_simple),
            }
        return self._on_device[key]


def init_hit_velocity(geom: Geometry, urms: float = 1.0, kpeak: float = 4.0,
                      seed: int = 0) -> np.ndarray:
    """Solenoidal random initial velocity with a k^4 exp(-2k^2/kp^2)
    spectrum, as numpy (the JAX package's construction, same generator)."""
    n = geom.ncell
    if geom.dim != 3:
        raise ValueError("HIT initial velocity is 3D-only")
    rng = np.random.default_rng(seed)
    kfreq = [np.fft.fftfreq(n[d], d=1.0 / n[d]) for d in range(3)]
    KX, KY, KZ = np.meshgrid(*kfreq, indexing="ij")
    K2 = KX**2 + KY**2 + KZ**2
    K = np.sqrt(np.maximum(K2, 1e-12))
    Ek = (K / kpeak) ** 4 * np.exp(-2.0 * (K / kpeak) ** 2)
    amp = np.sqrt(Ek / (4.0 * np.pi * np.maximum(K2, 1e-12)))
    u_hat = np.stack([
        amp * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        for _ in range(3)
    ])
    # project to solenoidal: u -= k (k.u)/k^2
    kvec = np.stack([KX, KY, KZ])
    kdotu = np.sum(kvec * u_hat, axis=0)
    u_hat = u_hat - kvec * kdotu / np.maximum(K2, 1e-12)
    u_hat[:, 0, 0, 0] = 0.0
    # zero the Nyquist planes (their aliased partners break solenoidality)
    for d in range(3):
        nyq = np.abs(kfreq[d]) == n[d] // 2
        sl_ = [slice(None)] * 4
        sl_[1 + d] = nyq
        u_hat[tuple(sl_)] = 0.0
    u = np.real(np.fft.ifftn(u_hat, axes=(1, 2, 3)))
    rms = np.sqrt(np.mean(np.sum(u**2, axis=0)) / 3.0)
    return u * (urms / max(rms, 1e-30))
