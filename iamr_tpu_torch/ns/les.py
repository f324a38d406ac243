"""LES subgrid closures: Smagorinsky and Sigma eddy viscosity
(counterpart of iamr_tpu/ns/les.py; ns.do_LES, ns.LES_model,
ns.smago_Cs_cst = 0.18, ns.sigma_Cs_cst = 1.5).

The eddy viscosity adds to the molecular face viscosity in the CN solves
and the explicit viscous terms (getViscosity).

Smagorinsky: mu_t = (Cs dx)^2 sqrt(2 S_ij S_ij)
Sigma (3D, Nicoud et al. 2011): mu_t = (Cs dx)^2
    sigma3 (sigma1 - sigma2)(sigma2 - sigma3) / sigma1^2
with sigma_i the singular values of grad(u), from torch.linalg.eigvalsh of
g^T g on every cell (ascending, as jnp.linalg.eigvalsh; on a CUDA tensor
each call reads its solver's status back to the host, a sync). mu_t carries no
density factor, as in the reference. Scalars (the filter width, the
constants) enter as Python floats: nothing is read back in the Smagorinsky
path.
"""

from __future__ import annotations

import torch

from iamr_tpu_torch.ops.stencil import avg2, cell_to_face, diff, sl

# 3x3 problems per torch.linalg.eigvalsh call: on the card it runs
# cuSOLVER's batched syev, which refuses 2^15 of them and more
# (CUSOLVER_STATUS_INVALID_VALUE; CUDA 12.8, H100); each problem is solved
# on its own, so the split changes no value
EIG_BATCH = 1 << 14


def _cc_gradients(cfg, bcp, vel):
    """grad(u): G[c][d] = du_c/dx_d at cells, central differences over one
    filled ghost."""
    dim = cfg.dim
    dx = cfg.geom.dx
    G = [[None] * dim for _ in range(dim)]
    vel_g = bcp.fill_vel(vel, 1)
    for c in range(dim):
        g = vel_g[c]
        for d in range(dim):
            ctr = (sl(g, d, 2, None) - sl(g, d, 0, -2)) / (2.0 * dx[d])
            G[c][d] = ctr[tuple(slice(None) if e == d else slice(1, -1) for e in range(dim))]
    return G


def mut_smagorinsky(cfg, bcp, vel, cs: float):
    dim = cfg.dim
    G = _cc_gradients(cfg, bcp, vel)
    smag = 0.0
    for i in range(dim):
        for j in range(dim):
            sij = 0.5 * (G[i][j] + G[j][i])
            smag = smag + 2.0 * sij * sij
    delta = min(cfg.geom.dx)
    return (cs * delta) ** 2 * torch.sqrt(smag)


def gram_eigenvalues(gtg):
    """Eigenvalues, ascending, of the symmetric 3x3 matrices gtg (..., 3,
    3), EIG_BATCH problems per torch.linalg.eigvalsh call."""
    ev = torch.cat([torch.linalg.eigvalsh(part)
                    for part in gtg.reshape(-1, 3, 3).split(EIG_BATCH)])
    return ev.reshape(gtg.shape[:-1])


def mut_sigma(cfg, bcp, vel, cs: float):
    if cfg.dim != 3:
        raise ValueError("Sigma model is 3D-only (reference NS_LES.cpp abort)")
    G = _cc_gradients(cfg, bcp, vel)
    # g: (*n, 3, 3), g[..., i, j] = du_i/dx_j
    g = torch.stack([torch.stack([G[i][j] for j in range(3)], dim=-1) for i in range(3)],
                    dim=-2)
    gtg = torch.einsum("...ki,...kj->...ij", g, g)
    ev = torch.clamp(gram_eigenvalues(gtg), min=0.0)
    s1 = torch.sqrt(ev[..., 2])
    s2 = torch.sqrt(ev[..., 1])
    s3 = torch.sqrt(ev[..., 0])
    delta = min(cfg.geom.dx)
    d_sigma = s3 * (s1 - s2) * (s2 - s3) / torch.clamp(s1 * s1, min=1e-30)
    return (cs * delta) ** 2 * d_sigma


def eddy_viscosity_faces(cfg, bcp, vel):
    """mu_t on faces (the arithmetic cell-to-face average; each domain face
    takes its boundary cell's mu_t, periodic or not, as the JAX package
    does) of the configured LES model, or None when LES is off."""
    if not cfg.do_les:
        return None
    if cfg.les_model.lower() == "sigma":
        mut = mut_sigma(cfg, bcp, vel, cfg.sigma_cs)
    else:
        mut = mut_smagorinsky(cfg, bcp, vel, cfg.smago_cs)
    return tuple(
        torch.cat([sl(mut, d, 0, 1), avg2(mut, d), sl(mut, d, -1, None)], dim=d)
        for d in range(cfg.dim)
    )


def tensor_cross_terms(cfg, bcp, vel, mu_f):
    """The explicit transpose part of the stress divergence,
    T_i = sum_j d_j(mu d_i u_j), on cells. With the componentwise
    div(mu grad u_i) it makes the incompressible stress divergence
    d_j(mu (d_j u_i + d_i u_j)) of the reference's MLTensorOp; it vanishes
    for constant mu and divergence-free U. mu_f: face viscosities per dim.
    Returns (dim, *n)."""
    dim = cfg.dim
    dx = cfg.geom.dx
    G = _cc_gradients(cfg, bcp, vel)
    out = []
    for i in range(dim):
        acc = None
        for j in range(dim):
            # mu (d_i u_j) on j-faces, then d/dx_j back to cells
            flux = mu_f[j] * cell_to_face(G[j][i], j, bc_wrap=cfg.geom.periodic[j])
            t = diff(flux, j) / dx[j]
            acc = t if acc is None else acc + t
        out.append(acc)
    return torch.stack(out)


def tensor_cross_fluxes(cfg, bcp, vel, mu_f):
    """The transpose part of the viscous face fluxes, out[i][j] =
    -mu_f[j] (d_i u_j) on j-faces (the sign of ops/mg.get_fluxes): added
    to the componentwise fluxes they make the full tensor stress flux a
    coarse-fine flux register takes (computeExtensiveFluxes)."""
    dim = cfg.dim
    G = _cc_gradients(cfg, bcp, vel)
    return [
        tuple(-mu_f[j] * cell_to_face(G[j][i], j, bc_wrap=cfg.geom.periodic[j])
              for j in range(dim))
        for i in range(dim)
    ]
