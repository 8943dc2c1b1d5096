"""Per-point geometric features (linearity, planarity, scattering,
verticality): the counterpart of ssdr_al_tpu/ops/geof.py.

For each point, the covariance of its neighbourhood (the point itself and
its k neighbours) is eigendecomposed in closed form, and the eigenvalues
λ1 ≥ λ2 ≥ λ3 with eigenvectors v1..v3 give
    linearity   = (√λ1 − √λ2) / √λ1
    planarity   = (√λ2 − √λ3) / √λ1
    scattering  =  √λ3 / √λ1
    verticality = u_z / ‖u‖,  u_i = Σ_j λ_j |v_j[i]|
JAX runs these as fused XLA ops; here they are plain torch ops on the
caller's device (elementwise, no kernel of their own), in JAX's formulas
and order: the trigonometric eigenvalues, then each eigenvector from the
largest column of its spectral projector (ties to the first column, as
jnp.argmax), the isotropic fallback and the cross product. The covariance
and the projector products are sums of elementwise products in f32, so no
matrix unit (TF32) touches them, as JAX's Precision.HIGHEST keeps them
full f32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_EPS = 1e-12


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] @ [..., 3, 3] as sums of elementwise f32 products."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def eigh3x3(cov: torch.Tensor):
    """Batched closed-form symmetric 3×3 eigendecomposition.

    cov: [..., 3, 3] symmetric. Returns (lam [..., 3] descending, vec
    [..., 3, 3] whose columns are unit eigenvectors in lam's order). The
    eigenvectors' signs are arbitrary (the features use |v| only)."""
    cov = cov.float()
    a00, a01, a02 = cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2]
    a11, a12, a22 = cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]

    q = (a00 + a11 + a22) / 3.0
    p1 = a01 ** 2 + a02 ** 2 + a12 ** 2
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))
    p_safe = torch.clamp(p, min=_EPS)

    b00, b11, b22 = (a00 - q) / p_safe, (a11 - q) / p_safe, (a22 - q) / p_safe
    b01, b02, b12 = a01 / p_safe, a02 / p_safe, a12 / p_safe
    detb = (b00 * (b11 * b22 - b12 * b12)
            - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    r = torch.clamp(detb / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    l1 = q + 2.0 * p * torch.cos(phi)
    l3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    l2 = 3.0 * q - l1 - l3
    lam = torch.stack([l1, l2, l3], dim=-1)  # descending by construction
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)

    def eig_vec(la, lb):
        # every nonzero column of (A − λa I)(A − λb I) lies in the third
        # eigenvalue's eigenspace: take the largest one
        proj = _matmul3(cov - la[..., None, None] * eye,
                        cov - lb[..., None, None] * eye)
        norms = (proj * proj).sum(-2)                      # column sq-norms
        col = torch.argmax(norms, dim=-1)
        v = torch.gather(proj, -1, col[..., None, None].expand(
            proj.shape[:-1] + (1,)))[..., 0]
        n = torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True), min=_EPS))
        # isotropic fallback: any unit vector is an eigenvector
        fallback = torch.tensor([1.0, 0.0, 0.0], dtype=cov.dtype,
                                device=cov.device).expand_as(v)
        return torch.where(n > 1e-6, v / n, fallback)

    v1 = eig_vec(l2, l3)
    v3 = eig_vec(l1, l2)
    v2 = torch.linalg.cross(v3, v1)  # symmetric ⇒ eigenvectors orthogonal
    n2 = torch.sqrt(torch.clamp((v2 * v2).sum(-1, keepdim=True), min=_EPS))
    v2 = v2 / n2
    return lam, torch.stack([v1, v2, v3], dim=-1)         # columns


def geometric_features(xyz: torch.Tensor, neighbor_idx: torch.Tensor,
                       chunk: int = 8192) -> torch.Tensor:
    """xyz [N, 3] f32, neighbor_idx [N, k] int (k neighbours, without the
    point itself, which is put first, as ply_c.cpp:400-412) on one device
    → [N, 4] f32 on that device: linearity, planarity, scattering,
    verticality. Rows go `chunk` at a time, as in JAX."""
    xyz = xyz.float()
    n, k = neighbor_idx.shape
    out = torch.empty((n, 4), dtype=torch.float32, device=xyz.device)
    for s in range(0, n, chunk):
        nb = neighbor_idx[s:s + chunk].long()
        si = torch.arange(s, s + nb.shape[0], device=xyz.device)
        pos = xyz[torch.cat([si[:, None], nb], dim=1)]    # [c, k+1, 3]
        centered = pos - pos.mean(dim=1, keepdim=True)
        cov = (centered[:, :, :, None] * centered[:, :, None, :]).sum(1) \
            / float(k + 1)
        lam, vec = eigh3x3(cov)
        lam = torch.clamp(lam, min=0.0)
        sq = torch.sqrt(lam)
        s1 = torch.clamp(sq[:, 0], min=_EPS)
        linearity = (sq[:, 0] - sq[:, 1]) / s1
        planarity = (sq[:, 1] - sq[:, 2]) / s1
        scattering = sq[:, 2] / s1
        unary = (lam[:, None, :] * vec.abs()).sum(-1)      # [c, 3]
        norm = torch.clamp(torch.linalg.norm(unary, dim=1), min=_EPS)
        out[s:s + nb.shape[0]] = torch.stack(
            [linearity, planarity, scattering, unary[:, 2] / norm], dim=1)
    return out


# How far two f32 runs of geometric_features may differ when they sum in
# other orders (JAX's XLA reductions and torch's, the card's and the
# CPU's): the closed form's eigenvalues carry an absolute error of a few
# ulp of λ1, so a feature built on √λ of an eigenvalue under SMALL·λ1 (a
# line's λ2, a plane's λ3) may move by ~√(4·2⁻²⁴) ≈ 4.9e-4 of √λ1
# (ATOL_SQRT), any other by ATOL. Where two eigenvalues are within GAP·λ1
# of each other, arccos near ±1 magnifies an ulp of r into ~√ulp of φ:
# the three eigenvalue features may move by ATOL_SQRT, and verticality,
# built on the eigenvectors, by ATOL_NEAR_TIE (JAX's own tolerance
# against LAPACK).
ATOL, ATOL_SQRT, ATOL_NEAR_TIE = 2e-5, 5e-4, 1e-2
SMALL, GAP = 1e-3, 0.05


def neighbourhood_eigenvalues(xyz, neighbor_idx):
    """[N, 3] f64 numpy eigenvalues, descending, of each point's
    neighbourhood covariance (the point and its neighbours), for
    agreement_tolerance."""
    xyz = np.asarray(xyz)
    full = np.concatenate([np.arange(len(xyz))[:, None],
                           np.asarray(neighbor_idx)], 1)
    c = xyz[full].astype(np.float64)
    c -= c.mean(1, keepdims=True)
    return np.linalg.eigvalsh(np.einsum("nki,nkj->nij", c, c)
                              / full.shape[1])[:, ::-1]


def agreement_tolerance(lam):
    """[N, 4] absolute tolerance between two runs' features (linearity,
    planarity, scattering, verticality) from lam [N, 3] (f64, descending,
    neighbourhood_eigenvalues)."""
    l1 = np.maximum(lam[:, 0], 1e-300)
    small2, small3 = lam[:, 1] < SMALL * l1, lam[:, 2] < SMALL * l1
    gap = np.minimum(lam[:, 0] - lam[:, 1], lam[:, 1] - lam[:, 2]) / l1
    tol = np.full((len(lam), 4), ATOL)
    tol[small2, 0] = ATOL_SQRT           # √λ2 (λ3 ≤ λ2: small too)
    tol[small3, 1:3] = ATOL_SQRT         # √λ3
    near = gap <= GAP
    tol[near, :3] = ATOL_SQRT
    tol[near, 3] = ATOL_NEAR_TIE
    return tol
