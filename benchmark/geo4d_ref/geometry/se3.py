"""SO3/SE3/Sim3 utilities, port of geo4d_tpu/geometry/se3.py: quaternion
codecs (xyzw), the aligner's 7-D pose codec [quat | signed-log1p t], the
weighted Umeyama sim3 and Procrustes rotation fitting. Every function is
batched over leading axes and differentiable where the aligner's loss uses it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) xyzw quaternion -> (..., 3, 3) rotation."""
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    x, y, z, w = q.unbind(-1)
    rows = [
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ]
    return torch.stack(rows, dim=-2)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) xyzw, branchless: the largest of the four
    candidate components anchors the other three (Shepperd)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=1e-12))

    qw = 0.5 * safe_sqrt(1.0 + tr)
    qx = 0.5 * safe_sqrt(1.0 + m00 - m11 - m22)
    qy = 0.5 * safe_sqrt(1.0 - m00 + m11 - m22)
    qz = 0.5 * safe_sqrt(1.0 - m00 - m11 + m22)
    options = torch.stack([
        torch.stack([qx, (m01 + m10) / (4 * qx), (m02 + m20) / (4 * qx), (m21 - m12) / (4 * qx)], -1),
        torch.stack([(m01 + m10) / (4 * qy), qy, (m12 + m21) / (4 * qy), (m02 - m20) / (4 * qy)], -1),
        torch.stack([(m02 + m20) / (4 * qz), (m12 + m21) / (4 * qz), qz, (m10 - m01) / (4 * qz)], -1),
        torch.stack([(m21 - m12) / (4 * qw), (m02 - m20) / (4 * qw), (m10 - m01) / (4 * qw), qw], -1),
    ], dim=-2)                                                         # (..., 4 anchors, 4)
    idx = torch.stack([qx, qy, qz, qw], -1).argmax(-1)
    q = torch.take_along_dim(options, idx[..., None, None].expand(*idx.shape, 1, 4), dim=-2)[..., 0, :]
    return q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)


def signed_log1p(x: torch.Tensor) -> torch.Tensor:
    """sign(x) * log1p(|x|): the aligner's translation codec."""
    return torch.sign(x) * torch.log1p(torch.abs(x))


def signed_expm1(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.expm1(torch.abs(x))


def _mat4(top: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) -> (..., 4, 4) with the bottom row [0, 0, 0, 1]."""
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def pose_to_params(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) pose -> (..., 7) [quat xyzw | signed_log1p(t)]."""
    return torch.cat([rotmat_to_quat(T[..., :3, :3]), signed_log1p(T[..., :3, 3])], dim=-1)


def params_to_pose(p: torch.Tensor) -> torch.Tensor:
    """(..., 7) params -> (..., 4, 4) pose."""
    R = quat_to_rotmat(p[..., :4])
    t = signed_expm1(p[..., 4:7])
    return _mat4(torch.cat([R, t[..., None]], dim=-1))


def umeyama_sim3(src: torch.Tensor, dst: torch.Tensor, weights: Optional[torch.Tensor] = None,
                 with_scale: bool = True) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Weighted Umeyama over leading batch axes: (s, R, t) minimising
    sum w |s R src + t - dst|^2. src/dst (..., N, 3), weights (..., N).
    Returns s (...), R (..., 3, 3), t (..., 3). Weights summing to ~0 fall
    back to uniform; the scale is clipped to [1e-6, 1e6] (NaN -> 1)."""
    w = torch.ones_like(src[..., 0]) if weights is None else weights
    w = torch.where((w.sum(-1, keepdim=True) > 1e-8), w, torch.ones_like(w))
    w = w / (w.sum(-1, keepdim=True) + 1e-12)
    mu_s = torch.einsum("...n,...ni->...i", w, src)
    mu_d = torch.einsum("...n,...ni->...i", w, dst)
    xs = src - mu_s[..., None, :]
    xd = dst - mu_d[..., None, :]
    cov = torch.einsum("...n,...ni,...nj->...ij", w, xd, xs)
    U, D, Vh = torch.linalg.svd(cov)
    sign = torch.sign(torch.linalg.det(U @ Vh))
    diag = torch.stack([torch.ones_like(sign), torch.ones_like(sign), sign], -1)
    R = U @ torch.diag_embed(diag) @ Vh
    if with_scale:
        var_s = torch.einsum("...n,...ni->...", w, xs * xs)
        s = (D * diag).sum(-1) / (var_s + 1e-12)
        s = torch.clamp(torch.nan_to_num(s, nan=1.0), 1e-6, 1e6)
    else:
        s = torch.ones_like(mu_s[..., 0])
    t = mu_d - s[..., None] * (R @ mu_s[..., None])[..., 0]
    return s, R, t


def procrustes_rotation(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """R minimising ||A - B @ R||_F over rotations, batched over leading axes.

    A, B: (..., N, 3) row-vector point sets. R = U S' Vh with H = B^T A and
    S' = diag(1, 1, sign(det(U Vh))) so that R is a proper rotation."""
    H = B.transpose(-1, -2) @ A
    U, _, Vh = torch.linalg.svd(H)
    sign = torch.sign(torch.linalg.det(U @ Vh))
    ones = torch.ones_like(sign)
    Sp = torch.diag_embed(torch.stack([ones, ones, sign], dim=-1))
    return U @ Sp @ Vh
