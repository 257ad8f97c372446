"""Rotation fitting, port of geo4d_tpu/geometry/se3.py::procrustes_rotation."""

from __future__ import annotations

import torch


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
