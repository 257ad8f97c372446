"""The inverse of rigid and similarity transforms, from
geo4d_tpu/geometry/utils.py (its pixel grids, unprojection and intrinsics
are left out of this copy)."""

from __future__ import annotations

import torch


def inv_se3(T: torch.Tensor) -> torch.Tensor:
    """Invert rigid or similarity (..., 4, 4) transforms (general inverse of
    the 3x3 block)."""
    Rinv = torch.linalg.inv_ex(T[..., :3, :3])[0]
    tinv = -(Rinv @ T[..., :3, 3:4])
    bottom = torch.zeros_like(T[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([torch.cat([Rinv, tinv], dim=-1), bottom], dim=-2)
