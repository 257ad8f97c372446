"""MoGe-style focal/shift recovery from affine-invariant point maps, port of
geo4d_tpu/geometry/moge.py::point_map_to_depth.

The model predicts point maps up to an unknown z-shift and focal. Recovery
solves min_{shift, f} |f * xy / (z + shift) - uv|^2, where f is closed-form
given the shift, leaving a scalar problem: a fixed count of damped
Gauss-Newton steps on the shift with accept/reject (Levenberg-Marquardt
style) damping, batched over every map at once. The derivative of the
residual with respect to the shift is written in closed form, including the
dependence of the optimal f on the shift.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def image_plane_uv(width: int, height: int, device=None) -> torch.Tensor:
    """(H, W, 2) UV grid spanning +-(w, h) / diagonal at pixel centres."""
    aspect = width / height
    span_x = aspect / (1 + aspect ** 2) ** 0.5
    span_y = 1 / (1 + aspect ** 2) ** 0.5
    u = np.linspace(-span_x * (width - 1) / width, span_x * (width - 1) / width, width)
    v = np.linspace(-span_y * (height - 1) / height, span_y * (height - 1) / height, height)
    uu, vv = np.meshgrid(u, v, indexing="xy")
    return torch.from_numpy(np.stack([uu, vv], -1).astype(np.float32)).to(device)


def _residuals(shift, uv, xy, z, w, with_jacobian: bool = False):
    """Residual f * xy / (z + shift) - uv (weighted, flattened per map) with
    the closed-form optimal f; optionally its derivative in the shift.
    shift (B,), uv (M, 2), xy (B, M, 2), z and w (B, M)."""
    denom = z + shift[:, None]
    safe = torch.abs(denom) > 1e-6
    denom = torch.where(safe, denom, torch.full_like(denom, 1e-6))
    a = xy / denom[..., None] * w[..., None]
    b = uv * w[..., None]
    aa = (a * a).sum((-2, -1)) + 1e-12
    ab = (a * b).sum((-2, -1))
    f = ab / aa
    r = (f[:, None, None] * a - b).flatten(1)
    if not with_jacobian:
        return r, f
    da = torch.where(safe[..., None], -xy * w[..., None] / (denom * denom)[..., None],
                     torch.zeros_like(xy))
    df = (da * b).sum((-2, -1)) / aa - ab * 2 * (a * da).sum((-2, -1)) / (aa * aa)
    J = (df[:, None, None] * a + f[:, None, None] * da).flatten(1)
    return r, f, J


def solve_shift_focal(uv: torch.Tensor, xyz: torch.Tensor, weights: Optional[torch.Tensor] = None,
                      num_iters: int = 30) -> Tuple[torch.Tensor, torch.Tensor]:
    """Damped Gauss-Newton on the scalar shift for each of B maps.
    uv (M, 2), xyz (B, M, 3), weights (B, M). Returns (shift, focal), (B,)."""
    xy, z = xyz[..., :2], xyz[..., 2]
    w = torch.ones_like(z) if weights is None else weights
    shift = torch.zeros_like(z[:, 0])
    lm = torch.full_like(shift, 1e-3)
    for _ in range(num_iters):
        r, _, J = _residuals(shift, uv, xy, z, w, with_jacobian=True)
        jtj = (J * J).sum(-1)
        jtr = (J * r).sum(-1)
        new_shift = shift - jtr / (jtj + lm * jtj + 1e-12)
        r_new, _ = _residuals(new_shift, uv, xy, z, w)
        better = (r_new * r_new).sum(-1) < (r * r).sum(-1)
        shift = torch.where(better, new_shift, shift)
        lm = torch.where(better, torch.clamp(lm * 0.5, min=1e-6), torch.clamp(lm * 4.0, max=1e4))
    return shift, _residuals(shift, uv, xy, z, w)[1]


def point_map_to_depth(points: torch.Tensor, mask: Optional[torch.Tensor] = None,
                       downsample_size: Tuple[int, int] = (64, 64),
                       image_size: Optional[Tuple[int, int]] = None):
    """Recover depth / FoV / z-shift from (..., H, W, 3) point maps with an
    optional (..., H, W) bool mask. Returns (depth (..., H, W), fov_x (...),
    fov_y (...), shift (...)); all maps solve at once.

    The solve runs on a nearest-neighbour `downsample_size` grid.
    `image_size=(ih, iw)` is the original resolution when `points` was
    ALREADY downsampled by the caller with the same `(arange(d) * orig) // d`
    index formula: the UV grid, aspect and FoV then come from the original
    geometry, not from the downsampled shape."""
    shape = points.shape
    h, w = shape[-3], shape[-2]
    ih, iw = image_size if image_size is not None else (h, w)
    diagonal = (ih ** 2 + iw ** 2) ** 0.5
    pts = points.reshape(-1, h, w, 3)
    dev = pts.device
    dh, dw = downsample_size
    yi = torch.arange(dh, device=dev) * h // dh
    xi = torch.arange(dw, device=dev) * w // dw
    pts_lr = pts[:, yi][:, :, xi]
    yi_full = torch.arange(dh, device=dev) * ih // dh
    xi_full = torch.arange(dw, device=dev) * iw // dw
    uv_lr = image_plane_uv(iw, ih, device=dev)[yi_full][:, xi_full]
    if mask is not None:
        m = mask.reshape(-1, h, w)[:, yi][:, :, xi].to(pts.dtype)
    else:
        m = torch.ones_like(pts_lr[..., 0])
    shift, focal = solve_shift_focal(uv_lr.reshape(-1, 2), pts_lr.reshape(pts_lr.shape[0], -1, 3),
                                     m.reshape(m.shape[0], -1))
    fov_x = 2 * torch.atan(iw / diagonal / focal)
    fov_y = 2 * torch.atan(ih / diagonal / focal)
    depth = pts[..., 2] + shift[:, None, None]
    lead = shape[:-3]
    return depth.reshape(*lead, h, w), fov_x.reshape(lead), fov_y.reshape(lead), shift.reshape(lead)
