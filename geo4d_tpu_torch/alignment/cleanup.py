"""Cross-view point-cloud consistency filtering, port of
geo4d_tpu/alignment/cleanup.py::clean_pointcloud: every frame's points are
projected into every other camera; a point clearly IN FRONT of that
camera's depth map (depth < (1 - tol) * depth_j) while being less confident
gets its confidence clipped to `bad_conf`. The loop runs over target
cameras j, all source frames at once; a source frame's confidence is
updated as the cameras are visited in order, as in the reference."""

from __future__ import annotations

import torch


def clean_pointcloud(confs: torch.Tensor, K: torch.Tensor, cams_w2c: torch.Tensor,
                     depthmaps: torch.Tensor, pts3d: torch.Tensor, tol: float = 0.001,
                     bad_conf: float = 0.0) -> torch.Tensor:
    """confs (N, H, W), K (N, 3, 3), cams_w2c (N, 4, 4), depthmaps (N, H, W),
    pts3d (N, H, W, 3) world points -> filtered confidences (N, H, W)."""
    n, h, w = confs.shape
    pts = pts3d.reshape(n, -1, 3)
    conf = confs.reshape(n, -1).clone()
    src = torch.arange(n, device=confs.device)[:, None]
    for j in range(n):
        p = pts @ cams_w2c[j, :3, :3].T + cams_w2c[j, :3, 3]
        z = p[..., 2]
        z_safe = torch.where(torch.abs(z) > 1e-8, z, torch.full_like(z, 1e-8))
        u = torch.round(K[j, 0, 0] * p[..., 0] / z_safe + K[j, 0, 2]).long()
        v = torch.round(K[j, 1, 1] * p[..., 1] / z_safe + K[j, 1, 2]).long()
        inside = (z > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        flat = v.clamp(0, h - 1) * w + u.clamp(0, w - 1)
        depth_j = depthmaps[j].reshape(-1)[flat]
        conf_j = confs[j].reshape(-1)[flat]
        bad = inside & (z < (1 - tol) * depth_j) & (conf < conf_j) & (src != j)
        conf = torch.where(bad, torch.clamp(conf, max=bad_conf), conf)
    return conf.reshape(n, h, w)
