"""Perspective-n-Point pose recovery with a focal sweep, a torch-native
RANSAC with the contract of geo4d_tpu/geometry/pnp.py::fast_pnp_points
(which calls OpenCV's solvePnPRansac; OpenCV is not a dependency here).

For every frame the focal candidates are geomspace(S/2, 3S, 63) when the
focal is unknown, else {f, f - 0.03 S, f + 0.03 S} (S = max(W, H)). The best
candidate by inlier count (reprojection error below `reproj_err` pixels,
first candidate on ties) gives the returned (focal, cam-to-world) pair.

All frames, focal candidates and hypotheses solve at once on the points'
device, in float64:

1. `niter` minimal sets of 6 points per frame, drawn from a CPU
   torch.Generator (so a CPU run and a CUDA run draw the same hypotheses) and
   shared by the frame's focal candidates;
2. a DLT per set, solved once in pixel units: the projection matrix for a
   focal f is diag(S/f, S/f, 1) times it. Its 3x3 block is projected onto a
   rotation, then Gauss-Newton on the set's reprojection error makes it the
   set's calibrated least-squares pose;
3. inliers counted for every (frame, candidate, hypothesis); each
   (frame, candidate) keeps its best hypothesis;
4. two rounds of Gauss-Newton on the reprojection error over the current
   inliers, recounting the inliers after each round.

A frame fails (None / ok False) when it has fewer than 4 points (6 for the
DLT), when its points are degenerate (all equal), or when no candidate keeps
6 inliers with a finite pose.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from geo4d_tpu_torch.core.timing import span

MIN_SET = 6          # points of one DLT hypothesis
FOCAL_SWEEP = 63
GN_ROUNDS = 2
GN_STEPS = 5


def focal_candidates(focal: Optional[float], S: int) -> np.ndarray:
    """The sweep of the reference: 63 geometric steps over [S/2, 3S] when the
    focal is unknown, else the focal and +-3% of S around it."""
    if focal is None or not np.isfinite(focal):
        return np.geomspace(S / 2, S * 3, FOCAL_SWEEP)
    return np.asarray([focal, focal - 0.03 * S, focal + 0.03 * S], dtype=np.float64)


def _skew(p: torch.Tensor) -> torch.Tensor:
    x, y, z = p.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([o, -z, y, z, o, -x, -y, x, o], -1).reshape(*p.shape, 3)


def _rodrigues(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 3, 3) rotation."""
    theta = torch.linalg.norm(w, dim=-1)[..., None, None]
    K = _skew(w)
    small = theta < 1e-12
    theta = torch.where(small, torch.ones_like(theta), theta)
    A = torch.where(small, torch.ones_like(theta), torch.sin(theta) / theta)
    B = torch.where(small, torch.full_like(theta, 0.5), (1 - torch.cos(theta)) / (theta * theta))
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + A * K + B * (K @ K)


def _project(R, t, f, pp, X):
    """Pixels (..., M, 2) and depths (..., M) of world points X (..., M, 3)."""
    Xc = X @ R.transpose(-1, -2) + t[..., None, :]
    z = Xc[..., 2]
    zs = torch.where(z > 1e-12, z, torch.ones_like(z))
    uv = f[..., None, None] * Xc[..., :2] / zs[..., None] + pp
    return uv, z, Xc


def _inliers(R, t, f, pp, X, x, valid, reproj_err):
    uv, z, _ = _project(R, t, f, pp, X)
    err = torch.linalg.norm(uv - x, dim=-1)
    return valid & (z > 1e-12) & (err < reproj_err)


def _refine(R, t, f, pp, X, x, w):
    """GN_STEPS Gauss-Newton steps on sum_w |proj - x|^2 over the pose
    (left-multiplied rotation increment, translation increment)."""
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)
    for _ in range(GN_STEPS):
        uv, z, Xc = _project(R, t, f, pp, X)
        good = (w & (z > 1e-12)).to(X.dtype)
        zs = torch.where(z > 1e-12, z, torch.ones_like(z))
        fz = f[..., None] / zs
        zero = torch.zeros_like(fz)
        Jp = torch.stack([fz, zero, -fz * Xc[..., 0] / zs,
                          zero, fz, -fz * Xc[..., 1] / zs], -1).reshape(*fz.shape, 2, 3)
        J = torch.cat([-Jp @ _skew(Xc), Jp], dim=-1)                       # (..., M, 2, 6)
        r = (uv - x) * good[..., None]
        Jw = J * good[..., None, None]
        H = torch.einsum("...mki,...mkj->...ij", Jw, J)
        g = torch.einsum("...mki,...mk->...i", Jw, r)
        damp = 1e-9 * torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)[..., None, None] + 1e-12
        delta = -torch.linalg.solve_ex(H + damp * eye6, g)[0]
        dR = _rodrigues(delta[..., :3])
        R = dR @ R
        t = (dR @ t[..., None])[..., 0] + delta[..., 3:]
    return R, t


def fast_pnp_points_batched(
    p3: torch.Tensor,                  # (N, M, 3) world points
    p2,                                # (M, 2) or (N, M, 2) pixel coordinates
    mask: torch.Tensor,                # (N, M) bool: usable correspondences
    size_wh: Tuple[int, int],
    focals: Optional[Sequence[Optional[float]]] = None,   # per frame, None = unknown
    pp: Optional[Tuple[float, float]] = None,
    niter: int = 10,
    reproj_err: float = 5.0,
    max_points: int = 4096,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """RANSAC-PnP with a focal sweep for N frames at once. Returns
    (focal (N,), cam_to_world (N, 4, 4), ok (N,)) as float64/bool numpy;
    failed frames have ok False (their focal and pose are not meaningful).

    A frame with more than `max_points` usable points keeps a seeded subset
    of them (np.random.default_rng(0).choice over its masked points, as the
    reference does per frame). Spans (`core.timing`): "pnp_prep" (the
    host's per-frame selection and the focal candidates), "pnp_ransac" (the
    minimal sets, their DLT and fit, the inlier counts) and "pnp_refine"
    (the refit on the inliers)."""
    dev = p3.device
    n = p3.shape[0]
    w, h = size_wh
    S = max(w, h)
    if pp is None:
        pp = (w / 2, h / 2)
    p2 = torch.as_tensor(p2, dtype=torch.float64, device=dev)
    if p2.dim() == 2:
        p2 = p2.expand(n, -1, -1)
    focals = [None] * n if focals is None else list(focals)

    with span("pnp_prep"):
        # ---- per-frame point selection (host: the seeded subsample) ----
        mask_np = mask.cpu().numpy()
        ok = np.ones(n, bool)
        rows = []
        for i in range(n):
            idx = np.flatnonzero(mask_np[i])
            if max_points and idx.size > max_points:
                idx = idx[np.random.default_rng(0).choice(idx.size, max_points, replace=False)]
            if idx.size < max(4, MIN_SET):
                ok[i] = False
            rows.append(idx)
        m_max = max(max((r.size for r in rows), default=0), MIN_SET)
        idx = np.zeros((n, m_max), np.int64)
        valid_np = np.zeros((n, m_max), bool)
        for i, r in enumerate(rows):
            idx[i, :r.size] = r
            valid_np[i, :r.size] = True
        idx_t = torch.from_numpy(idx).to(dev)
        valid = torch.from_numpy(valid_np).to(dev)
        X = torch.take_along_dim(p3.to(torch.float64), idx_t[..., None], dim=1) * valid[..., None]
        x = torch.take_along_dim(p2, idx_t[..., None], dim=1)
        # degenerate map: every usable point identical
        lo = torch.where(valid[..., None], X, torch.full_like(X, float("inf"))).amin(1)
        hi = torch.where(valid[..., None], X, torch.full_like(X, -float("inf"))).amax(1)
        ok &= ((hi - lo).amax(-1) >= 1e-9).cpu().numpy()

        # ---- focal candidates (N, F) ----
        cands = [focal_candidates(f, S) for f in focals]
        n_f = max(c.size for c in cands)
        cand = np.stack([np.pad(c, (0, n_f - c.size), mode="edge") for c in cands])
        cand_ok = np.stack([np.arange(n_f) < c.size for c in cands])
        fc = torch.from_numpy(cand).to(dev)                                   # (N, F)

    with span("pnp_ransac"):
        # ---- minimal sets from a CPU generator, shared across candidates ----
        gen = torch.Generator().manual_seed(seed)
        u = torch.rand(n, niter, m_max, generator=gen, dtype=torch.float64)
        u = torch.where(torch.from_numpy(valid_np)[:, None], u, torch.full_like(u, 2.0))
        sets = u.topk(MIN_SET, dim=-1, largest=False).indices.to(dev)        # (N, niter, 6)

        # ---- DLT per set in normalised units ----
        cnt = valid.sum(1, keepdim=True).clamp(min=1).to(torch.float64)
        centre = X.sum(1) / cnt                                               # (N, 3)
        spread = (torch.linalg.norm(X - centre[:, None], dim=-1) * valid).sum(1) / cnt[:, 0]
        spread = torch.where(spread > 1e-12, spread, torch.ones_like(spread))
        Xn = (X - centre[:, None]) / spread[:, None, None]
        xs = (x - x.new_tensor(pp)) / S
        Xs = torch.take_along_dim(Xn[:, None], sets[..., None], dim=2)       # (N, niter, 6, 3)
        us = torch.take_along_dim(xs[:, None], sets[..., None], dim=2)       # (N, niter, 6, 2)
        Xh = torch.cat([Xs, torch.ones_like(Xs[..., :1])], -1)                # (N, niter, 6, 4)
        zero = torch.zeros_like(Xh)
        A = torch.stack([torch.cat([Xh, zero, -us[..., :1] * Xh], -1),
                         torch.cat([zero, Xh, -us[..., 1:] * Xh], -1)], dim=-2).flatten(-3, -2)
        Q = torch.linalg.svd(A)[2][..., -1, :].reshape(n, niter, 3, 4)
        # undo the point normalisation: Q' = Q [I/s, -c/s; 0, 1]
        s4 = spread[:, None, None, None]
        Q = torch.cat([Q[..., :3] / s4, Q[..., 3:] - (Q[..., :3] @ centre[:, None, :, None]) / s4],
                      dim=-1)

        # ---- per focal candidate: rotation, translation, inliers ----
        scale = torch.stack([S / fc, S / fc, torch.ones_like(fc)], -1)        # (N, F, 3)
        P = scale[:, :, None, :, None] * Q[:, None]                           # (N, F, niter, 3, 4)
        P = torch.nan_to_num(P * torch.sign(torch.linalg.det(P[..., :3]))[..., None, None])
        U, sv, Vh = torch.linalg.svd(P[..., :3])
        R = U @ Vh
        t = P[..., 3] / sv.mean(-1, keepdim=True).clamp(min=1e-300)
        ppt = x.new_tensor(pp)
        f_b = fc[:, :, None].expand(-1, -1, niter)
        # calibrated least-squares fit of each minimal set (the DLT's 3x3 block
        # is only projected onto a rotation)
        X_set = torch.take_along_dim(X[:, None], sets[..., None], dim=2)[:, None]
        x_set = torch.take_along_dim(x[:, None], sets[..., None], dim=2)[:, None]
        R, t = _refine(R, t, f_b, ppt, X_set, x_set,
                       torch.ones(R.shape[:3] + (MIN_SET,), dtype=torch.bool, device=dev))
        inl = _inliers(R, t, f_b, ppt, X[:, None, None], x[:, None, None], valid[:, None, None],
                       reproj_err)
        best = inl.sum(-1).argmax(-1)                                         # (N, F)
        pick = best[..., None, None, None]
        R = torch.take_along_dim(R, pick, dim=2)[:, :, 0]
        t = torch.take_along_dim(t, best[..., None, None], dim=2)[:, :, 0]
        inl = torch.take_along_dim(inl, best[..., None, None], dim=2)[:, :, 0]  # (N, F, M)

    with span("pnp_refine"):
        # ---- refit on the inliers ----
        Xf, xf, vf = X[:, None], x[:, None], valid[:, None]
        for _ in range(GN_ROUNDS):
            R, t = _refine(R, t, fc, ppt, Xf, xf, inl)
            inl = _inliers(R, t, fc, ppt, Xf, xf, vf, reproj_err)
        finite = torch.isfinite(R).flatten(-2).all(-1) & torch.isfinite(t).all(-1)
        score = torch.where(finite, inl.sum(-1), torch.full_like(inl[..., 0], -1, dtype=torch.long))
        score = torch.where(torch.from_numpy(cand_ok).to(dev), score, torch.full_like(score, -1))
        k = score.argmax(-1)                                                  # first best candidate
        best_score = torch.take_along_dim(score, k[:, None], dim=1)[:, 0]
        R = torch.take_along_dim(R, k[:, None, None, None], dim=1)[:, 0]
        t = torch.take_along_dim(t, k[:, None, None], dim=1)[:, 0]
        ok &= (best_score >= MIN_SET).cpu().numpy()

        c2w = torch.eye(4, dtype=torch.float64, device=dev).repeat(n, 1, 1)
        c2w[:, :3, :3] = R.transpose(-1, -2)
        c2w[:, :3, 3] = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
        focal_out = np.take_along_axis(cand, k.cpu().numpy()[:, None], axis=1)[:, 0]
        c2w_np = c2w.cpu().numpy()
        c2w_np[~ok] = np.eye(4)
    return focal_out, c2w_np, ok


def fast_pnp(pts3d: torch.Tensor, mask: torch.Tensor, focal: Optional[float] = None,
             pp: Optional[Tuple[float, float]] = None, niter: int = 10,
             reproj_err: float = 5.0, max_points: int = 4096
             ) -> Optional[Tuple[float, np.ndarray]]:
    """One frame's pose from its point map pts3d (H, W, 3) at the pixels
    where mask (H, W) holds, each point seen at its own pixel -> (focal,
    cam_to_world 4x4) or None (fewer than 4 masked points, or no pose)."""
    pts3d, mask = torch.as_tensor(pts3d), torch.as_tensor(mask, device=pts3d.device)
    if int(mask.sum()) < 4:
        return None
    h, w = mask.shape
    y, x = torch.meshgrid(torch.arange(h, device=pts3d.device),
                          torch.arange(w, device=pts3d.device), indexing="ij")
    pix = torch.stack([x, y], -1).to(torch.float64)
    return fast_pnp_points(pts3d[mask], pix[mask], (w, h), focal=focal, pp=pp, niter=niter,
                           reproj_err=reproj_err, max_points=max_points)


def fast_pnp_points(p3, p2, size_wh: Tuple[int, int], focal: Optional[float] = None,
                    pp: Optional[Tuple[float, float]] = None, niter: int = 10,
                    reproj_err: float = 5.0, max_points: int = 4096,
                    ) -> Optional[Tuple[float, np.ndarray]]:
    """One frame's explicit correspondences (M, 3) / (M, 2) -> (focal,
    cam_to_world 4x4) or None; the single-frame form of
    `fast_pnp_points_batched`."""
    p3 = torch.as_tensor(p3)
    mask = torch.ones(p3.shape[0], dtype=torch.bool, device=p3.device)
    f, c2w, ok = fast_pnp_points_batched(p3[None], p2, mask[None], size_wh, [focal], pp,
                                         niter, reproj_err, max_points)
    return (float(f[0]), c2w[0]) if ok[0] else None
