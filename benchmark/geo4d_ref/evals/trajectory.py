"""Camera-trajectory metrics in numpy, the port's copy of what the group
aligner's calibration uses from geo4d_tpu/evals/trajectory.py: the
origin-aligned ATE and RPE (`align_trajectory_with_eval`). The evaluation's
sim3-aligned metrics and the TUM rows are left out of this copy.
The definitions are evo's (the reference's dust3r/utils/vo_eval.py); they
run on small (N, 4, 4) arrays on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class Trajectory:
    """c2w trajectory: positions (N, 3), rotations (N, 3, 3), timestamps (N,)."""

    positions: np.ndarray
    rotations: np.ndarray
    timestamps: np.ndarray

    @staticmethod
    def from_matrices(poses: np.ndarray, timestamps=None) -> "Trajectory":
        """(N, 4, 4) c2w -> a trajectory, with timestamps 0..N-1 unless given."""
        poses = np.asarray(poses, np.float64)
        ts = np.arange(len(poses)) if timestamps is None else np.asarray(timestamps)
        return Trajectory(poses[:, :3, 3].copy(), poses[:, :3, :3].copy(), ts)

    def matrices(self) -> np.ndarray:
        P = np.tile(np.eye(4), (len(self.positions), 1, 1))
        P[:, :3, :3] = self.rotations
        P[:, :3, 3] = self.positions
        return P

    def transformed(self, T: np.ndarray, scale: float = 1.0) -> "Trajectory":
        """The sim3 (T an SE3, then `scale`): positions scaled, then T @ P
        for every pose P."""
        R, t = T[:3, :3], T[:3, 3]
        return Trajectory((scale * self.positions) @ R.T + t,
                          np.einsum("ij,njk->nik", R, self.rotations), self.timestamps)


def umeyama_align(est: Trajectory, ref: Trajectory, correct_scale: bool = True
                  ) -> Tuple[float, np.ndarray, np.ndarray]:
    """(s, R, t) aligning est positions onto ref (evo's sim3 align; s = 1
    without `correct_scale`)."""
    src, dst = est.positions, ref.positions
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    U, D, Vt = np.linalg.svd(xd.T @ xs / len(src))
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = 1.0
    if correct_scale:
        s = float(np.trace(np.diag(D) @ S) / ((xs**2).sum() / len(src) + 1e-12))
    return s, R, mu_d - s * R @ mu_s


def align_origin(est: Trajectory, ref: Trajectory) -> np.ndarray:
    """SE3 P with (P @ est)[0] == ref[0] (evo's align_origin)."""
    E0, R0 = np.eye(4), np.eye(4)
    E0[:3, :3], E0[:3, 3] = est.rotations[0], est.positions[0]
    R0[:3, :3], R0[:3, 3] = ref.rotations[0], ref.positions[0]
    return R0 @ np.linalg.inv(E0)


def ape_translation_rmse(est: Trajectory, ref: Trajectory, align: bool = True,
                         correct_scale: bool = True) -> float:
    """APE on the translation part (the ATE definition), aligned first when
    `align` (sim3, or SE3 without `correct_scale`)."""
    pos = est.positions
    if align:
        s, R, t = umeyama_align(est, ref, correct_scale)
        pos = (s * pos) @ R.T + t
    err = np.linalg.norm(pos - ref.positions, axis=-1)
    return float(np.sqrt(np.mean(err**2)))


def _rotation_angle_deg(R: np.ndarray) -> np.ndarray:
    tr = np.clip((np.trace(R, axis1=-2, axis2=-1) - 1) / 2, -1.0, 1.0)
    return np.degrees(np.arccos(tr))


def rpe(est: Trajectory, ref: Trajectory, delta: int = 1, align: bool = True,
        correct_scale: bool = True) -> Tuple[float, float]:
    """RPE (trans RMSE, rot RMSE deg) at frame `delta`: the relative error
    E_i = inv(rel_ref_i) @ rel_est_i over all pairs (i, i + delta), aligned
    first when `align` (sim3, or SE3 without `correct_scale`)."""
    est_m = est.matrices()
    if align:
        s, R, t = umeyama_align(est, ref, correct_scale)
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, t
        est_m = np.einsum("ij,njk->nik", T, est_m)
        est_m[:, :3, 3] = (s * est.positions) @ R.T + t
    ref_m = ref.matrices()
    if len(est_m) <= delta:
        return 0.0, 0.0
    rel_est = np.einsum("nij,njk->nik", np.linalg.inv(est_m[:-delta]), est_m[delta:])
    rel_ref = np.einsum("nij,njk->nik", np.linalg.inv(ref_m[:-delta]), ref_m[delta:])
    E = np.einsum("nij,njk->nik", np.linalg.inv(rel_ref), rel_est)
    trans = np.linalg.norm(E[:, :3, 3], axis=-1)
    rot = _rotation_angle_deg(E[:, :3, :3])
    return float(np.sqrt(np.mean(trans**2))), float(np.sqrt(np.mean(rot**2)))


def align_trajectory_with_eval(pred: Trajectory, ref: Trajectory
                               ) -> Tuple[float, float, float, np.ndarray, Trajectory]:
    """Origin-aligned variant (SE3 `align_origin`, no scale): returns
    (ate, rpe_trans, rpe_rot_deg, P, aligned)."""
    P = align_origin(pred, ref)
    aligned = pred.transformed(P)
    ate = ape_translation_rmse(aligned, ref, align=False)
    rpe_trans, rpe_rot = rpe(aligned, ref, delta=1, align=False)
    return ate, rpe_trans, rpe_rot, P, aligned
