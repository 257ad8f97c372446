"""Camera-trajectory metrics in numpy, the port's copy of what it needs from
geo4d_tpu/evals/trajectory.py: ATE and RPE with sim3 alignment
(`eval_metrics`), the origin-aligned variant the aligner's calibration uses
(`align_trajectory_with_eval`), and TUM rows both ways (the results
directory, the evaluation's ground truth).
The definitions are evo's (the reference's dust3r/utils/vo_eval.py); they
run on small (N, 4, 4) arrays on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


def quat_wxyz_to_rotmat(q: np.ndarray) -> np.ndarray:
    """(N, 4) wxyz -> (N, 3, 3), normalising q first."""
    q = q / (np.linalg.norm(q, axis=-1, keepdims=True) + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3))
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - w * z)
    R[..., 0, 2] = 2 * (x * z + w * y)
    R[..., 1, 0] = 2 * (x * y + w * z)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - w * x)
    R[..., 2, 0] = 2 * (x * z - w * y)
    R[..., 2, 1] = 2 * (y * z + w * x)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def rotmat_to_quat_wxyz(R: np.ndarray) -> np.ndarray:
    """(N, 3, 3) -> (N, 4) wxyz, branching per matrix on its largest
    diagonal term."""
    R = np.asarray(R)
    out = np.empty(R.shape[:-2] + (4,))
    for i, M in enumerate(R.reshape(-1, 3, 3)):
        tr = np.trace(M)
        if tr > 0:
            s = np.sqrt(tr + 1.0) * 2
            q = [0.25 * s, (M[2, 1] - M[1, 2]) / s, (M[0, 2] - M[2, 0]) / s,
                 (M[1, 0] - M[0, 1]) / s]
        elif M[0, 0] > M[1, 1] and M[0, 0] > M[2, 2]:
            s = np.sqrt(1.0 + M[0, 0] - M[1, 1] - M[2, 2]) * 2
            q = [(M[2, 1] - M[1, 2]) / s, 0.25 * s, (M[0, 1] + M[1, 0]) / s,
                 (M[0, 2] + M[2, 0]) / s]
        elif M[1, 1] > M[2, 2]:
            s = np.sqrt(1.0 + M[1, 1] - M[0, 0] - M[2, 2]) * 2
            q = [(M[0, 2] - M[2, 0]) / s, (M[0, 1] + M[1, 0]) / s, 0.25 * s,
                 (M[1, 2] + M[2, 1]) / s]
        else:
            s = np.sqrt(1.0 + M[2, 2] - M[0, 0] - M[1, 1]) * 2
            q = [(M[1, 0] - M[0, 1]) / s, (M[0, 2] + M[2, 0]) / s,
                 (M[1, 2] + M[2, 1]) / s, 0.25 * s]
        out.reshape(-1, 4)[i] = q
    return out


@dataclasses.dataclass
class Trajectory:
    """c2w trajectory: positions (N, 3), rotations (N, 3, 3), timestamps (N,)."""

    positions: np.ndarray
    rotations: np.ndarray
    timestamps: np.ndarray

    @staticmethod
    def from_tum(rows: np.ndarray) -> "Trajectory":
        """(N, 8) TUM rows [t, x, y, z, qx, qy, qz, qw] -> a trajectory."""
        rows = np.asarray(rows, np.float64)
        q_wxyz = np.concatenate([rows[:, 7:8], rows[:, 4:7]], axis=-1)
        return Trajectory(rows[:, 1:4], quat_wxyz_to_rotmat(q_wxyz), rows[:, 0])

    @staticmethod
    def from_matrices(poses: np.ndarray) -> "Trajectory":
        """(N, 4, 4) c2w -> a trajectory with timestamps 0..N-1."""
        poses = np.asarray(poses, np.float64)
        return Trajectory(poses[:, :3, 3].copy(), poses[:, :3, :3].copy(), np.arange(len(poses)))

    def matrices(self) -> np.ndarray:
        P = np.tile(np.eye(4), (len(self.positions), 1, 1))
        P[:, :3, :3] = self.rotations
        P[:, :3, 3] = self.positions
        return P

    def to_tum(self) -> np.ndarray:
        """(N, 8) TUM rows [t, x, y, z, qx, qy, qz, qw]."""
        q_wxyz = rotmat_to_quat_wxyz(self.rotations)
        q_xyzw = np.concatenate([q_wxyz[:, 1:], q_wxyz[:, :1]], axis=-1)
        return np.concatenate([self.timestamps[:, None], self.positions, q_xyzw], axis=-1)

    def transformed(self, T: np.ndarray) -> "Trajectory":
        """T @ P for every pose P (T an SE3)."""
        R, t = T[:3, :3], T[:3, 3]
        return Trajectory(self.positions @ R.T + t,
                          np.einsum("ij,njk->nik", R, self.rotations), self.timestamps)


def umeyama_align(est: Trajectory, ref: Trajectory) -> Tuple[float, np.ndarray, np.ndarray]:
    """(s, R, t) aligning est positions onto ref (evo's sim3 align)."""
    src, dst = est.positions, ref.positions
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    U, D, Vt = np.linalg.svd(xd.T @ xs / len(src))
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / ((xs**2).sum() / len(src) + 1e-12))
    return s, R, mu_d - s * R @ mu_s


def align_origin(est: Trajectory, ref: Trajectory) -> np.ndarray:
    """SE3 P with (P @ est)[0] == ref[0] (evo's align_origin)."""
    E0, R0 = np.eye(4), np.eye(4)
    E0[:3, :3], E0[:3, 3] = est.rotations[0], est.positions[0]
    R0[:3, :3], R0[:3, 3] = ref.rotations[0], ref.positions[0]
    return R0 @ np.linalg.inv(E0)


def ape_translation_rmse(est: Trajectory, ref: Trajectory, align: bool) -> float:
    """APE on the translation part (the ATE definition), sim3-aligned first
    when `align`."""
    pos = est.positions
    if align:
        s, R, t = umeyama_align(est, ref)
        pos = (s * pos) @ R.T + t
    err = np.linalg.norm(pos - ref.positions, axis=-1)
    return float(np.sqrt(np.mean(err**2)))


def _rotation_angle_deg(R: np.ndarray) -> np.ndarray:
    tr = np.clip((np.trace(R, axis1=-2, axis2=-1) - 1) / 2, -1.0, 1.0)
    return np.degrees(np.arccos(tr))


def rpe(est: Trajectory, ref: Trajectory, align: bool) -> Tuple[float, float]:
    """RPE (trans RMSE, rot RMSE deg) between consecutive frames: the
    relative error E_i = inv(rel_ref_i) @ rel_est_i over pairs (i, i+1),
    sim3-aligned first when `align`."""
    delta = 1
    est_m = est.matrices()
    if align:
        s, R, t = umeyama_align(est, ref)
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


def eval_metrics(pred: Trajectory, ref: Trajectory) -> Tuple[float, float, float]:
    """(ATE, RPE-trans, RPE-rot-deg), sim3-aligned, delta 1."""
    ate = ape_translation_rmse(pred, ref, align=True)
    rpe_trans, rpe_rot = rpe(pred, ref, align=True)
    return ate, rpe_trans, rpe_rot


def align_trajectory_with_eval(pred: Trajectory, ref: Trajectory
                               ) -> Tuple[float, float, float, np.ndarray, Trajectory]:
    """Origin-aligned variant (SE3 `align_origin`, no scale): returns
    (ate, rpe_trans, rpe_rot_deg, P, aligned)."""
    P = align_origin(pred, ref)
    aligned = pred.transformed(P)
    ate = ape_translation_rmse(aligned, ref, align=False)
    rpe_trans, rpe_rot = rpe(aligned, ref, align=False)
    return ate, rpe_trans, rpe_rot, P, aligned
