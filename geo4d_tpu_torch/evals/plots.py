"""Trajectory plot, port of geo4d_tpu/evals/plots.py: the prediction is
sim3-aligned onto the ground truth, drawn in the plane of the ground truth's
two highest-variance axes (ground truth dashed gray, prediction solid
blue). matplotlib is imported when a plot is drawn; where it is missing,
the call raises ImportError."""

from __future__ import annotations

from typing import Optional

import numpy as np

from geo4d_tpu_torch.evals.trajectory import Trajectory, umeyama_align


def plot_trajectory(out_path: str, pred: Trajectory, gt: Optional[Trajectory] = None,
                    title: str = "", align: bool = True, correct_scale: bool = True) -> str:
    """Top-down trajectory plot -> PNG at out_path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pred_pos = pred.positions
    if gt is not None and align:
        s, R, t = umeyama_align(pred, gt, correct_scale=correct_scale)
        pred_pos = (s * pred_pos) @ R.T + t
    ref_pos = gt.positions if gt is not None else pred_pos
    order = np.argsort(np.var(ref_pos, axis=0))
    a1, a2 = order[2], order[1]
    fig, ax = plt.subplots(figsize=(8, 8))
    if gt is not None:
        ax.plot(gt.positions[:, a1], gt.positions[:, a2], "--", color="gray",
                label="Ground Truth")
    ax.plot(pred_pos[:, a1], pred_pos[:, a2], "-", color="blue", label="Predicted")
    ax.set_xlabel("xyz"[a1])
    ax.set_ylabel("xyz"[a2])
    ax.set_title(title)
    ax.legend()
    ax.set_aspect("equal", adjustable="datalim")
    fig.savefig(out_path, dpi=90, bbox_inches="tight")
    plt.close(fig)
    return out_path
