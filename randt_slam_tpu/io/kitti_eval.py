"""KITTI odometry evaluation, protocol-compatible with the pipeline behind
the reference's published numbers.

The reference's ``result.txt`` files are produced by the external
``radar_kitti_benchmark`` / ``kitti-odom-eval`` tool
(``eval_odom.py --align 6dof``, ``/root/reference/oxford-dataset.md:71-103``).
This module reimplements the headline metrics with the same protocol so runs
of this engine can be scored against ``BASELINE.md`` without ROS:

  * translational drift [%] and rotational drift [deg/100m] over segment
    lengths 100..800 m, segment starts every 10 frames,
  * ATE [m] — RMSE of translation after rigid (6-DoF Umeyama, no scale)
    alignment of the full trajectory,
  * RPE [m]/[deg] — mean consecutive-frame relative pose error (+ std dev).

Validated against the reference's own checked-in est/gt trajectory pairs:
``tests/test_kitti_eval_parity.py`` reproduces every value of all 16
``oxford_results/randt_eval_*/{slam,odom}/est/result.txt`` files.
"""

from __future__ import annotations

import numpy as np

SEGMENT_LENGTHS = (100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0)
STEP_SIZE = 10


def load_kitti_poses(path: str) -> np.ndarray:
    """Read a KITTI-format trajectory file: one row of the flattened 3x4
    world-from-body matrix per line.  Returns (N, 4, 4) float64."""
    raw = np.loadtxt(path, dtype=np.float64)
    if raw.ndim == 1:
        raw = raw[None, :]
    n = raw.shape[0]
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, :3, :4] = raw.reshape(n, 3, 4)
    return poses


def poses_from_se2(xyt: np.ndarray) -> np.ndarray:
    """(N, 3) [x, y, theta] -> (N, 4, 4) planar homogeneous poses."""
    xyt = np.asarray(xyt, np.float64)
    n = xyt.shape[0]
    c, s = np.cos(xyt[:, 2]), np.sin(xyt[:, 2])
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, 0, 0] = c
    poses[:, 0, 1] = -s
    poses[:, 1, 0] = s
    poses[:, 1, 1] = c
    poses[:, 0, 3] = xyt[:, 0]
    poses[:, 1, 3] = xyt[:, 1]
    return poses


def trajectory_distances(poses: np.ndarray) -> np.ndarray:
    """Cumulative path length of the (ground-truth) trajectory."""
    d = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1)
    return np.concatenate([[0.0], np.cumsum(d)])


def _rotation_error(E: np.ndarray) -> np.ndarray:
    """Geodesic rotation angle of (..., 4, 4) pose errors [rad]."""
    tr = E[..., 0, 0] + E[..., 1, 1] + E[..., 2, 2]
    return np.arccos(np.clip(0.5 * (tr - 1.0), -1.0, 1.0))


def _translation_error(E: np.ndarray) -> np.ndarray:
    return np.linalg.norm(E[..., :3, 3], axis=-1)


def _inv(T: np.ndarray) -> np.ndarray:
    """Batched rigid-pose inverse."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    out = np.tile(np.eye(4), T.shape[:-2] + (1, 1))
    Rt = np.swapaxes(R, -1, -2)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -np.einsum("...ij,...j->...i", Rt, t)
    return out


def segment_errors(gt: np.ndarray, est: np.ndarray,
                   lengths=SEGMENT_LENGTHS, step: int = STEP_SIZE):
    """Per-segment (r_err/len, t_err/len) pairs, KITTI protocol:
    for every start frame (every ``step``) and segment length, the pose error
    is inv(rel_est) @ rel_gt over the segment."""
    n = min(len(gt), len(est))
    gt, est = gt[:n], est[:n]
    dist = trajectory_distances(gt)
    firsts, lasts, lens = [], [], []
    for first in range(0, n, step):
        targets = dist[first] + np.asarray(lengths)
        idx = np.searchsorted(dist, targets)
        ok = idx < n
        firsts.extend([first] * int(ok.sum()))
        lasts.extend(idx[ok].tolist())
        lens.extend(np.asarray(lengths)[ok].tolist())
    if not firsts:
        return np.zeros((0, 2))
    f = np.asarray(firsts)
    l = np.asarray(lasts)
    L = np.asarray(lens)
    rel_gt = _inv(gt[f]) @ gt[l]
    rel_est = _inv(est[f]) @ est[l]
    E = _inv(rel_est) @ rel_gt
    return np.stack([_rotation_error(E) / L, _translation_error(E) / L],
                    axis=1)


def drift(gt: np.ndarray, est: np.ndarray) -> tuple:
    """(translational drift [%], rotational drift [deg/100m])."""
    errs = segment_errors(gt, est)
    if len(errs) == 0:
        return float("nan"), float("nan")
    r = float(np.mean(errs[:, 0]))
    t = float(np.mean(errs[:, 1]))
    return t * 100.0, r / np.pi * 180.0 * 100.0


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale=False):
    """Least-squares rigid alignment y ~ c R x + t (Umeyama 1991).
    x, y: (m, n) column points."""
    mean_x = x.mean(axis=1)
    mean_y = y.mean(axis=1)
    sigma_x = ((x - mean_x[:, None]) ** 2).mean()
    cov_xy = (y - mean_y[:, None]) @ (x - mean_x[:, None]).T / x.shape[1]
    u, d, v = np.linalg.svd(cov_xy)
    s = np.eye(x.shape[0])
    if np.linalg.det(u) * np.linalg.det(v) < 0.0:
        s[-1, -1] = -1
    r = u @ s @ v
    c = np.trace(np.diag(d) @ s) / sigma_x if with_scale else 1.0
    t = mean_y - c * r @ mean_x
    return r, t, c


def align_6dof(gt: np.ndarray, est: np.ndarray) -> np.ndarray:
    """Apply rigid Umeyama alignment (``--align 6dof``) of the estimated
    trajectory onto the ground truth; returns transformed est poses."""
    xyz_est = est[:, :3, 3].T
    xyz_gt = gt[:, :3, 3].T
    r, t, _ = umeyama_alignment(xyz_est, xyz_gt)
    A = np.eye(4)
    A[:3, :3] = r
    A[:3, 3] = t
    return A[None] @ est


def ate(gt: np.ndarray, est: np.ndarray) -> float:
    """RMSE of translation error (poses assumed already aligned)."""
    n = min(len(gt), len(est))
    d = gt[:n, :3, 3] - est[:n, :3, 3]
    return float(np.sqrt((d ** 2).sum(axis=1).mean()))


def rpe(gt: np.ndarray, est: np.ndarray) -> dict:
    """Consecutive-frame relative pose error: mean and std of translation [m]
    and rotation [deg]."""
    n = min(len(gt), len(est))
    rel_gt = _inv(gt[:n - 1]) @ gt[1:n]
    rel_est = _inv(est[:n - 1]) @ est[1:n]
    E = _inv(rel_gt) @ rel_est
    tr = _translation_error(E)
    ro = np.degrees(_rotation_error(E))
    return {
        "rpe_m": float(tr.mean()), "rpe_m_dev": float(tr.std()),
        "rpe_deg": float(ro.mean()), "rpe_deg_dev": float(ro.std()),
    }


def evaluate(gt: np.ndarray, est: np.ndarray, align: str = "6dof") -> dict:
    """Full scoring of one trajectory pair — the in-repo equivalent of
    ``eval_odom.py --align 6dof`` (drift uses the raw trajectories; ATE the
    aligned one, matching the tool)."""
    n = min(len(gt), len(est))
    gt, est = gt[:n], est[:n]
    t_pct, r_degp100 = drift(gt, est)
    est_aligned = align_6dof(gt, est) if align == "6dof" else est
    out = {
        "trans_err_pct": t_pct,
        "rot_err_degp100m": r_degp100,
        "ate_m": ate(gt, est_aligned),
    }
    out.update(rpe(gt, est))
    return out


def evaluate_files(gt_path: str, est_path: str, align: str = "6dof") -> dict:
    return evaluate(load_kitti_poses(gt_path), load_kitti_poses(est_path),
                    align=align)


def parse_result_txt(path: str) -> dict:
    """Read the reference tool's ``result.txt`` into a dict."""
    out = {}
    keymap = {
        "Trans.err.(%)": "trans_err_pct",
        "Rot.err.(deg/100m)": "rot_err_degp100m",
        "ATE(m)": "ate_m",
        "RPE(m)": "rpe_m",
        "RPE-dev(m)": "rpe_m_dev",
        "RPE(deg)": "rpe_deg",
        "RPE-dev(deg)": "rpe_deg_dev",
    }
    with open(path) as f:
        for line in f:
            parts = [p.strip() for p in line.split(",")]
            if len(parts) >= 2 and parts[0] in keymap:
                out[keymap[parts[0]]] = float(parts[1])
    return out
