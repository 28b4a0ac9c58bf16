"""Pose math: quaternion conversions, pose averaging/centering, and test
camera trajectories (spiral / wander); port of `nsff_pl_tpu/scene/poses.py`.

Re-implements the behavior of the pose utilities in the reference
(`datasets/colmap_utils.py:275-428`) in plain NumPy. Conventions follow the
reference exactly: poses are (3, 4) camera-to-world matrices in the
"right up back" convention after axis flipping (`datasets/monocular.py:120`).
"""
from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation, Slerp


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """COLMAP (w, x, y, z) quaternion -> 3x3 rotation.

    Matches `datasets/colmap_utils.py:275-286`.
    """
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * z * x + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * z * x - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
    ])


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """3x3 rotation -> COLMAP (w, x, y, z) quaternion.

    Matches `datasets/colmap_utils.py:288-300` (eigen decomposition method).
    """
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
    ]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec = -qvec
    return qvec


def normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def average_poses(poses: np.ndarray) -> np.ndarray:
    """Average (3, 4) c2w pose of a trajectory.

    Same construction as `datasets/colmap_utils.py:308-344`:
    center = mean of centers; z = normalized mean z axis;
    x = normalize(mean_y × z); y = z × x.
    """
    center = poses[..., 3].mean(0)
    z = normalize(poses[..., 2].mean(0))
    y_ = poses[..., 1].mean(0)
    x = normalize(np.cross(y_, z))
    y = np.cross(z, x)
    return np.stack([x, y, z, center], 1)


def center_poses(poses: np.ndarray) -> np.ndarray:
    """Express all poses relative to the average pose so NDC can be used.

    Matches `datasets/colmap_utils.py:347-370`.
    """
    pose_avg_homo = np.eye(4)
    pose_avg_homo[:3] = average_poses(poses)
    last_row = np.tile(np.array([0, 0, 0, 1.0]), (len(poses), 1, 1))
    poses_homo = np.concatenate([poses, last_row], 1)
    return (np.linalg.inv(pose_avg_homo) @ poses_homo)[:, :3]


def create_spiral_poses(original_poses: np.ndarray, radii: np.ndarray,
                        n_poses: int = 120) -> np.ndarray:
    """Spiral novel-view trajectory around an existing trajectory.

    Slerp rotations + linear-interp centers along the original path, with a
    4-turn (8π) circular offset of amplitude `radii` in the camera plane —
    matches `datasets/colmap_utils.py:373-400`.
    """
    n_frames = len(original_poses)
    rot_slerp = Slerp(range(n_frames), Rotation.from_matrix(original_poses[..., :3]))
    ts = np.linspace(0, n_frames - 1, n_poses + 1)[:-1]
    interp_rots = rot_slerp(ts).as_matrix()
    interp_xyzs = np.stack(
        [np.interp(ts, range(n_frames), original_poses[:, i, 3]) for i in range(3)], -1)

    angles = np.linspace(0, 8 * np.pi, n_poses + 1)[:-1]
    offsets = np.stack([np.cos(angles), -np.sin(angles), np.zeros_like(angles)], -1)
    poses = np.zeros((n_poses, 3, 4))
    poses[:, :, :3] = interp_rots
    poses[:, :, 3] = interp_xyzs + radii * offsets
    return poses


def create_wander_path(c2w: np.ndarray, max_trans: float,
                       n_poses: int = 60) -> np.ndarray:
    """Sinusoidal wander path around a single pose.

    Matches `datasets/colmap_utils.py:403-428` (itself borrowed from the
    original NSFF repo): a per-step translation-only pose is inverted and
    right-multiplied onto the reference pose. Returns (n_poses, 3, 4)
    (the reference returns 4x4s whose bottom row downstream code ignores).
    """
    phases = 2.0 * np.pi * np.arange(n_poses) / n_poses
    out = []
    ref = np.eye(4)
    ref[:3, :4] = c2w[:3, :4]
    for ph in phases:
        trans = np.array([max_trans * np.sin(ph),
                          max_trans * np.cos(ph) / 2.0,
                          max_trans * np.cos(ph)])
        i_pose = np.eye(4)
        i_pose[:3, 3] = trans
        out.append((ref @ np.linalg.inv(i_pose))[:3])
    return np.stack(out, 0)
