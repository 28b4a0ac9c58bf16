"""Monocular-video scene loader (port of `nsff_pl_tpu/scene/monocular.py`).

The geometry and prior work runs on the host in numpy as in the JAX
package; images, masks and disparities are decoded and resized by
`scene/imageio.py` (PIL's and OpenCV's rules, without either), flows by
`scene/flowio.py`. The (N_frames, H*W, 16) float32 ray table is built
frame by frame with the port's `ops/rays.py` on the scene's `device` and
stays there: the training pipeline gathers its batches from it.

Ray-table channel layout (as in the JAX package):
    [0:3]   rays_o (NDC)
    [3:6]   rays_d (NDC)
    [6:9]   rgb
    [9]     t (frame index)
    [10]    disparity prior
    [11]    motion mask (0 = static, 1 = dynamic)
    [12:14] uv + forward optical flow target
    [14:16] uv + backward optical flow target
"""
from __future__ import annotations

import glob
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from nsff_pl_tpu_torch import resolve_device
from nsff_pl_tpu_torch.ops import rays as ray_ops
from nsff_pl_tpu_torch.scene import colmap, flowio, imageio
from nsff_pl_tpu_torch.scene import poses as pose_utils


def _imread_rgb(path: str, img_wh: Tuple[int, int]) -> np.ndarray:
    """PIL: open, convert("RGB"), resize LANCZOS, / 255."""
    img = imageio.resize_lanczos(imageio.to_rgb(imageio.read_png(path)),
                                 img_wh)
    return img.astype(np.float32) / 255.0  # (h, w, 3)


def _imread_gray(path: str, img_wh: Tuple[int, int]) -> np.ndarray:
    """PIL: open, convert("L"), resize NEAREST, / 255."""
    img = imageio.resize_nearest_pil(imageio.to_l(imageio.read_png(path)),
                                     img_wh)
    return img.astype(np.float32) / 255.0  # (h, w)


def _imread_disp(path: str, img_wh: Tuple[int, int]) -> np.ndarray:
    """OpenCV: imread ANYDEPTH as float32, resize INTER_NEAREST."""
    disp = imageio.imread_anydepth(path).astype(np.float32)
    return imageio.resize_nearest_cv2(disp, img_wh)


class MonocularScene:
    """Scene geometry + priors + ray tables for one monocular video.

    Splits as in the JAX package: train, val, test, test_spiral,
    test_spiralX, test_fixviewX_interpY. The train split's `rays` is a
    float32 tensor on `device`; `test_item` returns tensors there too.
    """

    def __init__(self, root_dir: str, split: str = "train",
                 img_wh: Tuple[int, int] = (512, 288),
                 start_end: Tuple[int, int] = (0, 30),
                 cache_dir: Optional[str] = None,
                 hard_sampling: bool = False, device="cuda"):
        self.device = resolve_device(device)
        self.root_dir = root_dir
        self.split = split
        self.img_wh = tuple(img_wh)
        self.cam_train = [0]
        self.cam_test = 1
        self.start_frame, self.end_frame = start_end
        self.cache_dir = cache_dir or None
        self.hard_sampling = hard_sampling
        self._disps = {}  # frame -> resized disparity, read once
        self.read_meta()
        self._disps = {}

    # ------------------------------------------------------------------
    def _glob(self, sub: str, pattern: str = "*"):
        return sorted(glob.glob(os.path.join(self.root_dir, sub, pattern)))[
            self.start_frame:self.end_frame]

    def read_meta(self):
        """COLMAP model, near depth, centred and scaled poses, per-split
        buffers (`nsff_pl_tpu/scene/monocular.py::read_meta`)."""
        self.image_paths = self._glob("images")
        self.disp_paths = self._glob("disps")
        self.mask_paths = self._glob("masks")
        self.flow_fw_paths = self._glob("flow_fw", "*.flo") + ["dummy"]
        self.flow_bw_paths = ["dummy"] + self._glob("flow_bw", "*.flo")
        self.N_frames = len(self.image_paths)

        camdata = colmap.read_cameras_binary(
            os.path.join(self.root_dir, "sparse/0/cameras.bin"))
        cam = camdata[1]
        H, W = cam.height, cam.width
        f = cam.params[0]
        self.K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]],
                          dtype=np.float32)
        self.K[0] *= self.img_wh[0] / W
        self.K[1] *= self.img_wh[1] / H

        imdata = colmap.read_images_binary(
            os.path.join(self.root_dir, "sparse/0/images.bin"))
        perm = np.argsort([imdata[k].name for k in imdata])
        bottom = np.array([[0, 0, 0, 1.0]])
        w2c_mats = np.stack([
            np.concatenate([np.concatenate(
                [imdata[k].qvec2rotmat(), imdata[k].tvec.reshape(3, 1)], 1),
                bottom], 0)
            for k in imdata], 0)[perm][self.start_frame:self.end_frame]
        poses = np.linalg.inv(w2c_mats)[:, :3]  # (N_frames, 3, 4) c2w

        pts3d = colmap.read_points3d_binary(
            os.path.join(self.root_dir, "sparse/0/points3D.bin"))
        self.nearest_depth = self._estimate_near_depth(pts3d, w2c_mats)

        # COLMAP "right down front" -> "right up back", then centred
        self.poses = np.concatenate(
            [poses[..., 0:1], -poses[..., 1:3], poses[..., 3:4]], -1)
        self.poses = pose_utils.center_poses(self.poses)
        # the nearest content at depth ~1
        self.scale_factor = self.nearest_depth
        self.poses[..., 3] /= self.scale_factor

        # projection matrices of the 2D-3D flow loss
        bottom_n = np.zeros((self.N_frames, 1, 4))
        bottom_n[..., -1] = 1
        rt = np.linalg.inv(np.concatenate([self.poses, bottom_n], 1))[:, :3]
        rt[:, 1:] *= -1  # "right up back" -> "right down forward"
        self.Ps = (self.K @ rt)[None].astype(np.float32)  # (1, N, 3, 4)
        self.Ks = self.K[None].astype(np.float32)  # (1, 3, 3)

        if self.split == "train":
            self.rays = self._build_ray_table()
        elif self.split == "val" or self.split == "test":
            self.poses_test = self.poses.copy()
        elif self.split.startswith("test_fixview"):
            target_idx = int(self.split.split("_")[1][7:])
            self.poses_test = np.tile(self.poses[target_idx],
                                      (self.N_frames, 1, 1))
        elif self.split.startswith("test_spiral"):
            if self.split == "test_spiral":
                max_trans = np.percentile(
                    np.abs(np.diff(self.poses[:, 0, 3])), 10)
                radii = np.array([max_trans, max_trans, 0])
                self.poses_test = pose_utils.create_spiral_poses(
                    self.poses, radii, n_poses=6 * self.N_frames)
            else:
                target_idx = int(self.split.split("_")[1][6:])
                max_trans = np.abs(
                    self.poses[0, 0, 3] - self.poses[-1, 0, 3]) / 5
                self.poses_test = pose_utils.create_wander_path(
                    self.poses[target_idx], max_trans=max_trans, n_poses=60)

    # ------------------------------------------------------------------
    def _estimate_near_depth(self, pts3d, w2c_mats) -> float:
        """Near depth from regressing COLMAP point depths on the
        disparity prior, with the geometric fallback where the fit is
        poor."""
        from scipy.stats import linregress

        ids = list(pts3d)
        pts_w = np.stack([pts3d[k].xyz for k in ids], 1)  # (3, P)
        visibilities = np.zeros((self.N_frames, len(ids)))
        for i, k in enumerate(ids):
            for j in pts3d[k].image_ids:
                if self.start_frame <= j - 1 < self.end_frame:
                    visibilities[j - 1 - self.start_frame, i] = 1

        pts_w_h = np.concatenate([pts_w, np.ones((1, len(ids)))], 0)
        min_depth = 1e8
        for i in range(self.N_frames):
            disp = self._disp(i)
            vis = visibilities[i] == 1
            pts_c = (w2c_mats[i] @ pts_w_h[:, vis])[:3]
            pts_uvd = self.K @ pts_c
            uv = (pts_uvd[:2] / pts_uvd[2:]).T.astype(int)
            uv[:, 0] = np.clip(uv[:, 0], 0, self.img_wh[0] - 1)
            uv[:, 1] = np.clip(uv[:, 1], 0, self.img_wh[1] - 1)
            depth = pts_uvd[2]
            reg = linregress(1 / depth, disp[uv[:, 1], uv[:, 0]])
            if reg.rvalue ** 2 > 0.9:  # trustworthy fit
                min_depth = min(min_depth, reg.slope /
                                (np.percentile(disp, 95) - reg.intercept))
            else:
                min_depth = min(min_depth, np.percentile(depth, 5))
        return min_depth * 0.75

    def _disp(self, t: int) -> np.ndarray:
        """Frame t's disparity at img_wh; the near-depth fit and the ray
        table share one read while the scene loads."""
        if t not in self._disps:
            self._disps[t] = _imread_disp(self.disp_paths[t], self.img_wh)
        return self._disps[t]

    # ------------------------------------------------------------------
    def _frame_rays(self, c2w: np.ndarray):
        """NDC rays of one camera pose on the device: (rays_o, rays_d,
        uv), each (h*w, 3 | 3 | 2)."""
        w, h = self.img_wh
        directions, uv = ray_ops.get_ray_directions(
            h, w, self.K, return_uv=True, device=self.device)
        rays_o, rays_d = ray_ops.get_rays(directions,
                                          np.asarray(c2w)[:3, :4])
        shift_near = -min(-1.0, float(c2w[2, 3]))
        rays_o, rays_d = ray_ops.get_ndc_rays(self.K, 1.0, shift_near,
                                              rays_o, rays_d)
        return rays_o, rays_d, uv

    def _read_flow_pair(self, t: int):
        w, h = self.img_wh
        if t < self.N_frames - 1:
            fw = flowio.resize_flow(
                flowio.read_flow(self.flow_fw_paths[t]), w, h).reshape(-1, 2)
        else:
            fw = np.zeros((w * h, 2), np.float32)
        if t >= 1:
            bw = flowio.resize_flow(
                flowio.read_flow(self.flow_bw_paths[t]), w, h).reshape(-1, 2)
        else:
            bw = np.zeros((w * h, 2), np.float32)
        return fw, bw

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a),
                               dtype=torch.float32).to(self.device)

    def _build_ray_table(self) -> torch.Tensor:
        """(N_frames, h*w, 16) ray table on the device, cacheable to
        `cache_dir/rays.npy`."""
        if self.cache_dir:
            cache_file = os.path.join(self.cache_dir, "rays.npy")
            if os.path.exists(cache_file):
                return self._tensor(np.load(cache_file))
        w, h = self.img_wh
        table = torch.empty((self.N_frames, w * h, 16), dtype=torch.float32,
                            device=self.device)
        for t in range(self.N_frames):
            img = _imread_rgb(self.image_paths[t], self.img_wh)
            disp = self._disp(t)
            mask = _imread_gray(self.mask_paths[t], self.img_wh)
            flow_fw, flow_bw = self._read_flow_pair(t)
            rays_o, rays_d, uv = self._frame_rays(self.poses[t])
            row = table[t]
            row[:, 0:3] = rays_o
            row[:, 3:6] = rays_d
            row[:, 6:9] = self._tensor(img.reshape(-1, 3))
            row[:, 9] = float(t)
            row[:, 10] = self._tensor(disp.reshape(-1))
            row[:, 11] = self._tensor(mask.reshape(-1))
            row[:, 12:14] = uv + self._tensor(flow_fw)
            row[:, 14:16] = uv + self._tensor(flow_bw)
        if self.cache_dir:
            os.makedirs(self.cache_dir, exist_ok=True)
            np.save(os.path.join(self.cache_dir, "rays.npy"),
                    table.cpu().numpy())
        return table

    # ------------------------------------------------------------------
    def test_item(self, idx: int,
                  targets: Sequence[str] = ("rgbs", "disp", "mask", "flows")):
        """Full-image sample of the val / test splits: a dict of tensors
        on the device (and `cam_ids` 0). Of the frame's files only
        `targets` are read (the eval CLI reads the image and mask of the
        test split and none else)."""
        if self.split == "val":
            c2w = self.poses[self.N_frames // 2]
            t = self.N_frames // 2
        else:
            c2w = self.poses_test[idx]
            if self.split == "test" or self.split.startswith("test_fixview"):
                t = idx
            elif self.split == "test_spiral":
                t = int(idx / len(self.poses_test) * self.N_frames)
            elif self.split.startswith("test_spiral"):
                t = int(self.split.split("_")[1][6:])
            else:
                t = 0

        w, h = self.img_wh
        rays_o, rays_d, _ = self._frame_rays(c2w)
        sample = {
            "rays": torch.cat([rays_o, rays_d], 1),
            "ts": torch.full((w * h,), t, dtype=torch.long,
                             device=self.device),
            "c2w": self._tensor(c2w),
            "cam_ids": 0,
        }
        if t < len(self.image_paths):
            if "rgbs" in targets:
                sample["rgbs"] = self._tensor(_imread_rgb(
                    self.image_paths[t], self.img_wh).reshape(-1, 3))
            if "disp" in targets:
                sample["disp"] = self._tensor(_imread_disp(
                    self.disp_paths[t], self.img_wh).reshape(-1))
            if "mask" in targets:
                sample["mask"] = self._tensor(_imread_gray(
                    self.mask_paths[t], self.img_wh).reshape(-1))
            if "flows" in targets:
                fw, bw = self._read_flow_pair(t)
                sample["flow_fw"] = self._tensor(fw.reshape(h, w, 2))
                sample["flow_bw"] = self._tensor(bw.reshape(h, w, 2))
        return sample

    def __len__(self):
        if self.split == "train":
            # steps per epoch
            return self.img_wh[0] * self.img_wh[1] * self.N_frames // 1000
        if self.split == "val":
            return 1
        return len(self.poses_test)
