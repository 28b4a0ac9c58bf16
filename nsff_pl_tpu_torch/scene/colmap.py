"""COLMAP sparse-model I/O (binary and text) in plain NumPy (port of
`nsff_pl_tpu/scene/colmap.py`, the same readers and writers).

Replaces the reference's vendored readers (`datasets/colmap_utils.py:85-272`,
themselves BSD-licensed COLMAP code). This is an independent implementation
of the public COLMAP model format
(https://colmap.github.io/format.html), plus *writers* so tests can
synthesize sparse models without COLMAP installed.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict

import numpy as np

# COLMAP camera model ids -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}
CAMERA_MODEL_NPARAMS = {name: n for _, (name, n) in CAMERA_MODELS.items()}


@dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # (num_params,)


@dataclass
class Image:
    id: int
    qvec: np.ndarray  # (4,) w, x, y, z
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str
    xys: np.ndarray  # (N, 2)
    point3D_ids: np.ndarray  # (N,)

    def qvec2rotmat(self) -> np.ndarray:
        from nsff_pl_tpu_torch.scene.poses import qvec2rotmat

        return qvec2rotmat(self.qvec)


@dataclass
class Point3D:
    id: int
    xyz: np.ndarray  # (3,)
    rgb: np.ndarray  # (3,) uint8
    error: float
    image_ids: np.ndarray  # (M,)
    point2D_idxs: np.ndarray  # (M,)


def _read(fid, fmt: str):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, fid.read(size))


# ---------------------------------------------------------------------------
# binary readers (the format the pipeline actually consumes,
# cf. datasets/colmap_utils.py:111,171,233)
# ---------------------------------------------------------------------------

def read_cameras_binary(path: str) -> Dict[int, Camera]:
    cams: Dict[int, Camera] = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, "<" + "d" * n_params))
            cams[cam_id] = Camera(cam_id, name, int(w), int(h), params)
    return cams


def read_images_binary(path: str) -> Dict[int, Image]:
    images: Dict[int, Image] = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            vals = _read(f, "<idddddddi")
            im_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            cam_id = vals[8]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, "<Q")
            data = np.frombuffer(f.read(24 * n_pts), dtype=np.float64).reshape(n_pts, 3)
            xys = data[:, :2].copy()
            ids = data[:, 2].copy().view(np.int64).reshape(-1)
            images[im_id] = Image(im_id, qvec, tvec, cam_id, name.decode(), xys, ids)
    return images


def read_points3d_binary(path: str) -> Dict[int, Point3D]:
    pts: Dict[int, Point3D] = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            pid, x, y, z, r, g, b, err = _read(f, "<QdddBBBd")
            (track_len,) = _read(f, "<Q")
            track = np.frombuffer(f.read(8 * track_len), dtype=np.int32).reshape(-1, 2)
            pts[pid] = Point3D(
                int(pid), np.array([x, y, z]), np.array([r, g, b], dtype=np.uint8),
                err, track[:, 0].copy(), track[:, 1].copy())
    return pts


# ---------------------------------------------------------------------------
# text readers (cf. datasets/colmap_utils.py:85,140,206)
# ---------------------------------------------------------------------------

def read_cameras_text(path: str) -> Dict[int, Camera]:
    cams: Dict[int, Camera] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            cams[int(el[0])] = Camera(int(el[0]), el[1], int(el[2]), int(el[3]),
                                      np.array([float(x) for x in el[4:]]))
    return cams


def read_images_text(path: str) -> Dict[int, Image]:
    images: Dict[int, Image] = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]
    for i in range(0, len(lines), 2):
        el = lines[i].split()
        im_id = int(el[0])
        qvec = np.array([float(x) for x in el[1:5]])
        tvec = np.array([float(x) for x in el[5:8]])
        cam_id, name = int(el[8]), el[9]
        el2 = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array([float(x) for x in el2]).reshape(-1, 3) if el2 else np.zeros((0, 3))
        images[im_id] = Image(im_id, qvec, tvec, cam_id, name,
                              xys[:, :2], xys[:, 2].astype(np.int64))
    return images


def read_points3D_text(path: str) -> Dict[int, Point3D]:
    pts: Dict[int, Point3D] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            pid = int(el[0])
            track = np.array([int(x) for x in el[8:]]).reshape(-1, 2)
            pts[pid] = Point3D(pid, np.array([float(x) for x in el[1:4]]),
                               np.array([int(x) for x in el[4:7]], dtype=np.uint8),
                               float(el[7]), track[:, 0], track[:, 1])
    return pts


def read_model(path: str, ext: str = ".bin"):
    """Read (cameras, images, points3D) — cf. datasets/colmap_utils.py:263-272."""
    if ext == ".txt":
        return (read_cameras_text(os.path.join(path, "cameras.txt")),
                read_images_text(os.path.join(path, "images.txt")),
                read_points3D_text(os.path.join(path, "points3D.txt")))
    return (read_cameras_binary(os.path.join(path, "cameras.bin")),
            read_images_binary(os.path.join(path, "images.bin")),
            read_points3d_binary(os.path.join(path, "points3D.bin")))


# ---------------------------------------------------------------------------
# binary writers (new — used by tests / preprocessing; no reference analog)
# ---------------------------------------------------------------------------

def write_cameras_binary(cams: Dict[int, Camera], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            mid = CAMERA_MODEL_IDS[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, mid, cam.width, cam.height))
            f.write(struct.pack("<" + "d" * len(cam.params), *cam.params))


def write_images_binary(images: Dict[int, Image], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<idddddddi", im.id, *im.qvec, *im.tvec, im.camera_id))
            f.write(im.name.encode() + b"\x00")
            n = len(im.point3D_ids)
            f.write(struct.pack("<Q", n))
            data = np.empty((n, 3), dtype=np.float64)
            data[:, :2] = im.xys
            data[:, 2] = np.asarray(im.point3D_ids, dtype=np.int64).view(np.float64)
            f.write(data.tobytes())


def write_points3d_binary(pts: Dict[int, Point3D], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        for p in pts.values():
            f.write(struct.pack("<QdddBBBd", p.id, *p.xyz, *p.rgb.tolist(), p.error))
            f.write(struct.pack("<Q", len(p.image_ids)))
            track = np.stack([np.asarray(p.image_ids, dtype=np.int32),
                              np.asarray(p.point2D_idxs, dtype=np.int32)], -1)
            f.write(track.tobytes())


def write_model(cams, images, pts, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    write_cameras_binary(cams, os.path.join(path, "cameras.bin"))
    write_images_binary(images, os.path.join(path, "images.bin"))
    write_points3d_binary(pts, os.path.join(path, "points3D.bin"))
