"""Optical-flow I/O and visualization (Middlebury `.flo` format); port of
`nsff_pl_tpu/scene/flowio.py`, with OpenCV's resize rules from
`scene/imageio.py` in place of OpenCV.

Covers the subset of the reference's `datasets/flowlib.py` the pipeline
uses — `.flo` read/write (`flowlib.py:297-317,38`), `resize_flow`
(`flowlib.py:320-338`), flow colorization (`flowlib.py:132-162,198,242`)
and endpoint-error metrics (`flowlib.py:81-130,181-196`).
"""
from __future__ import annotations

import numpy as np

from nsff_pl_tpu_torch.scene import imageio

FLO_MAGIC = 202021.25
# flow values larger than this are treated as unknown (Middlebury convention)
UNKNOWN_FLOW_THRESH = 1e7


def read_flow(filename: str) -> np.ndarray:
    """Read a Middlebury .flo file -> (H, W, 2) float32."""
    with open(filename, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if len(magic) == 0 or magic[0] != FLO_MAGIC:
            raise ValueError(f"{filename}: invalid .flo magic number")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flow(flow: np.ndarray, filename: str) -> None:
    """Write (H, W, 2) flow to a Middlebury .flo file."""
    h, w = flow.shape[:2]
    with open(filename, "wb") as f:
        np.float32(FLO_MAGIC).tofile(f)
        np.int32(w).tofile(f)
        np.int32(h).tofile(f)
        flow.astype(np.float32).tofile(f)


def resize_flow(flow: np.ndarray, des_width: int, des_height: int,
                method: str = "bilinear") -> np.ndarray:
    """Resize flow and rescale its components — `flowlib.py:320-338`."""
    src_h, src_w = flow.shape[:2]
    if src_w == des_width and src_h == des_height:
        return flow
    resize = imageio.resize_linear_cv2 if method == "bilinear" \
        else imageio.resize_nearest_cv2
    out = np.array(resize(flow, (des_width, des_height)), np.float32)
    out[..., 0] *= des_width / src_w
    out[..., 1] *= des_height / src_h
    return out


def make_color_wheel() -> np.ndarray:
    """Middlebury color wheel, (55, 3) uint-valued — `flowlib.py:242-294`."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[:RY, 0] = 255
    wheel[:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel


def compute_color(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Colorize a (H, W) flow field given per-pixel (u, v) — `flowlib.py:198-239`."""
    h, w = u.shape
    img = np.zeros((h, w, 3), dtype=np.uint8)
    nan_idx = np.isnan(u) | np.isnan(v)
    u = np.where(nan_idx, 0, u)
    v = np.where(nan_idx, 0, v)

    wheel = make_color_wheel()
    ncols = wheel.shape[0]
    rad = np.sqrt(u ** 2 + v ** 2)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1) + 1
    k0 = np.floor(fk).astype(int)
    k1 = k0 + 1
    k1[k1 == ncols + 1] = 1
    f = fk - k0
    for i in range(3):
        col0 = wheel[(k0 - 1) % ncols, i] / 255
        col1 = wheel[(k1 - 1) % ncols, i] / 255
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col = np.where(idx, 1 - rad * (1 - col), col * 0.75)
        img[:, :, i] = np.uint8(np.floor(255 * col * (1 - nan_idx)))
    return img


def flow_to_image(flow: np.ndarray, maxrad: float = -1) -> np.ndarray:
    """Flow field -> RGB visualization image — `flowlib.py:132-162`."""
    u, v = flow[..., 0].copy(), flow[..., 1].copy()
    unknown = (np.abs(u) > UNKNOWN_FLOW_THRESH) | (np.abs(v) > UNKNOWN_FLOW_THRESH)
    u[unknown] = 0
    v[unknown] = 0
    rad = np.sqrt(u ** 2 + v ** 2)
    if maxrad <= 0:
        maxrad = max(rad.max(), 1e-8)
    img = compute_color(u / maxrad, v / maxrad)
    img[unknown] = 0
    return img


def flow_error(tu, tv, u, v) -> float:
    """Average endpoint error over known pixels — `flowlib.py:81-130`."""
    known = (np.abs(tu) <= UNKNOWN_FLOW_THRESH) & (np.abs(tv) <= UNKNOWN_FLOW_THRESH)
    du, dv = u[known] - tu[known], v[known] - tv[known]
    return float(np.mean(np.sqrt(du ** 2 + dv ** 2)))


def evaluate_flow(gt_flow: np.ndarray, pred_flow: np.ndarray) -> float:
    """Endpoint error between two flow fields — `flowlib.py:181-196`."""
    return flow_error(gt_flow[..., 0], gt_flow[..., 1],
                      pred_flow[..., 0], pred_flow[..., 1])
