"""PFM depth-map I/O (port of `nsff_pl_tpu/scene/depthio.py`).

Re-implements `datasets/depth_utils.py:5-70`. Like the reference, the
current monocular pipeline reads disparities as 16-bit PNGs
(`datasets/monocular.py:98,158,287`); PFM support is kept for parity with
DPT-style monodepth outputs.
"""
from __future__ import annotations

import re

import numpy as np


def read_pfm(filename: str):
    """Read a PFM file -> (data, scale). Data is (H, W) or (H, W, 3) float."""
    with open(filename, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError("Not a PFM file.")

        dims = f.readline()
        while dims.startswith(b"#"):  # skip comments
            dims = f.readline()
        m = re.match(rb"^(\d+)\s(\d+)\s$", dims)
        if not m:
            raise ValueError("Malformed PFM header.")
        width, height = map(int, m.groups())

        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)

        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    data = np.reshape(data, shape)
    data = np.flipud(data)  # PFM stores rows bottom-to-top
    return data, scale


def save_pfm(filename: str, image: np.ndarray, scale: float = 1.0) -> None:
    """Write (H, W) or (H, W, 3) float32 data as PFM."""
    if image.dtype.name != "float32":
        raise ValueError("Image dtype must be float32.")
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
        image = image.reshape(image.shape[0], image.shape[1])
    else:
        raise ValueError("Image must have H x W x {1,3} shape.")

    image = np.flipud(image)
    if image.dtype.byteorder == "<" or (
            image.dtype.byteorder == "=" and np.little_endian):
        scale = -scale
    with open(filename, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        f.write(f"{scale}\n".encode())
        image.tofile(f)
