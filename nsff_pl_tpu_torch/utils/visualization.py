"""Visualization helpers for logged image grids (port of
`nsff_pl_tpu/utils/visualization.py`), on numpy: (H, W, 3) float RGB in
[0, 1] out.

OpenCV's JET and BONE colormaps are the 256-entry RGB tables below
(`cv2.applyColorMap` of 0..255, held against OpenCV in the tests);
`blend_images` is `cv2.addWeighted(a, alpha, b, 1 - alpha, 2.2)` on
uint8: a * alpha + (b * beta + gamma) as two fused multiply-adds in
float32 (OpenCV's vector loop), rounded half to even, then saturated.
"""
from __future__ import annotations

import numpy as np

_JET_RGB = bytes.fromhex(
    "00008000008400008800008c00009000009400009800009c0000a00000a40000a80000ac"
    "0000b00000b40000b80000bc0000c00000c40000c80000cc0000d00000d40000d80000dc"
    "0000e00000e40000e80000ec0000f00000f40000f80000fc0000ff0004ff0008ff000cff"
    "0010ff0014ff0018ff001cff0020ff0024ff0028ff002cff0030ff0034ff0038ff003cff"
    "0040ff0044ff0048ff004cff0050ff0054ff0058ff005cff0060ff0064ff0068ff006cff"
    "0070ff0074ff0078ff007cff0080ff0084ff0088ff008cff0090ff0094ff0098ff009cff"
    "00a0ff00a4ff00a8ff00acff00b0ff00b4ff00b8ff00bcff00c0ff00c4ff00c8ff00ccff"
    "00d0ff00d4ff00d8ff00dcff00e0ff00e4ff00e8ff00ecff00f0ff00f4ff00f8ff00fcff"
    "02fffe06fffa0afff60efff212ffee16ffea1affe61effe222ffde26ffda2affd62effd2"
    "32ffce36ffca3affc63effc242ffbe46ffba4affb64effb252ffae56ffaa5affa65effa2"
    "62ff9e66ff9a6aff966eff9272ff8e76ff8a7aff867eff8282ff7e86ff7a8aff768eff72"
    "92ff6e96ff6a9aff669eff62a2ff5ea6ff5aaaff56aeff52b2ff4eb6ff4abaff46beff42"
    "c2ff3ec6ff3acaff36ceff32d2ff2ed6ff2adaff26deff22e2ff1ee6ff1aeaff16eeff12"
    "f2ff0ef6ff0afaff06feff01fffc00fff800fff400fff000ffec00ffe800ffe400ffe000"
    "ffdc00ffd800ffd400ffd000ffcc00ffc800ffc400ffc000ffbc00ffb800ffb400ffb000"
    "ffac00ffa800ffa400ffa000ff9c00ff9800ff9400ff9000ff8c00ff8800ff8400ff8000"
    "ff7c00ff7800ff7400ff7000ff6c00ff6800ff6400ff6000ff5c00ff5800ff5400ff5000"
    "ff4c00ff4800ff4400ff4000ff3c00ff3800ff3400ff3000ff2c00ff2800ff2400ff2000"
    "ff1c00ff1800ff1400ff1000ff0c00ff0800ff0400ff0000fc0000f80000f40000f00000"
    "ec0000e80000e40000e00000dc0000d80000d40000d00000cc0000c80000c40000c00000"
    "bc0000b80000b40000b00000ac0000a80000a40000a000009c0000980000940000900000"
    "8c0000880000840000800000"
)
_BONE_RGB = bytes.fromhex(
    "00000001010102020203030404040504040605050706060807070a08080b09090c0a0a0d"
    "0a0a0e0b0b100c0c110d0d120e0e130f0f1510101611111712121812121913131b14141c"
    "15151d16161e17171f1818211818221919231a1a241b1b251c1c271d1d281e1e291f1f2a"
    "20202b20202d21212e22222f232330242432252533262634262635272736282838292939"
    "2a2a3a2b2b3b2c2c3c2d2d3e2e2e3f2e2e402f2f41303042313144323245333346343447"
    "34344835354a36364b37374c38384d39394f3a3a503b3b513c3c523c3c533d3d553e3e56"
    "3f3f5740405841415942425b42425c43435d44445e45455f464661474762484863494964"
    "4949664a4a674b4b684c4c694d4d6a4e4e6c4f4f6d50506e50506f515170525271535373"
    "545474555575565776575876575977585a78595b795a5d7a5b5e7b5c5f7c5d607d5e617e"
    "5e637e5f647f606580616681626782636983646a84656b84666c85666e86676f87687088"
    "6971896a728a6b748b6c758c6c768c6d778d6e788e6f7a8f707b90717c91727d92737e92"
    "7480937481947582957683967784977886987987997a889a7a899a7b8a9b7c8c9c7d8d9d"
    "7e8e9e7f8f9f8091a08192a08293a18294a28395a38497a48598a58699a6879aa7889ba8"
    "889da8899ea98a9faa8ba0ab8ca1ac8da3ad8ea4ae8fa5ae90a6af90a8b091a9b192aab2"
    "93abb394acb495aeb596afb696b0b697b1b798b2b899b4b99ab5ba9bb6bb9cb7bc9db8bc"
    "9ebabd9ebbbe9fbcbfa0bdc0a1bec1a2c0c2a3c1c3a4c2c4a4c3c4a5c4c5a6c6c6a7c7c7"
    "a9c8c8aac9c9abcacaaccbcbaecbcbafccccb1cdcdb2ceceb3cfcfb5d0d0b6d1d1b8d2d2"
    "b9d2d2bad3d3bcd4d4bdd5d5bed6d6c0d7d7c1d8d8c3d8d8c4d9d9c5dadac7dbdbc8dcdc"
    "c9ddddcbdedeccdfdfcee0e0cfe0e0d0e1e1d2e2e2d3e3e3d4e4e4d6e5e5d7e6e6d8e7e7"
    "dae7e7dbe8e8dde9e9deeaeadfebebe1ecece2edede4eeeee5eeeee6efefe8f0f0e9f1f1"
    "eaf2f2ecf3f3edf4f4eff4f4f0f5f5f1f6f6f3f7f7f4f8f8f5f9f9f7fafaf8fbfbfafcfc"
    "fbfcfcfcfdfdfefefeffffff"
)
JET = np.frombuffer(_JET_RGB, np.uint8).reshape(256, 3)
BONE = np.frombuffer(_BONE_RGB, np.uint8).reshape(256, 3)


def visualize_depth(depth: np.ndarray, cmap: np.ndarray = JET) -> np.ndarray:
    """(H, W) depth -> (H, W, 3) float RGB in [0, 1]: min-max normalised,
    then the colormap."""
    x = np.nan_to_num(np.asarray(depth, dtype=np.float32))
    mi, ma = x.min(), x.max()
    x = (x - mi) / (ma - mi + 1e-8)
    x = (255 * x).astype(np.uint8)
    return cmap[x].astype(np.float32) / 255.0


def visualize_mask(mask: np.ndarray, cmap: np.ndarray = BONE) -> np.ndarray:
    """(H, W) mask in [0, 1] -> (H, W, 3) float RGB, BONE colormap."""
    x = (255 * np.clip(np.asarray(mask, dtype=np.float32), 0, 1)).astype(
        np.uint8)
    return cmap[x].astype(np.float32) / 255.0


def blend_images(img1: np.ndarray, img2: np.ndarray,
                 alpha: float) -> np.ndarray:
    """alpha-blend two (H, W, 3) float images on uint8."""
    a = (255 * np.clip(img1, 0, 1)).astype(np.uint8).astype(np.float64)
    b = (255 * np.clip(img2, 0, 1)).astype(np.uint8).astype(np.float64)
    f32 = lambda v: np.float64(np.float32(v))  # noqa: E731
    # a float32 fused multiply-add is exact in float64, rounded once
    inner = np.float32(b * f32(1 - alpha) + f32(2.2))
    t = np.float32(a * f32(alpha) + inner.astype(np.float64))
    blend = np.clip(np.rint(t), 0, 255).astype(np.uint8)
    return blend.astype(np.float32) / 255.0


def make_grid(images, nrow: int = 3) -> np.ndarray:
    """Tile (H, W, 3) images into a grid, `nrow` per row; an (H, W) image
    is shown as depth."""
    if not images:
        return np.zeros((1, 1, 3), np.float32)
    h, w = images[0].shape[:2]
    imgs = [np.clip(np.asarray(im, np.float32), 0, 1) if im.ndim == 3
            else visualize_depth(im) for im in images]
    n = len(imgs)
    ncol = nrow
    nrows = (n + ncol - 1) // ncol
    grid = np.zeros((nrows * h, ncol * w, 3), np.float32)
    for i, im in enumerate(imgs):
        r, c = divmod(i, ncol)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = im
    return grid
