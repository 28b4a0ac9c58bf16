"""Motion masks for dynamic objects (port of `nsff_pl_tpu/scene/masks.py`).

A COCO Mask-RCNN marks pixels of movable categories (person, vehicles,
animals, balls, ...) as dynamic; the mask is eroded (the dynamic region
inflated, since 0 marks dynamic) with a 15x15 box and written as
`masks/<name>.png` after the image's full name (`x.png` -> `x.png.png`:
COLMAP's `--ImageReader.mask_path` expects that name).

detectron2 is not a dependency, so the predictor is gated: without it
`predict_masks` raises the JAX package's `RuntimeError`, and
`trivial_masks` (all static) serves scenes without dynamic objects.
Images are read by OpenCV's rule (`imageio.imread_color`: a JPEG turned
by its EXIF orientation) and masks written as grey PNGs, with no PIL or
OpenCV.
"""
from __future__ import annotations

import glob
import os

import numpy as np

from nsff_pl_tpu_torch.scene import imageio

# COCO class ids treated as dynamic (person, vehicles, animals, ball, ...)
DYNAMIC_CATEGORIES = [0, 1, 2, 3, 5, 7, 14, 15, 16, 17, 18, 19, 20, 21, 32]
SCORE_THRESHOLD = 0.05
ERODE_KERNEL = 15


def _mask_path(out_dir: str, image_path: str) -> str:
    return os.path.join(out_dir, os.path.basename(image_path) + ".png")


def predict_masks(root_dir: str, categories=None,
                  score_thresh: float = SCORE_THRESHOLD) -> int:
    """Run Mask-RCNN (on the card: detectron2's default device) over
    `root_dir/images/*` and write the masks. Returns the number written.
    Raises RuntimeError when detectron2 is unavailable."""
    try:
        from detectron2 import model_zoo
        from detectron2.config import get_cfg
        from detectron2.engine import DefaultPredictor
    except Exception as e:
        raise RuntimeError(
            "detectron2 is required for mask prediction but is not "
            "installed; install it or provide masks/ yourself "
            f"(import error: {e})")

    categories = categories or DYNAMIC_CATEGORIES
    cfg = get_cfg()
    cfg.merge_from_file(model_zoo.get_config_file(
        "COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_3x.yaml"))
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = score_thresh
    cfg.MODEL.WEIGHTS = model_zoo.get_checkpoint_url(
        "COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_3x.yaml")
    predictor = DefaultPredictor(cfg)

    out_dir = os.path.join(root_dir, "masks")
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for path in sorted(glob.glob(os.path.join(root_dir, "images", "*"))):
        # the predictor takes BGR, as cv2.imread gives it
        img = np.ascontiguousarray(imageio.imread_color(path)[..., ::-1])
        inst = predictor(img)["instances"]
        mask = np.full(img.shape[:2], 255, np.uint8)  # 255 = static
        for cls, m in zip(inst.pred_classes.cpu().numpy(),
                          inst.pred_masks.cpu().numpy()):
            if int(cls) in categories:
                mask[m] = 0  # dynamic
        mask = imageio.erode_cv2(mask, ERODE_KERNEL)
        imageio.write_image(_mask_path(out_dir, path), mask)
        n += 1
    return n


def trivial_masks(root_dir: str) -> int:
    """All-static masks (for scenes without dynamic objects, or when
    detectron2 is unavailable and masks are provided some other way)."""
    out_dir = os.path.join(root_dir, "masks")
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for path in sorted(glob.glob(os.path.join(root_dir, "images", "*"))):
        h, w = imageio.imread_color(path).shape[:2]
        imageio.write_image(_mask_path(out_dir, path),
                            np.full((h, w), 255, np.uint8))
        n += 1
    return n
