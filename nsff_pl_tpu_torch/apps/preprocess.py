#!/usr/bin/env python
"""Offline preprocessing driver: video frames -> (images, masks, COLMAP
poses, monodepth disparities, RAFT optical flow). Port of
`nsff_pl_tpu/apps/preprocess.py`: the same flags, defaults, stage order,
skip-if-present rules and exit messages, on numpy (no OpenCV or PIL).

Every stage is idempotent (skipped when its output directory exists):

    resize   : cap frames at max_w x max_h (OpenCV's INTER_AREA rule,
               `imageio.resize_area_cv2`), each written back in its own
               format: a JPEG frame as the JPEG OpenCV writes
    masks    : Mask-RCNN motion masks (gates COLMAP features + the losses)
    colmap   : feature_extractor (masked, SIMPLE_RADIAL single camera) ->
               exhaustive_matcher -> mapper -> image_undistorter
    depth    : DPT monodepth -> disps/
    flow     : RAFT forward/backward -> flow_fw/*.flo, flow_bw/*.flo

COLMAP, DPT and RAFT are separate programs `run` starts; each stage
exits with a clear message when its tool is missing rather than failing
mid-run. Console script: `nsff-preprocess-torch`.
"""
from __future__ import annotations

import argparse
import glob
import os
import shutil
import subprocess
import sys

from nsff_pl_tpu_torch.scene import imageio


def run(cmd: str) -> int:
    print(f"[preprocess] $ {cmd}", flush=True)
    return subprocess.call(cmd, shell=True)


def resize_frames(root_dir: str, max_w: int = 1280, max_h: int = 720):
    """frames/ -> frames_resized/ capped at max_w x max_h, never enlarged:
    `int(w * scale)` x `int(h * scale)`, each frame read as `cv2.imread`
    reads it and written in its own format."""
    out_dir = os.path.join(root_dir, "frames_resized")
    if os.path.isdir(out_dir):
        print("[preprocess] frames_resized exists, skipping")
        return
    os.makedirs(out_dir)
    frames = sorted(glob.glob(os.path.join(root_dir, "frames", "*")))
    if not frames:
        sys.exit(f"no frames found under {root_dir}/frames")
    for f in frames:
        img = imageio.imread_color(f)
        h, w = img.shape[:2]
        scale = min(max_w / w, max_h / h, 1.0)
        if scale < 1.0:
            img = imageio.resize_area_cv2(img, (int(w * scale),
                                                int(h * scale)))
        imageio.write_image(os.path.join(out_dir, os.path.basename(f)), img)
    print(f"[preprocess] resized {len(frames)} frames")


def generate_masks(root_dir: str):
    """Motion masks via Mask-RCNN (`scene/masks.py::predict_masks`, gated
    on detectron2) on a temporary copy of frames_resized/ as images/."""
    mask_dir = os.path.join(root_dir, "masks")
    if os.path.isdir(mask_dir):
        print("[preprocess] masks exist, skipping")
        return
    img_dir = os.path.join(root_dir, "images")
    tmp = not os.path.isdir(img_dir)
    if tmp:
        shutil.copytree(os.path.join(root_dir, "frames_resized"), img_dir)
    try:
        from nsff_pl_tpu_torch.scene.masks import predict_masks

        predict_masks(root_dir)
    finally:
        if tmp:
            shutil.rmtree(img_dir)


def run_colmap(root_dir: str, colmap_bin: str = "colmap"):
    """SfM with masked features, single SIMPLE_RADIAL camera."""
    if os.path.isdir(os.path.join(root_dir, "sparse")):
        print("[preprocess] sparse/ exists, skipping colmap")
        return
    if shutil.which(colmap_bin) is None:
        sys.exit(f"COLMAP binary {colmap_bin!r} not found — install COLMAP "
                 "or pass --colmap_bin")
    db = os.path.join(root_dir, "database.db")
    frames = os.path.join(root_dir, "frames_resized")
    masks = os.path.join(root_dir, "masks")
    rc = run(
        f"{colmap_bin} feature_extractor "
        f"--database_path {db} --image_path {frames} "
        f"--ImageReader.mask_path {masks} "
        f"--ImageReader.camera_model SIMPLE_RADIAL "
        f"--ImageReader.single_camera 1")
    rc |= run(f"{colmap_bin} exhaustive_matcher --database_path {db}")
    os.makedirs(os.path.join(root_dir, "sparse"), exist_ok=True)
    rc |= run(f"{colmap_bin} mapper --database_path {db} "
              f"--image_path {frames} "
              f"--output_path {os.path.join(root_dir, 'sparse')}")
    rc |= run(f"{colmap_bin} image_undistorter "
              f"--input_path {os.path.join(root_dir, 'sparse/0')} "
              f"--image_path {frames} "
              f"--output_path {root_dir} --output_type COLMAP")
    if rc:
        sys.exit("COLMAP stage failed")


def generate_depth(root_dir: str, dpt_root: str):
    """DPT monodepth -> disps/."""
    if os.path.isdir(os.path.join(root_dir, "disps")):
        print("[preprocess] disps exist, skipping")
        return
    if not dpt_root or not os.path.isdir(dpt_root):
        sys.exit("DPT checkout not found — pass --dpt_root (clone of "
                 "github.com/isl-org/DPT with run_monodepth.py)")
    rc = run(f"cd {dpt_root} && python run_monodepth.py "
             f"-i {os.path.join(root_dir, 'images')} "
             f"-o {os.path.join(root_dir, 'disps')} -t dpt_large")
    if rc:
        sys.exit("DPT stage failed")


def generate_flow(root_dir: str, raft_root: str):
    """RAFT fw/bw optical flow -> flow_fw/ flow_bw/."""
    if os.path.isdir(os.path.join(root_dir, "flow_fw")):
        print("[preprocess] flows exist, skipping")
        return
    if not raft_root or not os.path.isdir(raft_root):
        sys.exit("RAFT checkout not found — pass --raft_root (clone of "
                 "github.com/princeton-vl/RAFT with demo.py)")
    rc = run(f"cd {raft_root} && python demo.py "
             f"--model models/raft-things.pth "
             f"--path {os.path.join(root_dir, 'images')} "
             f"--outdir {root_dir}")
    if rc:
        sys.exit("RAFT stage failed")


STAGES = ["resize", "masks", "colmap", "depth", "flow"]


def get_opts(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--root_dir", type=str, required=True,
                        help="scene root containing frames/")
    parser.add_argument("--max_w", type=int, default=1280)
    parser.add_argument("--max_h", type=int, default=720)
    parser.add_argument("--colmap_bin", type=str,
                        default=os.environ.get("COLMAP_BIN", "colmap"))
    parser.add_argument("--dpt_root", type=str,
                        default=os.environ.get("DPT_ROOT", "third_party/depth"))
    parser.add_argument("--raft_root", type=str,
                        default=os.environ.get("RAFT_ROOT", "third_party/flow"))
    parser.add_argument("--stages", nargs="+", default=list(STAGES),
                        choices=STAGES)
    return parser.parse_args(argv)


def main(args):
    stages = {
        "resize": lambda: resize_frames(args.root_dir, args.max_w, args.max_h),
        "masks": lambda: generate_masks(args.root_dir),
        "colmap": lambda: run_colmap(args.root_dir, args.colmap_bin),
        "depth": lambda: generate_depth(args.root_dir, args.dpt_root),
        "flow": lambda: generate_flow(args.root_dir, args.raft_root),
    }
    for s in args.stages:
        stages[s]()


def cli(argv=None):
    """Console entry point (`nsff-preprocess-torch`)."""
    main(get_opts(argv))


if __name__ == "__main__":
    cli()
