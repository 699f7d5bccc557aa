"""Normal-map evaluation, the twin of the repository's ``normal_eval.py``:

    python -m svgir_tpu_torch.cli.normal_eval --pred_dir a --gt_dir b

The mean angular error (degrees) of rendered normal PNGs against ground
truth normal PNGs, the [0, 1] encoding decoded back to [-1, 1] vectors;
the files of each directory that match ``--pattern``, paired in sorted
order, read through OpenCV.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def get_mae(pred: np.ndarray, gt: np.ndarray) -> float:
    """normal_eval.py:11-18: mean angular error over the pixels whose GT
    vector is longer than 0.5."""
    pred_v = pred * 2.0 - 1.0
    gt_v = gt * 2.0 - 1.0
    mask = np.linalg.norm(gt_v, axis=-1) > 0.5
    pred_n = pred_v / np.clip(np.linalg.norm(pred_v, axis=-1, keepdims=True),
                              1e-8, None)
    gt_n = gt_v / np.clip(np.linalg.norm(gt_v, axis=-1, keepdims=True),
                          1e-8, None)
    cos = np.clip((pred_n * gt_n).sum(-1), -1, 1)
    ang = np.degrees(np.arccos(cos))
    return float(ang[mask].mean())


def read_rgb(path: str) -> np.ndarray:
    """An 8-bit image as float32 RGB [H, W, 3] in [0, 1]."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise ValueError(f"{path}: OpenCV could not read the image")
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    return img[..., 2::-1].astype(np.float32) / 255          # BGR -> RGB


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="svgir_tpu_torch normal-map MAE")
    parser.add_argument("--pred_dir", required=True)
    parser.add_argument("--gt_dir", required=True)
    parser.add_argument("--pattern", default="*.png")
    args = parser.parse_args(argv)

    preds = sorted(glob.glob(os.path.join(args.pred_dir, args.pattern)))
    gts = sorted(glob.glob(os.path.join(args.gt_dir, args.pattern)))
    assert len(preds) == len(gts) and preds, \
        f"{len(preds)} pred vs {len(gts)} gt images"
    maes = [get_mae(read_rgb(p), read_rgb(g)) for p, g in zip(preds, gts)]
    print(f"MAE: {np.mean(maes):.4f} deg over {len(maes)} images")
    return float(np.mean(maes))


if __name__ == "__main__":
    main()
