"""Novel-view evaluation: ``eval_nvs.py``'s render_set and ``train.py``'s
training visualisation.

Mirrors ``svgir_tpu.eval.nvs``: render each view, score it against its
ground truth (PSNR, SSIM, LPIPS when weights exist), write the renders,
ground truths and auxiliary buffers as 8-bit PNGs (through OpenCV) and a
metrics summary.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from svgir_tpu_torch.eval import metrics as M


def to_numpy(img) -> np.ndarray:
    if isinstance(img, torch.Tensor):
        return img.detach().float().cpu().numpy()
    return np.asarray(img)


def save_image(path: str, img) -> None:
    """Write img ([C, H, W] with C 1 or 3, [H, W, C] or [H, W], values in
    [0, 1]) as an 8-bit PNG: clipped, times 255, truncated."""
    import cv2

    arr = to_numpy(img)
    if arr.ndim == 3 and arr.shape[0] in (1, 3):
        arr = arr.transpose(1, 2, 0)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    if arr.ndim == 3:
        arr = np.ascontiguousarray(arr[..., ::-1])          # RGB -> BGR
    if not cv2.imwrite(path, arr):
        raise OSError(f"OpenCV could not write {path}")


def warn_overflow(res, name: str, idx: int) -> bool:
    if "overflow" in res and bool(torch.as_tensor(res["overflow"]).any()):
        print(f"WARNING: instance-buffer overflow rendering {name} view "
              f"{idx}: splats were dropped — raise --max_instances",
              flush=True)
        return True
    return False


def render_set(out_dir: str, name: str, cameras: List,
               render_one: Callable,
               save_buffers: tuple = ("render", "depth", "opacity"),
               lpips_weights: Optional[str] = None) -> Dict:
    """eval_nvs.py render_set (:29-90): render each view with
    ``render_one(cam)`` (a dict with ``render`` [3, H, W]), score it
    against ``cam.image``, write ``<name>/renders``, ``<name>/gt``,
    ``<name>/metrics.json`` and ``metric_<name>.txt`` under ``out_dir``.
    LPIPS is the mean over the views, or the note of ``lpips_status``."""
    img_dir = os.path.join(out_dir, name, "renders")
    gt_dir = os.path.join(out_dir, name, "gt")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)

    psnrs, ssims, lpipss = [], [], []
    warned = False
    for idx, cam in enumerate(cameras):
        res = render_one(cam)
        warned = warned or warn_overflow(res, name, idx)
        pred = torch.clamp(res["render"], 0, 1)
        gt = cam.image
        psnrs.append(M.psnr(pred, gt))
        ssims.append(M.ssim(pred, gt))
        lp = M.lpips(pred, gt, lpips_weights)
        if lp is not None:
            lpipss.append(lp)
        save_image(os.path.join(img_dir, f"{idx:05d}.png"), pred)
        save_image(os.path.join(gt_dir, f"{idx:05d}.png"), gt)
        for key in save_buffers:
            if key == "render" or key not in res:
                continue
            buf = res[key]
            if key == "depth":
                d = to_numpy(buf)[0]
                buf = ((d - d.min()) / (d.max() - d.min() + 1e-8))[None]
            elif key in ("normal", "pseudo_normal"):
                buf = buf * 0.5 + 0.5      # train.py:403 save convention
            save_image(os.path.join(img_dir, f"{idx:05d}_{key}.png"), buf)

    _, note = M.lpips_status(lpips_weights)
    out = {
        "psnr": float(np.mean(psnrs)) if psnrs else float("nan"),
        "ssim": float(np.mean(ssims)) if ssims else float("nan"),
        # never a silently missing column
        "lpips": float(np.mean(lpipss)) if lpipss else note,
        "n_views": len(cameras),
    }
    with open(os.path.join(out_dir, name, "metrics.json"), "w") as f:
        json.dump(out, f, indent=2)
    # the reference's text twin (eval_nvs.py:86-89, train.py:421-424)
    with open(os.path.join(out_dir, f"metric_{name}.txt"), "w") as f:
        f.write(f"psnr: {out['psnr']}\n")
        f.write(f"ssim: {out['ssim']}\n")
        f.write(f"lpips: {out['lpips']}\n")
    return out


VIS_KEYS = ("render", "pbr", "base_color", "roughness", "diffuse",
            "local_lights", "visibility", "normal", "pseudo_normal", "depth",
            "opacity")


def save_training_vis(out_dir: str, iteration: int, results: Dict,
                      gt_image=None) -> None:
    """The training visualisation (train.py save_training_vis :319-363):
    the ground truth and the buffers of ``results`` that exist, side by
    side in one PNG ``iter_<iteration>.png``."""
    tiles = []
    for key in VIS_KEYS:
        if key not in results:
            continue
        img = to_numpy(results[key])
        if key == "depth":
            d = img[0]
            img = np.stack([(d - d.min()) / (d.max() - d.min() + 1e-8)] * 3)
        elif key in ("normal", "pseudo_normal"):
            img = img * 0.5 + 0.5
        elif img.shape[0] == 1:
            img = np.repeat(img, 3, 0)
        tiles.append(np.clip(img[:3], 0, 1))
    if gt_image is not None:
        tiles.insert(0, to_numpy(gt_image))
    if not tiles:
        return
    os.makedirs(out_dir, exist_ok=True)
    save_image(os.path.join(out_dir, f"iter_{iteration:06d}.png"),
               np.concatenate(tiles, axis=2))
