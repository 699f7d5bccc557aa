"""Procedural Blender-format scene at TensoIR scale, the twin of the
repository's ``tools/make_synth_dataset.py``:

    python -m svgir_tpu_torch.cli.make_synth_dataset --out scenes/synth800 \\
        --res 800 --views 100 --test-views 10 --n-gt 20000

The TensoIR datasets the recipe (script/run_tensoir.sh) trains on do not
ship, so this writes a scene of their shape: ``{train,test}/r_<i>.png``
(RGBA) and ``transforms_{train,test}.json``.  The ground truth is the
stand-in's known PBR surfel model (``eval/standin.make_gt_model``) on a
ring of cameras (``ring_cameras``), rendered in eval mode under a fixed
synthetic HDR light (``make_env``) with its radiance baked at
``--sample-num`` samples (``render_gt_views``).  The JSON holds the
inverse of the reader's OpenGL -> COLMAP flip, so that
``data/readers.read_blender_scene`` loads back exactly these cameras.

The flags are those of the tool, plus ``--device`` (``cuda`` unless asked
for ``cpu``).  The random draws (the surfels' directions, the light's base
map and azimuth, the bake's spiral azimuths) come from a
``torch.Generator`` seeded with ``--seed``, or are passed to
``make_dataset``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

import cv2
import numpy as np
import torch

from svgir_tpu_torch.config import RasterConfig
from svgir_tpu_torch.eval.standin import (make_env, make_gt_model,
                                          render_gt_views, ring_cameras)

ENV_H = 16                # the light's map height (make_env's default)
MAX_INSTANCES = 1 << 20   # the GT renders' instance buffer (the tool's)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="procedural TensoIR-shaped "
                                 "scene from the stand-in's GT model")
    ap.add_argument("--out", required=True)
    ap.add_argument("--res", type=int, default=800)
    ap.add_argument("--views", type=int, default=100)
    ap.add_argument("--test-views", type=int, default=10)
    ap.add_argument("--n-gt", type=int, default=20000)
    ap.add_argument("--sample-num", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on")
    return ap


def write_frames(out: str, split: str, cams) -> None:
    """``cams`` (rendered: image, image_mask) as ``<split>/r_<i>.png`` and
    ``transforms_<split>.json``."""
    os.makedirs(os.path.join(out, split), exist_ok=True)
    frames = []
    for i, cam in enumerate(cams):
        img = cam.image.detach().cpu().numpy().transpose(1, 2, 0)
        alpha = cam.image_mask.detach().cpu().numpy()[0]
        rgba = np.concatenate([np.clip(img, 0, 1), alpha[..., None]], -1)
        name = f"./{split}/r_{i}"
        u8 = (rgba * 255).round().astype(np.uint8)
        if not cv2.imwrite(os.path.join(out, f"{name[2:]}.png"),
                           cv2.cvtColor(u8, cv2.COLOR_RGBA2BGRA)):
            raise OSError(f"could not write {name[2:]}.png under {out}")
        # the reader flips OpenGL -> COLMAP axes: write the inverse
        c2w = np.linalg.inv(cam.world_view.detach().cpu().numpy()
                            .astype(np.float64))
        c2w[:3, 1:3] *= -1
        frames.append({"file_path": name, "transform_matrix": c2w.tolist()})
    with open(os.path.join(out, f"transforms_{split}.json"), "w") as f:
        json.dump({"camera_angle_x": float(cams[0].fovx), "frames": frames},
                  f)


def make_dataset(out: str, *, res: int = 800, views: int = 100,
                 test_views: int = 10, n_gt: int = 20000,
                 sample_num: int = 24, seed: int = 0,
                 dirs_draw=None, env_base_draw=None, env_az_draw=None,
                 bake_az_draw=None, device="cuda",
                 verbose: bool = True) -> List:
    """Render and write the scene; returns the rendered cameras (train,
    then test).  The draws: ``dirs_draw`` [n_gt, 3]
    standard normal (the surfels' directions), ``env_base_draw`` [4, 8, 3]
    and ``env_az_draw`` (one) uniform (the light), ``bake_az_draw``
    [n_gt, 1] uniform (the spirals of the GT bake); each one not given is
    drawn, in that order, from a generator seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    if dirs_draw is None:
        dirs_draw = torch.randn(n_gt, 3, generator=gen)
    if env_base_draw is None:
        env_base_draw = torch.rand(4, 8, 3, generator=gen)
    if env_az_draw is None:
        env_az_draw = torch.rand((), generator=gen)
    if bake_az_draw is None:
        bake_az_draw = torch.rand(n_gt, 1, generator=gen)
    az = torch.tensor(np.array(bake_az_draw, np.float32)).to(device)

    state = make_gt_model(n=n_gt, dirs_draw=dirs_draw, device=device)
    env = make_env(h=ENV_H, base_draw=env_base_draw, az_draw=env_az_draw,
                   device=device)
    cams = ring_cameras(views + test_views, res, device=device)
    if verbose:
        print(f"rendering {len(cams)} GT views at {res}px ({n_gt} surfels, "
              f"S={sample_num})", flush=True)
    rendered = render_gt_views(state, env, cams, sample_num=sample_num,
                               cfg=RasterConfig(max_instances=MAX_INSTANCES),
                               azimuth=az)
    write_frames(out, "train", rendered[:views])
    write_frames(out, "test", rendered[views:])
    if verbose:
        print(f"wrote {views}+{test_views} views to {out}", flush=True)
    return rendered


def main(argv: Optional[list] = None) -> None:
    args = build_parser().parse_args(argv)
    make_dataset(args.out, res=args.res, views=args.views,
                 test_views=args.test_views, n_gt=args.n_gt,
                 sample_num=args.sample_num, seed=args.seed,
                 device=args.device)


if __name__ == "__main__":
    main()
