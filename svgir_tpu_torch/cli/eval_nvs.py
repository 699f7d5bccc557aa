"""Novel-view evaluation CLI, the twin of the repository's ``eval_nvs.py``:

    python -m svgir_tpu_torch.cli.eval_nvs -s <scene> -m out/lego \\
        -c out/lego/chkpnt30000.npz [-t render_relight] [--device cpu]

Renders a checkpoint (written by either package) from the scene's train
and test cameras at ``--eval_scale`` (4 by default, the reference's
scale-4 camera set), scores each view against its image (PSNR, SSIM and
LPIPS where weights exist, ``eval/nvs.render_set``) and writes
``<-m>/eval/{train,test}/`` (renders, ground truths, ``metrics.json``)
and ``metric_{train,test}.txt``; prints the metrics as JSON.

``-t render`` renders stage 1.  ``-t render_relight`` renders stage 2
with the checkpoint's env map and its bake; a checkpoint without a bake
is baked once, as the reference does (``bake_radiance`` at k 16 over the
alive surfels, unturned spirals, the grid tracer from a capacity of 4096
rows): one pass, no re-bake at a larger k.  The flags are those of
``eval_nvs.py`` plus ``--device`` (``cuda`` unless asked for ``cpu``).
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from svgir_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                    RasterConfig, add_to_parser, from_args)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="svgir_tpu_torch novel-view evaluation")
    add_to_parser(ModelConfig, parser, "Loading Parameters")
    parser.add_argument("-c", "--checkpoint", required=True)
    parser.add_argument("-t", "--type", default="render",
                        choices=["render", "render_relight"])
    parser.add_argument("--sample_num", type=int, default=64)
    parser.add_argument("--max_instances", type=int, default=1 << 20)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--max_cameras", type=int, default=None)
    # the reference renders the scale-4 camera set (eval_nvs.py:133-136)
    parser.add_argument("--eval_scale", type=float, default=4.0)
    parser.add_argument("--device", default="cuda",
                        help="torch device to render on")
    return parser


def bake_once(params, alive, *, sample_num: int) -> dict:
    """The bake of a checkpoint that has none (eval_nvs.py:68-74): one pass
    at k 16 over the alive surfels, the spirals unturned, the tracer
    chosen by the capacity as the reference chooses it."""
    from svgir_tpu_torch.eval.relighting import bake_hemisphere
    from svgir_tpu_torch.models.gaussians import GRID_FROM

    return bake_hemisphere(params, alive, sample_num=sample_num,
                           use_grid=alive.shape[0] >= GRID_FROM)


def main(argv=None):
    args = build_parser().parse_args(argv)
    model_cfg = from_args(ModelConfig, args)
    raster_cfg = RasterConfig(max_instances=args.max_instances)
    dev = args.device

    from svgir_tpu_torch.data.readers import load_scene
    from svgir_tpu_torch.eval.nvs import render_set
    from svgir_tpu_torch.models import lights as LT
    from svgir_tpu_torch.train import checkpoint as CK
    from svgir_tpu_torch.train.staging import stage_cameras
    from svgir_tpu_torch.train.trainer import strip_meta

    scene = load_scene(model_cfg.source_path,
                       white_background=model_cfg.white_background,
                       eval_split=True, resolution=model_cfg.resolution,
                       max_cameras=args.max_cameras)
    _, tree = CK.load_checkpoint(args.checkpoint, device=dev)
    state = tree["state"]
    params, alive = state["params"], state["alive"].to(bool)
    bg = torch.full((3,), 1.0 if model_cfg.white_background else 0.0,
                    device=dev)
    out_dir = os.path.join(model_cfg.model_path or ".", "eval")
    opt = OptimizationConfig()

    if args.type == "render":
        from svgir_tpu_torch.render.stage1 import render_stage1

        def render(cam):
            return render_stage1(cam, params, bg, opt=opt,
                                 is_training=False, alive=alive,
                                 cfg=raster_cfg)
    else:
        from svgir_tpu_torch.render.svgss import render_svgss

        bake = tree.get("extra")
        if bake is None:
            with torch.no_grad():
                bake = bake_once(params, alive, sample_num=args.sample_num)
        bake = {k: v for k, v in bake.items() if k != "exhausted_frac"}
        if "incident_qxy" not in bake:          # a bake saved by svgir_tpu
            bake["incident_qxy"] = torch.stack(
                LT.equirect_grid_coords(bake["incident_dirs"]), -1)
        env = tree["env"]

        def render(cam):
            return render_svgss(cam, params, bg, bake=bake,
                                env_params=env["params"], opt=opt,
                                is_training=False, alive=alive,
                                cfg=raster_cfg)

    @torch.no_grad()
    def render_one(cam):
        return render(stage_cameras([strip_meta(cam)], device=dev)[0])

    results = {}
    s = args.eval_scale
    if not args.skip_train and scene.train_cameras:
        results["train"] = render_set(out_dir, "train",
                                      scene.train_cameras_at(s), render_one)
    if not args.skip_test and scene.test_cameras:
        results["test"] = render_set(out_dir, "test",
                                     scene.test_cameras_at(s), render_one)
    print(json.dumps(results, indent=2), flush=True)
    return results


if __name__ == "__main__":
    main()
