"""Relighting evaluation CLI, the twin of the repository's
``eval_relighting.py`` (``eval_relighting_tensoIR.py``):

    python -m svgir_tpu_torch.cli.eval_relighting -s <scene> \\
        -c out/lego/chkpnt50000.npz --hdr a.hdr b.hdr [-m out/lego]

Relights a stage-2 checkpoint (written by either package) under each HDR
light and scores the scene's test views (its train views where it has
none).  The hemisphere bake depends on the geometry only, so it runs once
(``--sample_num`` directions a surfel, 384 by default) and each light
re-shades it.  Writes ``<-m>/eval_relight/<light>/`` (the relit images
and ``metrics.json``) and prints every light's metrics as JSON.  The flags
are those of ``eval_relighting.py`` plus ``--device`` (``cuda`` unless
asked for ``cpu``).  LPIPS reads ``$SVGIR_LPIPS_WEIGHTS`` or
``lpips_vgg.npz`` at the repository root (``eval/metrics.py``); without
either, ``metrics.json`` says so in its ``pbr_lpips`` entry.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from svgir_tpu_torch.config import (ModelConfig, RasterConfig, add_to_parser,
                                    from_args)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="svgir_tpu_torch relighting evaluation")
    add_to_parser(ModelConfig, parser, "Loading Parameters")
    parser.add_argument("-c", "--checkpoint", required=True)
    parser.add_argument("--hdr", nargs="+", required=True,
                        help="paths to HDR environment maps")
    parser.add_argument("--sample_num", type=int, default=384)
    parser.add_argument("--max_instances", type=int, default=1 << 20)
    parser.add_argument("--max_cameras", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device to evaluate on")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    model_cfg = from_args(ModelConfig, args)
    raster_cfg = RasterConfig(max_instances=args.max_instances)

    from svgir_tpu_torch.data.readers import load_scene
    from svgir_tpu_torch.eval.relighting import (bake_hemisphere,
                                                 eval_relighting)
    from svgir_tpu_torch.models import lights as LT
    from svgir_tpu_torch.train import checkpoint as CK

    scene = load_scene(model_cfg.source_path,
                       white_background=model_cfg.white_background,
                       eval_split=True, resolution=model_cfg.resolution,
                       max_cameras=args.max_cameras)
    cams = scene.test_cameras or scene.train_cameras
    _, tree = CK.load_checkpoint(args.checkpoint, device=args.device)
    state = tree["state"]
    if "base_color" not in state["params"]:
        raise ValueError(f"{args.checkpoint} is not a stage-2 checkpoint "
                         "(it has no base_color)")
    params, alive = state["params"], state["alive"].to(bool)
    out_dir = os.path.join(model_cfg.model_path or ".", "eval_relight")
    bg = (1.0, 1.0, 1.0) if model_cfg.white_background else (0.0, 0.0, 0.0)

    # the hemisphere trace is light-independent: bake once, re-shade per
    # light (the reference builds its hit table once per proxy,
    # pbgi/renderer.py:470-489)
    with torch.no_grad():
        bake = bake_hemisphere(params, alive, sample_num=args.sample_num)
    results = {}
    for path in args.hdr:
        name = os.path.splitext(os.path.basename(path))[0]
        env = LT.env_light_init(LT.load_hdr(path), device=args.device)
        results[name] = eval_relighting(
            out_dir, params, alive, env, cams, sample_num=args.sample_num,
            raster_cfg=raster_cfg, bg=bg, light_name=name, bake=bake)
    print(json.dumps(results, indent=2), flush=True)
    return results


if __name__ == "__main__":
    main()
