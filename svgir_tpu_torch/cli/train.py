"""Two-stage training CLI, the twin of the repository's ``train.py``.

    stage 1:  python -m svgir_tpu_torch.cli.train -s <scene> -m out/lego \\
                  -t render --iterations 30000 --lambda_mask_entropy 0.1 ...
    stage 2:  python -m svgir_tpu_torch.cli.train -s <scene> -m out/lego \\
                  -t render_relight -c out/lego/chkpnt30000.npz \\
                  --iterations 50000 --sample_num 64 --env_resolution 32 ...

The flags and defaults are those of ``train.py`` (script/run_tensoir.sh
drives both), plus ``--device`` (``cuda`` unless asked for ``cpu``).  A
run writes ``cfg_args.json``, ``cameras.json``, ``train_log.jsonl``,
``tb/`` (where TensorBoard imports), ``chkpnt<iter>.npz`` (every
``--checkpoint_interval`` and at the end) and ``point_cloud.ply`` into
``-m``.  ``-c`` resumes a run from a checkpoint: within a stage with its
Adam moments, or stage 2 from a stage-1 checkpoint through
``upgrade_to_pbr``.  ``--max_instances 0`` (the default) sizes the
rasterizer's instance buffer from the scene (``train.cap_probe``).

``--finetune_visibility`` fits the visibility SH to traced visibility
before stage 2 (1,000 iterations, draws from a generator seeded with
``--seed`` + 7).  ``--save_training_vis`` writes the buffers of the
iteration's view to ``visualize/iter_<iter>.png`` every
``--save_training_vis_iteration``.  ``--eval`` on a scene with test views
renders them at the end of the run (``eval/metrics.json``,
``metric_eval.txt`` and the renders under ``eval/``; stage 2 scores pbr).

``--profile_steps A:B`` traces iterations A to B of either stage under
``torch.profiler`` (``utils.profiling``): on leaving B it writes
``trace.json`` (the layers' spans and the kernels on one timeline) and
``spans.json`` (per span: calls, host and device ms, host syncs) into
``--profile_dir`` (``<model_path>/profile`` by default) and prints host
ms, device ms and host syncs a step for each span.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from svgir_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                    PipelineConfig, RasterConfig,
                                    add_to_parser, from_args)
from svgir_tpu_torch.utils import profiling


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="svgir_tpu_torch trainer")
    add_to_parser(ModelConfig, parser, "Loading Parameters")
    add_to_parser(PipelineConfig, parser, "Pipeline Parameters")
    add_to_parser(OptimizationConfig, parser, "Optimization Parameters")
    parser.add_argument("-t", "--type", default="render",
                        choices=["render", "render_relight"])
    parser.add_argument("-c", "--checkpoint", default=None)
    parser.add_argument("--checkpoint_interval", type=int, default=5000)
    parser.add_argument("--test_interval", type=int, default=2500)
    # 0: probe the scene for a snug instance cap at the start and double
    # it whenever a frame overflows
    parser.add_argument("--max_instances", type=int, default=0)
    parser.add_argument("--strip", type=int, default=RasterConfig.strip,
                        help="blend strip width in tiles (0: tile-major "
                             "blocks)")
    parser.add_argument("--tile", type=int, default=RasterConfig.tile)
    parser.add_argument("--chunk", type=int, default=RasterConfig.chunk,
                        help="instances a blend block stages at once")
    parser.add_argument("--max_cameras", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    # the reference's torch.autograd anomaly mode (train.py:435)
    parser.add_argument("--detect_anomaly", action="store_true")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on")
    parser.add_argument("--profile_steps", type=profiling.parse_steps,
                        default=None, metavar="A:B",
                        help="trace iterations A to B (torch.profiler)")
    parser.add_argument("--profile_dir", default=None,
                        help="where --profile_steps writes trace.json and "
                             "spans.json (default: <model_path>/profile)")
    return parser


def raster_cfg_from_args(args) -> RasterConfig:
    cap = args.max_instances or RasterConfig.max_instances  # 0: probe later
    return RasterConfig(max_instances=cap, strip=args.strip, tile=args.tile,
                        chunk=args.chunk)


def eval_test_views(out_dir, scene, state, opt_cfg, raster_cfg, bg, *,
                    is_pbr, bake=None, env_state=None, device="cuda"):
    """The end-of-run test render (reference eval_render, train.py:246-249,
    365-426): every test view with the final model through ``render_set``
    under ``out_dir/eval``; stage 2 scores pbr and keeps the plain render
    as ``image_render``."""
    from svgir_tpu_torch.eval.nvs import render_set
    from svgir_tpu_torch.render.stage1 import render_stage1
    from svgir_tpu_torch.render.svgss import render_svgss
    from svgir_tpu_torch.train.staging import stage_cameras
    from svgir_tpu_torch.train.trainer import strip_meta

    params, alive = state["params"], state["alive"]
    bg_t = torch.as_tensor(bg, dtype=torch.float32, device=device)

    @torch.no_grad()
    def render_one(cam):
        cam = stage_cameras([strip_meta(cam)], device=device)[0]
        if not is_pbr:
            return render_stage1(cam, params, bg_t, opt=opt_cfg,
                                 is_training=False, alive=alive,
                                 cfg=raster_cfg)
        res = render_svgss(cam, params, bg_t, bake=bake,
                           env_params=env_state["params"], opt=opt_cfg,
                           is_training=False, alive=alive, cfg=raster_cfg)
        res["image_render"] = res["render"]
        res["render"] = res["pbr"]          # the metric image (train.py:391)
        return res

    buffers = ("render", "image_render", "normal", "base_color",
               "roughness", "visibility", "depth", "opacity") if is_pbr \
        else ("render", "normal", "depth", "opacity")
    return render_set(out_dir, "eval", scene.test_cameras, render_one,
                      save_buffers=buffers)


def main(argv=None):
    args = build_parser().parse_args(argv)
    model_cfg = from_args(ModelConfig, args)
    pipe_cfg = from_args(PipelineConfig, args)
    opt_cfg = from_args(OptimizationConfig, args)
    raster_cfg = raster_cfg_from_args(args)
    device = args.device
    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)

    from svgir_tpu_torch.data.readers import dump_cameras_json, load_scene
    from svgir_tpu_torch.models import gaussians as G
    from svgir_tpu_torch.train import checkpoint as CK
    from svgir_tpu_torch.train.cap_probe import snug_instance_cap
    from svgir_tpu_torch.train.trainer import (jsonl_logger,
                                               tensorboard_logger,
                                               train_stage1, train_stage2)

    out_dir = model_cfg.model_path or "output"
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "cfg_args.json"), "w") as f:
        json.dump({k: v for k, v in vars(args).items()
                   if isinstance(v, (int, float, str, bool, type(None)))},
                  f, indent=2)

    print(f"Loading scene {model_cfg.source_path}", flush=True)
    scene = load_scene(model_cfg.source_path,
                       white_background=model_cfg.white_background,
                       eval_split=model_cfg.eval,
                       resolution=model_cfg.resolution,
                       max_cameras=(6 if model_cfg.debug_subset
                                    else args.max_cameras))
    print(f"  {len(scene.train_cameras)} train / "
          f"{len(scene.test_cameras)} test cameras, "
          f"extent {scene.cameras_extent:.3f}", flush=True)
    is_pbr = args.type == "render_relight"
    dump_cameras_json(out_dir, scene)   # scene/__init__.py:78-83

    bg = (1.0, 1.0, 1.0) if model_cfg.white_background else (0.0, 0.0, 0.0)
    first_iter, env_state, opt_state, bake = 0, None, None, None
    if args.checkpoint:
        first_iter, tree = CK.load_checkpoint(args.checkpoint, device=device)
        state = tree["state"]
        env_state = tree.get("env")
        bake = tree.get("extra")     # the stage-2 radiance bake
        if is_pbr and "base_color" not in state["params"]:
            state = G.upgrade_to_pbr(state)
        else:
            # same parameter set: the Adam moments carry over
            opt_state = tree.get("opt")
        print(f"Resumed from {args.checkpoint} at iter {first_iter}",
              flush=True)
    else:
        state = G.init_from_points(
            scene.points, scene.colors, normals=scene.normals,
            sh_degree=model_cfg.sh_degree, morton_order=True, device=device)
        if is_pbr:
            state = G.upgrade_to_pbr(state)

    if args.max_instances == 0:
        cap = snug_instance_cap(state["params"], scene.train_cameras,
                                raster_cfg, alive=state["alive"])
        raster_cfg = dataclasses.replace(raster_cfg, max_instances=cap)
        print(f"snug instance cap: {cap}", flush=True)

    log_cb = jsonl_logger(os.path.join(out_dir, "train_log.jsonl"))
    tb_cb = tensorboard_logger(os.path.join(out_dir, "tb"))

    def cb(entry, *_cb_args):
        log_cb(entry)
        if tb_cb is not None:
            tb_cb(entry)
        if not args.quiet:
            print("  " + "  ".join(f"{k}={v:.4g}" if isinstance(v, float)
                                   else f"{k}={v}" for k, v in entry.items()),
                  flush=True)

    window = None
    if args.profile_steps:
        window = profiling.StepWindow(
            *args.profile_steps,
            args.profile_dir or os.path.join(out_dir, "profile"))
    common = dict(
        bg=bg, raster_cfg=raster_cfg, spatial_lr_scale=scene.cameras_extent,
        sh_degree=model_cfg.sh_degree, first_iter=first_iter,
        iterations=opt_cfg.iterations, seed=args.seed, callback=cb,
        opt_state=opt_state, out_dir=out_dir,
        checkpoint_interval=args.checkpoint_interval,
        test_cameras=scene.test_cameras, test_interval=args.test_interval,
        vis_interval=(pipe_cfg.save_training_vis_iteration
                      if pipe_cfg.save_training_vis else 0),
        profile_window=window, device=device)
    final = os.path.join(out_dir, f"chkpnt{opt_cfg.iterations}.npz")
    try:
        if not is_pbr:
            state, opt_state, _ = train_stage1(
                state, scene.train_cameras, opt_cfg,
                white_background=model_cfg.white_background, **common)
            CK.save_checkpoint(final, opt_cfg.iterations, state, opt_state)
        else:
            if opt_cfg.finetune_visibility:
                # gaussian_model.py:397-432, behind the same flag
                print("Finetuning visibility SH...", flush=True)
                state = G.finetune_visibility(
                    state, generator=torch.Generator(device=device)
                    .manual_seed(args.seed + 7), log_every=100)
            state, opt_state, env_state, bake, _ = train_stage2(
                state, scene.train_cameras, opt_cfg,
                sample_num=pipe_cfg.sample_num,
                env_resolution=model_cfg.env_resolution,
                env_state=env_state, bake=bake, **common)
            CK.save_checkpoint(final, opt_cfg.iterations, state, opt_state,
                               env=env_state, extra=bake)
    finally:
        if window is not None:
            window.close()
        if tb_cb is not None:
            tb_cb.writer.close()
    CK.save_model_ply(os.path.join(out_dir, "point_cloud.ply"),
                      state["params"], state["alive"], use_pbr=is_pbr)
    if model_cfg.eval and scene.test_cameras:
        metrics = eval_test_views(out_dir, scene, state, opt_cfg, raster_cfg,
                                  bg, is_pbr=is_pbr, bake=bake,
                                  env_state=env_state, device=device)
        print("eval:", json.dumps(metrics), flush=True)
    print("Training complete.", flush=True)


if __name__ == "__main__":
    main()
