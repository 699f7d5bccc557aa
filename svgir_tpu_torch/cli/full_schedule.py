"""The reference's two-stage schedule end to end on the port, the twin of
the repository's ``tools/full_schedule_r5.sh``:

    python -m svgir_tpu_torch.cli.full_schedule --scene scenes/synth800 \\
        --run output/full_r5 [--resume]

1. Makes the scene (``cli.make_synth_dataset``: 100 + 10 views of 800 x
   800 from 20,000 GT surfels) when ``<scene>/transforms_train.json`` is
   missing.
2. Stage 1 (``cli.train``, script/run_tensoir.sh's stage-1 flags plus
   ``--max_points --checkpoint_interval 2500 --test_interval 10000
   --quiet``) into ``<run>/gss`` up to ``--s1_iters``, resuming from its
   newest ``chkpnt<iter>.npz``.  Without ``--resume`` both stages' output
   directories are emptied first, so that a stale partial checkpoint
   never seeds a run.
3. Refuses to go on unless stage 1's newest checkpoint is at
   ``--s1_iters``.
4. Stage 2 (``-t render_relight`` at S = 64 and a 32 x 64 env) into
   ``<run>/render_relight`` up to ``--s2_iters``, from its own newest
   checkpoint, else from stage 1's.
5. ``cli.eval_nvs`` of both final checkpoints, as script/run_tensoir.sh
   runs it (stage 2 with ``--skip_train``).

Writes ``<run>/schedule.json``: each part's seconds, peak device memory
and kernel launches, the checkpoints and the evaluations' metrics.
``--device`` defaults to ``cuda``.  Any other flag goes to both stages'
trainer after the recipe's own, so that it overrides them (a smoke run's
``--checkpoint_interval 2 --sample_num 4``).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import time
from typing import List, Optional, Tuple

import torch

from svgir_tpu_torch import kernels

STAGE1_FLAGS = [
    "--lambda_normal_render_depth", "0.0",
    "--lambda_normal_smooth", "0.02",
    "--lambda_mask_entropy", "0.1",
    "--densify_grad_normal_threshold", "1e-8",
    "--lambda_depth_var", "1e-2",
]
STAGE2_FLAGS = [
    "--position_lr_init", "0.0", "--position_lr_final", "0.0",
    "--normal_lr", "0.001", "--sh_lr", "0.00025", "--opacity_lr", "0.005",
    "--scaling_lr", "0.0", "--rotation_lr", "0.0",
    "--lambda_base_color_smooth", "0.1", "--lambda_roughness_smooth", "0.05",
    "--lambda_light_smooth", "0.0", "--lambda_light", "0.0",
    "--lambda_env_smooth", "0.02",
]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="the two-stage recipe on a procedural scene, "
        "resumable; other flags go to both stages' trainer, after the "
        "recipe's own", allow_abbrev=False)
    ap.add_argument("--scene", default="scenes/synth800")
    ap.add_argument("--run", default="output/full_r5")
    ap.add_argument("--s1_iters", type=int, default=30000)
    ap.add_argument("--s2_iters", type=int, default=50000)
    ap.add_argument("--max_points", type=int, default=250000)
    ap.add_argument("--resume", action="store_true",
                    help="keep the output directories and resume both "
                         "stages from their newest checkpoints")
    ap.add_argument("--device", default="cuda")
    return ap


def latest_checkpoint(out_dir: str) -> Optional[Tuple[int, str]]:
    """(iteration, path) of the ``chkpnt<iter>.npz`` with the largest
    iteration in ``out_dir``, or None."""
    best = None
    if os.path.isdir(out_dir):
        for name in os.listdir(out_dir):
            m = re.fullmatch(r"chkpnt(\d+)\.npz", name)
            if m and (best is None or int(m.group(1)) > best[0]):
                best = (int(m.group(1)), os.path.join(out_dir, name))
    return best


def stage1_argv(args, out1: str, resume: Optional[str],
                extra: List[str]) -> List[str]:
    argv = ["--eval", "-s", args.scene, "-m", out1]
    if resume:
        argv += ["-c", resume]
    return argv + [
        "--iterations", str(args.s1_iters),
        "--max_points", str(args.max_points), *STAGE1_FLAGS,
        "--checkpoint_interval", "2500", "--test_interval", "10000",
        "--quiet", "--device", args.device, *extra]


def stage2_argv(args, out2: str, resume: str,
                extra: List[str]) -> List[str]:
    return [
        "--eval", "-s", args.scene, "-m", out2, "-c", resume,
        "-t", "render_relight", "--iterations", str(args.s2_iters),
        *STAGE2_FLAGS, "--sample_num", "64", "--env_resolution", "32",
        "--checkpoint_interval", "2500", "--test_interval", "10000",
        "--quiet", "--device", args.device, *extra]


class _Part:
    """Seconds, peak device memory and kernel launches of one part of the
    schedule, written with the rest of ``summary`` to
    ``<run>/schedule.json`` as it ends."""

    def __init__(self, summary: dict, name: str, device: str):
        self.summary, self.name = summary, name
        self.cuda = torch.device(device).type == "cuda"

    def __enter__(self):
        if self.cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        self.launched = kernels.launches()
        self.t0 = time.perf_counter()
        print(f"[schedule] {self.name}", flush=True)
        return self

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.synchronize()
        rec = {"seconds": time.perf_counter() - self.t0}
        if self.cuda:
            rec["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"[schedule] {self.name}: " + ", ".join(
            f"{k} {v:.3f}" for k, v in rec.items()), flush=True)
        rec["launches"] = {k: v - self.launched[k]
                           for k, v in kernels.launches().items()}
        self.summary["parts"][self.name] = rec
        with open(os.path.join(self.summary["run"], "schedule.json"),
                  "w") as f:
            json.dump(self.summary, f, indent=2)


def main(argv: Optional[list] = None) -> dict:
    args, extra = build_parser().parse_known_args(argv)
    from svgir_tpu_torch.cli import eval_nvs, make_synth_dataset, train

    out1 = os.path.join(args.run, "gss")
    out2 = os.path.join(args.run, "render_relight")
    summary = {"scene": args.scene, "run": args.run, "parts": {}}

    os.makedirs(args.run, exist_ok=True)
    if not os.path.exists(os.path.join(args.scene, "transforms_train.json")):
        with _Part(summary, "scene", args.device):
            make_synth_dataset.make_dataset(args.scene, device=args.device)
    if not args.resume:
        shutil.rmtree(out1, ignore_errors=True)
        shutil.rmtree(out2, ignore_errors=True)
    os.makedirs(out1, exist_ok=True)
    os.makedirs(out2, exist_ok=True)

    ck1 = latest_checkpoint(out1)
    if ck1 is None or ck1[0] < args.s1_iters:
        if ck1:
            print(f"[schedule] resuming stage 1 from {ck1[1]}", flush=True)
        with _Part(summary, "stage1", args.device):
            train.main(stage1_argv(args, out1, ck1 and ck1[1], extra))
        ck1 = latest_checkpoint(out1)
    if ck1 is None or ck1[0] < args.s1_iters:
        raise SystemExit(f"stage 1 incomplete (newest checkpoint "
                         f"{ck1 and ck1[1]}, want chkpnt{args.s1_iters}"
                         ".npz): refusing to start stage 2")
    summary["stage1_checkpoint"] = ck1[1]

    ck2 = latest_checkpoint(out2)
    if ck2 is None or ck2[0] < args.s2_iters:
        start = ck2 or ck1
        print(f"[schedule] stage 2 from {start[1]}", flush=True)
        with _Part(summary, "stage2", args.device):
            train.main(stage2_argv(args, out2, start[1], extra))
        ck2 = latest_checkpoint(out2)
    summary["stage2_checkpoint"] = ck2[1]

    common = ["--eval", "-s", args.scene, "--device", args.device]
    with _Part(summary, "eval_stage1", args.device):
        summary["eval_stage1"] = eval_nvs.main(
            common + ["-m", out1, "-c", ck1[1]])
    with _Part(summary, "eval_stage2", args.device):
        summary["eval_stage2"] = eval_nvs.main(
            common + ["-m", out2, "-c", ck2[1], "-t", "render_relight",
                      "--skip_train"])
    return summary


if __name__ == "__main__":
    main()
