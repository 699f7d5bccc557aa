"""Stage-1 training: the train step and the step loop.

Mirrors ``svgir_tpu.train.trainer`` (reference ``train.py:28-249``): a
without-replacement camera schedule, the exponential xyz learning-rate
schedule, Adam over the parameter groups, densification statistics and the
binner-overflow growth of ``max_instances``.  Densification, opacity reset,
checkpointing and staging are not ported yet: ``train_stage1`` raises
``NotImplementedError`` at an iteration where a densify or opacity-reset
cadence would act, instead of skipping it.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Dict, List, Optional

import torch

from svgir_tpu_torch.config import OptimizationConfig, RasterConfig
from svgir_tpu_torch.models import gaussians as G
from svgir_tpu_torch.render.stage1 import render_stage1
from svgir_tpu_torch.train import optim
from svgir_tpu_torch.utils.transforms import get_expon_lr_fn


def make_train_step(opt: OptimizationConfig, raster_cfg: RasterConfig, bg, *,
                    sh_degree: int = 3,
                    lrs: Optional[Dict[str, float]] = None,
                    track_stats: bool = True, device="cuda"):
    """Build the stage-1 train step.

    Returns step(state, opt_state, camera, iteration, xyz_lr)
      -> (state, opt_state, tb_dict).

    ``track_stats=False`` skips the densification bookkeeping (the
    per-Gaussian weight sums and the screen-gradient statistics).
    """
    bg = torch.as_tensor(bg, dtype=torch.float32, device=device)

    def step(state, opt_state, camera, iteration, xyz_lr):
        alive, stats = state["alive"], state["stats"]
        cap = alive.shape[0]
        names = list(state["params"])
        params = {k: v.detach().requires_grad_(True)
                  for k, v in state["params"].items()}
        off = torch.zeros(cap, 2, device=alive.device, requires_grad=True)

        res = render_stage1(camera, params, bg, opt=opt, iteration=iteration,
                            is_training=True, alive=alive, mean2d_offset=off,
                            sh_degree=sh_degree, mono=camera.mono,
                            need_weights=track_stats, cfg=raster_cfg)
        grads = torch.autograd.grad(
            res["loss"], [params[k] for k in names] + [off],
            allow_unused=True)
        # parameters the loss does not reach get zero gradients, as under
        # jax.grad, so their Adam moments decay the same way
        gp = {k: torch.zeros_like(params[k]) if g is None else g
              for k, g in zip(names, grads[:-1])}
        goff = grads[-1] if grads[-1] is not None else torch.zeros_like(off)

        step_lrs = {**(lrs or {}), "xyz": xyz_lr}
        new_params, opt_state = optim.adam_step(
            {k: v.detach() for k, v in params.items()}, gp, opt_state,
            step_lrs)

        visible = res["visibility_filter"] & alive
        if track_stats:
            # densification stats: NDC-scale screen grads (backward.cu:639)
            scale = goff.new_tensor([0.5 * camera.width, 0.5 * camera.height])
            stats = G.add_densification_stats(
                stats, goff * scale, visible, res["weights"].detach(),
                res["radii"].to(torch.float32))

        tb = {k: v.detach() for k, v in res["tb_dict"].items()}
        tb["n_visible"] = visible.sum()
        tb["overflow"] = res["overflow"]
        return ({"params": new_params, "alive": alive, "stats": stats},
                opt_state, tb)

    return step


def camera_for_iter(cams: List, it: int, seed: int):
    """Deterministic without-replacement camera schedule: epoch
    ``(it-1)//len`` is a seed+epoch-keyed shuffle, so a resumed run
    continues the uninterrupted sequence."""
    epoch, k = divmod(it - 1, len(cams))
    order = list(range(len(cams)))
    random.Random(seed * 1_000_003 + epoch).shuffle(order)
    return cams[order[k]]


def _densify_would_act(it: int, opt: OptimizationConfig, state,
                       white_background: bool) -> bool:
    """Whether the reference loop would densify or reset opacity after
    iteration ``it`` (trainer.py / train.py:194-210)."""
    if it >= opt.densify_until_iter:
        return False
    at_densify = (it > opt.densify_from_iter
                  and it % opt.densification_interval == 0)
    at_reset = (it % opt.opacity_reset_interval == 0
                or (white_background and it == opt.densify_from_iter))
    if not (at_densify or at_reset):
        return False
    return int(state["alive"].sum()) < opt.max_points


def train_stage1(state, cameras: List, opt: OptimizationConfig, *,
                 bg=(0.0, 0.0, 0.0), raster_cfg: RasterConfig = RasterConfig(),
                 spatial_lr_scale: float = 1.0, sh_degree: int = 3,
                 first_iter: int = 0, iterations: Optional[int] = None,
                 seed: int = 0, log_every: int = 50, callback=None,
                 opt_state=None, auto_grow_instances: bool = True,
                 white_background: bool = False, device="cuda"):
    """Run the stage-1 loop.  Returns (state, opt_state, history).

    Raises ``NotImplementedError`` before an iteration after which the
    densify or opacity-reset cadence would act (not ported yet).
    """
    iterations = iterations or opt.iterations
    lrs = optim.group_lrs(opt, spatial_lr_scale)
    xyz_sched = get_expon_lr_fn(
        lr_init=opt.position_lr_init * spatial_lr_scale,
        lr_final=opt.position_lr_final * spatial_lr_scale,
        lr_delay_mult=opt.position_lr_delay_mult,
        max_steps=opt.position_lr_max_steps)
    if opt_state is None:
        opt_state = optim.adam_init(state["params"])

    def make(cfg, track_stats):
        return make_train_step(opt, cfg, bg, sh_degree=sh_degree, lrs=lrs,
                               track_stats=track_stats, device=device)

    step_fn = make(raster_cfg, True)
    step_fast = make(raster_cfg, False)
    cams = [dataclasses.replace(c, uid=0, image_name="") for c in cameras]

    history = []
    t0 = time.time()
    for it in range(first_iter + 1, iterations + 1):
        if _densify_would_act(it, opt, state, white_background):
            raise NotImplementedError(
                f"iteration {it} would densify or reset opacity, which "
                "svgir_tpu_torch does not implement yet")
        cam = camera_for_iter(cams, it, seed)
        xyz_lr = float(xyz_sched(it))
        fn = step_fast if it >= opt.densify_until_iter else step_fn
        state, opt_state, tb = fn(state, opt_state, cam, float(it), xyz_lr)

        if it % log_every == 0 or it == iterations:
            entry = {"iter": it, "psnr": float(tb["psnr"]),
                     "loss": float(tb["loss"]),
                     "n_alive": int(state["alive"].sum()),
                     "elapsed": time.time() - t0}
            if bool(tb["overflow"]):
                entry["overflow"] = 1.0
                print(f"WARNING: instance-buffer overflow at iter {it}: "
                      "splats were dropped this frame", flush=True)
                if auto_grow_instances:
                    raster_cfg = dataclasses.replace(
                        raster_cfg, max_instances=raster_cfg.max_instances * 2)
                    print(f"growing max_instances -> "
                          f"{raster_cfg.max_instances}", flush=True)
                    step_fn = make(raster_cfg, True)
                    step_fast = make(raster_cfg, False)
            history.append(entry)
            if callback:
                callback(entry, state)
    return state, opt_state, history
