"""The stage-1 and stage-2 training steps in plain PyTorch, and the loop's
camera schedule: what ``svgir_tpu.train.trainer`` computes per iteration
past densification (reference ``train.py:28-249``).
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

import torch

from reference.config import OptimizationConfig, RasterConfig
from reference.models import lights as LT
from reference.render.stage1 import render_stage1
from reference.render.svgss import render_svgss
from reference.train import optim


def set_tf32(on: bool) -> None:
    """float32 matmuls and convolutions in full float32 (off, the
    configuration's precision) or in TF32 (on, the control)."""
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def camera_for_iter(cams: List, it: int, seed: int):
    """The without-replacement camera schedule: epoch ``(it-1)//len`` is a
    seed+epoch-keyed shuffle."""
    epoch, k = divmod(it - 1, len(cams))
    order = list(range(len(cams)))
    random.Random(seed * 1_000_003 + epoch).shuffle(order)
    return cams[order[k]]


def loss_grads(loss: torch.Tensor, params: Dict[str, torch.Tensor],
               extra: List[torch.Tensor]):
    """Gradients of ``loss`` with respect to every parameter and each
    tensor of ``extra``; tensors the loss does not reach get zeros."""
    wrt = list(params.values()) + extra
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(
        wrt, torch.autograd.grad(loss, wrt, allow_unused=True))]
    return dict(zip(params, grads)), grads[len(params):]


def stage1_step(opt: OptimizationConfig, raster_cfg: RasterConfig, bg, *,
                lrs: Dict[str, float], sh_degree: int = 3):
    """step(state, opt_state, camera, iteration, xyz_lr) -> (state,
    opt_state, loss): render, the stage-1 loss, its gradients and one Adam
    step (no densification statistics: the steps lie past
    ``densify_until_iter``)."""

    def step(state, opt_state, camera, iteration, xyz_lr):
        alive = state["alive"]
        params = {k: v.detach().requires_grad_(True)
                  for k, v in state["params"].items()}
        res = render_stage1(camera, params, bg, opt=opt, iteration=iteration,
                            is_training=True, alive=alive,
                            sh_degree=sh_degree, mono=camera.mono,
                            need_weights=False, cfg=raster_cfg)
        gp, _ = loss_grads(res["loss"], params, [])
        new_params, opt_state = optim.adam_step(
            {k: v.detach() for k, v in params.items()}, gp, opt_state,
            {**lrs, "xyz": xyz_lr})
        return ({"params": new_params, "alive": alive}, opt_state,
                res["loss"].detach())

    return step


def stage2_step(opt: OptimizationConfig, raster_cfg: RasterConfig, bg, *,
                lrs: Dict[str, float], sh_degree: int = 3):
    """step(state, opt_state, env_state, bake, camera, iteration, xyz_lr,
    radiance_lr) -> (state, opt_state, env_state, loss): the deferred-PBR
    render, the stage-2 loss with the radiance consistency term, and one
    Adam step over the Gaussian groups and the env map."""

    def step(state, opt_state, env_state, bake, camera, iteration, xyz_lr,
             radiance_lr: Optional[float]):
        alive = state["alive"]
        params = {k: v.detach().requires_grad_(True)
                  for k, v in state["params"].items()}
        env = env_state["params"]["env"].detach().requires_grad_(True)
        res = render_svgss(camera, params, bg, bake=bake,
                           env_params={"env": env}, opt=opt,
                           iteration=iteration, is_training=True,
                           alive=alive, sh_degree=sh_degree, cfg=raster_cfg)
        gp, (genv,) = loss_grads(res["loss"], params, [env])
        new_params, opt_state = optim.adam_step(
            {k: v.detach() for k, v in params.items()}, gp, opt_state,
            {**lrs, "xyz": xyz_lr, "radiances": radiance_lr})
        new_env = LT.direct_light_map_step(
            {"params": {"env": env.detach()}, "opt": env_state["opt"]},
            {"env": genv}, opt.env_lr)
        return ({"params": new_params, "alive": alive}, opt_state, new_env,
                res["loss"].detach())

    return step
