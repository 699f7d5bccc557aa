"""The two sides of a training cell.

``Program`` builds the system under test, ``svgir_tpu_torch``, from the
cell's inputs as its training CLI and loops build it (cameras staged once,
the snug instance cap probed, the step built by ``make_train_step`` or
``make_svgss_train_step``, a fresh Adam state) and runs the loop's body
one iteration at a time: the camera of ``camera_for_iter``, the loop's
learning rates, the step, the binner's overflow flag or-ed on the device
and read at the loop's log cadence.  ``Reference`` runs the same
iterations on the same inputs through ``reference.steps``.

Both record the readings that decide ``correct``: each step's loss, each
parameter group's gradient norm at step 1 (from Adam's first moment after
one step, m = (1 - beta1) g) and each group's change after the checked
steps.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import torch

from benchlib import scene

BETA1 = 0.9            # Adam's first-moment rate on both sides
BG = (0.0, 0.0, 0.0)   # run_tensoir.sh / run_syn4.sh: black background


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in d.items()}


class Readings:
    """Losses of the checked steps, step-1 gradient norms and the change
    of each parameter group over the checked steps."""

    def __init__(self):
        self.losses: List[float] = []
        self.grad: Dict[str, float] = {}
        self.change: Dict[str, float] = {}

    def as_dict(self) -> Dict:
        return {"losses": self.losses, "grad": self.grad,
                "change": self.change}


class _Side:
    """What both sides share: the inputs made from the seed, and the
    checked steps' readings."""

    stage: int

    def __init__(self, cell: Dict, seed: int, dev):
        from reference.steps import set_tf32
        set_tf32(False)             # the inputs are made in full float32
        self.cfg, self.traffic = cell["config"], cell["traffic"]
        self.seed, self.dev = int(seed), dev
        self.flags = self.cfg[f"stage{self.stage}_flags"]
        self.surfels = scene.make_surfels(self.cfg, seed, dev)
        self.views = scene.make_views(self.cfg, seed, dev)
        self.extent = scene.cameras_extent(
            scene.view_eyes(self.cfg, seed))
        self.first = self.traffic["first_iteration"]
        self.it = self.first

    def camera_args(self, v: scene.View) -> Dict:
        return dict(eye=v.eye.tolist(), target=[0.0, 0.0, 0.0],
                    up=[0.0, 0.0, 1.0], fovx=v.fov, fovy=v.fov,
                    width=v.width, height=v.height)

    def leaves(self) -> Dict[str, torch.Tensor]:
        out = dict(self.state["params"])
        if self.stage == 2:
            out["env"] = self.env_state["params"]["env"]
        return out

    def first_moments(self) -> Dict[str, torch.Tensor]:
        out = dict(self.opt_state["m"])
        if self.stage == 2:
            out["env"] = self.env_state["opt"]["m"]["env"]
        return out

    def checked_steps(self, n: int) -> Readings:
        """Run the first ``n`` iterations through ``step`` and read them."""
        r = Readings()
        start = {k: v.clone() for k, v in self.leaves().items()}
        for i in range(n):
            r.losses.append(float(self.step()))
            if i == 0:
                r.grad = {k: v / (1 - BETA1) for k, v in
                          _norms(self.first_moments()).items()}
        now = self.leaves()
        r.change = _norms({k: now[k] - start[k] for k in start})
        return r


class Program(_Side):
    """The system under test, built and driven as its loop drives it."""

    def __init__(self, cell: Dict, seed: int, dev, stage: int):
        self.stage = stage
        super().__init__(cell, seed, dev)
        from svgir_tpu_torch.cameras import look_at_camera
        from svgir_tpu_torch.config import OptimizationConfig, RasterConfig
        from svgir_tpu_torch.models import gaussians as G
        from svgir_tpu_torch.train import optim, trainer
        from svgir_tpu_torch.train.cap_probe import snug_instance_cap
        from svgir_tpu_torch.train.staging import stage_cameras
        from svgir_tpu_torch.utils.transforms import get_expon_lr_fn

        self.trainer = trainer
        opt = OptimizationConfig(**self.flags)
        cams = [dataclasses.replace(
            look_at_camera(**self.camera_args(v), device=dev),
            image=v.image, image_mask=v.mask) for v in self.views]
        self.cams = stage_cameras([trainer.strip_meta(c) for c in cams],
                                  device=dev)
        self.views = None
        params, alive = self.surfels["params"], self.surfels["alive"]
        state = {"params": params, "alive": alive,
                 "stats": G.init_stats(alive.shape[0], device=dev)}
        raster = RasterConfig(**self.cfg["raster"])
        if stage == 2:
            state = G.upgrade_to_pbr(state)
            bake = scene.make_bake(self.cfg, self.traffic, self.surfels,
                                   self.seed, dev)
            params = dict(state["params"])
            params["radiances"] = bake["radiance"].clone()
            params["radiance_ratio"] = torch.ones((), device=dev)
            state = {**state, "params": params}
            self.bake = bake
            env = scene.make_env(self.cfg, seed, opt.light_init, dev)
            self.env_state = {"params": {"env": env},
                              "opt": optim.adam_init({"env": env})}
            self.radiance_lr = opt.radiance_lr
        self.surfels = None
        cap = snug_instance_cap(state["params"], self.cams, raster,
                                alive=state["alive"])
        self.raster = dataclasses.replace(raster, max_instances=cap)
        self.state = state
        self.opt_state = optim.adam_init(state["params"])
        lrs = optim.group_lrs(opt, self.extent, use_pbr=stage == 2)
        if stage == 1:
            self.step_fn = trainer.make_train_step(
                opt, self.raster, BG, sh_degree=3, lrs=lrs,
                track_stats=False, device=dev)
        else:
            self.step_fn = trainer.make_svgss_train_step(
                opt, self.raster, BG, sh_degree=3, lrs=lrs, device=dev)
        self.xyz_sched = get_expon_lr_fn(
            lr_init=opt.position_lr_init * self.extent,
            lr_final=opt.position_lr_final * self.extent,
            lr_delay_mult=opt.position_lr_delay_mult,
            max_steps=opt.position_lr_max_steps)
        self.log_every = self.traffic["log_every"]
        self.overflow = None
        self.host_s = 0.0
        self.log_times: List[float] = []     # host clock at each log read
        self.losses: List[torch.Tensor] = []
        self.flags_dev: List[torch.Tensor] = []

    def step(self) -> torch.Tensor:
        """One iteration of the loop's body; returns the step's loss (on
        the device) and keeps it and its overflow flag for the count of
        failed steps."""
        self.it += 1
        it = self.it
        cam = self.trainer.camera_for_iter(self.cams, it, self.seed)
        xyz_lr = float(self.xyz_sched(it))
        t0 = time.perf_counter()
        if self.stage == 1:
            self.state, self.opt_state, tb = self.step_fn(
                self.state, self.opt_state, cam, float(it), xyz_lr)
        else:
            self.state, self.opt_state, self.env_state, tb = self.step_fn(
                self.state, self.opt_state, self.env_state, self.bake, cam,
                float(it - self.first), xyz_lr, self.radiance_lr)
            if it % 1000 == 0:      # train.py:211-214
                self.radiance_lr = 0.0
        self.host_s += time.perf_counter() - t0
        self.overflow = self.trainer._any_overflow(self.overflow, tb)
        self.losses.append(tb["loss"])
        self.flags_dev.append(torch.as_tensor(tb["overflow"]))
        if it % self.log_every == 0:
            # the loop's log line reads these, and the overflow flag
            float(tb["psnr"]), float(tb["loss"])
            bool(self.overflow)
            self.overflow = None
            self.log_times.append(time.perf_counter())
        return tb["loss"]

    def failed_steps(self, first: int) -> int:
        """Steps from index ``first`` on whose loss is not finite or whose
        binner overflowed (instances dropped)."""
        if len(self.losses) <= first:
            return 0
        loss = torch.stack(self.losses[first:])
        flag = torch.stack(self.flags_dev[first:]).reshape(len(loss), -1)
        return int((~torch.isfinite(loss) | flag.any(1)).sum())

    def free(self):
        for name in ("state", "opt_state", "env_state", "bake", "cams",
                     "step_fn", "losses", "flags_dev"):
            if hasattr(self, name):
                delattr(self, name)


class Reference(_Side):
    """The plain reference on the same inputs and iterations."""

    def __init__(self, cell: Dict, seed: int, dev, stage: int,
                 tf32: bool = False):
        self.stage = stage
        super().__init__(cell, seed, dev)
        from reference import steps
        from reference.cameras import look_at_camera
        from reference.config import OptimizationConfig, RasterConfig
        from reference.train import optim
        from reference.utils.transforms import get_expon_lr_fn

        steps.set_tf32(tf32)
        self.steps = steps
        opt = OptimizationConfig(**self.flags)
        self.cams = [dataclasses.replace(
            look_at_camera(**self.camera_args(v), device=dev),
            image=v.image, image_mask=v.mask) for v in self.views]
        self.views = None
        params, alive = self.surfels["params"], self.surfels["alive"]
        raster = RasterConfig(**{**self.cfg["raster"],
                                 "max_instances": self.cfg["reference_slots"]})
        bg = torch.zeros(3, device=dev)
        if stage == 2:
            bake = scene.make_bake(self.cfg, self.traffic, self.surfels,
                                   self.seed, dev)
            cap = params["xyz"].shape[0]
            params = {**params,
                      **{k: torch.zeros(cap, c, device=dev) for k, c in
                         (("base_color", 12), ("roughness", 4),
                          ("normal", 12))},
                      "incidents_dc": torch.zeros(cap, 1, 3, device=dev),
                      "incidents_rest": torch.zeros(cap, 15, 3, device=dev),
                      "visibility_dc": torch.zeros(cap, 1, 1, device=dev),
                      "visibility_rest": torch.zeros(cap, 15, 1, device=dev),
                      "radiances": bake["radiance"].clone(),
                      "radiance_ratio": torch.ones((), device=dev)}
            self.bake = bake
            env = scene.make_env(self.cfg, seed, opt.light_init, dev)
            self.env_state = {"params": {"env": env},
                              "opt": optim.adam_init({"env": env})}
            self.radiance_lr = opt.radiance_lr
            self.step_fn = steps.stage2_step(
                opt, raster, bg,
                lrs=optim.group_lrs(opt, self.extent, use_pbr=True))
        else:
            self.step_fn = steps.stage1_step(
                opt, raster, bg, lrs=optim.group_lrs(opt, self.extent))
        self.surfels = None
        self.state = {"params": params, "alive": alive}
        self.opt_state = optim.adam_init(params)
        self.xyz_sched = get_expon_lr_fn(
            lr_init=opt.position_lr_init * self.extent,
            lr_final=opt.position_lr_final * self.extent,
            lr_delay_mult=opt.position_lr_delay_mult,
            max_steps=opt.position_lr_max_steps)

    def step(self) -> torch.Tensor:
        self.it += 1
        it = self.it
        cam = self.steps.camera_for_iter(self.cams, it, self.seed)
        xyz_lr = float(self.xyz_sched(it))
        if self.stage == 1:
            self.state, self.opt_state, loss = self.step_fn(
                self.state, self.opt_state, cam, float(it), xyz_lr)
        else:
            self.state, self.opt_state, self.env_state, loss = self.step_fn(
                self.state, self.opt_state, self.env_state, self.bake, cam,
                float(it - self.first), xyz_lr, self.radiance_lr)
            if it % 1000 == 0:
                self.radiance_lr = 0.0
        return loss
