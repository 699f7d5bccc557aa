"""Training: the stage-1 and stage-2 train steps and step loops.

Mirrors ``svgir_tpu.train.trainer`` (reference ``train.py:28-249``): a
without-replacement camera schedule, the exponential xyz learning-rate
schedule, Adam over the parameter groups, densification statistics, the
densify / prune / opacity-reset cadence with its capacity growth, the
binner-overflow growth of ``max_instances``, cameras staged on the device
once, and the periodic checkpoint and test-PSNR tasks.  Stage 2
(``train_stage2``) starts with the radiance bake over the alive surfels
(``bake_radiance_compact``), unless it is given one.  The periodic
tasks are the checkpoints, the test PSNR and the training visualisation.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import time
from typing import Callable, Dict, List, Optional

import torch

from svgir_tpu_torch.config import OptimizationConfig, RasterConfig
from svgir_tpu_torch.eval.nvs import save_training_vis
from svgir_tpu_torch.models import gaussians as G
from svgir_tpu_torch.models import lights as LT
from svgir_tpu_torch.models import radiance as RAD
from svgir_tpu_torch.render.stage1 import render_stage1, render_view_stage1
from svgir_tpu_torch.render.svgss import render_svgss, render_view_svgss
from svgir_tpu_torch.train import checkpoint as CK
from svgir_tpu_torch.train import optim
from svgir_tpu_torch.train.staging import stage_cameras
from svgir_tpu_torch.utils import profiling
from svgir_tpu_torch.utils.transforms import get_expon_lr_fn

N_SPLIT = 2          # children per split surfel (gaussian_model.py:1229)
MIN_OPACITY = 0.005  # prune threshold of the densify cadence (train.py:203)
MAX_TEST_VIEWS = 8   # test views of the periodic PSNR


def strip_meta(camera):
    """The camera without its per-view metadata (uid, image name)."""
    return dataclasses.replace(camera, uid=0, image_name="")


@profiling.span("svgir.backward")
def loss_grads(loss: torch.Tensor, params: Dict[str, torch.Tensor],
               extra: List[torch.Tensor]):
    """The gradients of ``loss`` with respect to every parameter and to each
    tensor of ``extra``: (dict, list).  Tensors the loss does not reach get
    zero gradients, as under jax.grad, so their Adam moments decay the same
    way."""
    wrt = list(params.values()) + extra
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(
        wrt, torch.autograd.grad(loss, wrt, allow_unused=True))]
    return dict(zip(params, grads)), grads[len(params):]


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

    @profiling.span(profiling.STEP)
    def step(state, opt_state, camera, iteration, xyz_lr):
        alive, stats = state["alive"], state["stats"]
        cap = alive.shape[0]
        params = {k: v.detach().requires_grad_(True)
                  for k, v in state["params"].items()}
        off = torch.zeros(cap, 2, device=alive.device, requires_grad=True)

        res = render_stage1(camera, params, bg, opt=opt, iteration=iteration,
                            is_training=True, alive=alive, mean2d_offset=off,
                            sh_degree=sh_degree, mono=camera.mono,
                            need_weights=track_stats, cfg=raster_cfg)
        gp, (goff,) = loss_grads(res["loss"], params, [off])

        step_lrs = {**(lrs or {}), "xyz": xyz_lr}
        with profiling.span("svgir.optimizer"):
            new_params, opt_state = optim.adam_step(
                {k: v.detach() for k, v in params.items()}, gp, opt_state,
                step_lrs)

        visible = res["visibility_filter"] & alive
        if track_stats:
            # densification stats: NDC-scale screen grads (backward.cu:639)
            with profiling.span("svgir.stats"):
                scale = goff.new_tensor([0.5 * camera.width,
                                         0.5 * camera.height])
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


class PeriodicTasks:
    """Mid-run checkpoints, test PSNR and training visualisation
    (train.py:229-363): a ``chkpnt<iter>.npz`` every
    ``checkpoint_interval`` iterations into ``out_dir``, the mean PSNR of
    up to ``MAX_TEST_VIEWS`` test views every ``test_interval``, and every
    ``vis_interval`` the buffers of one view (the iteration's training
    camera) side by side in ``out_dir/visualize/iter_<iter>.png``."""

    def __init__(self, *, out_dir: Optional[str] = None,
                 checkpoint_interval: int = 0,
                 test_cameras: Optional[List] = None,
                 test_interval: int = 0, vis_interval: int = 0,
                 device="cuda"):
        self.out_dir = out_dir
        self.vis_iv = vis_interval if out_dir else 0
        self.ckpt_iv = checkpoint_interval if out_dir else 0
        self.test_cams = stage_cameras(
            [strip_meta(c) for c in (test_cameras or [])[:MAX_TEST_VIEWS]],
            device=device) if test_interval else []
        self.test_iv = test_interval if self.test_cams else 0

    @torch.no_grad()
    def run(self, it: int, *, eval_fn: Callable, save_fn: Callable,
            vis_cam=None) -> Dict[str, float]:
        """Extra log entries ({} when nothing fired)."""
        extras: Dict[str, float] = {}
        if self.ckpt_iv and it % self.ckpt_iv == 0:
            save_fn(it)
            extras["checkpoint"] = float(it)
        if self.test_iv and it % self.test_iv == 0:
            psnrs = []
            for cam in self.test_cams:
                pred = torch.clamp(eval_fn(cam)["render"], 0, 1)
                mse = torch.mean(torch.square(pred - cam.image))
                psnrs.append(float(-10.0 * torch.log10(mse)))
            extras["test_psnr"] = float(sum(psnrs) / len(psnrs))
        if self.vis_iv and it % self.vis_iv == 0:
            cam = vis_cam if vis_cam is not None else (
                self.test_cams[0] if self.test_cams else None)
            if cam is not None:
                save_training_vis(os.path.join(self.out_dir, "visualize"),
                                  it, eval_fn(cam), gt_image=cam.image)
        return extras


def _split_noise(seed: int, it: int, cap: int, device) -> torch.Tensor:
    """The split children's standard-normal draws at iteration ``it``, from
    a generator seeded by (seed, it), so a resumed run draws what an
    uninterrupted one does."""
    gen = torch.Generator(device=device).manual_seed(
        seed * (1 << 32) + it)
    return torch.randn(N_SPLIT, cap, 3, generator=gen, device=device)


def train_stage1(state, cameras: List, opt: OptimizationConfig, *,
                 bg=(0.0, 0.0, 0.0), raster_cfg: RasterConfig = RasterConfig(),
                 spatial_lr_scale: float = 1.0, sh_degree: int = 3,
                 first_iter: int = 0, iterations: Optional[int] = None,
                 seed: int = 0, log_every: int = 50, callback=None,
                 opt_state=None, out_dir: Optional[str] = None,
                 checkpoint_interval: int = 0,
                 test_cameras: Optional[List] = None,
                 test_interval: int = 0, vis_interval: int = 0,
                 auto_grow_instances: bool = True,
                 white_background: bool = False,
                 split_noise: Optional[Callable] = None,
                 profile_window: Optional[profiling.StepWindow] = None,
                 device="cuda"):
    """Run the stage-1 loop.  Returns (state, opt_state, history).

    ``split_noise(it, cap)`` -> [2, cap, 3] gives the split children's
    standard-normal draws at a densify iteration; by default they come
    from a generator seeded by ``seed`` and ``it``.  ``profile_window``
    traces the iterations it names (``cli/train.py --profile_steps``).
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
    periodic = PeriodicTasks(
        out_dir=out_dir, checkpoint_interval=checkpoint_interval,
        test_cameras=test_cameras, test_interval=test_interval,
        vis_interval=vis_interval, device=device)
    if split_noise is None:
        def split_noise(it, cap):
            return _split_noise(seed, it, cap, device)

    def make(cfg, track_stats):
        return make_train_step(opt, cfg, bg, sh_degree=sh_degree, lrs=lrs,
                               track_stats=track_stats, device=device)

    step_fn = make(raster_cfg, True)
    step_fast = make(raster_cfg, False)
    cams = stage_cameras([strip_meta(c) for c in cameras], device=device)
    extent = spatial_lr_scale  # cameras_extent == spatial_lr_scale (train.py)
    bg_t = torch.as_tensor(bg, dtype=torch.float32, device=device)

    def eval_fn(cam):
        return render_view_stage1(cam, state["params"], bg_t,
                                  sh_degree=sh_degree, alive=state["alive"],
                                  cfg=raster_cfg)

    def save_fn(i):
        CK.save_checkpoint(os.path.join(out_dir, f"chkpnt{i}.npz"), i, state,
                           opt_state)

    history = []
    t0 = time.time()
    overflow = None       # any frame since the last log line, on the device
    for it in range(first_iter + 1, iterations + 1):
        if profile_window is not None:
            profile_window.begin(it)
        cam = camera_for_iter(cams, it, seed)
        xyz_lr = float(xyz_sched(it))
        fn = step_fast if it >= opt.densify_until_iter else step_fn
        state, opt_state, tb = fn(state, opt_state, cam, float(it), xyz_lr)
        overflow = _any_overflow(overflow, tb)
        if it < opt.densify_until_iter:
            with profiling.span("svgir.loop.densify"):
                state, opt_state = _densify_cadence(
                    it, state, opt_state, opt, extent, white_background,
                    split_noise)

        with profiling.span("svgir.loop.periodic"):
            extras = periodic.run(it, eval_fn=eval_fn, save_fn=save_fn,
                                  vis_cam=cam)
        if it % log_every == 0 or it == iterations or extras:
            with profiling.span("svgir.loop.log"):
                entry = {"iter": it, "psnr": float(tb["psnr"]),
                         "loss": float(tb["loss"]),
                         "n_alive": int(state["alive"].sum()),
                         "elapsed": time.time() - t0, **extras}
                if _overflowed(entry, overflow, it) and auto_grow_instances:
                    raster_cfg = _grow_instance_cap(raster_cfg)
                    step_fn = make(raster_cfg, True)
                    step_fast = make(raster_cfg, False)
                overflow = None
                history.append(entry)
                if callback:
                    callback(entry, state)
        if profile_window is not None:
            profile_window.end(it)
    return state, opt_state, history


def _densify_cadence(it: int, state, opt_state, opt: OptimizationConfig,
                     extent: float, white_background: bool,
                     split_noise: Callable):
    """The reference loop's densification block after iteration ``it``
    (train.py:194-210): densify and prune every ``densification_interval``
    past ``densify_from_iter``; reset opacity every
    ``opacity_reset_interval`` and, on white-background scenes, once at
    ``densify_from_iter``; both only below ``opt.max_points``.  Capacity
    doubles before a densify that finds it 85% full, and after one that
    ran out of free slots."""
    at_densify = (it > opt.densify_from_iter
                  and it % opt.densification_interval == 0)
    at_reset = (it % opt.opacity_reset_interval == 0
                or (white_background and it == opt.densify_from_iter))
    if not (at_densify or at_reset):
        return state, opt_state
    # the alive count is read on the host only at cadence points
    n_alive = int(state["alive"].sum())
    if n_alive >= opt.max_points:
        return state, opt_state
    if at_densify:
        cap = state["alive"].shape[0]
        if n_alive > 0.85 * cap:
            state, opt_state = G.grow_capacity(state, opt_state, cap * 2)
        cap = state["alive"].shape[0]
        state, opt_state, rep = G.densify_and_prune(
            state, opt_state, split_noise(it, cap),
            max_grad=opt.densify_grad_threshold, min_opacity=MIN_OPACITY,
            extent=extent,
            max_screen_size=20.0 if it > opt.opacity_reset_interval else None,
            max_grad_normal=(opt.densify_grad_normal_threshold
                             if it > opt.normal_densify_from_iter
                             else 99999.0),
            percent_dense=opt.percent_dense, n_split=N_SPLIT)
        # children past the free slots were dropped: say so and grow, so
        # the next cadence has room
        if bool(rep["out_of_capacity"]):
            print(f"WARNING: densify out of capacity at iter {it} (cap "
                  f"{cap}): some clone/split children were dropped; "
                  f"growing capacity -> {cap * 2}", flush=True)
            state, opt_state = G.grow_capacity(state, opt_state, cap * 2)
    if at_reset:
        params, opt_state = G.reset_opacity(state["params"], opt_state)
        state = {**state, "params": params}
    return state, opt_state


def _any_overflow(overflow, tb):
    """The binner's overflow flag of this step or-ed into ``overflow``
    (None: no step since the last log line), on the device: no sync."""
    flag = torch.as_tensor(tb["overflow"])
    return flag if overflow is None else overflow | flag


def _overflowed(entry, overflow, it) -> bool:
    """Flag and report a binner overflow (instances were dropped in a
    frame since the last log line); read at log cadence only, so that the
    steps in between do not wait for the device."""
    if overflow is None or not bool(overflow):
        return False
    entry["overflow"] = 1.0
    print(f"WARNING: instance-buffer overflow at or before iter {it}: "
          "splats were dropped", flush=True)
    return True


def _grow_instance_cap(raster_cfg: RasterConfig) -> RasterConfig:
    new = dataclasses.replace(raster_cfg,
                              max_instances=raster_cfg.max_instances * 2)
    print(f"growing max_instances -> {new.max_instances}", flush=True)
    return new


def make_svgss_train_step(opt: OptimizationConfig, raster_cfg: RasterConfig,
                          bg, *, sh_degree: int = 3,
                          lrs: Optional[Dict[str, float]] = None,
                          device="cuda"):
    """Build the stage-2 (render_relight) train step.

    Returns step(state, opt_state, env_state, bake, camera, iteration,
    xyz_lr, radiance_lr) -> (state, opt_state, env_state, tb_dict).

    One joint step: Adam over the Gaussian groups and, with its own state
    and ``opt.env_lr``, over the env map.  The radiance group's learning
    rate is a per-step scalar, so the loop can zero it at the first
    %1000 iteration (train.py:211-214).
    """
    bg = torch.as_tensor(bg, dtype=torch.float32, device=device)

    @profiling.span(profiling.STEP)
    def step(state, opt_state, env_state, bake, camera, iteration, xyz_lr,
             radiance_lr):
        alive = state["alive"]
        params = {k: v.detach().requires_grad_(True)
                  for k, v in state["params"].items()}
        env = env_state["params"]["env"].detach().requires_grad_(True)

        res = render_svgss(camera, params, bg, bake=bake,
                           env_params={"env": env}, opt=opt,
                           iteration=iteration, is_training=True,
                           alive=alive, sh_degree=sh_degree, cfg=raster_cfg)
        gp, (genv,) = loss_grads(res["loss"], params, [env])

        step_lrs = {**(lrs or {}), "xyz": xyz_lr, "radiances": radiance_lr}
        with profiling.span("svgir.optimizer"):
            new_params, opt_state = optim.adam_step(
                {k: v.detach() for k, v in params.items()}, gp, opt_state,
                step_lrs)
            new_env = LT.direct_light_map_step(
                {"params": {"env": env.detach()}, "opt": env_state["opt"]},
                {"env": genv}, opt.env_lr)

        tb = {k: v.detach() for k, v in res["tb_dict"].items()}
        tb["overflow"] = res["overflow"]
        return ({"params": new_params, "alive": alive,
                 "stats": state["stats"]}, opt_state, new_env, tb)

    return step


def train_stage2(state, cameras: List, opt: OptimizationConfig, *,
                 bake: Optional[Dict] = None,
                 bg=(0.0, 0.0, 0.0), raster_cfg: RasterConfig = RasterConfig(),
                 spatial_lr_scale: float = 1.0, sh_degree: int = 3,
                 sample_num: int = 64, env_resolution: int = 16,
                 first_iter: int = 30_000, iterations: int = 50_000,
                 seed: int = 0, log_every: int = 50, callback=None,
                 bake_azimuth: Optional[torch.Tensor] = None,
                 env_state=None, opt_state=None,
                 out_dir: Optional[str] = None, checkpoint_interval: int = 0,
                 test_cameras: Optional[List] = None, test_interval: int = 0,
                 vis_interval: int = 0, auto_grow_instances: bool = True,
                 profile_window: Optional[profiling.StepWindow] = None,
                 device="cuda"):
    """Stage-2 loop (train.py with is_pbr=True).  Returns (state,
    opt_state, env_state, bake, history).

    ``state`` must be PBR-upgraded (``models.gaussians.upgrade_to_pbr``).
    Without a ``bake`` the loop first bakes radiance over the alive
    surfels (``bake_radiance_compact``, update_radiace at train.py:59):
    the spirals turn by ``bake_azimuth`` [n_alive, 1] when given, else by
    draws from the loop's generator seeded with ``seed``.  ``radiances``
    and ``radiance_ratio`` are initialized from the bake when absent; a
    new env map draws from the loop's generator (after the bake's draws).
    Checkpoints carry the env map (``env=``) and the bake (``extra=``).
    ``profile_window`` traces the iterations it names, as in
    ``train_stage1``.
    """
    gen = torch.Generator(device=device).manual_seed(seed)
    params = dict(state["params"])
    if bake is None:
        if bake_azimuth is None:
            bake_azimuth = torch.rand(int(state["alive"].sum()), 1,
                                      generator=gen, device=device)
        t0 = time.time()
        bake = bake_radiance_compact(params, state["alive"],
                                     sample_num=sample_num,
                                     azimuth=bake_azimuth)
        print(f"bake: {int(state['alive'].sum())} surfels x S={sample_num}, "
              f"{float(bake['exhausted_frac']):.4%} of rays exhausted, "
              f"{time.time() - t0:.2f} s", flush=True)
    bake = {k: v for k, v in bake.items() if k != "exhausted_frac"}
    if "incident_qxy" not in bake:      # a bake saved by svgir_tpu
        bake["incident_qxy"] = torch.stack(
            LT.equirect_grid_coords(bake["incident_dirs"]), -1)

    if "radiances" not in params or params["radiances"].shape[1] != sample_num:
        params["radiances"] = bake["radiance"].clone()
        params["radiance_ratio"] = torch.ones((), device=device)
    state = {**state, "params": params}

    if env_state is None:
        env_state = LT.direct_light_map_init(env_resolution, opt.light_init,
                                             generator=gen, device=device)

    lrs = optim.group_lrs(opt, spatial_lr_scale, use_pbr=True)
    if opt_state is None:
        opt_state = optim.adam_init(params)
    step_fn = make_svgss_train_step(opt, raster_cfg, bg, sh_degree=sh_degree,
                                    lrs=lrs, device=device)
    xyz_sched = get_expon_lr_fn(
        lr_init=opt.position_lr_init * spatial_lr_scale,
        lr_final=opt.position_lr_final * spatial_lr_scale,
        lr_delay_mult=opt.position_lr_delay_mult,
        max_steps=opt.position_lr_max_steps)
    periodic = PeriodicTasks(
        out_dir=out_dir, checkpoint_interval=checkpoint_interval,
        test_cameras=test_cameras, test_interval=test_interval,
        vis_interval=vis_interval, device=device)
    cams = stage_cameras([strip_meta(c) for c in cameras], device=device)
    bg_t = torch.as_tensor(bg, dtype=torch.float32, device=device)

    def eval_fn(cam):
        return render_view_svgss(cam, state["params"], bake,
                                 env_state["params"], bg_t,
                                 is_training=False, alive=state["alive"],
                                 sh_degree=sh_degree, cfg=raster_cfg)

    def save_fn(i):
        CK.save_checkpoint(os.path.join(out_dir, f"chkpnt{i}.npz"), i, state,
                           opt_state, env=env_state, extra=bake)

    radiance_lr = opt.radiance_lr
    # resuming past the first %1000 boundary keeps it zeroed
    if first_iter >= 1000 and (first_iter // 1000) * 1000 > 30_000:
        radiance_lr = 0.0
    history = []
    t0 = time.time()
    overflow = None
    for it in range(first_iter + 1, iterations + 1):
        if profile_window is not None:
            profile_window.begin(it)
        cam = camera_for_iter(cams, it, seed)
        xyz_lr = float(xyz_sched(it))
        state, opt_state, env_state, tb = step_fn(
            state, opt_state, env_state, bake, cam, float(it - first_iter),
            xyz_lr, radiance_lr)
        overflow = _any_overflow(overflow, tb)
        # train.py:211-214: zero the radiance lr at the first %1000
        # boundary
        if it % 1000 == 0:
            radiance_lr = 0.0

        with profiling.span("svgir.loop.periodic"):
            extras = periodic.run(it, eval_fn=eval_fn, save_fn=save_fn,
                                  vis_cam=cam)
        if it % log_every == 0 or it == iterations or extras:
            with profiling.span("svgir.loop.log"):
                entry = {"iter": it, "psnr": float(tb["psnr"]),
                         "psnr_pbr": float(tb["psnr_pbr"]),
                         "loss": float(tb["loss"]),
                         "elapsed": time.time() - t0, **extras}
                if _overflowed(entry, overflow, it) and auto_grow_instances:
                    raster_cfg = _grow_instance_cap(raster_cfg)
                    step_fn = make_svgss_train_step(
                        opt, raster_cfg, bg, sh_degree=sh_degree, lrs=lrs,
                        device=device)
                overflow = None
                history.append(entry)
                if callback:
                    callback(entry, state, env_state)
        if profile_window is not None:
            profile_window.end(it)
    return state, opt_state, env_state, bake, history


EXHAUSTED_TOL = 0.01    # share of bake rays that may use up their hit list
MAX_K_HITS = 128        # the exhausted re-bake doubles k_hits up to this


@profiling.span("svgir.bake")
def bake_radiance_compact(params, alive, *, sample_num: int,
                          azimuth: Optional[torch.Tensor] = None,
                          k_hits: int = 16,
                          max_k_hits: int = MAX_K_HITS,
                          use_grid: Optional[bool] = None) -> Dict:
    """Bake over the alive surfels only, then expand the buffers to
    capacity rows (dead rows: radiance 0, visibility 1, areas 2*pi, hit
    -1) with the hit indices mapped back to capacity rows.

    ``azimuth`` [n_alive, 1] turns the spirals (a re-bake reuses it).
    Rays that use up their K-hit list composite a truncated radiance, which
    the reference march never does: when more than 1% of the rays do, the
    bake warns and runs again with ``k_hits`` doubled, up to
    ``max_k_hits`` (``max_k_hits=k_hits``: one pass).  ``use_grid``
    chooses the tracer as ``bake_radiance``'s does (by default by the
    alive count)."""
    cap = alive.shape[0]
    idx = torch.nonzero(alive)[:, 0]                       # compact -> cap
    n_alive = idx.shape[0]
    sub = {k: params[k][idx] for k in
           ("xyz", "scaling", "rotation", "opacity", "shs_dc", "shs_rest")}
    while True:
        bake_c = RAD.bake_radiance(
            sub["xyz"], G.get_scaling(sub), G.get_rotation(sub),
            G.get_opacity(sub)[:, 0], G.get_shs(sub), sample_num=sample_num,
            azimuth=azimuth, k_hits=k_hits, use_grid=use_grid)
        frac = float(bake_c["exhausted_frac"])
        if frac <= EXHAUSTED_TOL or k_hits >= max_k_hits:
            if frac > EXHAUSTED_TOL:
                print(f"WARNING: radiance bake still has {frac:.1%} "
                      f"exhausted rays at k_hits={k_hits} (max reached)",
                      flush=True)
            break
        print(f"WARNING: {frac:.1%} of bake rays exhausted the {k_hits}-hit "
              f"list; re-baking with k_hits={k_hits * 2}", flush=True)
        k_hits *= 2

    def expand(x, fill=0.0):
        out = torch.full((cap,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                         device=x.device)
        out[idx] = x
        return out

    hit_c = bake_c["hit_idx"]
    hit_cap = torch.where(hit_c >= 0,
                          idx[torch.clamp(hit_c, 0, max(n_alive - 1, 0))
                              .long()].to(torch.int32),
                          torch.full_like(hit_c, -1))
    dirs = expand(bake_c["incident_dirs"])
    qx, qy = LT.equirect_grid_coords(dirs)      # dead rows' too
    return {
        "radiance": expand(bake_c["radiance"]),
        "visibility": expand(bake_c["visibility"], fill=1.0),
        "incident_dirs": dirs,
        "incident_areas": expand(bake_c["incident_areas"],
                                 fill=2.0 * 3.141592653589793),
        "incident_qxy": torch.stack([qx, qy], -1),
        "hit_idx": expand(hit_cap, fill=-1),
        "uv": expand(bake_c["uv"]),
        "exhausted_frac": bake_c["exhausted_frac"],
    }


def jsonl_logger(path: str):
    """Callback that appends each history entry to a JSON-lines file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def cb(entry, *_):
        with open(path, "a") as f:
            f.write(json.dumps(entry) + "\n")

    return cb


def tensorboard_logger(log_dir: str):
    """Callback that writes each history entry as TensorBoard scalars
    (``train_loss_patches/<key>``, training_report at train.py:252-311), or
    None when ``torch.utils.tensorboard`` cannot be imported."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    writer = SummaryWriter(log_dir)

    def cb(entry, *_):
        step = int(entry.get("iter", 0))
        for key, val in entry.items():
            if key != "iter" and isinstance(val, (int, float)):
                writer.add_scalar(f"train_loss_patches/{key}", val, step)

    cb.writer = writer          # callers close it
    return cb
