"""Data parallelism over cameras on ``torch.distributed``, and the sharded
radiance bake.

Mirrors ``svgir_tpu.parallel.dp``: the ranks of a process group stand in
for the JAX mesh's devices (NCCL on the card, gloo on the CPU), each rank
runs the reference's ``shard_map`` body for its own camera, and the
``psum``/``pmean`` over the ``data`` axis become all-reduces
(``parallel/comm.py``).  Parameters are replicated: every rank renders
its camera, computes its loss and gradients, averages gradients and loss
over the ranks, and takes the same Adam step, so the replicas stay
bit-equal (the all-reduce hands every rank the same bits).

The densification deltas are summed over the ranks before they meet the
old statistics, ``max_radii2d`` included (``dp.py:137-143``): on this path
the views' radii add where a sequence of single-view steps takes their max
(ROADMAP hazard 11).  The port computes what the reference computes.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from svgir_tpu_torch.config import OptimizationConfig, RasterConfig
from svgir_tpu_torch.models import gaussians as G
from svgir_tpu_torch.models import lights as LT
from svgir_tpu_torch.ops import tracing
from svgir_tpu_torch.parallel import comm
from svgir_tpu_torch.render.stage1 import render_stage1
from svgir_tpu_torch.render.svgss import render_svgss
from svgir_tpu_torch.train import optim
from svgir_tpu_torch.train.trainer import loss_grads
from svgir_tpu_torch.utils.graphics import fibonacci_sphere_sampling


def local_device(rank: Optional[int] = None) -> torch.device:
    """``cuda:{local rank}``: ``LOCAL_RANK`` where a launcher (torchrun)
    sets it, else the rank (this process's by default) modulo the cards of
    the host."""
    r = os.environ.get("LOCAL_RANK")
    if r is None:
        r = (dist.get_rank() if rank is None else rank) \
            % max(torch.cuda.device_count(), 1)
    return torch.device("cuda", int(r))


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None, *, device=None,
                     backend: Optional[str] = None) -> int:
    """Join this process to the process group; returns its rank.  A second
    call returns the rank of the group already joined.

    With no arguments a launcher's environment (``torchrun``: ``env://``)
    gives the address, world size and rank; else ``init_method``
    (``tcp://host:port`` or ``file://path``), ``world_size`` and ``rank``.
    ``device`` (default, and for ``"cuda"`` without an index,
    ``cuda:{local rank}``) picks the backend: NCCL for a card, gloo for
    ``"cpu"``; ``backend`` overrides it (gloo over CUDA
    tensors runs several ranks on one card, where NCCL refuses).
    """
    if dist.is_initialized():
        return dist.get_rank()
    device = torch.device(device or "cuda")
    if device.type == "cuda" and device.index is None:
        device = local_device(rank or 0)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=-1 if world_size is None
                            else world_size,
                            rank=-1 if rank is None else rank)
    return dist.get_rank()


def make_mesh(n_devices: Optional[int] = None, axis: str = "data", *,
              device_type: str = "cuda") -> DeviceMesh:
    """A 1-D mesh named ``axis`` over the first ``n_devices`` ranks (all
    by default)."""
    n = n_devices or dist.get_world_size()
    return DeviceMesh(device_type, list(range(n)), mesh_dim_names=(axis,))


def make_global_mesh(axes: Dict[str, int] | None = None, *,
                     device_type: str = "cuda") -> DeviceMesh:
    """Mesh over every rank of the process group.  ``axes`` maps axis name
    -> size with at most one -1 (inferred), e.g. ``{"data": -1, "tile":
    4}``; the default is a 1-D ``data`` mesh.  Axes follow dict order,
    the last the fastest-varying."""
    n = dist.get_world_size()
    axes = dict(axes or {"data": -1})
    sizes = list(axes.values())
    if -1 in sizes:
        known = 1
        for s in sizes:
            if s != -1:
                known *= s
        sizes[sizes.index(-1)] = n // known
    prod = 1
    for s in sizes:
        prod *= s
    if prod != n:
        raise ValueError(f"mesh axes {axes} do not tile {n} devices "
                         f"(product {prod})")
    return init_device_mesh(device_type, tuple(sizes),
                            mesh_dim_names=tuple(axes))


def stack_cameras(cameras: List):
    """One camera whose tensor fields stack the cameras' along a leading
    batch dimension; the other fields must match across the batch."""
    first = cameras[0]
    fields = {}
    for f in dataclasses.fields(first):
        vals = [getattr(c, f.name) for c in cameras]
        if isinstance(vals[0], torch.Tensor):
            fields[f.name] = torch.stack(vals)
        elif any(v != vals[0] for v in vals[1:]):
            raise ValueError(f"cameras differ in {f.name}")
    return dataclasses.replace(first, **fields)


def index_camera(batched, i: int):
    """Camera ``i`` of a ``stack_cameras`` batch."""
    return dataclasses.replace(batched, **{
        f.name: getattr(batched, f.name)[i]
        for f in dataclasses.fields(batched)
        if isinstance(getattr(batched, f.name), torch.Tensor)})


def _mesh_axis(mesh: DeviceMesh):
    axis = mesh.mesh_dim_names[0]
    return mesh.get_group(axis), mesh.get_local_rank(axis)


def _reduce_dict(tensors: Dict[str, torch.Tensor], op: str,
                 group) -> Dict[str, torch.Tensor]:
    """Every tensor reduced over the ranks by ``op``, in one all-reduce of
    their concatenation."""
    names = list(tensors)
    flat = comm.reduce_values(
        torch.cat([tensors[k].reshape(-1) for k in names]), op, group)
    parts = flat.split([tensors[k].numel() for k in names])
    return {k: p.reshape(tensors[k].shape) for k, p in zip(names, parts)}


def make_dp_train_step(mesh: DeviceMesh, opt: OptimizationConfig,
                       raster_cfg: RasterConfig, bg, *, sh_degree: int = 3,
                       lrs: Optional[Dict[str, float]] = None,
                       render_fn=render_stage1, device=None):
    """Build the data-parallel stage-1 step.

    step(state, opt_state, cam_batch, iteration, xyz_lr) -> (state,
    opt_state, {"loss", "psnr"}); ``cam_batch`` (``stack_cameras``) holds
    one camera per rank of the mesh's first axis, and rank r renders camera
    r.  Gradients and loss are averaged over the ranks, the densification
    deltas summed (``max_radii2d`` too: hazard 11), psnr averaged.
    """
    group, idx = _mesh_axis(mesh)
    bg = torch.as_tensor(bg, dtype=torch.float32,
                         device=device or local_device())

    def step(state, opt_state, cam_batch, iteration, xyz_lr):
        alive, stats = state["alive"], state["stats"]
        cam = index_camera(cam_batch, idx)
        cap = alive.shape[0]
        params = {k: v.detach().requires_grad_(True)
                  for k, v in state["params"].items()}
        off = torch.zeros(cap, 2, device=alive.device, requires_grad=True)
        res = render_fn(cam, params, bg, opt=opt, iteration=iteration,
                        is_training=True, alive=alive, mean2d_offset=off,
                        sh_degree=sh_degree, mono=cam.mono, cfg=raster_cfg)
        gp, (goff,) = loss_grads(res["loss"], params, [off])
        mean = _reduce_dict({**gp, "loss": res["loss"].detach()[None],
                             "psnr": res["tb_dict"]["psnr"].detach()[None]},
                            "mean", group)

        step_lrs = {**(lrs or {}), "xyz": xyz_lr}
        new_params, opt_state = optim.adam_step(
            {k: v.detach() for k, v in params.items()},
            {k: mean[k] for k in gp}, opt_state, step_lrs)

        scale = goff.new_tensor([0.5 * cam.width, 0.5 * cam.height])
        visible = res["visibility_filter"] & alive
        # per-view deltas summed over the ranks, then applied once
        delta = _reduce_dict(G.add_densification_stats(
            G.init_stats(cap, device=alive.device), goff * scale, visible,
            res["weights"].detach(), res["radii"].to(torch.float32)),
            "sum", group)
        stats = {
            **{k: stats[k] + delta[k] for k in
               ("xyz_gradient_accum", "normal_gradient_accum", "denom",
                "weights_accum")},
            "max_radii2d": torch.maximum(stats["max_radii2d"],
                                         delta["max_radii2d"]),
        }
        return ({"params": new_params, "alive": alive, "stats": stats},
                opt_state, {"loss": mean["loss"][0], "psnr": mean["psnr"][0]})

    return step


def make_dp_svgss_train_step(mesh: DeviceMesh, opt: OptimizationConfig,
                             raster_cfg: RasterConfig, bg, *,
                             sh_degree: int = 3,
                             lrs: Optional[Dict[str, float]] = None,
                             device=None):
    """Build the data-parallel stage-2 (render_relight) step.

    step(state, opt_state, env_state, bake, cam_batch, iteration, xyz_lr,
    radiance_lr) -> (state, opt_state, env_state, {"loss", "psnr"}): rank
    r renders camera r through the deferred-PBR forward and loss; the
    Gaussian and env-map gradients and the loss are averaged over the
    ranks, then every rank takes the joint Adam step (the env's as
    ``train.trainer.make_svgss_train_step`` takes it).  The bake is
    replicated.
    """
    group, idx = _mesh_axis(mesh)
    bg = torch.as_tensor(bg, dtype=torch.float32,
                         device=device or local_device())

    def step(state, opt_state, env_state, bake, cam_batch, iteration,
             xyz_lr, radiance_lr):
        alive = state["alive"]
        cam = index_camera(cam_batch, idx)
        params = {k: v.detach().requires_grad_(True)
                  for k, v in state["params"].items()}
        env = env_state["params"]["env"].detach().requires_grad_(True)
        res = render_svgss(cam, params, bg, bake=bake,
                           env_params={"env": env}, opt=opt,
                           iteration=iteration, is_training=True,
                           alive=alive, sh_degree=sh_degree, cfg=raster_cfg)
        gp, (genv,) = loss_grads(res["loss"], params, [env])
        mean = _reduce_dict({**gp, "__env": genv,
                             "loss": res["loss"].detach()[None],
                             "psnr": res["tb_dict"]["psnr"].detach()[None]},
                            "mean", group)

        step_lrs = {**(lrs or {}), "xyz": xyz_lr, "radiances": radiance_lr}
        new_params, opt_state = optim.adam_step(
            {k: v.detach() for k, v in params.items()},
            {k: mean[k] for k in gp}, opt_state, step_lrs)
        new_env = LT.direct_light_map_step(
            {"params": {"env": env.detach()}, "opt": env_state["opt"]},
            {"env": mean["__env"]}, opt.env_lr)
        return ({"params": new_params, "alive": alive,
                 "stats": state["stats"]}, opt_state, new_env,
                {"loss": mean["loss"][0], "psnr": mean["psnr"][0]})

    return step


@torch.no_grad()
def bake_radiance_sharded(mesh: DeviceMesh, axis: str, means, scales, quats,
                          opacity, shs, *, sample_num: int,
                          azimuth: Optional[torch.Tensor] = None,
                          k_hits: int = 8, gauss_chunk: int = 256,
                          ray_chunk: int = 65536) -> Dict:
    """The radiance bake with its N*S hemisphere rays split over the ranks
    of ``axis``: each rank traces its share with the brute tracer
    (``ops/tracing.nearest_hits``) against the replicated surfels and
    marches it, and the outputs are gathered in ray order.  The same
    outputs as ``models.radiance.bake_radiance(use_grid=False)``; N*S must
    split evenly over the ranks.  ``azimuth`` [N, 1] turns each surfel's
    spiral, as the bake's does (the caller draws it); rays run in chunks of
    ``ray_chunk``."""
    group = mesh.get_group(axis)
    ndev, idx = dist.get_world_size(group), dist.get_rank(group)
    n, s = means.shape[0], sample_num
    if (n * s) % ndev:
        raise ValueError(f"{n * s} rays do not split over {ndev} ranks")
    geo = tracing.build_surfel_geometry(means, scales, quats, opacity)
    dirs, areas = fibonacci_sphere_sampling(geo.normal, s, azimuth)
    per = n * s // ndev
    rays = slice(idx * per, (idx + 1) * per)
    rays_o = means.repeat_interleave(s, 0)[rays]
    rays_d = dirs.reshape(-1, 3)[rays]
    self_idx = torch.arange(n, dtype=torch.int32,
                            device=means.device).repeat_interleave(s)[rays]

    outs = []
    for r0 in range(0, per, ray_chunk):
        sl = slice(r0, min(r0 + ray_chunk, per))
        hits = tracing.nearest_hits(geo, rays_o[sl], rays_d[sl],
                                    chunk=gauss_chunk, k=k_hits)
        outs.append(tracing.radiance_march(hits, self_idx[sl], shs, means,
                                           rays_o[sl]))
    cat = {k: comm.gather_values(torch.cat([x[k] for x in outs]), group)
           for k in outs[0]}
    qx, qy = LT.equirect_grid_coords(dirs)
    return {
        "radiance": cat["radiance"].reshape(n, s, 3),
        "visibility": cat["visibility"].reshape(n, s, 1),
        "incident_dirs": dirs,
        "incident_areas": areas,
        "incident_qxy": torch.stack([qx, qy], -1),
        "hit_idx": cat["first_hit"].reshape(n, s),
        "uv": cat["first_uv"].reshape(n, s, 2),
        "exhausted_frac": cat["exhausted"].to(torch.float32).mean(),
    }
