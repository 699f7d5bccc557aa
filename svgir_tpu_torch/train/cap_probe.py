"""Snug instance cap for the training CLI.

The rasterizer bins (tile, depth) instances into a buffer of
``RasterConfig.max_instances`` slots, and the step's instance-sized work
(the slab gather, the blend's chunk walk, the per-instance scatter of the
backward) scales with that capacity, not with the instances a frame holds.
The reference sizes its buffers per frame (rasterizer_impl.cu:70-111); the
port, like ``svgir_tpu``, probes the scene once at the start: the largest
instance count over a few training views, with headroom, rounded up.  The
loop then doubles the cap whenever a frame overflows it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from svgir_tpu_torch.models.gaussians import get_rotation, get_scaling
from svgir_tpu_torch.ops.binning import bin_instances_counting
from svgir_tpu_torch.ops.preprocess import preprocess

N_PROBE_VIEWS = 3     # training views binned by the probe
HEADROOM = 1.3        # factor over the largest count
QUANTUM = 2048        # the cap is a multiple of this
PROBE_CAP = 1 << 21   # slots of the probe's own binning


@torch.no_grad()
def snug_instance_cap(params, camera_list: List, cfg, *,
                      alive: Optional[torch.Tensor] = None) -> int:
    """The largest padded instance count over ``N_PROBE_VIEWS`` views
    spread over ``camera_list``, times ``HEADROOM``, rounded up to
    ``QUANTUM``.  The views are binned (B1, B2 on the card) at ``PROBE_CAP``
    slots, so the count is exact whatever the tile and chunk padding; the
    cameras' matrices go to the device of ``params``."""
    pcfg = dataclasses.replace(cfg, max_instances=PROBE_CAP)
    dev = params["xyz"].device
    scaling = get_scaling(params)
    if alive is not None:
        # dead rows keep stale parameters after pruning: shrink them to
        # nothing so they bin no instances
        scaling = torch.where(alive[:, None], scaling,
                              torch.full_like(scaling, 1e-10))
    rotation = get_rotation(params)
    worst = 0
    step = max(1, len(camera_list) // N_PROBE_VIEWS)
    for cam in camera_list[::step][:N_PROBE_VIEWS]:
        prep = preprocess(
            params["xyz"], scaling, rotation, cam.world_view.to(dev),
            cam.full_proj.to(dev), cam.camera_center.to(dev),
            width=cam.width, height=cam.height, tanfovx=cam.tanfovx,
            tanfovy=cam.tanfovy, focal_x=cam.focal_x, focal_y=cam.focal_y,
            cfg=pcfg)
        binned = bin_instances_counting(prep, width=cam.width,
                                        height=cam.height, cfg=pcfg)
        if bool(binned.overflow):
            raise RuntimeError(f"instance-cap probe overflowed its "
                               f"{PROBE_CAP} slots")
        worst = max(worst, int(binned.num_instances))
    snug = -(-int(worst * HEADROOM) // QUANTUM) * QUANTUM
    return max(snug, QUANTUM)
