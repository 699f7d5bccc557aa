"""The yardstick's arithmetic: the card's published peaks, and the
operations and bytes a training step's work needs, counted from the cell's
inputs by the plain reference (``benchmark/reference``), never from what
the program made.

A later change to how the program bins, blends or looks up moves none of
these counts: the blend's pairs are those the reference's own binning and
blend take for the view, and the env lookup's queries are the bake's.
"""

from __future__ import annotations

from typing import Dict

import torch

# One NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W power limit):
# float32 outside the tensor cores, and HBM3.
FP32_OPS_S = 67e12
HBM_BYTES_S = 3.35e12

# Float operations the blend needs per (pixel, instance) pair, by what the
# pair needs (an exp, log1p or division counts as one; a multiply-add as
# two; each nonzero term of a sum over the tile's pixels as one add):
#   test   every pair of a real row: offset, power, exp, alpha, both tests;
#   ok     the pair passes the footprint test: forward log1p and logT update;
#          backward loga, logT_excl, the logT part of d_alpha, d_power and
#          the six geometry rows (mean2d, conic, opacity) with their sums;
#   gated  ok and above the transmittance threshold: the weight, the plain
#          channel sums (forward) or dw, the plain rows and the weight part
#          of d_alpha (backward); with CV > 0 also the bilinear (u, v), the
#          vertex sums or rows, and in the backward d_Jinv and d_lam.
FWD_TEST, FWD_OK = 16, 4
BWD_TEST, BWD_OK = 16, 36
NG = 12                 # geometry columns of a blend row


def fwd_gated_ops(ca: int, cv: int) -> int:
    return 4 + 2 * ca + (30 + 8 * cv if cv else 0)


def bwd_gated_ops(ca: int, cv: int) -> int:
    return 7 + 4 * ca + (84 + 17 * cv if cv else 0)


def least_s(nbytes: float, ops: float) -> float:
    """The least time the card could take: bytes at the memory rate or
    operations at the float32 rate, whichever is longer."""
    return max(nbytes / HBM_BYTES_S, ops / FP32_OPS_S)


def blend_bounds(work: Dict, *, ca: int, cv: int, width: int, height: int,
                 tile: int) -> Dict[str, float]:
    """Least seconds of one view's blend forward and backward.  ``work``:
    the reference blend's counts for the view (``count_blend``).  Bytes:
    each real instance row read once (NG + CA + 4 CV floats), the image
    (CA + CV channels, logT and n_contrib) written once, or in the
    backward read once as the cotangent and logT, and each instance's
    gradient row written once."""
    gx, gy = -(-width // tile), -(-height // tile)
    t, hw = gx * gy, gx * gy * tile * tile
    kr = NG + ca + 4 * cv
    rows_b = 4 * work["rows"] * kr
    fwd_ops = (work["pairs"] * FWD_TEST + work["ok"] * FWD_OK
               + work["gated"] * fwd_gated_ops(ca, cv))
    bwd_ops = (work["pairs"] * BWD_TEST + work["ok"] * BWD_OK
               + work["gated"] * bwd_gated_ops(ca, cv))
    return {
        "forward_s": least_s(rows_b + 4 * (ca + cv + 2) * hw + 12 * t,
                             fwd_ops),
        "backward_s": least_s(2 * rows_b + 4 * (ca + cv + 2) * hw + 8 * t,
                              bwd_ops),
        "ops": fwd_ops + bwd_ops,
    }


# Per-query operations of the env lookup (floor, clamps, fraction, tap
# index: 18; per channel the forward's three lerps, the backward's two tap
# weights and four weighted adds into d_env).
ENV_TAP_OPS = 18


def env_bounds(queries: int, h: int, w: int, c: int = 3) -> Dict[str, float]:
    """Least seconds of one env lookup of ``queries`` coordinates into an
    [h, w, c] map and of its backward: each query's (u, v) and its sample
    (or cotangent) once, the map (or its gradient) once."""
    nb = 4 * (2 * queries + queries * c + h * w * c)
    fwd = queries * (ENV_TAP_OPS + 9 * c)
    bwd = queries * (ENV_TAP_OPS + 10 * c)
    return {"forward_s": least_s(nb, fwd), "backward_s": least_s(nb, bwd),
            "ops": fwd + bwd}


@torch.no_grad()
def count_blend(params, alive, camera, raster_cfg) -> Dict:
    """The reference blend's work for one view of the surfels: its real
    instance rows, (pixel, row) pairs, pairs past the footprint test and
    pairs that blend.  The counts depend on the geometry and opacity only,
    so the blend runs with the plain colour channels alone."""
    from reference.models import gaussians as G
    from reference.ops import blend_pallas_strip as BS
    from reference.ops.binning import bin_instances_counting
    from reference.ops.preprocess import preprocess
    from reference.ops.rasterizer import _clamp_runs, _gather, _pack_slab

    width, height, tile = camera.width, camera.height, raster_cfg.tile
    opacity = torch.where(alive, G.get_opacity(params)[:, 0],
                          torch.zeros_like(params["opacity"][:, 0]))
    prep = preprocess(
        params["xyz"], G.get_scaling(params), G.get_rotation(params),
        camera.world_view, camera.full_proj, camera.camera_center,
        width=width, height=height, tanfovx=camera.tanfovx,
        tanfovy=camera.tanfovy, focal_x=camera.focal_x,
        focal_y=camera.focal_y, colors=torch.zeros_like(params["xyz"]),
        cfg=raster_cfg)
    valid = prep.valid & alive
    prep = prep._replace(
        valid=valid, radius=torch.where(valid, prep.radius, 0),
        tiles_touched=torch.where(valid, prep.tiles_touched, 0))
    padded = bin_instances_counting(prep, width=width, height=height,
                                    cfg=raster_cfg)
    if bool(padded.overflow):
        raise RuntimeError("the reference binning overflowed its slots")
    slab, ca, cv = _pack_slab(prep, opacity, None, None, raster_cfg)
    slab_ext = torch.cat([slab, slab.new_zeros(1, slab.shape[1])])
    _, inst = _gather(slab_ext, padded.gaussian_id)
    start, count = _clamp_runs(padded, raster_cfg.max_instances,
                               raster_cfg.chunk)
    work: Dict = {}
    BS.blend_forward_plain(
        inst, start, count, ca=ca, cv=cv, grid_x=-(-width // tile),
        grid_y=-(-height // tile), tile=tile, chunk=raster_cfg.chunk,
        emit_wsum=False, work=work)
    work["instances"] = int((padded.gaussian_id >= 0).sum())
    return work


def adam_ops(elements: int) -> int:
    """Adam's update per element: moments (6), bias-corrected ratio,
    square root and step (7), NaN scrubbing (1)."""
    return 14 * elements


def ssim_ops(pixels: int, images: int = 1) -> int:
    """SSIM of ``images`` 3-channel images against one target: five
    separable 11-tap blurs (44 operations a pixel-channel) and the SSIM
    map (20), forward and twice that backward."""
    return 3 * pixels * images * (5 * 44 + 20) * 3


def preprocess_ops(surfels: int) -> int:
    """Projection, rotation, covariance, the local homography and SH
    degree 3 per visible surfel (about 600 operations), forward and twice
    that backward."""
    return 3 * 600 * surfels


def shading_ops(surfels: int, samples: int) -> int:
    """Stage 2's per-vertex shading: the GGX specular and diffuse terms of
    ``rendering_equation4`` for 4 vertices and each sample (about 120
    operations), forward and twice that backward."""
    return 3 * 120 * 4 * surfels * samples


def consistency_ops(surfels: int, samples: int) -> int:
    """The one-bounce consistency loss: at each surfel's chosen sample the
    simple BRDF of the hit surfel's 4 vertices along each of its
    ``samples`` directions (about 60 operations), forward and twice that
    backward."""
    return 3 * 60 * 4 * surfels * samples
