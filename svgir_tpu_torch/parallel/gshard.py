"""Gaussian-sharded preprocess and tile-row-sharded blend over the ranks of
a process group.

Mirrors ``svgir_tpu.parallel.gshard``, whose ``shard_map`` body each rank
runs here:

  1. the rank preprocesses its shard of the Gaussians (inputs are
     replicated; ``comm.shard`` takes the rank's rows, and its backward
     gathers the rows' gradients, so every rank ends with the whole
     gradient);
  2. it gathers every rank's blend slab, depth, validity and tile rects
     (``all_gather``; the slab's backward sums the ranks' cotangents,
     since every rank's band reads every Gaussian's row), or, with
     ``exchange_cap``, sends each rank only the splats whose rects overlap
     that rank's tile rows (two all-to-alls of fixed [cap] buffers, the
     weight sums routed back by a third);
  3. it translates screen space so that its band of tile rows starts at
     y = 0 (``mean2d.y`` and the depth intercept, slab columns 1 and 18),
     bins the splats into the band with the counting binner (B1/B2) and
     blends it with the tile-major blend (B5/B6, ``_BlendGatherTiles``),
     whatever ``cfg.strip`` says, as the reference does;
  4. it gathers the bands into the whole image on every rank (the backward
     keeps the rank's own band of the cotangent: every rank computes the
     same loss from it) and sums the per-Gaussian weight sums.

Load balance: the tile rows split equal-area by default, or at
``balanced_row_starts``' exact min-max cut of the per-row instance
histogram (``row_instance_histogram``, a difference array over the
projected rects, no binning); each rank's tile grid is padded to the
widest band, and ``instance_stats`` reports the realized per-rank counts.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from svgir_tpu_torch.config import RasterConfig
from svgir_tpu_torch.ops import blend_pallas, common
from svgir_tpu_torch.ops.binning import bin_instances_counting
from svgir_tpu_torch.ops.preprocess import Preprocessed, preprocess
from svgir_tpu_torch.ops.rasterizer import (RenderBuffers, _BlendGatherTiles,
                                            _clamp_runs, _pack_slab)
from svgir_tpu_torch.parallel import comm

# slab columns the band translation touches: geometry (12) + rgb (3) +
# normal (3) -> the depth intercept, then c1, c2
NG_ADEPTH = 12 + 6
NG_C2 = 12 + 8


def _project(means3d, scales, quats, camera, cfg, **kw) -> Preprocessed:
    return preprocess(means3d, scales, quats, camera.world_view,
                      camera.full_proj, camera.camera_center,
                      width=camera.width, height=camera.height,
                      tanfovx=camera.tanfovx, tanfovy=camera.tanfovy,
                      focal_x=camera.focal_x, focal_y=camera.focal_y,
                      cfg=cfg, **kw)


@torch.no_grad()
def row_instance_histogram(means3d, scales, quats, opacity, camera, *,
                           mask=None, cfg: RasterConfig = RasterConfig()):
    """[grid_y] int32 instances per tile row (each projected rect adds its
    x-width to every row it spans), by a difference array: no binning."""
    grid_y = -(-camera.height // cfg.tile)
    prep = _project(means3d, scales, quats, camera, cfg)
    valid = prep.valid if mask is None else (prep.valid & mask)
    w = torch.where(valid, prep.rect_max[:, 0] - prep.rect_min[:, 0],
                    torch.zeros_like(prep.rect_max[:, 0])).to(torch.int32)
    lo = torch.clamp(prep.rect_min[:, 1], 0, grid_y).long()
    hi = torch.clamp(prep.rect_max[:, 1], 0, grid_y).long()
    diff = torch.zeros(grid_y + 1, dtype=torch.int32, device=w.device)
    diff.index_add_(0, lo, w)
    diff.index_add_(0, hi, -w)
    return torch.cumsum(diff, 0, dtype=torch.int32)[:grid_y]


def balanced_row_starts(hist, ndev: int) -> tuple:
    """Contiguous instance-balanced row partition: ``ndev + 1`` boundaries
    (a tuple of ints, decided at setup), by the exact min-max DP over
    contiguous blocks of at least one row, which minimizes the heaviest
    rank's instance count.  ``hist``: a tensor or array of row counts."""
    if isinstance(hist, torch.Tensor):
        hist = hist.cpu().numpy()
    h = np.asarray(hist).astype(np.int64)
    if len(h) < ndev:        # fewer rows than ranks: pad with empty rows
        h = np.pad(h, (0, ndev - len(h)))
    grid_y = len(h)
    c = np.concatenate([[0], np.cumsum(h)])
    inf = np.iinfo(np.int64).max
    # dp[d][i]: the least max block load over partitions of rows[0:i] into
    # d blocks; block d covers rows[j:i], j in [d-1, i-1]
    dp = np.full((ndev + 1, grid_y + 1), inf)
    cut = np.zeros((ndev + 1, grid_y + 1), np.int64)
    dp[1, 1:] = c[1:]
    for d in range(2, ndev + 1):
        for i in range(d, grid_y - (ndev - d) + 1):
            js = np.arange(d - 1, i)
            cand = np.maximum(dp[d - 1, js], c[i] - c[js])
            k = int(np.argmin(cand))
            dp[d, i] = cand[k]
            cut[d, i] = js[k]
    starts = [grid_y]
    i = grid_y
    for d in range(ndev, 1, -1):
        i = int(cut[d, i])
        starts.append(i)
    starts.append(0)
    return tuple(reversed(starts))


def instance_stats(means3d, scales, quats, opacity, camera, row_starts, *,
                   mask=None, cfg: RasterConfig = RasterConfig()) -> dict:
    """Per-rank instance counts of a row partition, with max/mean
    imbalance."""
    hist = row_instance_histogram(means3d, scales, quats, opacity, camera,
                                  mask=mask, cfg=cfg).cpu().numpy()
    counts = [int(hist[row_starts[d]:row_starts[d + 1]].sum())
              for d in range(len(row_starts) - 1)]
    mean = max(float(np.mean(counts)), 1e-9)
    return {"per_device": counts, "max": int(np.max(counts)),
            "mean": mean, "imbalance": float(np.max(counts) / mean)}


def _row_partition(row_starts, ndev: int, grid_rows: int) -> tuple:
    """(row_starts, grid_y_total): equal-area bands over the grid padded
    to a multiple of the ranks, or the given boundaries checked."""
    if row_starts is None:
        total = -(-grid_rows // ndev) * ndev
        per = total // ndev
        return tuple(d * per for d in range(ndev + 1)), total
    # balanced_row_starts pads the grid to at least one row per rank
    total = max(grid_rows, ndev)
    row_starts = tuple(int(r) for r in row_starts)
    if (len(row_starts) != ndev + 1 or row_starts[0] != 0
            or row_starts[-1] != total):
        raise ValueError(f"row_starts must be {ndev + 1} boundaries covering "
                         f"[0, {total}]; got {row_starts}")
    return row_starts, total


def _translate(slab, y_off: float):
    """Move mean2d.y up by the band's pixel offset and the depth intercept
    with it (compensated exactly by band-local pixel rows)."""
    return torch.cat([
        slab[:, :1], slab[:, 1:2] - y_off, slab[:, 2:NG_ADEPTH],
        slab[:, NG_ADEPTH:NG_ADEPTH + 1] + y_off * slab[:, NG_C2:NG_C2 + 1],
        slab[:, NG_ADEPTH + 1:]], 1)


def rasterize_sharded(mesh, axis: str, means3d, scales, quats, opacity,
                      camera, bg, *, shs=None, sh_degree=3, colors=None,
                      features=None, vfeatures=None, mask=None,
                      cfg: RasterConfig = RasterConfig(),
                      exchange_cap: Optional[int] = None,
                      row_starts: Optional[tuple] = None) -> RenderBuffers:
    """Rasterize one camera over the ranks of ``mesh``'s ``axis``: every
    rank calls it with the same (replicated) inputs and gets the same
    ``RenderBuffers`` as ``ops.rasterizer.rasterize``, whole image
    included.

    N must split evenly over the ranks; the tile rows are padded so the
    equal-area bands divide evenly.  ``exchange_cap``: the blend payload
    moves by a budgeted all-to-all, each rank sending each destination at
    most ``cap`` splats (those overlapping its band), instead of the
    all-gather of the whole [N, KR] slab: a rank receives D*cap rows
    instead of N.  An overflowing budget is flagged in ``overflow``.
    """
    group = mesh.get_group(axis)
    ndev = dist.get_world_size(group)
    idx = dist.get_rank(group)
    width, height = camera.width, camera.height
    tile = cfg.tile
    grid_x = -(-width // tile)
    row_starts, grid_y_total = _row_partition(row_starts, ndev,
                                              -(-height // tile))
    bands = tuple(row_starts[d + 1] - row_starts[d] for d in range(ndev))
    if min(bands) < 1:
        raise ValueError(f"empty tile-row band in {row_starts}")
    rows_per_dev = max(bands)        # every rank's grid: the widest band
    y0, band = row_starts[idx], bands[idx]
    tiles_local = grid_x * rows_per_dev
    # every tile's count is chunk-padded, so the local buffer holds at
    # least a chunk a tile (uneven bands pad the grid past grid_y/D)
    m_local = max(cfg.max_instances // ndev, tiles_local * cfg.chunk)
    cfg_local = dataclasses.replace(cfg, max_instances=m_local)

    n = means3d.shape[0]
    if n % ndev:
        raise ValueError(f"{n} Gaussians do not split over {ndev} ranks")

    def local(x):
        return None if x is None else comm.shard(x, group)

    prep = _project(local(means3d), local(scales), local(quats), camera,
                    cfg, shs=local(shs), sh_degree=sh_degree,
                    colors=local(colors))
    if mask is not None:
        valid = prep.valid & local(mask)
        prep = prep._replace(
            valid=valid, radius=torch.where(valid, prep.radius, 0),
            tiles_touched=torch.where(valid, prep.tiles_touched, 0))
    slab_l, ca, cv = _pack_slab(prep, local(opacity), local(features),
                                local(vfeatures), cfg)
    n_l, kr = slab_l.shape
    y_off = float(y0 * tile)

    def blend_rows(slab, depth, valid, rect_min, rect_max):
        """Bin and blend the candidate splats (slab translated) into this
        rank's band."""
        rows = slab.shape[0]
        rmin_y = torch.clamp(rect_min[:, 1] - y0, 0, band)
        rmax_y = torch.clamp(rect_max[:, 1] - y0, 0, band)
        touched = (rect_max[:, 0] - rect_min[:, 0]) * (rmax_y - rmin_y)
        valid_loc = valid & (touched > 0)
        zeros = slab.new_zeros
        prep_view = Preprocessed(
            valid=valid_loc, mean2d=zeros(rows, 2), depth=depth,
            conic=zeros(rows, 3),
            radius=torch.zeros(rows, dtype=torch.int32, device=slab.device),
            rect_min=torch.stack([rect_min[:, 0], rmin_y], -1),
            rect_max=torch.stack([rect_max[:, 0], rmax_y], -1),
            tiles_touched=torch.where(valid_loc, touched,
                                      torch.zeros_like(touched)),
            normal_view=zeros(rows, 3), jinv=zeros(rows, 10),
            lam=zeros(rows, 2), rgb=zeros(rows, 3), view_cos=zeros(rows))
        padded = bin_instances_counting(prep_view, width=width,
                                        height=rows_per_dev * tile,
                                        cfg=cfg_local)
        tile_start, tile_count = _clamp_runs(padded, m_local, cfg.chunk)
        kw = dict(ca=ca, cv=cv, grid_x=grid_x, grid_y=rows_per_dev,
                  tile=tile, chunk=cfg.chunk)
        # one extra all-zero row: padding slots (gid -1) gather it
        slab_ext = torch.cat([slab, slab.new_zeros(1, kr)])
        out, weights = _BlendGatherTiles.apply(
            slab_ext, padded.gaussian_id, tile_start, tile_count, kw, True,
            True)
        return out, weights, padded.overflow

    if exchange_cap is None:
        slab = comm.all_gather(slab_l, group)                    # [N, KR]
        depth = comm.gather_values(prep.depth, group)
        valid = comm.gather_values(prep.valid, group)
        rect_min = comm.gather_values(prep.rect_min, group)
        rect_max = comm.gather_values(prep.rect_max, group)
        out, weights, overflow = blend_rows(
            _translate(slab, y_off), depth, valid, rect_min, rect_max)
        # the per-Gaussian weight sums span every rank's band
        weights = comm.all_reduce(weights, "sum", group)
        radii = comm.gather_values(prep.radius, group)
    else:
        cap = exchange_cap
        y0s = torch.tensor(row_starts[:-1], device=slab_l.device)
        y1s = torch.tensor(row_starts[1:], device=slab_l.device)
        # which local splats overlap each destination's band, and their
        # slot in its [cap] buffer (slot D*cap: dropped)
        ov = (prep.valid[None]
              & (prep.rect_min[None, :, 1] < y1s[:, None])
              & (prep.rect_max[None, :, 1] > y0s[:, None]))      # [D, n_l]
        pos = torch.cumsum(ov.to(torch.int32), 1) - 1
        send_overflow = bool(((pos >= cap) & ov).any())
        dst = torch.arange(ndev, device=slab_l.device)[:, None]
        slot = torch.where(ov & (pos < cap), dst * cap + pos,
                           torch.full_like(pos, ndev * cap)).reshape(-1)
        # the local row that fills each (destination, slot); -1: empty
        src = torch.full((ndev * cap + 1,), -1, dtype=torch.int64,
                         device=slab_l.device)
        src[slot] = torch.arange(n_l, device=slab_l.device).repeat(ndev)
        src = src[:ndev * cap]
        take = torch.where(src >= 0, src, torch.full_like(src, n_l))
        send_slab = torch.cat([slab_l, slab_l.new_zeros(1, kr)])[take]
        meta_l = torch.cat([
            prep.depth.detach()[:, None], prep.rect_min.to(torch.float32),
            prep.rect_max.to(torch.float32),
            prep.valid[:, None].to(torch.float32)], 1)         # [n_l, 6]
        send_meta = torch.cat([meta_l, meta_l.new_zeros(1, 6)])[take]
        recv_slab = comm.all_to_all(send_slab, group)       # [D*cap, KR]
        recv_meta = comm.all_to_all(send_meta, group)
        out, weights_r, overflow = blend_rows(
            _translate(recv_slab, y_off), recv_meta[:, 0],
            recv_meta[:, 5] > 0.5, recv_meta[:, 1:3].to(torch.int32),
            recv_meta[:, 3:5].to(torch.int32))
        overflow = overflow | send_overflow
        # route the received rows' weight sums back to their owners
        w_back = comm.all_to_all(weights_r, group)               # [D*cap]
        weights_l = torch.zeros(n_l + 1, dtype=w_back.dtype,
                                device=w_back.device).index_add(
            0, take, w_back)[:n_l]
        weights = comm.all_gather(weights_l, group, backward="own")
        radii = comm.gather_values(prep.radius, group)
    # the bands gathered into the whole image on every rank
    out = comm.all_gather(out, group, backward="own")
    overflow = bool(comm.reduce_values(
        torch.as_tensor(overflow, dtype=torch.int32,
                        device=slab_l.device).reshape(1), "max", group))

    # [D * tiles_local, CO, tile**2] -> the image, each band's pad rows
    # dropped
    co = out.shape[1]
    out = out.reshape(ndev, tiles_local, co, tile * tile)
    out = torch.cat([out[d, :bands[d] * grid_x] for d in range(ndev)])
    img = blend_pallas.to_image(out, grid_x, grid_y_total, tile)
    img = img[:, :height, :width]

    s = 0 if features is None else features.shape[1]
    color_raw, normal = img[0:3], img[3:6]
    adepth, c1img, c2img = img[6], img[7], img[8]
    feat = img[9:9 + s]
    vfeat = img[ca:ca + cv]
    logT = img[ca + cv]
    n_contrib = img[ca + cv + 1].detach().to(torch.int32)

    dev = means3d.device
    # pixel rows local to each band (the depth intercept was translated)
    off = np.zeros(height, np.float32)
    for d in range(ndev):
        a = min(row_starts[d] * tile, height)
        b = min(row_starts[d + 1] * tile, height)
        off[a:b] = row_starts[d] * tile
    vv, uu = torch.meshgrid(torch.arange(height, dtype=torch.float32,
                                         device=dev),
                            torch.arange(width, dtype=torch.float32,
                                         device=dev), indexing="ij")
    py_local = vv - torch.from_numpy(off).to(dev)[:, None]
    D = adepth + uu * c1img + py_local * c2img
    T = torch.clamp(torch.exp(logT), max=1.0 - 1e-6)
    return RenderBuffers(
        color=color_raw + T[None] * bg[:, None, None], normal=normal,
        depth=common.finalize_depth(D, T, cfg.normalize_depth)[None],
        opacity=(1.0 - T)[None], feature=feat, vfeature=vfeat, final_t=T,
        n_contrib=n_contrib, weights=weights[:, None], radii=radii,
        overflow=torch.tensor(overflow, device=dev))
