"""Tile binning: expand Gaussians into (tile, depth)-sorted, chunk-aligned
instance runs with the sort-free counting binner
(``bin_instances_counting``), as in ``svgir_tpu.ops.binning``:
  1. stable sort of the Gaussians by depth (invalid ones last, zero rects);
  2. per-tile counts and per-chunk carry snapshots (B1);
  3. the exclusive prefix sum of the touched counts;
  4. per-instance slots = chunk-aligned tile start + depth rank (B2);
  5. one indexed store of the Gaussian ids into their (distinct) slots.

Equal depths keep Gaussian-index order (duplication order), as the
reference's stable radix sort does.  Everything here is integer bookkeeping
without gradients.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from reference.config import RasterConfig
from reference.ops.binning_pallas import compute_counts, compute_instances
from reference.ops.preprocess import Preprocessed


class PaddedInstances(NamedTuple):
    """Chunk-aligned instance layout: each tile's run starts at a multiple of
    ``chunk`` and is padded to a multiple of ``chunk`` with slots of id -1."""

    gaussian_id: torch.Tensor    # [M] int32, -1 for padding slots
    inst_valid: torch.Tensor     # [M] bool
    tile_start: torch.Tensor     # [T] int32, chunk-aligned starts
    tile_count: torch.Tensor     # [T] int32, padded counts
    num_instances: torch.Tensor  # [] int32, total padded count (<= M)
    overflow: torch.Tensor       # [] bool
    # [N] depth-sorted ids (-1 culled)
    order: Optional[torch.Tensor] = None


@torch.no_grad()
def bin_instances_counting(prep: Preprocessed, *, width: int, height: int,
                           cfg: RasterConfig = RasterConfig(),
                           gauss_chunk: int = 256) -> PaddedInstances:
    tile, chunk = cfg.tile, cfg.chunk
    grid_x = (width + tile - 1) // tile
    grid_y = (height + tile - 1) // tile
    m = cfg.max_instances
    n = prep.valid.shape[0]
    dev = prep.valid.device
    i32 = torch.int32

    v = prep.valid
    key = torch.where(v, prep.depth.detach(),
                      torch.full_like(prep.depth, float("inf")))
    _, perm = torch.sort(key, stable=True)
    zero = torch.zeros((), dtype=i32, device=dev)

    def sorted_col(a):
        return torch.where(v, a, zero)[perm]

    x0, y0 = sorted_col(prep.rect_min[:, 0]), sorted_col(prep.rect_min[:, 1])
    x1, y1 = sorted_col(prep.rect_max[:, 0]), sorted_col(prep.rect_max[:, 1])
    ids = torch.where(v, torch.arange(n, dtype=i32, device=dev),
                      torch.full((), -1, dtype=i32, device=dev))
    order_s = ids[perm]
    touched = (x1 - x0) * (y1 - y0)

    npad = (-n) % gauss_chunk

    def pad(a):
        return torch.cat([a, a.new_zeros(npad)])

    x0p, y0p, x1p, y1p = pad(x0), pad(y0), pad(x1), pad(y1)
    tile_start, padded_counts, total_padded, carry = compute_counts(
        x0p, y0p, x1p, y1p, grid_x=grid_x, grid_y=grid_y, chunk=chunk,
        gauss_chunk=gauss_chunk)

    touched_p = pad(touched)
    offsets = torch.cumsum(touched_p, 0, dtype=i32) - touched_p
    total_raw = offsets[-1] + touched_p[-1]
    overflow = (total_raw > m) | (total_padded > m)

    table = (carry + tile_start[None]).contiguous()
    slot, gid = compute_instances(
        x0p, y0p, x1p, y1p, offsets, pad(order_s), table, total_raw,
        m=m, grid_x=grid_x, gauss_chunk=gauss_chunk)

    # slots are distinct below m; slot m collects everything dropped
    out_gid = torch.full((m + 1,), -1, dtype=i32, device=dev)
    out_gid[slot.clamp(max=m).long()] = gid
    out_gid = out_gid[:m]

    return PaddedInstances(
        gaussian_id=out_gid, inst_valid=out_gid >= 0,
        tile_start=tile_start.to(i32), tile_count=padded_counts.to(i32),
        num_instances=torch.clamp(total_padded, max=m), overflow=overflow,
        order=order_s)
