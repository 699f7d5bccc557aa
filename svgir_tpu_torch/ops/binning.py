"""Tile binning: expand Gaussians into (tile, depth)-sorted, chunk-aligned
instance runs.  Two binners, as in ``svgir_tpu.ops.binning``:

The sort-free counting binner (``bin_instances_counting``, the default):
  1. stable sort of the Gaussians by depth (invalid ones last, zero rects);
  2. per-tile counts and per-chunk carry snapshots (B1);
  3. the exclusive prefix sum of the touched counts;
  4. per-instance slots = chunk-aligned tile start + depth rank (B2);
  5. one indexed store of the Gaussian ids into their (distinct) slots.

The sort binner (``bin_instances`` + ``pad_to_chunks``), the reference's
cub pipeline in closed form and the counting binner's equivalence oracle:
every (Gaussian, tile) instance in a fixed-capacity buffer, a stable sort by
(tile, depth), tile ranges by ``searchsorted``, then a re-lay into
chunk-aligned runs.

Equal depths keep Gaussian-index order (duplication order), as the
reference's stable radix sort does.  Everything here is integer bookkeeping
without gradients.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from svgir_tpu_torch.config import RasterConfig
from svgir_tpu_torch.ops.binning_pallas import (compute_counts,
                                                compute_instances)
from svgir_tpu_torch.ops.preprocess import Preprocessed


class BinnedInstances(NamedTuple):
    """The (tile, depth)-sorted instance list of the sort binner."""

    gaussian_id: torch.Tensor    # [M] int32, source Gaussian per instance
    tile_id: torch.Tensor        # [M] int32, owning tile (T for padding)
    inst_valid: torch.Tensor     # [M] bool
    tile_start: torch.Tensor     # [T] int32, range starts in the list
    tile_end: torch.Tensor       # [T] int32
    num_instances: torch.Tensor  # [] int32, true count (<= M)
    overflow: torch.Tensor       # [] bool, the true count exceeded M


class PaddedInstances(NamedTuple):
    """Chunk-aligned instance layout: each tile's run starts at a multiple of
    ``chunk`` and is padded to a multiple of ``chunk`` with slots of id -1."""

    gaussian_id: torch.Tensor    # [M] int32, -1 for padding slots
    inst_valid: torch.Tensor     # [M] bool
    tile_start: torch.Tensor     # [T] int32, chunk-aligned starts
    tile_count: torch.Tensor     # [T] int32, padded counts
    num_instances: torch.Tensor  # [] int32, total padded count (<= M)
    overflow: torch.Tensor       # [] bool
    # [N] depth-sorted ids (-1 culled); None from the sort binner
    order: Optional[torch.Tensor] = None


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Exclusive int32 prefix sum (exact; the reference's matmul prefix sum
    is exact below 2**24)."""
    return torch.cumsum(x, 0, dtype=torch.int32) - x


@torch.no_grad()
def bin_instances(prep: Preprocessed, *, width: int, height: int,
                  cfg: RasterConfig = RasterConfig()) -> BinnedInstances:
    """Every (Gaussian, touched tile) pair in a buffer of ``max_instances``,
    sorted by (tile, depth); ties keep duplication order (Gaussian-major,
    then y outer, x inner over the rect)."""
    tile = cfg.tile
    grid_x = (width + tile - 1) // tile
    grid_y = (height + tile - 1) // tile
    num_tiles = grid_x * grid_y
    m = cfg.max_instances
    dev = prep.valid.device
    i32 = torch.int32

    touched = prep.tiles_touched.to(i32)
    offsets = _exclusive_cumsum(touched)
    total = offsets[-1] + touched[-1]
    overflow = total > m
    total = torch.clamp(total, max=m)

    j = torch.arange(m, dtype=i32, device=dev)
    inst_valid = j < total
    # instance -> Gaussian: the last g with offsets[g] <= j
    gid = torch.searchsorted(offsets, j, right=True).to(i32) - 1
    gid = gid.clamp(0, prep.mean2d.shape[0] - 1)
    gl = gid.long()
    k = j - offsets[gl]

    # duplication order (rasterizer_impl.cu:70-111): y outer, x inner
    rmin, rmax = prep.rect_min[gl], prep.rect_max[gl]
    rect_w = torch.clamp(rmax[:, 0] - rmin[:, 0], min=1)
    tx = rmin[:, 0] + k % rect_w
    ty = rmin[:, 1] + k // rect_w
    tile_id = torch.where(inst_valid, ty * grid_x + tx,
                          torch.full_like(ty, num_tiles)).to(i32)
    depth_key = torch.where(inst_valid, prep.depth.detach()[gl].float(),
                            torch.full((m,), float("inf"), device=dev))

    # the two-key stable sort as two stable passes: by depth, then by tile
    _, by_depth = torch.sort(depth_key, stable=True)
    _, by_tile = torch.sort(tile_id[by_depth], stable=True)
    perm = by_depth[by_tile]
    tile_s, gid_s = tile_id[perm], gid[perm]

    tiles = torch.arange(num_tiles, dtype=i32, device=dev)
    tile_start = torch.searchsorted(tile_s, tiles).to(i32)
    tile_end = torch.searchsorted(tile_s, tiles, right=True).to(i32)
    return BinnedInstances(
        gaussian_id=gid_s, tile_id=tile_s, inst_valid=inst_valid,
        tile_start=tile_start, tile_end=tile_end, num_instances=total,
        overflow=overflow)


@torch.no_grad()
def pad_to_chunks(binned: BinnedInstances, *, chunk: int,
                  max_instances: int) -> PaddedInstances:
    """Re-lay the sorted instance list so that every tile's run starts at a
    multiple of ``chunk`` and is padded to one: slot q belongs to the last
    tile whose padded start is <= q (zero-count tiles are skipped by the
    right-sided search), at in-tile offset q - start; slots past the tile's
    true count are padding (id -1)."""
    dev = binned.gaussian_id.device
    counts = binned.tile_end - binned.tile_start
    padded_counts = (counts + chunk - 1) // chunk * chunk
    padded_starts = _exclusive_cumsum(padded_counts)
    total = padded_starts[-1] + padded_counts[-1]
    overflow = binned.overflow | (total > max_instances)
    total = torch.clamp(total, max=max_instances)

    q = torch.arange(max_instances, dtype=torch.int32, device=dev)
    tile = torch.searchsorted(padded_starts, q, right=True) - 1
    tile = tile.clamp(0, counts.shape[0] - 1)
    off = q - padded_starts[tile]
    valid = (q < total) & (off < counts[tile])
    src = (binned.tile_start[tile] + off).clamp(
        0, binned.gaussian_id.shape[0] - 1)
    gid = torch.where(valid, binned.gaussian_id[src.long()],
                      torch.full_like(q, -1))
    return PaddedInstances(
        gaussian_id=gid, inst_valid=valid,
        tile_start=padded_starts.to(torch.int32),
        tile_count=padded_counts.to(torch.int32),
        num_instances=total, overflow=overflow)


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
