"""Per-tile counts with per-chunk carry snapshots, and the instance slots,
in plain PyTorch: the semantics of ``svgir_tpu/ops/binning_pallas.py``.
"""

from __future__ import annotations

import torch



def counts_plain(x0, y0, x1, y1, *, grid_x: int, grid_y: int,
                 gauss_chunk: int = 256):
    """Plain version of B1: (counts [T] int32, carry [Ns/gauss_chunk, T]
    int32) with carry[c, t] = instances tile t gets from chunks before c."""
    num_tiles = grid_x * grid_y
    nchunks = x0.shape[0] // gauss_chunk
    t = torch.arange(num_tiles, device=x0.device)
    tx, ty = t % grid_x, t // grid_x
    per_chunk = torch.empty(nchunks, num_tiles, dtype=torch.int64,
                            device=x0.device)
    step = max(1, (1 << 22) // max(gauss_chunk * num_tiles, 1))
    for c0 in range(0, nchunks, step):
        sl = slice(c0 * gauss_chunk, min(c0 + step, nchunks) * gauss_chunk)
        cov = ((tx >= x0[sl, None]) & (tx < x1[sl, None])
               & (ty >= y0[sl, None]) & (ty < y1[sl, None]))
        per_chunk[c0:c0 + step] = cov.reshape(-1, gauss_chunk,
                                              num_tiles).sum(1)
    carry = torch.cumsum(per_chunk, 0) - per_chunk
    return per_chunk.sum(0).to(torch.int32), carry.to(torch.int32)


def compute_counts(x0, y0, x1, y1, *, grid_x: int, grid_y: int, chunk: int,
                   gauss_chunk: int = 256):
    """Depth-ordered rects [Ns] int32 -> (tile_start [T] chunk-aligned,
    padded_counts [T], total padded, carry [Ns/gauss_chunk, T]), as
    ``svgir_tpu.ops.binning_pallas.compute_counts`` (carry unpadded)."""
    counts, carry = counts_plain(x0, y0, x1, y1, grid_x=grid_x,
                                 grid_y=grid_y, gauss_chunk=gauss_chunk)
    padded_counts = (counts + chunk - 1) // chunk * chunk
    tile_start = torch.cumsum(padded_counts, 0,
                              dtype=torch.int32) - padded_counts
    total = tile_start[-1] + padded_counts[-1]
    return tile_start, padded_counts, total, carry


def instances_plain(x0, y0, x1, y1, offsets, order, table, total_raw, *,
                    m: int, grid_x: int, gauss_chunk: int = 256):
    """Plain version of B2: per-instance (slot [m], gid [m]) int32.

    For instance j < total_raw of the Gaussian-major enumeration: its
    Gaussian g is the last with offsets[g] <= j, its tile the (j -
    offsets[g])-th cell of g's rect (y outer, x inner), and its slot
    table[chunk(g), tile] + the number of earlier Gaussians of g's chunk
    whose rect covers the tile.  Instances past total_raw get slot m and
    gid -1.
    """
    dev = x0.device
    ns = x0.shape[0]
    num_tiles = table.shape[1]
    j = torch.arange(m, dtype=torch.int64, device=dev)
    live = j < total_raw
    g = torch.searchsorted(offsets.to(torch.int64), j, right=True) - 1
    g = g.clamp(0, ns - 1)
    k = j - offsets[g]
    w = torch.clamp(x1[g] - x0[g], min=1)
    qy = torch.div(k, w, rounding_mode="floor")
    tx = x0[g] + k - qy * w
    ty = y0[g] + qy
    tid = torch.where(live, ty * grid_x + tx, 0).clamp(0, num_tiles - 1)
    cidx = torch.div(g, gauss_chunk, rounding_mode="floor")

    rank = torch.empty(m, dtype=torch.int64, device=dev)
    win = torch.arange(gauss_chunk, device=dev)
    step = max(1, (1 << 22) // gauss_chunk)
    for b0 in range(0, m, step):
        sl = slice(b0, b0 + step)
        h = cidx[sl, None] * gauss_chunk + win[None]          # [B, gc]
        cover = ((x0[h] <= tx[sl, None]) & (tx[sl, None] < x1[h])
                 & (y0[h] <= ty[sl, None]) & (ty[sl, None] < y1[h])
                 & (h < g[sl, None]))
        rank[sl] = cover.sum(1)
    slot = torch.where(live, table[cidx, tid] + rank, m)
    gid = torch.where(live, order[g], -1)
    return slot.to(torch.int32), gid.to(torch.int32)


def compute_instances(x0, y0, x1, y1, offsets, order, table, total_raw, *,
                      m: int, grid_x: int, gauss_chunk: int = 256):
    """Compact instance expansion with depth-rank slots (B2).

    x0..y1/order: depth-sorted rects and original ids [Ns] int32; offsets:
    exclusive prefix sum of the touched counts [Ns]; table
    [Ns/gauss_chunk, T] int32: carry snapshots plus chunk-aligned tile
    starts; total_raw: [] int32 instance count.  Returns (slot, gid), each
    [m] int32.
    """
    return instances_plain(x0, y0, x1, y1, offsets, order, table, total_raw,
                           m=m, grid_x=grid_x, gauss_chunk=gauss_chunk)
