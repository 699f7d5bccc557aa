"""Tile-major blend kernels B5 (forward compositing) and B6 (per-instance
gradients), and the column copies B9, each with its plain PyTorch version.

Named after ``svgir_tpu/ops/blend_pallas.py``, whose Pallas kernels these
replace.  On CUDA tensors the functions launch the hand-written kernels
(``csrc/blend_forward.cu``, ``csrc/blend_backward.cu``, ``csrc/cols.cu``);
on CPU tensors they run the plain versions below.

B5/B6 compute what B3/B4 (``ops/blend_pallas_strip.py``) compute, with the
same slab layout; only the layout of the per-pixel channels differs.  The
blend output is tile-major, ``out [T, CA+CV+3, tile**2]``: plain sums,
vertex sums, final logT, n_contrib and the chunks the tile processed before
its early exit (as a float, broadcast over the tile's pixels).  The backward
takes tile-major cotangents ``g_out`` of the same shape and the forward's
``meta = out[:, CA+CV:]`` (logT, n_contrib, chunks processed), from which it
reads the chunks to sweep.  The weight sums ``wsum`` are per instance
([M]); ``wsum_slot``/``wsum_to_instances``/``wsum_from_instances`` convert
to and from the reference's slot layout, where each chunk of fewer than
128 instances owns 128 lanes.

The plain versions re-lay the data and run the strip module's plain
versions: they are test oracles, not a second copy of the chunk math.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from svgir_tpu_torch.kernels import blend as K
from svgir_tpu_torch.kernels import cols as KC
from svgir_tpu_torch.ops import blend_pallas_strip as strip
from svgir_tpu_torch.ops.common import on_cuda


def wsum_slot(chunk: int) -> int:
    """Lanes per chunk in the reference's wsum/g_wsum layout."""
    return max(chunk, 128)


def wsum_to_instances(wsum: torch.Tensor, m: int, chunk: int) -> torch.Tensor:
    """[1, (m//chunk)*slot] slot layout -> [1, m] per instance."""
    slot = wsum_slot(chunk)
    if slot == chunk:
        return wsum
    return wsum.reshape(m // chunk, slot)[:, :chunk].reshape(1, m)


def wsum_from_instances(g: torch.Tensor, chunk: int) -> torch.Tensor:
    """[1, m] per instance -> [1, (m//chunk)*slot] slot layout (zero pad)."""
    slot = wsum_slot(chunk)
    if slot == chunk:
        return g
    m = g.shape[1]
    return F.pad(g.reshape(m // chunk, chunk), (0, slot - chunk)).reshape(
        1, (m // chunk) * slot)


def to_tiles(img: torch.Tensor, grid_x: int, grid_y: int, tile: int):
    """[C, grid_y*tile, grid_x*tile] image -> [T, C, tile**2] tile-major."""
    return strip._from_image(img, grid_x, grid_y, tile).transpose(0, 1)


def to_image(out: torch.Tensor, grid_x: int, grid_y: int, tile: int):
    """[T, C, tile**2] tile-major -> [C, grid_y*tile, grid_x*tile] (the
    rasterizer's assembly transpose)."""
    return strip._to_image(out.transpose(0, 1), grid_x, grid_y, tile)


def blend_forward_plain(slab, tile_start, tile_count, *, ca: int, cv: int,
                        grid_x: int, grid_y: int, tile: int, chunk: int,
                        emit_wsum: bool = True):
    """Plain version of B5: B3's plain version, re-laid tile-major, with the
    chunks processed as row CA+CV+2."""
    img, eff, wsum = strip.blend_forward_plain(
        slab, tile_start, tile_count, ca=ca, cv=cv, grid_x=grid_x,
        grid_y=grid_y, tile=tile, chunk=chunk, emit_wsum=emit_wsum)
    out = to_tiles(img, grid_x, grid_y, tile)
    chunks = eff.to(out.dtype)[:, None, None].expand(-1, 1, tile * tile)
    return torch.cat([out, chunks], 1), wsum


def blend_backward_plain(slab, tile_start, g_out, meta, g_wsum, *, ca: int,
                         cv: int, grid_x: int, grid_y: int, tile: int,
                         chunk: int):
    """Plain version of B6: B4's plain version on the cotangents and the
    forward's logT re-laid as images; the chunks to sweep come from
    ``meta[:, 2, 0]``, as in the reference."""
    eff = meta[:, 2, 0].to(torch.int32)
    g_img = to_image(g_out[:, :ca + cv + 1], grid_x, grid_y, tile)
    logt_img = to_image(meta[:, :1], grid_x, grid_y, tile)[0]
    return strip.blend_backward_plain(
        slab, tile_start, eff, g_img, logt_img, g_wsum, ca=ca, cv=cv,
        grid_x=grid_x, grid_y=grid_y, tile=tile, chunk=chunk)


def blend_forward(slab, tile_start, tile_count, *, ca: int, cv: int,
                  grid_x: int, grid_y: int, tile: int, chunk: int,
                  emit_wsum: bool = True):
    """Forward blend (B5): (out [T, CA+CV+3, tile**2], wsum [M] or None);
    wsum is zero on the rows of chunks the early exit skipped."""
    kw = dict(ca=ca, cv=cv, grid_x=grid_x, grid_y=grid_y, tile=tile,
              chunk=chunk, emit_wsum=emit_wsum)
    if on_cuda(slab):
        return K.blend_forward_tiles(slab, tile_start, tile_count, **kw)
    return blend_forward_plain(slab, tile_start, tile_count, **kw)


def blend_backward(slab, tile_start, g_out, meta, g_wsum, *, ca: int,
                   cv: int, grid_x: int, grid_y: int, tile: int, chunk: int):
    """Backward blend (B6): d_slab [M, KR]; rows of skipped chunks and of
    padding are zero.  Unlike the reference it takes no ``tile_count``:
    the chunks to sweep come from ``meta`` and the wrapper zero-fills."""
    kw = dict(ca=ca, cv=cv, grid_x=grid_x, grid_y=grid_y, tile=tile,
              chunk=chunk)
    if on_cuda(slab):
        return K.blend_backward_tiles(slab, tile_start, g_out, meta, g_wsum,
                                      **kw)
    return blend_backward_plain(slab, tile_start, g_out, meta, g_wsum, **kw)


def pad_cols_plain(x: torch.Tensor, kout: int) -> torch.Tensor:
    """Plain version of B9's pad: [M, kin] -> [M, kout] zero-padded."""
    return F.pad(x, (0, kout - x.shape[1]))


def slice_cols_plain(x: torch.Tensor, kout: int) -> torch.Tensor:
    """Plain version of B9's slice: [M, kin] -> [M, kout]."""
    return x[:, :kout].contiguous()


def _cols(name, x, kout, block, kernel, plain):
    """B9's contract, as the reference's: ``kin == kout`` returns ``x``;
    else M must be a multiple of ``block``."""
    m, kin = x.shape
    if (kin > kout) if name == "pad_cols" else (kout > kin):
        raise ValueError(f"{name}: kin={kin}, kout={kout}")
    if kin == kout:
        return x
    if m % block:
        raise ValueError(f"{name}: M={m} is not a multiple of block={block}")
    if on_cuda(x):
        return kernel(x, kout, block=block)
    return plain(x, kout)


def pad_cols(x: torch.Tensor, kout: int, *, block: int = 1024):
    """[M, kin] -> [M, kout] zero-padded (kin <= kout, M % block == 0);
    ``kin == kout`` returns ``x``."""
    return _cols("pad_cols", x, kout, block, KC.pad_cols, pad_cols_plain)


def slice_cols(x: torch.Tensor, kout: int, *, block: int = 1024):
    """[M, kin] -> [M, kout] column slice (kout <= kin, M % block == 0);
    ``kin == kout`` returns ``x``."""
    return _cols("slice_cols", x, kout, block, KC.slice_cols,
                 slice_cols_plain)
