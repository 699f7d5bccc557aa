"""Blend kernels B3 (forward compositing) and B4 (per-instance gradients),
each with its plain PyTorch version.

Named after ``svgir_tpu/ops/blend_pallas_strip.py``, whose Pallas kernels
these replace.  On CUDA tensors the functions launch the hand-written
kernels (``csrc/blend_forward.cu``, ``csrc/blend_backward.cu``); on CPU
tensors they run the plain versions below.

Slab layout (``NG = 12`` geometry rows, then the channels), one row per
instance: x, y, conic (xx, xy, yy), opacity, j0..j3, lam_x, lam_y; then CA
plain channels; then 4*CV vertex channels, v-major (``vtx*CV + c``).  The
blend image is [CA+CV+2, grid_y*tile, grid_x*tile]: plain sums, vertex sums,
final logT, n_contrib.  ``eff`` [T] int32 counts the chunks each tile
processed before its early exit; ``wsum`` [M] holds each instance's weight
summed over its tile's pixels (padding pixels included, as in the
reference).

The plain versions follow ``blend_pallas._chunk_math`` and the strip
kernels chunk by chunk: all tiles of a group advance together, a tile stops
before the first chunk at which none of its pixels has logT >= log(1e-4),
and the final logT of saturated pixels therefore depends on the chunk size
exactly as in the kernels.
"""

from __future__ import annotations

import torch

from svgir_tpu_torch.kernels import blend as K
from svgir_tpu_torch.ops.common import (ALPHA_MAX, ALPHA_MIN, LOG_T_EPS, NG,
                                        on_cuda)

# With PyTorch 2.13 on an AVX-512 CPU, the first torch.exp of a process on a
# CPU tensor large enough to be split over threads can give one thread's
# share other values (in about one process in five: 1/8 of a 196,608-value
# tensor, up to 1,772 ulp off); every later call gives the same values.
# Such a difference moves the plain versions below (the CPU path, and the
# oracle of the tests) across the transmittance gate.  One call on a few
# values, made by this thread alone when the module loads, settles it
# before any split call of this module.
torch.exp(torch.zeros(8))


def _chunk_math(s, px, py):
    """Per-(tile, pixel, instance) quantities of one chunk.

    s: [G, C, KR] slab rows; px, py: [G, P, 1].  Returns a dict of
    [G, P, C] tensors.  Zero rows (padding) have opacity 0, so ok=False.
    """
    def row(i):
        return s[:, None, :, i]          # [G, 1, C]

    dx = row(0) - px
    dy = row(1) - py
    power = -0.5 * (row(2) * dx * dx + row(4) * dy * dy) - row(3) * dx * dy
    alpha = torch.clamp(row(5) * torch.exp(power), max=ALPHA_MAX)
    ok = (power <= 0.0) & (alpha >= ALPHA_MIN)
    loga = torch.where(ok, torch.log1p(-alpha), torch.zeros_like(alpha))
    du0 = dx * row(6) + dy * row(7)
    du1 = dx * row(8) + dy * row(9)
    uv_max_x = 0.5 * row(10) + 0.1
    uv_max_y = 0.5 * row(11) + 0.1
    u_raw = du0 / uv_max_x * 0.5 + 0.5
    v_raw = du1 / uv_max_y * 0.5 + 0.5
    return dict(dx=dx, dy=dy, power=power, alpha=alpha, ok=ok, loga=loga,
                du0=du0, du1=du1, u=u_raw.clamp(0.001, 0.999),
                v=v_raw.clamp(0.001, 0.999), u_raw=u_raw, v_raw=v_raw,
                uv_max_x=uv_max_x, uv_max_y=uv_max_y)


def _vertex_weights(m):
    u, v = m["u"], m["v"]
    return ((1 - u) * (1 - v), u * (1 - v), (1 - u) * v, u * v)


# warp patches (width, height in pixels) whose visits ``work`` counts: one
# tile row of 32 pixels, and the lane blocks of the CUDA kernels at 1, 2 and
# 4 pixels per thread (csrc/blend_common.cuh, svgir_pixel)
_PATCHES = ((32, 1), (8, 4), (8, 8), (16, 8))


def _running_sum(start, terms, reverse: bool = False):
    """[G, P, C+1] running sums of ``start`` [G, P] and ``terms`` [G, P, C]:
    entry k is start plus terms 0..k-1 (``reverse``: start plus terms
    k..C-1, so entry C is start and entry 0 adds them all).  One sequential
    scan with one rounding per entry, its order fixed by the data's order,
    not by how a library splits a reduction."""
    seq = torch.flip(terms, [-1]) if reverse else terms
    out = torch.cumsum(torch.cat([start[..., None], seq], -1), -1)
    return torch.flip(out, [-1]) if reverse else out


def _tile_groups(num_tiles: int, pix: int, chunk: int):
    """Tile ranges whose [G, P, chunk] temporaries stay near 2**24 floats."""
    g = max(1, (1 << 24) // (pix * chunk))
    return [range(a, min(a + g, num_tiles)) for a in range(0, num_tiles, g)]


def _pixel_coords(tiles, grid_x, tile, dev):
    t = torch.as_tensor(tiles, device=dev)
    p = torch.arange(tile * tile, device=dev)
    px = ((t % grid_x) * tile)[:, None] + (p % tile)[None]
    py = ((t // grid_x) * tile)[:, None] + (p // tile)[None]
    return px.float()[..., None], py.float()[..., None]       # [G, P, 1]


def _to_image(x, grid_x, grid_y, tile):
    """[C, T, P] per-tile pixels -> [C, grid_y*tile, grid_x*tile]."""
    c = x.shape[0]
    x = x.reshape(c, grid_y, grid_x, tile, tile).permute(0, 1, 3, 2, 4)
    return x.reshape(c, grid_y * tile, grid_x * tile)


def _from_image(x, grid_x, grid_y, tile):
    """[C, grid_y*tile, grid_x*tile] -> [C, T, P]."""
    c = x.shape[0]
    x = x.reshape(c, grid_y, tile, grid_x, tile).permute(0, 1, 3, 2, 4)
    return x.reshape(c, grid_x * grid_y, tile * tile)


def blend_forward_plain(slab, tile_start, tile_count, *, ca: int, cv: int,
                        grid_x: int, grid_y: int, tile: int, chunk: int,
                        emit_wsum: bool = True, work: dict | None = None):
    """Plain version of B3 (see the module docstring for the layout).

    ``work``, when given, receives the work these inputs need, counted over
    the chunks the tiles process: ``rows`` (real slab rows; padding rows are
    all zero), ``pairs`` ((pixel, real row) pairs, each needing the
    footprint test), ``ok`` (pairs that pass it and enter the logT chain),
    ``gated`` (ok pairs above the transmittance threshold, which blend),
    and, for each warp patch of ``_PATCHES`` that tiles the tile (keys
    "WxH"), ``warp_visits`` ((patch, real row) pairs with some pixel of the
    patch past the footprint test: the visits a kernel whose warps cover
    such patches cannot skip) out of ``warp_visit_total``.
    """
    dev = slab.device
    m = slab.shape[0]
    num_tiles, pix = grid_x * grid_y, tile * tile
    slab_ext = torch.cat([slab, slab.new_zeros(1, slab.shape[1])])
    wsum = slab.new_zeros(m + 1)                       # row m: dump
    acc = slab.new_zeros(ca + cv, num_tiles, pix)
    meta = slab.new_zeros(2, num_tiles, pix)           # logT, n_contrib
    eff = torch.zeros(num_tiles, dtype=torch.int32, device=dev)
    nch = (tile_count // chunk).long()
    lane = torch.arange(chunk, device=dev)
    patches = [(pw, ph) for pw, ph in _PATCHES
               if tile % pw == 0 and tile % ph == 0]
    counts = torch.zeros(3 + len(patches), dtype=torch.int64,
                         device=dev)                   # see ``work``
    for tiles in _tile_groups(num_tiles, pix, chunk):
        ts = slice(tiles.start, tiles.stop)
        px, py = _pixel_coords(tiles, grid_x, tile, dev)
        logT = slab.new_zeros(len(tiles), pix)
        nc = slab.new_zeros(len(tiles), pix)
        for c in range(int(nch[ts].max()) if len(tiles) else 0):
            active = (c < nch[ts]) & (logT.amax(1) >= LOG_T_EPS)
            rows = torch.where(active[:, None],
                               tile_start[ts, None].long() + c * chunk + lane,
                               m)                                   # [G, C]
            s = slab_ext[rows]                                      # [G, C, KR]
            mth = _chunk_math(s, px, py)
            loga = mth["loga"]
            # logT before each instance and, last, after the chunk: one
            # running sum from the carried logT, so the gate and the carry
            # come from the same additions, in instance order
            chain = _running_sum(logT, loga)
            logT_excl = chain[..., :-1]
            gate = mth["ok"] & (logT_excl >= LOG_T_EPS)
            w = torch.where(gate, mth["alpha"] * torch.exp(logT_excl),
                            torch.zeros_like(logT_excl))            # [G, P, C]
            acc[:ca, ts] += torch.einsum("gpc,gck->kgp", w,
                                         s[:, :, NG:NG + ca])
            if cv:
                va = s[:, :, NG + ca:NG + ca + 4 * cv].reshape(
                    len(tiles), chunk, 4, cv)
                wv = _vertex_weights(mth)
                for vtx in range(4):
                    acc[ca:, ts] += torch.einsum("gpc,gck->kgp", w * wv[vtx],
                                                 va[:, :, vtx])
            if emit_wsum:
                wsum[rows.reshape(-1)] = w.sum(1).reshape(-1)
            if work is not None:
                counts[0] += (s != 0).any(-1).sum()
                counts[1] += mth["ok"].sum()
                counts[2] += gate.sum()
                for i, (pw, ph) in enumerate(patches):
                    hit = mth["ok"].reshape(len(tiles), tile // ph, ph,
                                            tile // pw, pw, chunk)
                    counts[3 + i] += hit.any(4).any(2).sum()
            logT = chain[..., -1]
            nc = nc + gate.sum(-1)
            eff[ts] += active.to(torch.int32)
        meta[0, ts], meta[1, ts] = logT, nc
    if work is not None:
        real, ok, gated = (int(x) for x in counts[:3])
        work.update(rows=real, pairs=real * pix, ok=ok, gated=gated)
        names = [f"{pw}x{ph}" for pw, ph in patches]
        work["warp_visits"] = dict(zip(names, counts[3:].tolist()))
        work["warp_visit_total"] = {
            n: real * pix // (pw * ph) for n, (pw, ph) in zip(names, patches)}
    img = _to_image(torch.cat([acc, meta]), grid_x, grid_y, tile)
    return img, eff, (wsum[:m] if emit_wsum else None)


def blend_backward_plain(slab, tile_start, eff, g_img, logt_img, g_wsum, *,
                         ca: int, cv: int, grid_x: int, grid_y: int,
                         tile: int, chunk: int):
    """Plain version of B4: per-instance gradient rows d_slab [M, KR]."""
    dev = slab.device
    m, kr = slab.shape
    num_tiles, pix = grid_x * grid_y, tile * tile
    slab_ext = torch.cat([slab, slab.new_zeros(1, kr)])
    gw_ext = None if g_wsum is None else torch.cat([g_wsum,
                                                    g_wsum.new_zeros(1)])
    d_ext = slab.new_zeros(m + 1, kr)                   # row m: dump
    g_t = _from_image(g_img[:ca + cv + 1], grid_x, grid_y, tile)   # [C, T, P]
    logt_t = _from_image(logt_img[None], grid_x, grid_y, tile)[0]  # [T, P]
    eff_l = eff.long()
    lane = torch.arange(chunk, device=dev)
    for tiles in _tile_groups(num_tiles, pix, chunk):
        ts = slice(tiles.start, tiles.stop)
        px, py = _pixel_coords(tiles, grid_x, tile, dev)
        g_plain = g_t[:ca, ts]                          # [CA, G, P]
        g_vf = g_t[ca:ca + cv, ts]
        logT = logt_t[ts].clone()                       # logT after chunk c
        suf = g_t[ca + cv, ts].clone()                  # g_logT + later terms
        for c in reversed(range(int(eff_l[ts].max()) if len(tiles) else 0)):
            active = c < eff_l[ts]
            rows = torch.where(active[:, None],
                               tile_start[ts, None].long() + c * chunk + lane,
                               m)
            s = slab_ext[rows]                          # [G, C, KR]
            mth = _chunk_math(s, px, py)
            loga, alpha, ok = mth["loga"], mth["alpha"], mth["ok"]
            # the forward's chain run backwards from the chunk's final logT:
            # entry i is logT before instance i (entry 0: before the chunk)
            chain = _running_sum(logT, -loga, reverse=True)
            logT_excl = chain[..., :-1]
            gate = ok & (logT_excl >= LOG_T_EPS)
            expT = torch.exp(logT_excl)
            zero = torch.zeros_like(expT)
            w = torch.where(gate, alpha * expT, zero)

            dw = torch.einsum("kgp,gck->gpc", g_plain, s[:, :, NG:NG + ca])
            if gw_ext is not None:
                dw = dw + gw_ext[rows][:, None, :]
            d_du0 = d_du1 = zero
            d_lamx = d_lamy = s.new_zeros(len(tiles), chunk)
            if cv:
                va = s[:, :, NG + ca:NG + ca + 4 * cv].reshape(
                    len(tiles), chunk, 4, cv)
                mv = [torch.einsum("kgp,gck->gpc", g_vf, va[:, :, vtx])
                      for vtx in range(4)]
                wv = _vertex_weights(mth)
                u, v = mth["u"], mth["v"]
                dw = dw + sum(wv[k] * mv[k] for k in range(4))
                d_u = w * ((1 - v) * (mv[1] - mv[0]) + v * (mv[3] - mv[2]))
                d_v = w * ((1 - u) * (mv[2] - mv[0]) + u * (mv[3] - mv[1]))
                d_u = d_u * ((mth["u_raw"] > 0.001)
                             & (mth["u_raw"] < 0.999)).float()
                d_v = d_v * ((mth["v_raw"] > 0.001)
                             & (mth["v_raw"] < 0.999)).float()
                d_du0 = d_u * 0.5 / mth["uv_max_x"]
                d_du1 = d_v * 0.5 / mth["uv_max_y"]
                d_lamx = 0.5 * (d_u * (-mth["du0"] / (mth["uv_max_x"] ** 2))
                                 * 0.5).sum(1)
                d_lamy = 0.5 * (d_v * (-mth["du1"] / (mth["uv_max_y"] ** 2))
                                * 0.5).sum(1)

            s_term = dw * w
            # entry i + 1: g_logT plus the terms of the instances after i
            # (entry 0, all of them: the carry)
            suffix = _running_sum(suf, s_term, reverse=True)
            d_loga = suffix[..., 1:]
            not_clamped = (alpha < ALPHA_MAX).float()
            d_alpha = torch.where(gate, dw * expT, zero) \
                + d_loga * (-1.0 / (1.0 - alpha)) * ok.float()
            d_power = d_alpha * alpha * not_clamped
            dx, dy = mth["dx"], mth["dy"]

            def r(i):
                return s[:, None, :, i]

            cols = [
                (d_power * (-r(2) * dx - r(3) * dy) + d_du0 * r(6)
                 + d_du1 * r(8)).sum(1),
                (d_power * (-r(4) * dy - r(3) * dx) + d_du0 * r(7)
                 + d_du1 * r(9)).sum(1),
                (d_power * (-0.5 * dx * dx)).sum(1),
                (d_power * (-dx * dy)).sum(1),
                (d_power * (-0.5 * dy * dy)).sum(1),
                (d_alpha * torch.exp(mth["power"]) * not_clamped).sum(1),
                (d_du0 * dx).sum(1), (d_du0 * dy).sum(1),
                (d_du1 * dx).sum(1), (d_du1 * dy).sum(1),
                d_lamx, d_lamy,
            ]
            rows_out = [torch.stack(cols, -1),                     # [G, C, 12]
                        torch.einsum("kgp,gpc->gck", g_plain, w)]
            if cv:
                rows_out.append(torch.cat(
                    [torch.einsum("kgp,gpc->gck", g_vf, w * wv[vtx])
                     for vtx in range(4)], -1))
            d_ext[rows.reshape(-1)] = torch.cat(rows_out, -1).reshape(-1, kr)

            logT = chain[..., 0]
            suf = suffix[..., 0]
    return d_ext[:m]


def blend_forward(slab, tile_start, tile_count, *, ca: int, cv: int,
                  grid_x: int, grid_y: int, tile: int, chunk: int,
                  emit_wsum: bool = True):
    """Forward blend (B3): (img [CA+CV+2, grid_y*tile, grid_x*tile],
    eff [T] int32, wsum [M] or None)."""
    kw = dict(ca=ca, cv=cv, grid_x=grid_x, grid_y=grid_y, tile=tile,
              chunk=chunk, emit_wsum=emit_wsum)
    if on_cuda(slab):
        return K.blend_forward(slab, tile_start, tile_count, **kw)
    return blend_forward_plain(slab, tile_start, tile_count, **kw)


def blend_backward(slab, tile_start, eff, g_img, logt_img, g_wsum, *,
                   ca: int, cv: int, grid_x: int, grid_y: int, tile: int,
                   chunk: int):
    """Backward blend (B4): d_slab [M, KR]; rows of skipped chunks and of
    padding are zero."""
    kw = dict(ca=ca, cv=cv, grid_x=grid_x, grid_y=grid_y, tile=tile,
              chunk=chunk)
    if on_cuda(slab):
        return K.blend_backward(slab, tile_start, eff, g_img, logt_img,
                                g_wsum, **kw)
    return blend_backward_plain(slab, tile_start, eff, g_img, logt_img,
                                g_wsum, **kw)
