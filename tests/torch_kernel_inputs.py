"""Synthetic inputs of kernels B1 (tile counts and carry table, also on grids
too wide for one block's shared memory), B2 (instance slots, at its edge
cases), B3/B4 (the blend, at its edge cases) and B7 (the env-map lookup),
made with numpy from a seed.

The CPU tests (``tests/test_torch_binning.py``,
``tests/test_torch_blend_edges.py``, ``tests/test_torch_env_lookup.py``)
hold the port's plain versions to the JAX kernels on them;
``chip_smoke.py`` builds the same arrays and holds the CUDA kernels to
their plain versions on the card.  This module imports numpy only, so the
smoke run can use it where JAX is not installed.
"""

from __future__ import annotations

import numpy as np

GAUSS_CHUNK = 256

# name -> (grid_x, grid_y, Gaussian chunks)
RECT_CASES = {
    "tile32_25x25": (25, 25, 3),    # the bench grid: 800x800 at tile 32
    "single_chunk": (25, 25, 1),
    "tile16_50x30": (50, 30, 4),    # 800x480 at tile 16: not square
}


def synthetic_rects(name: str, seed: int = 0):
    """Depth-sorted rects (x0, y0, x1, y1), each [nchunks * 256] int32 in
    tile units (half-open), and (grid_x, grid_y).

    Every chunk mixes, by a seeded draw per Gaussian: rects covering the
    whole grid; zero-area rects (x1 == x0 or y1 == y0); inverted rects
    (x1 < x0, y1 < y0); rects ending at x1 = grid_x and y1 = grid_y; rects
    reaching past the grid on every side; the all-zero rects of padding and
    invalid Gaussians; and small rects anywhere.  The last chunk ends in a
    run of padding, as the binner pads Ns to whole chunks."""
    gx, gy, nchunks = RECT_CASES[name]
    ns = nchunks * GAUSS_CHUNK
    rng = np.random.default_rng(seed)
    x0 = rng.integers(0, gx, ns)
    y0 = rng.integers(0, gy, ns)
    x1 = np.minimum(x0 + rng.integers(1, 6, ns), gx)
    y1 = np.minimum(y0 + rng.integers(1, 6, ns), gy)
    kind = rng.integers(0, 12, ns)
    full = kind == 0
    x0[full], y0[full], x1[full], y1[full] = 0, 0, gx, gy
    flat = kind == 1                                  # zero area
    x1[flat] = x0[flat]
    thin = kind == 2
    y1[thin] = y0[thin]
    inv = kind == 3                                   # inverted
    x0[inv], x1[inv] = x1[inv] + 1, x0[inv]
    y0[inv], y1[inv] = y1[inv] + 1, y0[inv]
    edge = kind == 4                                  # ends at the grid's end
    x1[edge], y1[edge] = gx, gy
    out = kind == 5                                   # reaches past the grid
    x0[out] -= 3
    y0[out] -= 2
    x1[out] += gx
    y1[out] += gy
    pad = kind == 6
    x0[pad] = y0[pad] = x1[pad] = y1[pad] = 0
    tail = ns - GAUSS_CHUNK // 3                      # padding at the end
    x0[tail:] = y0[tail:] = x1[tail:] = y1[tail:] = 0
    return tuple(a.astype(np.int32) for a in (x0, y0, x1, y1)), (gx, gy)


def wide_grid_rects(grid_x: int, grid_y: int, ns: int = 2 * GAUSS_CHUNK,
                    seed: int = 7):
    """Rects (x0, y0, x1, y1), each [ns] int32, over a tile grid too large
    for B1's difference array in one block's shared memory: four cover the
    whole grid, four reach past its right edge, the rest start anywhere
    (some before the grid) and span up to 40 tiles."""
    rng = np.random.default_rng(seed)
    x0 = rng.integers(-8, grid_x, ns)
    y0 = rng.integers(-8, grid_y, ns)
    x1 = x0 + rng.integers(0, 40, ns)
    y1 = y0 + rng.integers(0, 40, ns)
    x0[:4], y0[:4], x1[:4], y1[:4] = 0, 0, grid_x, grid_y
    x1[4:8] += grid_x
    return tuple(a.astype(np.int32) for a in (x0, y0, x1, y1))


# B2's edge cases, each built by ``instance_inputs``
INSTANCE_CASES = ("edges", "edges_overflow", "tile16_50x50", "wide_256x256",
                  "wide_60000x3")


def instances_from_rects(rects, grid_x: int, grid_y: int, *, seed: int = 0):
    """B2's inputs from depth-sorted rects [Ns] (Ns a multiple of 256),
    as the counting binner forms them: the rects clipped to the grid (an
    inverted one stays inverted: it covers no tile), each one's touched
    count max(dx, 0) * max(dy, 0), their exclusive offsets and total_raw,
    a seeded permutation as the original ids, and the table of carry
    snapshots plus the chunk-aligned tile starts (tiles padded to the
    blend's chunk of 128), with m = total_raw + 1,000 slots.  Returns a
    dict of int32 arrays (x0, y0, x1, y1, offsets, order, table) with
    total_raw, m, grid_x and grid_y."""
    x0, y0, x1, y1 = (np.asarray(a, np.int64) for a in rects)
    x0, x1 = np.clip(x0, 0, grid_x), np.clip(x1, 0, grid_x)
    y0, y1 = np.clip(y0, 0, grid_y), np.clip(y1, 0, grid_y)
    ns = x0.shape[0]
    touched = np.maximum(x1 - x0, 0) * np.maximum(y1 - y0, 0)
    offsets = np.cumsum(touched) - touched
    total_raw = int(touched.sum())
    nchunks, wd = ns // GAUSS_CHUNK, grid_x + 1
    # per-chunk tile counts by difference arrays, then the carry snapshots
    live = (x1 > x0) & (y1 > y0)
    plane = np.arange(ns) // GAUSS_CHUNK * (grid_y + 1) * wd
    diff = np.zeros(nchunks * (grid_y + 1) * wd, np.int64)
    for yy, xx, sign in ((y0, x0, 1), (y0, x1, -1), (y1, x0, -1),
                         (y1, x1, 1)):
        np.add.at(diff, (plane + yy * wd + xx)[live], sign)
    per = diff.reshape(nchunks, grid_y + 1, wd).cumsum(1).cumsum(2)
    per = per[:, :grid_y, :grid_x].reshape(nchunks, grid_x * grid_y)
    counts = per.sum(0)
    padded = -(-counts // 128) * 128
    table = np.cumsum(per, 0) - per + (np.cumsum(padded) - padded)[None]
    order = np.random.default_rng(seed).permutation(ns)
    i32 = lambda a: np.ascontiguousarray(a, np.int32)
    return dict(x0=i32(x0), y0=i32(y0), x1=i32(x1), y1=i32(y1),
                offsets=i32(offsets), order=i32(order), table=i32(table),
                total_raw=total_raw, m=total_raw + 1000, grid_x=grid_x,
                grid_y=grid_y)


def instance_inputs(name: str, seed: int = 0):
    """B2's inputs at its edge cases (``instances_from_rects``' dict).

    edges: the bench grid (25 x 25) and four chunks: small rects anywhere;
    256 rects that all cover tile (12, 7), from 1 x 1 up, so the tile's
    ranks run 0..255; only empty (zero-area) and inverted rects, whose
    offsets repeat; and a last chunk whose real rects end after 100 in
    padding, with m past total_raw.  edges_overflow: the same rects with m
    below total_raw (the binner's overflow).  tile16_50x50: 800x800 at tile
    16, three chunks of rects up to 8 tiles wide.  wide_256x256 and
    wide_60000x3: ``wide_grid_rects`` in reverse depth order (the four
    full-grid rects last, so their ranks count the earlier rects of their
    chunk), grids past a block's shared memory."""
    rng = np.random.default_rng(seed)
    if name.startswith("wide_"):
        gx, gy = (int(v) for v in name[5:].split("x"))
        rects = [a[::-1] for a in wide_grid_rects(gx, gy)]
        return instances_from_rects(rects, gx, gy, seed=seed)
    if name == "tile16_50x50":
        gx = gy = 50
        ns = 3 * GAUSS_CHUNK
        x0, y0 = rng.integers(0, gx, ns), rng.integers(0, gy, ns)
        x1 = x0 + rng.integers(1, 9, ns)
        y1 = y0 + rng.integers(1, 9, ns)
        return instances_from_rects((x0, y0, x1, y1), gx, gy, seed=seed)
    gx = gy = 25
    c = GAUSS_CHUNK
    x0, y0 = rng.integers(0, gx, 4 * c), rng.integers(0, gy, 4 * c)
    x1 = x0 + rng.integers(1, 5, 4 * c)
    y1 = y0 + rng.integers(1, 5, 4 * c)
    one = slice(c, 2 * c)                  # every rect covers tile (12, 7)
    x0[one] = 12 - rng.integers(0, 6, c)
    y0[one] = 7 - rng.integers(0, 6, c)
    x1[one] = 13 + rng.integers(0, 6, c)
    y1[one] = 8 + rng.integers(0, 6, c)
    x0[one][0], y0[one][0], x1[one][0], y1[one][0] = 12, 7, 13, 8
    empty = slice(2 * c, 3 * c)            # zero-area or inverted
    kind = rng.integers(0, 3, c)
    x1[empty] = np.where(kind == 0, x0[empty], x1[empty])
    y1[empty] = np.where(kind == 1, y0[empty], y1[empty])
    inv = kind == 2
    x0[empty][inv], x1[empty][inv] = x1[empty][inv] + 1, x0[empty][inv]
    x0[3 * c + 100:] = y0[3 * c + 100:] = 0      # padding ends the last chunk
    x1[3 * c + 100:] = y1[3 * c + 100:] = 0
    out = instances_from_rects((x0, y0, x1, y1), gx, gy, seed=seed)
    if name == "edges_overflow":
        out["m"] = out["total_raw"] - 777
    return out


def env_lookup_inputs(h: int, w: int, c: int = 3, m: int = 20_000,
                      seed: int = 0):
    """An env [h, w, c] in [0, 3), pixel coordinates u, v [m] and
    cotangents g [m, c], float32.

    The coordinates are uniform over [-1.5, size + 0.5], so some lie below
    0 and some past the last sample; the first 6k (k = min(40, m // 6))
    are exact edge cases: u = 0, u = w-1, v = 0, v = h-1, the two corners,
    integer grid points, and values just below 0 and just past the edge."""
    if m < 12:
        raise ValueError(f"m = {m}: the edge cases need at least 12 queries")
    rng = np.random.default_rng(seed)
    env = (3.0 * rng.random((h, w, c))).astype(np.float32)
    u = rng.uniform(-1.5, w + 0.5, m).astype(np.float32)
    v = rng.uniform(-1.5, h + 0.5, m).astype(np.float32)
    k = min(40, m // 6)
    u[:k], v[:k] = 0.0, rng.uniform(0, h - 1, k)              # left edge
    u[k:2 * k], v[k:2 * k] = w - 1, rng.uniform(0, h - 1, k)  # right edge
    u[2 * k:3 * k], v[2 * k:3 * k] = rng.uniform(0, w - 1, k), 0.0
    u[3 * k:4 * k], v[3 * k:4 * k] = rng.uniform(0, w - 1, k), h - 1
    u[4 * k], v[4 * k] = w - 1, h - 1                         # corners
    u[4 * k + 1], v[4 * k + 1] = 0.0, 0.0
    u[4 * k + 2:5 * k] = rng.integers(0, w, k - 2)            # on the grid
    v[4 * k + 2:5 * k] = rng.integers(0, h, k - 2)
    half = 5 * k + k // 2                                     # just outside
    u[5 * k:half], v[5 * k:half] = -0.25, h - 0.75
    u[half:6 * k], v[half:6 * k] = w - 0.75, -0.25
    g = rng.normal(size=(m, c)).astype(np.float32)
    return env, u, v, g


# name -> (CA, CV): the blend's exact-width variants (stage 1, the stage-2
# step, its eval render) and one generic width
BLEND_EDGE_CASES = {"stage1": (14, 0), "stage2": (13, 13), "eval": (16, 16),
                    "generic": (3, 4)}


def blend_near_clamp_inputs(*, tile: int = 16, chunk: int = 128,
                            seed: int = 0):
    """Blend inputs (``blend_edge_inputs``' layout and keys, the stage-1
    widths CA 14 / CV 0) whose unsaturated pixels take pairs with alpha
    just below the 0.99 clamp beside faint ones, where d log(1 - alpha) /
    d alpha nears -100: the regime in which a float32 log(1 - alpha)
    drifts past 1e-5 of exact at the recipe's size.

    Every tile holds one chunk of 128 rows in an order drawn from the
    seed: 96 faint wide splats (alpha up to 0.03) over it and 32
    near-opaque ones (opacity 0.992-1, so alpha clamps over their cores and
    runs through 0.95-0.99 around them), two over each 4 x 4 block of a
    tile 16, half of them thin and turned (conic xy^2 at 81-96% of
    xx yy, so the power's terms cancel)."""
    ca, cv = BLEND_EDGE_CASES["stage1"]
    kr = 12 + ca + 4 * cv
    gx, gy = 3, 2
    rng = np.random.default_rng(seed)
    n_t = gx * gy
    m = n_t * chunk
    slab = np.zeros((m, kr), np.float32)
    for t in range(n_t):
        ox, oy = (t % gx) * tile, (t // gx) * tile
        r = slab[t * chunk:(t + 1) * chunk]
        faint, near = chunk * 3 // 4, chunk // 4
        r[:, 0] = ox + rng.uniform(0, tile, chunk)
        r[:, 1] = oy + rng.uniform(0, tile, chunk)
        r[:faint, 2] = rng.uniform(0.002, 0.02, faint)
        r[:faint, 4] = rng.uniform(0.002, 0.02, faint)
        r[:faint, 3] = 0.0
        r[:faint, 5] = rng.uniform(0.005, 0.03, faint)
        b = np.arange(near)
        r[faint:, 0] = ox + (b % 4) * tile / 4 + tile / 8 + rng.uniform(
            -0.5, 0.5, near)
        r[faint:, 1] = oy + (b // 4 % 4) * tile / 4 + tile / 8 \
            + rng.uniform(-0.5, 0.5, near)
        cxx = rng.uniform(0.3, 1.5, near)
        cyy = rng.uniform(0.3, 1.5, near)
        cxy = rng.uniform(-0.5, 0.5, near) * np.sqrt(cxx * cyy)
        thin = b >= near // 2
        cxy[thin] = np.sign(cxy[thin] + 1e-9) * np.sqrt(
            cxx[thin] * cyy[thin]) * (1 - rng.uniform(0.02, 0.1, thin.sum()))
        r[faint:, 2], r[faint:, 3], r[faint:, 4] = cxx, cxy, cyy
        r[faint:, 5] = rng.uniform(0.992, 1.0, near)
        r[:, 6:10] = rng.normal(size=(chunk, 4))
        r[:, 10:12] = rng.uniform(1.0, 6.0, (chunk, 2))
        r[:, 12:] = rng.uniform(0.0, 1.0, (chunk, kr - 12))
        r[:] = r[rng.permutation(chunk)]
    img_shape = (ca + cv + 2, gy * tile, gx * tile)
    return dict(slab=slab,
                tile_start=np.arange(0, m, chunk).astype(np.int32),
                tile_count=np.full(n_t, chunk, np.int32),
                g_img=rng.normal(size=img_shape).astype(np.float32),
                g_wsum=rng.normal(size=m).astype(np.float32), ca=ca, cv=cv,
                grid_x=gx, grid_y=gy, tile=tile, chunk=chunk)


def blend_edge_inputs(name: str, *, tile: int = 16, chunk: int = 128,
                      seed: int = 0):
    """Inputs of the blend forward and backward at their edge cases: a dict
    of slab [M, 12+CA+4CV], tile_start / tile_count [6] int32 (a 3 x 2 tile
    grid), g_img [CA+CV+2, 2*tile, 3*tile] and g_wsum [M] float32, with
    ca, cv, grid_x, grid_y, tile and chunk.

    The tiles, in order: no chunk at all; three chunks, the first of which
    saturates every pixel (12 opaque splats over the tile, alpha clamped at
    0.99), so the tile exits after it; two chunks with padding rows (all
    zero) between real rows; one chunk of splats whose alpha clamps at
    0.99 over their cores; two chunks whose bilinear u and v run past their
    clamps at 0.001 and 0.999 (small extents, large Jinv) with some rows on
    u = v = 0.5 (zero Jinv); two chunks, the second all padding.  Rows past
    the last tile's range are padding too."""
    ca, cv = BLEND_EDGE_CASES[name]
    kr = 12 + ca + 4 * cv
    gx, gy = 3, 2
    nchunks = [0, 3, 2, 1, 2, 2]
    rng = np.random.default_rng(seed)
    counts = np.array(nchunks) * chunk
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    m = int(counts.sum()) + chunk // 2
    slab = np.zeros((m, kr), np.float32)
    for t, (s0, n) in enumerate(zip(starts, counts)):
        if n == 0:
            continue
        ox, oy = (t % gx) * tile, (t // gx) * tile
        r = slab[s0:s0 + n]
        r[:, 0] = ox + rng.uniform(-4, tile + 4, n)
        r[:, 1] = oy + rng.uniform(-4, tile + 4, n)
        cxx = rng.uniform(0.01, 0.3, n)
        cyy = rng.uniform(0.01, 0.3, n)
        r[:, 2], r[:, 4] = cxx, cyy
        r[:, 3] = rng.uniform(-0.5, 0.5, n) * np.sqrt(cxx * cyy)
        r[:, 5] = rng.uniform(0.05, 0.99, n)
        r[:, 6:10] = rng.normal(size=(n, 4))
        r[:, 10:12] = rng.uniform(1.0, 6.0, (n, 2))
        r[:, 12:] = rng.normal(size=(n, kr - 12))
        if t == 1:      # 12 rows of the first chunk saturate the tile
            c0 = r[rng.choice(chunk, 12, replace=False)]
            c0[:, 0] = ox + tile / 2 + rng.uniform(-1, 1, 12)
            c0[:, 1] = oy + tile / 2 + rng.uniform(-1, 1, 12)
            c0[:, 2] = c0[:, 4] = 1e-4
            c0[:, 3] = 0.0
            c0[:, 5] = rng.uniform(1.5, 3.0, 12)
            r[np.sort(rng.choice(chunk, 12, replace=False))] = c0
        elif t == 2:    # padding rows between real rows
            r[rng.random(n) < 0.3] = 0.0
        elif t == 3:    # cores clamped at alpha 0.99
            r[:, 5] = rng.uniform(1.0, 3.0, n)
        elif t == 4:    # u, v past their clamps; some on 0.5
            r[:, 6:10] *= 4.0
            r[:, 10:12] = rng.uniform(0.0, 0.2, (n, 2))
            r[rng.random(n) < 0.2, 6:10] = 0.0
        elif t == 5:    # the second chunk is all padding
            r[chunk:] = 0.0
    img_shape = (ca + cv + 2, gy * tile, gx * tile)
    return dict(slab=slab, tile_start=starts.astype(np.int32),
                tile_count=counts.astype(np.int32),
                g_img=rng.normal(size=img_shape).astype(np.float32),
                g_wsum=rng.normal(size=m).astype(np.float32), ca=ca, cv=cv,
                grid_x=gx, grid_y=gy, tile=tile, chunk=chunk)
