"""Synthetic inputs of kernels B1 (tile counts and carry table, also on grids
too wide for one block's shared memory), B2 (instance slots, at its edge
cases), B3/B4 (the blend, at its edge cases), B7 (the env-map lookup) and
R1 (the per-Gaussian row sums over the binner's instance lists), made with
numpy from a seed; and of the preprocess (P1) and the training shading
(C2), made with torch from a seed, on random rows and on rows built to
meet their edges.

The CPU tests (``tests/test_torch_binning.py``,
``tests/test_torch_blend_edges.py``, ``tests/test_torch_env_lookup.py``,
``tests/test_torch_preprocess.py``, ``tests/test_torch_svgss.py``) hold
the port's plain versions to ``svgir_tpu`` on them; ``chip_smoke.py`` and
the ``card`` tests build the same inputs and hold the CUDA kernels to
their plain versions on the card.  This module imports numpy, torch and
``svgir_tpu_torch``, never JAX, so the smoke run can use it where JAX is
not installed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from svgir_tpu_torch.cameras import look_at_camera
from svgir_tpu_torch.config import RasterConfig
from svgir_tpu_torch.ops import preprocess as P
from svgir_tpu_torch.utils import sh as sh_utils
from svgir_tpu_torch.utils.transforms import normal_to_rotation, normalize

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


# ---------------------------------------------------------------------------
# the preprocess (P1): float64 rows, 256 random or one per edge
# ---------------------------------------------------------------------------

PREP_N = 256
PREP_W, PREP_H = 64, 48
PREP_EDGE_ROWS = ("behind", "outside", "view_cos", "grazing", "tz0",
                  "tx_past", "ty_past", "rgb_clamp", "zero_cot_a",
                  "zero_cot_b", "plain")

# (name, cfg, colour source, SH degree, active SH degree, scale_modifier,
#  fields whose cotangent is None): every branch P1's templates take
PREP_CASES = [
    ("sh3", {}, "sh", 3, None, 1.0, ()),
    ("sh3_active1_half_scale", {}, "sh", 3, 1.0, 0.5, ()),
    ("sh2_active0", {}, "sh", 2, 0.0, 1.0, ()),
    ("sh1_active_none", {}, "sh", 1, -1.0, 1.0, ()),
    ("sh0", {}, "sh", 0, None, 0.5, ()),
    ("sh4_active2", {}, "sh", 4, 2.5, 1.0, ()),
    ("colors", {}, "colors", 3, None, 1.0, ()),
    ("no_colour", {}, "none", 3, None, 1.0, ("rgb",)),
    ("no_surface", dict(surface=False), "sh", 3, None, 1.0, ()),
    ("no_surface_half_scale", dict(surface=False), "sh", 2, None, 0.5, ()),
    ("no_per_pixel_depth", dict(per_pixel_depth=False), "sh", 3, 2.0, 1.0,
     ()),
    ("none_cotangents", {}, "sh", 3, None, 1.0,
     ("view_cos", "normal_view", "depth")),
]
PREP_CASE_IDS = [c[0] for c in PREP_CASES]


def prep_camera(edges: bool):
    """A rotated camera for the random rows; for the edge rows one on the
    z axis, whose p_view is exact (p_view = m + (0, 0, 3), W = I)."""
    eye = [0.0, 0.0, -3.0] if edges else [0.5, 0.4, -2.6]
    return look_at_camera(eye=eye, target=[0, 0, 0], up=[0, -1, 0],
                          fovx=math.pi / 3, fovy=math.pi / 3, width=PREP_W,
                          height=PREP_H, device="cpu")


def _unit(v):
    return v / v.norm()


def prep_edge_geometry():
    """(means, quats) of the edge rows under the axis camera: behind the
    camera, outside the 1.2x frustum, view_cos at -0.01, a grazing ray at
    the 0.01 threshold, p_view z exactly 0, x and y past 1.3 tan(fov / 2),
    and rows that meet nothing (the rgb clamp is met by their SH)."""
    f64 = torch.float64
    t = torch.tensor([0.0, 0.0, 3.0], dtype=f64)
    pv = {"behind": [0.1, 0.1, -0.5], "outside": [4.0, 0.0, 3.0],
          "view_cos": [0.1, 0.05, 3.0], "grazing": [0.2, -0.1, 2.5],
          "tz0": [0.3, 0.2, 0.0], "tx_past": [2.0, 0.1, 1.0],
          "ty_past": [0.1, -2.0, 1.0], "rgb_clamp": [0.05, 0.0, 2.0],
          "zero_cot_a": [0.0, 0.1, 2.5], "zero_cot_b": [-0.1, 0.0, 2.8],
          "plain": [0.05, 0.02, 3.0]}
    means, quats = [], []
    for name in PREP_EDGE_ROWS:
        p = torch.tensor(pv[name], dtype=f64)
        if name == "view_cos":
            # n . p = -0.01
            u = _unit(torch.linalg.cross(p, torch.tensor([0.0, 1, 0],
                                                         dtype=f64)))
            a = -0.01 / float(p @ p)
            n = a * p + math.sqrt(1 - a * a * float(p @ p)) * u
        elif name == "grazing":
            # |(dir0 . n) / mod0| = 0.01 for the ray offset in x
            d0 = torch.tensor([p[0] / p[2] + 1e-3, p[1] / p[2], 1.0],
                              dtype=f64)
            mod0 = float(d0.norm())
            dir0 = d0 / mod0
            u = _unit(torch.linalg.cross(dir0, torch.tensor([0.0, 1, 0],
                                                            dtype=f64)))
            n = -0.01 * mod0 * dir0 + math.sqrt(1 - (0.01 * mod0) ** 2) * u
        else:
            n = _unit(torch.tensor([0.1, -0.2, -1.0], dtype=f64))
        means.append(p - t)
        # a w-first quaternion whose rotation's third column is n (the
        # axis camera's rotation is the identity)
        quats.append(normal_to_rotation(n[None])[0] * 1.7)
    return torch.stack(means), torch.stack(quats)


def _dc_at(value: float) -> float:
    """A DC coefficient c with fl(c * C0) == value, in float64."""
    c = value / sh_utils.C0
    for _ in range(64):
        got = c * sh_utils.C0
        if got == value:
            return c
        c = math.nextafter(c, math.inf if got < value else -math.inf)
    raise AssertionError("no DC coefficient meets the value")


def prep_rows(edges: bool, degree: int, seed: int = 0):
    """(means, scales, quats, shs [N, K, 3] at K = (degree + 1)^2, colors)
    in float64.  On the edge rows the ``rgb_clamp`` row's red channel sits
    exactly on the clamp at 0 and its green one below it."""
    f64 = torch.float64
    g = torch.Generator().manual_seed(seed)
    k = (degree + 1) ** 2
    if edges:
        means, quats = prep_edge_geometry()
        n = means.shape[0]
    else:
        n = PREP_N
        d = torch.randn(n, 3, generator=g, dtype=f64)
        means = d / d.norm(dim=-1, keepdim=True) \
            * (0.6 + 0.6 * torch.rand(n, 1, generator=g, dtype=f64))
        quats = torch.randn(n, 4, generator=g, dtype=f64)
    scales = torch.exp(-3 + 0.6 * torch.randn(n, 3, generator=g, dtype=f64))
    shs = 0.3 * torch.randn(n, k, 3, generator=g, dtype=f64)
    colors = torch.rand(n, 3, generator=g, dtype=f64)
    if edges:
        r = PREP_EDGE_ROWS.index("rgb_clamp")
        shs[r] = 0
        shs[r, 0] = torch.tensor([_dc_at(-0.5), -0.7 / sh_utils.C0,
                                  0.4 / sh_utils.C0], dtype=f64)
    return means, scales, quats, shs, colors


def prep_cotangents(out, edges: bool, seed: int = 1, none=()):
    """Random cotangents of ``P.FLOAT_FIELDS`` of ``out``, zero on the
    zero_cot rows (and on the first rows of the random set); None for the
    fields in ``none``.  Returns (cotangents, the zero rows)."""
    g = torch.Generator().manual_seed(seed)
    zero = [PREP_EDGE_ROWS.index("zero_cot_a"),
            PREP_EDGE_ROWS.index("zero_cot_b")] if edges else [0, 1, 2]
    cots = []
    for f in P.FLOAT_FIELDS:
        if f in none:
            cots.append(None)
            continue
        x = getattr(out, f)
        c = torch.randn(x.shape, generator=g, dtype=x.dtype)
        c[zero] = 0
        cots.append(c)
    return cots, zero


def prep_kw(cam, case):
    """``preprocess``'s keyword arguments for a camera and a PREP_CASES
    entry (the colour source apart)."""
    _, cfg, _, degree, active, mod, _ = case
    return dict(width=cam.width, height=cam.height, tanfovx=cam.tanfovx,
                tanfovy=cam.tanfovy, focal_x=cam.focal_x, focal_y=cam.focal_y,
                sh_degree=degree, active_sh_degree=active,
                scale_modifier=mod, cfg=RasterConfig(**cfg))


# ---------------------------------------------------------------------------
# the training shading (C2): float64 rows, random or on the clamps' bounds
# ---------------------------------------------------------------------------

SHADE_N, SHADE_S = 64, 8
# shade_train's inputs in its order; the first six take a gradient
SHADE_INPUTS = ("base_color", "roughness", "normals", "viewdirs", "radiance",
                "env_radiance", "visibility", "incident_dirs",
                "incident_areas")


def shade_rows(edges: bool, seed: int = 0):
    """(shade_train's nine inputs by name, d_pbr, d_diffuse_light) in
    float64, SHADE_N rows at SHADE_S samples.  Random rows: base colour and
    roughness in get_base_color's and get_roughness's ranges, unit normals
    (half of them facing away from the view), env values in [-4, 80],
    visibility 0 or 1.  With ``edges``, rows 0-7 meet the edges: no
    cotangent (rows 0-1), roughness 0.09 and 0.99 (2), every vertex facing
    away (3), env values on the clamp's bounds 0 and 64 and past them (4),
    GGX's N.L, N.V, N.H and V.H at 1, the denominator at 4 pi and the
    transport's N.L at 0 (5), GGX's N.L, N.V and N.H at 1e-6 (6), and the
    denominator far below its lower bound at a specular peak (7)."""
    f64 = torch.float64
    n, s = SHADE_N, SHADE_S
    g = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.rand(*shape, generator=g, dtype=f64)

    def unit(*shape):
        return normalize(torch.randn(*shape, 3, generator=g, dtype=f64))

    x = {"base_color": rand(n, 12) * 0.77 + 0.03,
         "roughness": rand(n, 4) * 0.9 + 0.09,
         "normals": unit(n, 4), "viewdirs": unit(n),
         "radiance": rand(n, s, 3) * 2, "env_radiance": rand(n, s, 3) * 84 - 4,
         "visibility": (rand(n, s, 1) > 0.3).double(),
         "incident_dirs": unit(n, s),
         "incident_areas": torch.full((n, s, 1), 4 * math.pi / s,
                                      dtype=f64)}
    d_pbr = torch.randn(n, 12, generator=g, dtype=f64)
    d_dl = torch.randn(n, 12, generator=g, dtype=f64)
    if not edges:
        return x, d_pbr, d_dl

    def vec(*v):
        return torch.tensor(v, dtype=f64)

    z, e = (0.0, 0.0, 1.0), 1e-6
    # |(e, 0, side)|^2 rounds to 1 + 2^-52, whose square root rounds to 1:
    # normalize leaves the vector as it is, its x exactly 1e-6
    side = math.nextafter(math.sqrt(1 - e * e), 2.0)
    d_pbr[:2] = 0
    d_dl[:2] = 0
    x["roughness"][2] = vec(0.09, 0.99, 0.09, 0.99)
    x["normals"][3] = -x["viewdirs"][3].expand(4, 3) + 0.1 * unit(4)
    x["env_radiance"][4, :4] = vec(
        (0.0, 64.0, 80.0), (64.0, 0.0, -1.0), (100.0, 64.0, 0.0),
        (0.0, 0.0, 64.0))
    # row 5: V = N = L at sample 0 and roughness 1; sample 1 perpendicular
    # to the normals
    x["viewdirs"][5] = vec(*z)
    x["normals"][5] = vec(*z)
    x["roughness"][5] = 1.0
    x["incident_dirs"][5, 0] = vec(*z)
    x["incident_dirs"][5, 1] = vec(1.0, 0.0, 0.0)
    # row 6: V = L along x, unit normals with x = 1e-6
    x["viewdirs"][6] = vec(1.0, 0.0, 0.0)
    x["normals"][6] = vec(e, 0.0, side)
    x["incident_dirs"][6, 0] = vec(1.0, 0.0, 0.0)
    # row 7: roughness 0.09 at a specular peak; other samples around it
    x["viewdirs"][7] = vec(*z)
    x["normals"][7] = vec(*z)
    x["roughness"][7] = 0.09
    x["incident_dirs"][7, 0] = vec(*z)
    return x, d_pbr, d_dl


# ---------------------------------------------------------------------------
# the per-Gaussian row sums (R1): per-Gaussian instance lists
# ---------------------------------------------------------------------------

# name -> (rows N, row width K, dropped: raw instances past R and slots past
# M); the recipe's size: 524,288 rows, half of them alive, K 1 (the
# weight sums), 21 (stage 1) and 77 (stage 2, CA 13 / CV 13)
ROWS_CASES = {"k1": (524_288, 1, False), "k21": (524_288, 21, False),
              "k77": (524_288, 77, False), "k77_dropped": (524_288, 77, True),
              "empty": (4096, 21, False)}


def gaussian_rows_inputs(name: str, seed: int = 0, n=None):
    """(d_inst [M, K] f32, gauss_lists [N, 2] int32, raw_slot [R] int32) as a
    counting binner lays them out: the raw instances run list by list in a
    random (depth) order of the Gaussians; half of the rows are alive, 45%
    of those have no instance and the rest 1 to 12 (most 1-2); each list's
    slots are distinct and ascending, drawn from [0, 1.3 x instances) (the
    rest: padding).  With dropping, R is 90% of the raw instances and M 80%
    of the slots' range.  "empty": every list empty and R = 0.  ``n``
    overrides the rows (the CPU tests take a small size)."""
    rows, k, dropped = ROWS_CASES[name]
    n = rows if n is None else n
    rng = np.random.default_rng(seed)
    count = np.zeros(n, np.int64)
    alive = rng.random(n) < 0.5
    some = alive & (rng.random(n) >= 0.45)
    count[some] = np.minimum(rng.geometric(0.55, int(some.sum())), 12)
    if name == "empty":
        count[:] = 0
    order = rng.permutation(n)                     # raw order of the lists
    first = np.empty(n, np.int64)
    first[order] = np.cumsum(count[order]) - count[order]
    total = int(count.sum())
    span = max(int(total * 1.3), 1024)
    slot = rng.choice(span, total, replace=False)
    owner = np.repeat(np.arange(n), count[order])       # list position
    slot = slot[np.lexsort((slot, owner))]               # ascending a list
    m, r = span, total
    if dropped:
        m, r = int(span * 0.8), int(total * 0.9)
    d_inst = rng.standard_normal((m, k)).astype(np.float32)
    lists = np.stack([first, count], 1).astype(np.int32)
    return d_inst, lists, slot[:r].astype(np.int32)


def list_entries(gauss_lists, raw_slot, m: int):
    """The kept entries of per-Gaussian instance lists, in list order:
    (Gaussian [E], rank in its list [E], slot [E]) int64 arrays.  Entries
    past ``raw_slot``'s end or with a slot outside [0, m) are dropped."""
    first = np.asarray(gauss_lists[:, 0], np.int64)
    count = np.asarray(gauss_lists[:, 1], np.int64)
    raw_slot = np.asarray(raw_slot, np.int64)
    count = np.clip(np.minimum(count, raw_slot.shape[0] - first), 0, None)
    g = np.repeat(np.arange(first.shape[0]), count)
    rank = np.arange(g.size) - np.repeat(np.cumsum(count) - count, count)
    q = raw_slot[first[g] + rank]
    keep = (q >= 0) & (q < m)
    return g[keep], rank[keep], q[keep]


def list_gaussian_id(gauss_lists, raw_slot, m: int):
    """[m] int64: the Gaussian whose list holds each slot, -1 for slots in
    no list (padding), as the binner's ``gaussian_id``."""
    g, _, q = list_entries(gauss_lists, raw_slot, m)
    gid = np.full(m, -1, np.int64)
    gid[q] = g
    return gid


def list_sums(d_inst, gauss_lists, raw_slot):
    """R1's sum in numpy: [N+1, K] float32, row g the rows of ``d_inst`` at
    the slots of g's list added in list order onto 0, row N zero."""
    d_inst = np.asarray(d_inst, np.float32)
    n = gauss_lists.shape[0]
    g, rank, q = list_entries(gauss_lists, raw_slot, d_inst.shape[0])
    out = np.zeros((n + 1, d_inst.shape[1]), np.float32)
    for level in np.unique(rank):            # each list's entries in order
        at = rank == level
        out[g[at]] += d_inst[q[at]]
    return out
