"""Synthetic inputs of kernels B1 (tile counts and carry table) and B7 (the
env-map lookup), made with numpy from a seed.

The CPU tests (``tests/test_torch_binning.py``,
``tests/test_torch_env_lookup.py``) hold the port's plain versions to the
JAX kernels on them; ``chip_smoke.py`` builds the same arrays and holds the
CUDA kernels to their plain versions on the card.  This module imports
numpy only, so the smoke run can use it where JAX is not installed.
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
