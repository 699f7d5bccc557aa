"""Nearest-neighbour distances for the scale initialization (the simple-knn
``distCUDA2`` contract), as in ``svgir_tpu.ops.knn``: exact, chunked brute
force with d2 = |x|^2 - 2 x.y + |y|^2.
"""

from __future__ import annotations

import torch


@torch.no_grad()
def knn(points: torch.Tensor, k: int = 8, *, n_valid=None,
        chunk: int = 1024):
    """Exact top-k nearest neighbours excluding self: (sq_dists [N, k],
    idx [N, k]).  Rows from ``n_valid`` on (an int or a 0-d tensor) are
    padding: no point takes them as a neighbour."""
    n = points.shape[0]
    if n_valid is None:
        n_valid = n
    sq = (points * points).sum(-1)
    d_out = points.new_empty(n, k)
    i_out = torch.empty(n, k, dtype=torch.int64, device=points.device)
    cols = torch.arange(n, device=points.device)
    for a in range(0, n, chunk):
        cp = points[a:a + chunk]
        d2 = sq[a:a + chunk, None] - 2.0 * cp @ points.T + sq[None]
        rows = torch.arange(a, a + cp.shape[0], device=points.device)
        d2 = d2.masked_fill((cols[None] == rows[:, None])
                            | (cols[None] >= n_valid), float("inf"))
        d, i = torch.topk(d2, k, dim=1, largest=False)
        d_out[a:a + chunk], i_out[a:a + chunk] = d, i
    return d_out, i_out


def mean_sq_dist_3nn(points: torch.Tensor) -> torch.Tensor:
    """Mean squared distance to the 3 nearest neighbours
    (gaussian_model.py:706-707)."""
    d2, _ = knn(points, k=3)
    return torch.where(torch.isfinite(d2), d2, torch.zeros_like(d2)).mean(1)
