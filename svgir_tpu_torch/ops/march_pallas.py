"""The grid march B8: test a visit's BLK packed candidate rows against each
ray and merge the accepted ones into the ray's running k nearest hits,
visit after visit over the ray's whole walk.

Named after ``svgir_tpu/ops/march_pallas.py``, whose ``_march_kernel``
(one visit for a block of rays, behind a ``lax.scan`` over the visits)
this replaces.  On CUDA tensors ``march`` launches the hand-written kernel
(``csrc/march.cu``), which walks each ray's cells and runs all of its
visits in one launch; on CPU tensors it runs ``march_plain``, the same
walk as a loop over steps and blocks of ``march_visit_plain``.

The test is ``grid_tracer._test_candidates``' (plane-hit t, local uv with
dis <= 9, power <= 0, alpha in [1/255, 0.99], facing, t in [t_lo, t_hi)),
evaluated one rounded operation at a time in that order (ROADMAP C-1:
for thin surfels any other order accepts other hits).  The merge keeps
``lax.top_k``'s contract: the k smallest t in ascending order, ties in
slot order (running hits first, then candidates in row order), empty
slots (inf, -1).
"""

from __future__ import annotations

import torch

from svgir_tpu_torch.kernels import march as K
from svgir_tpu_torch.ops import grid_tracer as GT
from svgir_tpu_torch.ops.common import on_cuda


def march_visit_plain(g, rays_o, rays_d, t_lo, t_hi, hits_t, hits_idx, *,
                      k: int):
    """One visit: field-major packed rows g [R, 32 * BLK], rays [R, 3],
    span t_lo, t_hi (f32, [R] or 0-d), running hits t [R, k] f32 and idx
    [R, k] int32 -> merged (t, idx)."""
    r = g.shape[0]
    rows = g.reshape(r, GT.PACK_W, -1).transpose(1, 2)      # [R, BLK, 32]
    cand = GT._test_candidates(rows, rays_o, rays_d, t_lo, t_hi)
    t, idx = GT.merge_candidates(hits_t, hits_idx, cand, k=k)
    return t, torch.where(torch.isfinite(t), idx, torch.full_like(idx, -1))


def march_plain(grid: GT.TraceGrid, rays_o, rays_d, *, t_max: float, k: int,
                n_steps: int, kmax: int):
    """Plain version of the kernel: every ray's visits (``_run_scan``) in
    step order, each visit's blocks in order, each through
    ``march_visit_plain``.  Returns t [R, k] f32, idx [R, k] int32."""
    r = rays_o.shape[0]
    dev = rays_o.device
    t = torch.full((r, k), float("inf"), device=dev)
    idx = torch.full((r, k), -1, dtype=torch.int32, device=dev)
    nb, spans, cells = GT._run_scan(grid, rays_o, rays_d, n_steps=n_steps,
                                    kmax=kmax)
    dt = GT.grid_dt(grid)
    t_max_t = torch.tensor(t_max, dtype=torch.float32, device=dev)
    for j in range(n_steps):
        nbj = nb[:, j]
        most = int(nbj.max())
        if most == 0:
            continue
        jj = torch.tensor(float(j), device=dev)
        t_lo = jj * dt
        t_hi = torch.minimum((jj + spans[:, j].to(torch.float32)) * dt,
                             t_max_t)
        for bi in range(most):
            sel = torch.nonzero(nbj > bi)[:, 0]
            row = grid.block_start[cells[sel, j].long()].long() + bi
            t[sel], idx[sel] = march_visit_plain(
                grid.block_geo[row], rays_o[sel], rays_d[sel], t_lo,
                t_hi[sel], t[sel], idx[sel], k=k)
    return t, idx


def march(grid: GT.TraceGrid, rays_o, rays_d, *, t_max: float, k: int,
          n_steps: int, kmax: int):
    """B8 over whole walks: rays [R, 3] -> the k nearest accepted hits of
    the grid's cell lists, t [R, k] f32 (inf = none) and idx [R, k] int32
    (-1 = none).  Big surfels are not in the cell lists."""
    if on_cuda(rays_o):
        return K.march(grid.block_geo, grid.block_start, grid.cell_count,
                       rays_o, rays_d, lo=grid.lo, inv_cell=grid.inv_cell,
                       res=grid.res, dt=GT.grid_dt(grid), t_max=t_max,
                       n_steps=n_steps, kmax=kmax, cap=grid.cell_cap, k=k)
    return march_plain(grid, rays_o, rays_d, t_max=t_max, k=k,
                       n_steps=n_steps, kmax=kmax)
