"""Uniform-grid accelerated nearest-hit tracing: the bake's tracer at scale.

Mirrors the parts of ``svgir_tpu.ops.grid_tracer`` that the radiance bake
runs.  Built once per bake:

* surfels are binned into a ``res^3`` cell grid by their +-3 sigma AABBs
  (expanded by half a march step), by one stable sort of (cell, surfel)
  pairs; surfels whose AABB spans more than ``span_cap`` cells go to a
  dense "big" list instead, which every ray tests once;
* every occupied (cell, BLK-wide slice of its list) block gets its surfels'
  packed geometry rows gathered into ``block_geo``, FIELD-MAJOR (``[32,
  BLK]`` per block row: field ``f`` of candidate ``c`` at ``f * BLK + c``),
  so the march kernel reads each field of a block as one coalesced run.

The march walks each ray's cells at half-cell steps, merges consecutive
steps in one cell into a visit of at most ``kmax`` steps (``_run_scan``),
tests every block of the visit's cell within the visit's t-span, and keeps
the k nearest accepted hits; each hit lies in exactly one span, so a
surfel listed in several cells is found once.  The march itself is kernel
B8 (``ops/march_pallas.py``); the big-surfel pass and the recomputation of
the winners' records are plain tensor code.

The JAX package's environment switches (``SVGIR_TRACE_BLOCK``,
``SVGIR_MERGE_IMPL``, ``SVGIR_BLOCKGEO_LIMIT``, ``SVGIR_MARCH_PALLAS``)
are constants here: BLK 64, one stable merge after every visit, the
field-major table always.

``trace_visibility_grid`` is the visibility tracer of
``finetune_visibility`` at scale: it walks the same steps and tests the
same blocks, with the reference's acceptance for visibility, and sums
log(1 - alpha) over a ray's accepted pairs.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from svgir_tpu_torch.ops import tracing

BLK = 64          # candidates per march visit
PACK_W = 32       # floats per packed geometry row
BIG_BLOCK = 256   # big surfels tested per pass of the dense big-surfel merge
ID_LANE = 26      # lane of the packed row that holds the surfel id
SIGMA = 3.0       # AABB half width in scales
CAP_LIMIT = 4096  # largest exact cell cap before the resolution grows
RES_LIMIT = 128   # largest resolution build_grid_auto grows to


class TraceGrid(NamedTuple):
    """Uniform grid of the small surfels plus the dense big-surfel list."""
    cell_count: torch.Tensor   # [C] int32 candidates per cell (uncapped)
    big_ids: torch.Tensor      # [B] int32 (B may be 0)
    lo: torch.Tensor           # [3] grid origin
    inv_cell: torch.Tensor     # [3] 1 / cell size
    res: int
    cell_cap: int
    overflow: bool             # some cell exceeded its cap
    block_geo: torch.Tensor    # [Bocc + 1, 32 * BLK] f32, field-major
    block_start: torch.Tensor  # [C] int32 first block row of each cell


def _to_cell(x: torch.Tensor, res: int) -> torch.Tensor:
    """clip(int32(x), 0, res-1) with int32 truncating toward zero.  The
    float is clamped to [-1, res] first: that changes no result and keeps
    the conversion defined for any float (the CUDA march does the same)."""
    return torch.clamp(torch.clamp(x, -1.0, float(res)).to(torch.int32),
                       0, res - 1)


def auto_res(geo: tracing.SurfelGeometry) -> int:
    """Grid resolution: start where the median surfel spans about one cell
    per axis (at most 128), then walk down until at most 1% of the surfels
    exceed the 64-cell span budget.  Host numpy, exactly as
    ``svgir_tpu.ops.grid_tracer.auto_res`` with its defaults, so both
    packages pick the same resolution."""
    sigma, target_span, max_res, span_cap, big_frac = \
        SIGMA, 1.0, RES_LIMIT, 64, 0.01
    valid = geo.valid.cpu().numpy()
    sc = geo.scales.detach().cpu().numpy()[valid]
    pts = geo.means.detach().cpu().numpy()[valid]
    if len(sc) == 0:
        return 16
    med = np.median(sc.max(axis=1))
    ext3 = pts.max(0) - pts.min(0) + 2 * sigma * sc.max() + 1e-6
    extent = float(ext3.max())
    res_med = int(np.clip(extent / max(2 * sigma * med / target_span, 1e-6),
                          4, max_res))
    r = sigma * np.einsum("nij,nj->ni",
                          np.abs(geo.rot.detach().cpu().numpy()[valid]), sc)
    res = res_med
    while res > 4:
        cell = ext3 / res
        e = float(cell.min()) / 4.0          # dt/2 expansion per side
        span = np.floor(2 * (r + e) / cell[None]).astype(np.int64) + 1
        frac = float(np.mean(span.prod(axis=1) > span_cap))
        if frac <= big_frac:
            break
        res = max(int(res * 0.75), 4)
    return res


def _sort_pairs(pts, r_exp, select, lo, inv_cell, *, res: int,
                span_cap: int):
    """Enumerate and stably sort the (cell, surfel) pairs of the selected
    surfels (each spans at most ``span_cap`` cells).  Returns gid_s
    [N * span_cap] (surfel ids in cell order), starts [C], counts [C]."""
    n = pts.shape[0]
    dev = pts.device
    c0 = _to_cell((pts - r_exp - lo) * inv_cell, res)
    c1 = _to_cell((pts + r_exp - lo) * inv_cell, res)
    span = c1 - c0 + 1
    ncells = torch.where(select, span[:, 0] * span[:, 1] * span[:, 2],
                         torch.zeros_like(span[:, 0]))
    k = torch.arange(span_cap, dtype=torch.int32, device=dev)[None]
    sx, sy = span[:, 0:1], span[:, 1:2]
    dx = k % sx
    dy = (k // sx) % sy
    dz = k // (sx * sy)
    cell = ((c0[:, 2:3] + dz) * res + (c0[:, 1:2] + dy)) * res \
        + (c0[:, 0:1] + dx)                                   # [N, K]
    num_cells = res ** 3
    cell = torch.where(k < ncells[:, None], cell,
                       torch.full_like(cell, num_cells))
    gid = torch.arange(n, dtype=torch.int32, device=dev)[:, None] \
        .expand(n, span_cap)
    cell_s, order = torch.sort(cell.reshape(-1), stable=True)
    gid_s = gid.reshape(-1)[order]
    grid_ids = torch.arange(num_cells, dtype=torch.int32, device=dev)
    starts = torch.searchsorted(cell_s, grid_ids)
    counts = (torch.searchsorted(cell_s, grid_ids, right=True)
              - starts).to(torch.int32)
    return gid_s, starts, counts


def pack_geometry(geo: tracing.SurfelGeometry) -> torch.Tensor:
    """[N + 1, 32] packed rows: means 0:3, scales 3:6, rot (row-major)
    6:15, inv_cov 15:21, normal 21:24, opacity 24, valid 25, the surfel id
    (as float, exact below 2^24) 26.  Row N is the padding row (valid 0,
    id -1) that id -1 routes to."""
    n = geo.means.shape[0]
    dev = geo.means.device
    packed = torch.cat([
        geo.means, geo.scales, geo.rot.reshape(n, 9), geo.inv_cov,
        geo.normal, geo.opacity[:, None], geo.valid.to(torch.float32)[:, None],
        torch.arange(n, dtype=torch.float32, device=dev)[:, None],
        torch.zeros(n, PACK_W - ID_LANE - 1, device=dev)], 1)
    pad = torch.zeros(1, PACK_W, device=dev)
    pad[0, ID_LANE] = -1.0
    return torch.cat([packed, pad], 0)


def _build_geo_blocks(geo, starts, counts, gid_s, cell_cap: int):
    """Packed geometry of every occupied (cell, block) pair, field-major:
    block_geo [Bocc + 1, 32 * BLK] (the last row is an all-padding block)
    and block_start [C] int32, so visit (cell, bi) reads row
    ``block_start[cell] + bi``."""
    dev = gid_s.device
    counts_c = torch.clamp(counts, max=cell_cap).long()
    nbc = (counts_c + BLK - 1) // BLK                      # blocks per cell
    bocc = int(nbc.sum())
    block_start = torch.cumsum(nbc, 0) - nbc               # exclusive
    cell_of_b = torch.repeat_interleave(
        torch.arange(nbc.shape[0], device=dev), nbc)
    k_of_b = torch.arange(bocc, device=dev) - block_start[cell_of_b]
    src0 = starts[cell_of_b].long() + k_of_b * BLK
    slot = torch.arange(BLK, device=dev)
    src = torch.clamp(src0[:, None] + slot[None], 0, gid_s.shape[0] - 1)
    ok = slot[None] < (counts_c[cell_of_b] - k_of_b * BLK)[:, None]
    rows = torch.where(ok, gid_s[src].long(), torch.full_like(src, -1))
    rows = torch.cat([rows, torch.full((1, BLK), -1, dtype=rows.dtype,
                                       device=dev)], 0)
    packed = pack_geometry(geo)
    n = packed.shape[0] - 1
    gathered = packed[torch.where(rows >= 0, rows, torch.full_like(rows, n))]
    block_geo = gathered.transpose(1, 2).reshape(bocc + 1, PACK_W * BLK)
    return block_geo.contiguous(), block_start.to(torch.int32)


def _half_widths(rot, scales):
    """|R| s per axis [N, 3] (the AABB half widths over sigma), summed as
    the chain of fused multiply-adds ``fma(a2, s2, fma(a1, s1, a0 s0))``
    by which XLA evaluates the JAX package's einsum, so both packages bin
    every surfel into the same cells.  A float32 product is exact in
    float64; the sum is rounded in float64, then to float32."""
    a = rot.abs().double()
    s = scales.double()
    acc = (a[..., 0] * s[:, None, 0]).float().double()
    for j in (1, 2):
        acc = (a[..., j] * s[:, None, j] + acc).float().double()
    return acc.float()


def build_grid(geo: tracing.SurfelGeometry, *, res: int = 32,
               cell_cap: Optional[int] = 64,
               span_cap: int = 64) -> TraceGrid:
    """Bin the surfels into the grid by their +-sigma AABBs (|R| sigma s
    per axis), expanded by half a march step so a hit within half a step
    of a step's midpoint always finds its surfel in the midpoint's cell.

    ``cell_cap=None`` sizes the cap exactly (the largest cell count,
    rounded up to a multiple of BLK); an explicit cap clips the lists and
    sets ``overflow`` when exceeded."""
    valid = geo.valid
    v3 = valid[:, None]
    pts = torch.where(v3, geo.means, torch.zeros_like(geo.means))
    r = SIGMA * _half_widths(geo.rot, geo.scales)
    r = torch.where(v3, r, torch.zeros_like(r))
    lo = torch.where(v3, pts - r, torch.full_like(r, 1e30)).amin(0)
    hi = torch.where(v3, pts + r, torch.full_like(r, -1e30)).amax(0)
    extent = torch.clamp(hi - lo, min=1e-6)
    inv_cell = torch.full_like(extent, res) / extent   # not res * (1/extent)
    dt = (extent / res).min() * 0.5
    r_exp = r + 0.5 * dt

    c0 = _to_cell((pts - r_exp - lo) * inv_cell, res)
    c1 = _to_cell((pts + r_exp - lo) * inv_cell, res)
    sp = c1 - c0 + 1
    fine_sel = valid & (sp[:, 0] * sp[:, 1] * sp[:, 2] <= span_cap)

    big_ids = torch.nonzero(valid & ~fine_sel)[:, 0].to(torch.int32)
    n_valid = max(int(valid.sum()), 1)
    if big_ids.shape[0] > 0.05 * n_valid:
        print(f"WARNING: {int(big_ids.shape[0])}/{n_valid} surfels exceed "
              f"the {span_cap}-cell span budget at res={res} — the dense "
              "big-surfel pass degenerates toward brute force; lower the "
              "grid res", flush=True)

    gid_s, starts, counts = _sort_pairs(pts, r_exp, fine_sel, lo, inv_cell,
                                        res=res, span_cap=span_cap)
    max_count = int(counts.max())
    if cell_cap is None:
        cell_cap = max(-(-max_count // BLK) * BLK, BLK)
        overflow = False
    else:
        overflow = max_count > cell_cap
    block_geo, block_start = _build_geo_blocks(geo, starts, counts, gid_s,
                                               cell_cap)
    return TraceGrid(cell_count=counts, big_ids=big_ids, lo=lo,
                     inv_cell=inv_cell, res=res, cell_cap=cell_cap,
                     overflow=overflow, block_geo=block_geo,
                     block_start=block_start)


def build_grid_auto(geo: tracing.SurfelGeometry, *, res: int = 32,
                    span_cap: int = 64) -> TraceGrid:
    """build_grid with the cap sized exactly.  When the exact cap exceeds
    CAP_LIMIT the resolution grows x1.5 up to RES_LIMIT; past that the
    lists are clipped at the limit, with a warning."""
    while True:
        grid = build_grid(geo, res=res, cell_cap=None, span_cap=span_cap)
        if grid.cell_cap <= CAP_LIMIT:
            return grid
        if res < RES_LIMIT:
            res = min(int(res * 1.5), RES_LIMIT)
            continue
        print(f"WARNING: exact grid cap {grid.cell_cap} exceeds cap_limit "
              f"{CAP_LIMIT} at res={res} (res_limit {RES_LIMIT}) — "
              "clipping; some candidates are dropped", flush=True)
        return build_grid(geo, res=res, cell_cap=CAP_LIMIT,
                          span_cap=span_cap)


# ---------------------------------------------------------------------------
# walking the grid
# ---------------------------------------------------------------------------

def grid_dt(grid: TraceGrid) -> torch.Tensor:
    """March step: half the smallest cell edge (f32, 0-d)."""
    return (1.0 / grid.inv_cell).min() * 0.5


def _cell_index(grid: TraceGrid, pos: torch.Tensor) -> torch.Tensor:
    """Flat cell index [R] (int32) at world positions [R, 3]."""
    c = _to_cell((pos - grid.lo) * grid.inv_cell, grid.res)
    return (c[:, 2] * grid.res + c[:, 1]) * grid.res + c[:, 0]


def _concrete_n_steps(grid: TraceGrid, t_max: float) -> int:
    """Steps covering [0, t_max) at half-cell strides, at most 6 * res."""
    dt = float(np.min(1.0 / grid.inv_cell.cpu().numpy())) * 0.5
    return max(1, min(int(np.ceil(t_max / dt)), 6 * int(grid.res)))


def _run_kmax(grid: TraceGrid) -> int:
    """Longest visit in steps: ceil(sqrt(3) * max_cell / (min_cell / 2)),
    clamped to [2, 8] (longer runs of one cell become several visits)."""
    cell = 1.0 / grid.inv_cell.cpu().numpy()
    return int(min(8, max(2, np.ceil(3.47 * cell.max() / cell.min()))))


STEP_CHUNK = 1 << 22   # (ray, step) pairs whose cells are formed at once


def _step_cells(grid: TraceGrid, rays_o: torch.Tensor, rays_d: torch.Tensor,
                *, n_steps: int) -> torch.Tensor:
    """[R, n_steps] int32 cell of every step's midpoint: step j samples
    o + (j dt + dt/2) d, each product and sum rounded as the per-step walk
    rounds it.  Rays are taken in chunks of ``STEP_CHUNK // n_steps``."""
    dt = grid_dt(grid)
    mids = torch.arange(n_steps, dtype=torch.float32,
                        device=rays_o.device) * dt + 0.5 * dt
    out = []
    step = max(STEP_CHUNK // n_steps, 1)
    for r0 in range(0, rays_o.shape[0], step):
        o = rays_o[r0:r0 + step, None]
        d = rays_d[r0:r0 + step, None]
        pos = o + mids[None, :, None] * d                   # [r, S, 3]
        out.append(_cell_index(grid, pos.reshape(-1, 3)).reshape(
            -1, n_steps))
    if not out:
        return torch.empty(0, n_steps, dtype=torch.int32,
                           device=rays_o.device)
    return torch.cat(out, 0)


def _run_scan(grid: TraceGrid, rays_o: torch.Tensor, rays_d: torch.Tensor,
              *, n_steps: int, kmax: int):
    """The march's visit list.  Half-cell steps sample a cell 2-3 times in
    a row; a visit covers one run of consecutive steps in one cell (runs
    are cut every ``kmax`` steps).  Returns, each [R, n_steps]:

      nb    candidate blocks at the steps that start a visit, 0 elsewhere
      spans the visit's length in steps (valid where nb > 0)
      cells the cell of every step (int32)
    """
    r = rays_o.shape[0]
    cap = grid.cell_cap
    cells = _step_cells(grid, rays_o, rays_d, n_steps=n_steps)
    nb = torch.zeros(r, n_steps, dtype=torch.int32, device=rays_o.device)
    prev = torch.full((r,), -1, dtype=torch.int32, device=rays_o.device)
    run_pos = torch.zeros_like(prev)
    for j in range(n_steps):
        cell = cells[:, j]
        cnt = torch.clamp(grid.cell_count[cell.long()], max=cap)
        run_pos = torch.where((cell == prev) & (j > 0), run_pos + 1,
                              torch.zeros_like(run_pos))
        start = (cnt > 0) & (run_pos % kmax == 0)
        nb[:, j] = torch.where(start, (cnt + BLK - 1) // BLK,
                               torch.zeros_like(cnt))
        prev = cell
    same = torch.cat([torch.zeros(r, 1, dtype=torch.bool, device=nb.device),
                      cells[:, 1:] == cells[:, :-1]], 1)
    spans = torch.ones_like(nb)
    acc = torch.ones_like(same)
    for u in range(1, kmax):
        nxt = torch.cat([same[:, u:], torch.zeros(r, u, dtype=torch.bool,
                                                  device=nb.device)], 1)
        acc = acc & nxt
        spans = spans + acc.to(torch.int32)
    return nb, spans, cells


def count_visit_blocks(grid: TraceGrid, rays_o: torch.Tensor,
                       rays_d: torch.Tensor, *, t_max: float,
                       n_steps: Optional[int] = None) -> torch.Tensor:
    """[R] candidate blocks a ray's march visits (its BLK-wide tests)."""
    if n_steps is None:
        n_steps = _concrete_n_steps(grid, t_max)
    nb, _, _ = _run_scan(grid, rays_o, rays_d, n_steps=n_steps,
                         kmax=_run_kmax(grid))
    return nb.sum(1)


def count_occupied_steps(grid: TraceGrid, rays_o: torch.Tensor,
                         rays_d: torch.Tensor, *, t_max: float,
                         n_steps: int) -> torch.Tensor:
    """[R] number of march steps whose cell holds a candidate (of the
    small-surfel partition; ``t_max`` is not used, as in the reference)."""
    del t_max
    cells = _step_cells(grid, rays_o, rays_d, n_steps=n_steps)
    return (grid.cell_count[cells.long()] > 0).sum(1)


def _test_candidates(rows: torch.Tensor, rays_o: torch.Tensor,
                     rays_d: torch.Tensor, t_lo, t_hi) -> Dict:
    """Exact surfel tests of packed candidate rows [R or 1, L, 32] for rays
    [R, 3] within the t-span [t_lo, t_hi) (f32 tensors, each [R] or 0-d;
    the same tests as ``tracing.nearest_hits`` plus the span).  Returns
    [R, L] t (inf unless accepted), alpha, uv [R, L, 2], ok, idx."""
    ids = rows[..., ID_LANE].to(torch.int32)
    rot = rows[..., 6:15].reshape(rows.shape[:-1] + (3, 3))
    t_plane, dis, power, alpha, facing, u, v = tracing.surfel_test(
        rows[..., 0:3], rows[..., 21:24], rot, rows[..., 3:6],
        rows[..., 15:21], rows[..., 24], rays_o[:, None], rays_d[:, None])
    def col(x):
        return x[:, None] if x.dim() else x
    ok = ((ids >= 0) & tracing.accepted(rows[..., 25] > 0.5, dis, power,
                                        alpha, facing)
          & (t_plane >= col(t_lo)) & (t_plane < col(t_hi)))
    return {"t": torch.where(ok, t_plane,
                             torch.full_like(t_plane, float("inf"))),
            "alpha": alpha, "uv": tracing.swapped_uv(u, v), "ok": ok,
            "idx": ids.expand(ok.shape)}


def merge_candidates(t, idx, cand: Dict, *, k: int):
    """Merge tested candidates (``_test_candidates``) into running hits t,
    idx [R, k]: the k nearest, ties in slot order (running hits first)."""
    cand_idx = torch.where(cand["ok"], cand["idx"],
                           torch.full_like(cand["idx"], -1))
    return tracing.topk_smallest(torch.cat([t, cand["t"]], 1),
                                 torch.cat([idx, cand_idx], 1), k)


def _merge_big(t, idx, grid: TraceGrid, packed, rays_o, rays_d, t_max, *,
               k: int):
    """The dense once-per-ray pass over the big surfels (absent from every
    cell list), merged into the march's top-k over the march's whole
    window [0, t_max)."""
    n_big = grid.big_ids.shape[0]
    for b0 in range(0, n_big, BIG_BLOCK):
        ids = grid.big_ids[b0:b0 + BIG_BLOCK].long()
        cand = _test_candidates(packed[ids][None], rays_o, rays_d,
                                torch.zeros((), device=t.device), t_max)
        t, idx = merge_candidates(t, idx, cand, k=k)
    return t, idx


def nearest_hits_grid(geo: tracing.SurfelGeometry, grid: TraceGrid,
                      rays_o: torch.Tensor, rays_d: torch.Tensor, *,
                      t_max: float = 2.0, k: int = 16,
                      n_steps: Optional[int] = None) -> Dict:
    """Grid-walk counterpart of ``tracing.nearest_hits`` (same output
    dict).  The march (B8, ``ops/march_pallas.march``) visits every block
    of every visited cell, so it never truncates; then the big surfels are
    merged in and the k winners' records (t, alpha, uv) recomputed over
    the whole window [0, t_max)."""
    from svgir_tpu_torch.ops import march_pallas

    if n_steps is None:
        n_steps = _concrete_n_steps(grid, t_max)
    t, idx = march_pallas.march(grid, rays_o, rays_d, t_max=t_max, k=k,
                                n_steps=n_steps, kmax=_run_kmax(grid))
    packed = pack_geometry(geo)
    t_max_t = torch.tensor(t_max, dtype=torch.float32, device=t.device)
    t, idx = _merge_big(t, idx, grid, packed, rays_o, rays_d, t_max_t, k=k)
    n = packed.shape[0] - 1
    full = _test_candidates(
        packed[torch.where(idx >= 0, idx, torch.full_like(idx, n)).long()],
        rays_o, rays_d, torch.zeros((), device=t.device), t_max_t)
    fin = torch.isfinite(t)
    return {"t": torch.where(fin, full["t"], t),
            "idx": torch.where(fin, idx, torch.full_like(idx, -1)),
            "alpha": full["alpha"], "uv": full["uv"]}


# ---------------------------------------------------------------------------
# visibility along rays (trace.cu:196-280 semantics)
# ---------------------------------------------------------------------------

VIS_BATCH = 1 << 15   # visit blocks (of BLK candidates) tested at once


def _vis_runs(grid: TraceGrid, rays_o, rays_d, *, t_max: float,
              n_steps: int):
    """The visits of the visibility walk: each run of consecutive steps in
    one cell whose list is not empty, as (ray [V] int64, cell [V] int64,
    t_lo [V], t_hi [V]).  A run of steps j0 .. j1-1 covers the union of
    their spans [max(j dt, 0.01), min((j + 1) dt, t_max)), which is
    [max(j0 dt, 0.01), min(j1 dt, t_max)); the spans do not overlap, so a
    (ray, surfel) pair is accepted in at most one of them."""
    dev = rays_o.device
    cells = _step_cells(grid, rays_o, rays_d, n_steps=n_steps)
    r = cells.shape[0]
    start = torch.ones_like(cells, dtype=torch.bool)
    start[:, 1:] = cells[:, 1:] != cells[:, :-1]
    col = torch.arange(n_steps, device=dev)
    nxt = torch.where(start, col[None], torch.full_like(cells, n_steps,
                                                        dtype=torch.long))
    nxt = torch.cat([nxt[:, 1:], torch.full((r, 1), n_steps,
                                            dtype=torch.long, device=dev)], 1)
    j1 = torch.flip(torch.cummin(torch.flip(nxt, [1]), 1).values, [1])
    occupied = grid.cell_count[cells.long()] > 0
    ray, j0 = torch.nonzero(start & occupied, as_tuple=True)
    dt = grid_dt(grid)
    t_lo = torch.clamp(j0.to(torch.float32) * dt, min=0.01)
    t_hi = torch.clamp(j1[ray, j0].to(torch.float32) * dt, max=t_max)
    return ray, cells[ray, j0].long(), t_lo, t_hi


def _vis_terms(cand: Dict, opacity: torch.Tensor):
    """log(1 - alpha) summed over the accepted candidates of each row and
    their count (trace.cu:233: opacity >= 1/255 before the exp)."""
    ok = cand["ok"] & (opacity >= tracing.ALPHA_MIN)
    a = torch.where(ok, torch.clamp(cand["alpha"], max=tracing.ALPHA_MAX),
                    torch.zeros_like(cand["alpha"]))
    return torch.log1p(-a).sum(1), ok.sum(1, dtype=torch.int32)


def trace_visibility_grid(geo: tracing.SurfelGeometry, grid: TraceGrid,
                          rays_o: torch.Tensor, rays_d: torch.Tensor, *,
                          t_max: float = 20.0, n_steps: int = 256) -> Dict:
    """Grid-walk visibility (trace.cu semantics, as the brute
    ``tracing.trace_visibility`` but with ``_test_candidates``' acceptance:
    plane hit, ellipse dis <= 9, power <= 0, alpha >= 1/255, facing, the
    step's span, and opacity >= 1/255).  Each run of steps in one cell is
    visited once with the union of its steps' spans, every BLK-wide block
    of the cell's list; the big surfels are tested once per ray over
    [0.01, t_max).  The product of (1 - alpha) does not depend on order,
    so the log terms of a ray are summed in float64.  Returns visibility
    [R, 1] (0 below 0.9) and contribute [R, 1] (the accepted count)."""
    r = rays_o.shape[0]
    dev = rays_o.device
    ray, cell, t_lo, t_hi = _vis_runs(grid, rays_o, rays_d, t_max=t_max,
                                      n_steps=n_steps)
    nb = (torch.clamp(grid.cell_count[cell], max=grid.cell_cap)
          + BLK - 1) // BLK
    # one entry per (visit, block of the visit's cell)
    first = torch.repeat_interleave(grid.block_start[cell].long(), nb)
    visit = torch.repeat_interleave(torch.arange(ray.shape[0], device=dev),
                                    nb)
    row = first + torch.arange(visit.shape[0], device=dev) \
        - torch.repeat_interleave(torch.cumsum(nb, 0) - nb, nb)
    log_t = torch.zeros(r, dtype=torch.float64, device=dev)
    count = torch.zeros(r, dtype=torch.int32, device=dev)
    for e0 in range(0, row.shape[0], VIS_BATCH):
        v = visit[e0:e0 + VIS_BATCH]
        rr = ray[v]
        rows = grid.block_geo[row[e0:e0 + VIS_BATCH]]
        rows = rows.reshape(-1, PACK_W, BLK).transpose(1, 2)
        cand = _test_candidates(rows, rays_o[rr], rays_d[rr], t_lo[v],
                                t_hi[v])
        lt, n = _vis_terms(cand, rows[..., 24])
        log_t.index_add_(0, rr, lt.double())
        count.index_add_(0, rr, n)
    if grid.big_ids.shape[0]:
        packed = pack_geometry(geo)
        lo = torch.full((), 0.01, device=dev)
        hi = torch.full((), t_max, device=dev)
        for b0 in range(0, grid.big_ids.shape[0], BIG_BLOCK):
            sub = packed[grid.big_ids[b0:b0 + BIG_BLOCK].long()][None]
            cand = _test_candidates(sub, rays_o, rays_d, lo, hi)
            lt, n = _vis_terms(cand, sub[..., 24])
            log_t += lt.double()
            count += n
    v = torch.exp(log_t.to(torch.float32))
    v = torch.where(v < 0.9, torch.zeros_like(v), v)
    return {"visibility": v[:, None], "contribute": count[:, None]}
