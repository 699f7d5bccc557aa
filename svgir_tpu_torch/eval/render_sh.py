"""Debug ray-traced SH render, the reference's ``render_SH`` utility.

Mirrors ``svgir_tpu.eval.render_sh``: the surfels are ray traced instead
of rasterized.  Per pixel a primary camera ray keeps its k nearest
accepted hits, then the radiance bake's sliding-window SH composite
(``ops/tracing.radiance_march``) runs over them with unbounded windows,
so the image shows what the bake sees.  Large scenes take the grid tracer
(``ops/grid_tracer.nearest_hits_grid``, whose march is kernel B8 on the
card), small ones the brute tracer; both give the same hits.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from svgir_tpu_torch.ops import grid_tracer, tracing

# the debug kernel marches UNBOUNDED windows from the camera (reference
# intersect_test.slang:2022-2024: t_min 0.01 after each hit, t_max 1e9),
# unlike the bake's sliding 0.2-window: primary hits sit at scene scale
_CAMERA_WINDOWS = dict(t_min_first=0.01, t_min_next=0.01, t_window=1e9)


@torch.no_grad()
def render_sh_image(means, scales, quats, opacity, shs, camera, *,
                    valid=None, k_hits: int = 16, ray_chunk: int = 65536,
                    gauss_chunk: int = 512, use_grid: Optional[bool] = None,
                    bg: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
    """Ray-trace the SH radiance field through ``camera``.

    The rays go in chunks of ``ray_chunk`` (the last padded with rays from
    the origin along (1, 1, 1)); the image does not depend on it.  The grid
    tracer is the default when surfels x pixels pass 2^22.  Returns
    ``render`` [3, H, W] (the march radiance; ``bg`` [3] where the ray
    misses), ``visibility`` [1, H, W], ``hit`` [H, W] int32 (the first
    surfel, -1 for a miss) and ``t`` [H, W] (the distance to the first
    surfel's centre, inf for a miss)."""
    h, w = camera.height, camera.width
    dev = means.device
    geo = tracing.build_surfel_geometry(means, scales, quats, opacity,
                                        valid=valid)
    rays_d = camera.world_directions().reshape(3, -1).T.contiguous()
    rays_o = camera.camera_center[None].expand_as(rays_d).contiguous()
    r_total = h * w
    n = means.shape[0]
    if use_grid is None:
        use_grid = n * r_total > (1 << 22)

    if use_grid:
        grid = grid_tracer.build_grid_auto(geo)
        # the camera sits outside the scene's box: the march must reach its
        # far side (steps through empty cells cost only the occupancy test)
        t_max = float((means - camera.camera_center[None]).norm(dim=-1)
                      .max()) * 1.2

        def hits_of(o, d):
            return grid_tracer.nearest_hits_grid(geo, grid, o, d,
                                                 t_max=t_max, k=k_hits)
    else:
        def hits_of(o, d):
            return tracing.nearest_hits(geo, o, d, chunk=gauss_chunk,
                                        k=k_hits)

    pad = -r_total % ray_chunk
    o_p = torch.cat([rays_o, torch.zeros(pad, 3, device=dev)])
    d_p = torch.cat([rays_d, torch.ones(pad, 3, device=dev)])
    # primary rays have no source surfel: self index -1 never matches
    no_self = torch.full((ray_chunk,), -1, dtype=torch.int32, device=dev)
    outs = []
    for r0 in range(0, r_total + pad, ray_chunk):
        o, d = o_p[r0:r0 + ray_chunk], d_p[r0:r0 + ray_chunk]
        outs.append(tracing.radiance_march(hits_of(o, d), no_self, shs,
                                           means, o, **_CAMERA_WINDOWS))
    cat = {k: torch.cat([x[k] for x in outs], 0)[:r_total] for k in outs[0]}

    radiance = cat["radiance"].T.reshape(3, h, w)
    vis = cat["visibility"].T.reshape(1, h, w)
    first = cat["first_hit"].reshape(h, w)
    if bg is not None:
        radiance = torch.where((first < 0)[None],
                               bg.to(radiance)[:, None, None], radiance)
    hit_c = means[torch.clamp(first.reshape(-1), 0, n - 1).long()]
    t = torch.where(first.reshape(-1) >= 0,
                    (hit_c - rays_o).norm(dim=-1),
                    torch.full((r_total,), float("inf"), device=dev))
    return {"render": radiance, "visibility": vis, "hit": first,
            "t": t.reshape(h, w)}
