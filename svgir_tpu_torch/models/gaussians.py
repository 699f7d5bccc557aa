"""Gaussian-surfel model state: parameters, activations, initialization and
the densification statistics.

The state mirrors ``svgir_tpu.models.gaussians``: a dict with "params" (a
dict of tensors with the JAX pytree's keys and shapes), "alive" (a [cap]
bool mask over a fixed capacity) and "stats".  ``params_from_jax`` and
``params_to_numpy`` carry the JAX state (as numpy arrays) across so both
packages compute the same thing in the tests.

The stage-2 groups (per-vertex base color, roughness and normal offsets,
the baked radiances and their ratio) come from ``upgrade_to_pbr`` and the
stage-2 trainer.  Densification (``densify_and_prune``, ``reset_opacity``,
``grow_capacity``) keeps the reference's fixed-shape semantics: clones and
split children are scattered into the free slots of the capacity in index
order, on the state's device, with no host round trip.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from svgir_tpu_torch.utils.sh import rgb_to_sh
from svgir_tpu_torch.utils.transforms import (inverse_sigmoid, normal_to_rotation,
                                              normalize, quat_multiply,
                                              quat_to_rotmat, rotmat_to_quat)

VERTEX_NUM = 4  # gaussian_model.py:150

# ---------------------------------------------------------------------------
# activations (gaussian_model.py:104-125, 270-351)
# ---------------------------------------------------------------------------


def get_scaling(params) -> torch.Tensor:
    return torch.nan_to_num(torch.exp(params["scaling"]), nan=1e-6)


def get_rotation(params) -> torch.Tensor:
    return torch.nan_to_num(normalize(params["rotation"]), nan=1e-6)


def get_opacity(params) -> torch.Tensor:
    return torch.sigmoid(params["opacity"])


def get_geo_normal(params) -> torch.Tensor:
    """3rd column of the rotation matrix (gaussian_model.py:297-299)."""
    return quat_to_rotmat(get_rotation(params))[..., :, 2]


def get_shs(params) -> torch.Tensor:
    return torch.cat([params["shs_dc"], params["shs_rest"]], 1)


def get_shading_normal(params) -> torch.Tensor:
    """[N, 4, 3] per-vertex normals: geo normal + offsets, normalized
    (gaussian_model.py:287-295).  ``normal`` holds channel-major offsets
    [cx*4, cy*4, cz*4]."""
    geo = get_geo_normal(params)[:, None, :]                     # [N, 1, 3]
    off = params["normal"].reshape(-1, 3, VERTEX_NUM).transpose(1, 2)
    return normalize(geo + off)


def get_base_color(params, base_color_scale: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """sigmoid(x)*0.77 + 0.03, channel-major over the 4 vertices, optionally
    rescaled per colour channel [3] (gaussian_model.py:123, 338-339; the
    relighting evaluation's albedo calibration)."""
    bc = torch.sigmoid(params["base_color"]) * 0.77 + 0.03
    if base_color_scale is not None:
        bc = bc * torch.repeat_interleave(base_color_scale, VERTEX_NUM)[None]
    return bc


def get_roughness(params) -> torch.Tensor:
    return torch.nan_to_num(torch.sigmoid(params["roughness"]) * 0.9 + 0.09,
                            nan=1e-8)


def get_radiances(params) -> torch.Tensor:
    """Baked radiance, detached, times the trainable ratio
    (gaussian_model.py:322-324): ``radiances`` trains only through the
    consistency loss, ``radiance_ratio`` through the rendered PBR loss."""
    return torch.nan_to_num(
        params["radiances"].detach() * params["radiance_ratio"], nan=0.0)


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------

def _round_capacity(n: int) -> int:
    cap = 4096
    while cap < n:
        cap *= 2
    return cap


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _expand_bits(v: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of ``v`` (uint32) two zeros apart."""
    v = (v * np.uint32(0x00010001)) & np.uint32(0xFF0000FF)
    v = (v * np.uint32(0x00000101)) & np.uint32(0x0F00F00F)
    v = (v * np.uint32(0x00000011)) & np.uint32(0xC30C30C3)
    v = (v * np.uint32(0x00000005)) & np.uint32(0x49249249)
    return v


def morton_codes(points: np.ndarray) -> np.ndarray:
    """30-bit morton codes of ``points`` [N, 3] normalised into their
    bounding box, x in the highest bit of each triple: float32 arithmetic
    as ``native/svgir_native.cpp`` ``svgir_morton3d`` does it."""
    pts = np.asarray(points, np.float32)
    lo = pts.min(axis=0)
    inv = np.float32(1.0) / np.maximum(pts.max(axis=0) - lo,
                                       np.float32(1e-12))
    v = np.clip((pts - lo) * inv, np.float32(0.0), np.float32(0.99999))
    c = _expand_bits((v * np.float32(1024.0)).astype(np.uint32))
    return (c[:, 0] << np.uint32(2)) | (c[:, 1] << np.uint32(1)) | c[:, 2]


def init_from_points(points, colors, normals=None, *, sh_degree: int = 3,
                     capacity: Optional[int] = None, mean_sq_dist=None,
                     rotation_init: str = "identity",
                     morton_order: bool = False,
                     device="cuda") -> Dict[str, Any]:
    """create_from_pcd (gaussian_model.py:695-735) with padded capacity.

    ``mean_sq_dist``: mean squared distance to the 3 nearest neighbours
    (simple-knn distCUDA2); computed brute-force when not given.
    ``morton_order``: sort the cloud by 30-bit morton code first (the
    spatial order simple-knn applies), so that index-adjacent Gaussians
    stay spatially adjacent and a chunk of the counting binner touches a
    coherent set of tiles.
    """
    if morton_order:
        pts_h = (points.detach().cpu().numpy()
                 if isinstance(points, torch.Tensor) else points)
        order = torch.as_tensor(
            np.argsort(morton_codes(pts_h), kind="stable"))

        def reorder(x):
            if x is None:
                return None
            if isinstance(x, torch.Tensor):
                return x[order.to(x.device)]
            return np.asarray(x)[order.numpy()]
        points, colors, normals, mean_sq_dist = (
            reorder(points), reorder(colors), reorder(normals),
            reorder(mean_sq_dist))
    points = _as_tensor(points, device)
    colors = _as_tensor(colors, device)
    normals = None if normals is None else _as_tensor(normals, device)
    n = points.shape[0]
    cap = capacity or _round_capacity(n)
    k = (sh_degree + 1) ** 2

    if mean_sq_dist is None:
        from svgir_tpu_torch.ops.knn import mean_sq_dist_3nn
        mean_sq_dist = mean_sq_dist_3nn(points)
    dist2 = torch.clamp(_as_tensor(mean_sq_dist, device), min=1e-7)
    scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)

    def pad(x, fill=0.0):
        out = torch.full((cap,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                         device=device)
        out[:n] = x
        return out

    shs = torch.zeros(n, k, 3, device=device)
    shs[:, 0, :] = rgb_to_sh(colors)

    if rotation_init == "normal" and normals is not None:
        rots = normal_to_rotation(normals)
    else:  # reference default: identity (gaussian_model.py:708-709)
        rots = torch.zeros(n, 4, device=device)
        rots[:, 0] = 1.0
    opac = inverse_sigmoid(0.1 * torch.ones(n, 1, device=device))
    if normals is None:
        normals = torch.zeros(n, 3, device=device)

    params = {
        "xyz": pad(points),
        "normal": pad(normals),
        "shs_dc": pad(shs[:, 0:1, :]),
        "shs_rest": pad(shs[:, 1:, :]),
        "scaling": pad(scales),
        "rotation": pad(rots),
        "opacity": pad(opac, fill=-10.0),
    }
    alive = torch.zeros(cap, dtype=torch.bool, device=device)
    alive[:n] = True
    return {"params": params, "alive": alive,
            "stats": init_stats(cap, device=device)}


def pbr_init(cap: int, sh_degree: int = 3,
             device="cuda") -> Dict[str, torch.Tensor]:
    """Per-vertex PBR parameters of the stage-1 -> stage-2 upgrade
    (gaussian_model.py:667-684), all zeros; ``upgrade_to_pbr`` replaces
    ``normal`` by [cap, 12] per-vertex offsets."""
    k = (sh_degree + 1) ** 2
    return {
        "base_color": torch.zeros(cap, 3 * VERTEX_NUM, device=device),
        "roughness": torch.zeros(cap, VERTEX_NUM, device=device),
        "incidents_dc": torch.zeros(cap, 1, 3, device=device),
        "incidents_rest": torch.zeros(cap, k - 1, 3, device=device),
        "visibility_dc": torch.zeros(cap, 1, 1, device=device),
        "visibility_rest": torch.zeros(cap, 15, 1, device=device),
    }


def upgrade_to_pbr(state: Dict[str, Any]) -> Dict[str, Any]:
    """Stage 1 -> stage 2 (create_from_ckpt, from_gs path,
    gaussian_model.py:667-684): add the per-vertex parameters and replace
    the [cap, 3] normal by zeroed [cap, 12] per-vertex offsets.  The new
    tensors go where ``xyz`` lies."""
    params = dict(state["params"])
    cap, dev = params["xyz"].shape[0], params["xyz"].device
    params.update(pbr_init(cap, device=dev))
    params["normal"] = torch.zeros(cap, 3 * VERTEX_NUM, device=dev)
    return {**state, "params": params}


def init_stats(cap: int, device="cuda") -> Dict[str, torch.Tensor]:
    return {
        "xyz_gradient_accum": torch.zeros(cap, 1, device=device),
        "normal_gradient_accum": torch.zeros(cap, 1, device=device),
        "denom": torch.zeros(cap, 1, device=device),
        "weights_accum": torch.zeros(cap, 1, device=device),
        "max_radii2d": torch.zeros(cap, device=device),
    }


def add_densification_stats(stats, mean2d_grad_ndc, update_filter, weights,
                            radii):
    """train.py:194-199 + gaussian_model.py:1270-1276.  ``mean2d_grad_ndc``
    is the screen-position gradient scaled to NDC (x 0.5 W, 0.5 H)."""
    upd = update_filter[:, None]
    zero = torch.zeros((), device=weights.device)
    stats = dict(stats)
    stats["weights_accum"] = stats["weights_accum"] + weights
    stats["xyz_gradient_accum"] = stats["xyz_gradient_accum"] + torch.where(
        upd, mean2d_grad_ndc.norm(dim=-1, keepdim=True), zero)
    stats["denom"] = stats["denom"] + upd.to(torch.float32)
    stats["max_radii2d"] = torch.where(
        update_filter, torch.maximum(stats["max_radii2d"], radii),
        stats["max_radii2d"])
    return stats


def num_alive(state) -> torch.Tensor:
    return state["alive"].sum()


# ---------------------------------------------------------------------------
# densification (gaussian_model.py:1136-1268; train.py:194-209)
# ---------------------------------------------------------------------------

def _free_slots(free: torch.Tensor) -> torch.Tensor:
    """Indices of the True entries of ``free`` in index order, then cap-1
    (``jnp.nonzero(free, size=cap, fill_value=cap - 1)``), without reading
    their count on the host."""
    cap = free.shape[0]
    rank = torch.cumsum(free.to(torch.int64), 0) - 1
    out = torch.full((cap + 1,), cap - 1, dtype=torch.int64,
                     device=free.device)
    # every non-free row writes to the extra entry cap, which is dropped
    out.scatter_(0, torch.where(free, rank, cap),
                 torch.arange(cap, device=free.device))
    return out[:cap]


def _place(x: torch.Tensor, dst: torch.Tensor, src: torch.Tensor):
    """``x`` with rows ``src[i]`` written at ``dst[i]``; rows with
    ``dst == cap`` are dropped (``.at[dst].set(src, mode="drop")``)."""
    out = torch.cat([x, x[:1]])
    out.index_copy_(0, dst, src)
    return out[:x.shape[0]]


@torch.no_grad()
def densify_and_prune(state: Dict[str, Any], opt_state: Dict,
                      noise: Optional[torch.Tensor] = None, *,
                      max_grad: float, min_opacity: float, extent: float,
                      max_screen_size: Optional[float],
                      max_grad_normal: float = 99999.0,
                      percent_dense: float = 0.001,
                      weights_threshold: float = 1e-5, n_split: int = 2,
                      generator: Optional[torch.Generator] = None):
    """Clone, split and prune in one fixed-shape pass
    (gaussian_model.py:1229-1268).

      clone  if |grad| >= max_grad and max(scale) <= percent_dense*extent
      split  if |grad| >= max_grad and max(scale) >  percent_dense*extent
             (``n_split`` children drawn from the Gaussian, scales
             / (0.8 n_split), z log-scale -1e10; the original dies)
      prune  if opacity < min_opacity or weights_accum < weights_threshold
             or, with ``max_screen_size``, radii2d > max_screen_size or
             max(scale) > 0.1 extent

    Clones take the first free slots in index order, then child 0 of each
    split source, then child 1, ...; sources past the free slots are
    dropped and ``report["out_of_capacity"]`` says so.  Placed rows get
    zero Adam moments; the statistics are reset.

    ``noise`` [n_split, cap, 3]: standard-normal draws for the children's
    offsets; drawn with ``generator`` when not given.  Returns (state,
    opt_state, report) with the report's counts as 0-d tensors.
    """
    params, alive, stats = state["params"], state["alive"], state["stats"]
    cap, dev = alive.shape[0], alive.device
    if noise is None:
        noise = torch.randn(n_split, cap, 3, generator=generator, device=dev)

    def mean_grad(accum):
        g = accum / torch.clamp(stats["denom"], min=1e-12)
        return torch.nan_to_num(g[:, 0], nan=0.0)

    grads, grads_n = (mean_grad(stats["xyz_gradient_accum"]),
                      mean_grad(stats["normal_gradient_accum"]))
    scaling = get_scaling(params)
    max_scale = scaling.max(dim=1).values
    hot = ((grads >= max_grad) | (grads_n >= max_grad_normal)) & alive
    small = max_scale <= percent_dense * extent
    clone_mask, split_mask = hot & small, hot & ~small

    # prune the originals; split originals die too
    prune = ((get_opacity(params)[:, 0] < min_opacity)
             | (stats["weights_accum"][:, 0] < weights_threshold))
    if max_screen_size is not None:
        prune |= stats["max_radii2d"] > max_screen_size
        prune |= max_scale > 0.1 * extent
    prune = (prune | split_mask) & alive
    survivors = alive & ~prune
    free = ~survivors
    free_idx = _free_slots(free)
    free_count = free.sum()

    n_clone, n_split_src = clone_mask.sum(), split_mask.sum()
    clone_rank = torch.cumsum(clone_mask.to(torch.int64), 0) - 1
    split_rank = torch.cumsum(split_mask.to(torch.int64), 0) - 1

    def slots(src_mask, slot_rank):
        ok = src_mask & (slot_rank < free_count)
        return torch.where(ok, free_idx[slot_rank.clamp(0, cap - 1)], cap)

    # sources laid out as [clones, child 0 of each split, child 1, ...]
    dst = torch.cat([slots(clone_mask, clone_rank)] + [
        slots(split_mask, n_clone + i * n_split_src + split_rank)
        for i in range(n_split)])
    rot_mat = quat_to_rotmat(get_rotation(params))
    child_xyz = [params["xyz"]
                 + (rot_mat @ (noise[i] * scaling)[..., None])[..., 0]
                 for i in range(n_split)]
    child_scaling = torch.log(scaling / (0.8 * n_split))
    child_scaling[:, 2] = -1e10

    def children(name, x):
        if name == "xyz":
            return child_xyz
        return [child_scaling if name == "scaling" else x] * n_split

    new_params = {k: _place(x, dst, torch.cat([x] + children(k, x)))
                  for k, x in params.items()}
    placed = torch.zeros(cap + 1, dtype=torch.bool, device=dev)
    placed[dst] = True
    placed = placed[:cap]

    def zero_placed(t):
        return t.masked_fill(placed.view((cap,) + (1,) * (t.dim() - 1)), 0)

    new_alive = survivors | placed
    new_opt = {**opt_state,
               "m": {k: zero_placed(v) for k, v in opt_state["m"].items()},
               "v": {k: zero_placed(v) for k, v in opt_state["v"].items()}}
    report = {
        "n_clone": n_clone,
        "n_split": n_split_src,
        "n_prune": (prune & ~split_mask).sum(),
        "n_alive": new_alive.sum(),
        "out_of_capacity": n_clone + n_split * n_split_src > free_count,
    }
    return ({"params": new_params, "alive": new_alive,
             "stats": init_stats(cap, device=dev)}, new_opt, report)


@torch.no_grad()
def reset_opacity(params, opt_state):
    """opacity <- min(opacity, 0.01) and zero its Adam moments
    (gaussian_model.py:886-889, replace_tensor_to_optimizer)."""
    new_opac = inverse_sigmoid(torch.clamp(get_opacity(params), max=0.01))
    zeros = torch.zeros_like(new_opac)
    return ({**params, "opacity": new_opac},
            {**opt_state, "m": {**opt_state["m"], "opacity": zeros},
             "v": {**opt_state["v"], "opacity": zeros.clone()}})


def grow_capacity(state, opt_state, new_cap: int):
    """Pad every per-Gaussian tensor with zero rows (dead, zero moments) to
    ``new_cap`` rows."""
    def pad(x):
        return torch.cat([x, x.new_zeros((new_cap - x.shape[0],)
                                         + tuple(x.shape[1:]))])

    def pad_all(d):
        return {k: pad(v) for k, v in d.items()}

    return ({"params": pad_all(state["params"]), "alive": pad(state["alive"]),
             "stats": pad_all(state["stats"])},
            {**opt_state, "m": pad_all(opt_state["m"]),
             "v": pad_all(opt_state["v"])})


# ---------------------------------------------------------------------------
# scene composition and the neighbourhood regulariser
# ---------------------------------------------------------------------------

def apply_transform(params: Dict[str, torch.Tensor],
                    transform: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Move the model by a 4x4 similarity ``transform`` (set_transform,
    gaussian_model.py:169-193), as relighting.py's scene composition does:
    each row norm of its 3x3 scales the surfels, the row-normalised 3x3
    rotates the normals (when they are [N, 3]) and premultiplies the
    rotations."""
    params = dict(params)
    scale = torch.linalg.norm(transform[:3, :3], dim=-1)      # per-row norm
    params["scaling"] = torch.log(get_scaling(params) * scale)
    ones = torch.ones_like(params["xyz"][:, :1])
    homo = torch.cat([params["xyz"], ones], -1)
    params["xyz"] = (homo @ transform.T)[:, :3]
    rot = transform[:3, :3] / scale[:, None]
    if params["normal"].shape[-1] == 3:
        params["normal"] = params["normal"] @ rot.T
    rot_q = rotmat_to_quat(rot[None])[0]
    params["rotation"] = quat_multiply(rot_q[None], params["rotation"])
    return params


def concatenate_models(states) -> Dict[str, Any]:
    """The alive rows of several models in one state (create_from_gaussians,
    gaussian_model.py:599-611): capacity ``_round_capacity`` of their sum,
    ``radiance_ratio`` from the first, fresh statistics."""
    parts = [{k: v[st["alive"]] for k, v in st["params"].items() if v.dim()}
             for st in states]
    total = sum(p["xyz"].shape[0] for p in parts)
    cap = _round_capacity(total)
    dev = parts[0]["xyz"].device
    params = {}
    for k in parts[0]:
        cat = torch.cat([p[k] for p in parts], 0)
        params[k] = torch.cat([cat, cat.new_zeros((cap - total,)
                                                  + tuple(cat.shape[1:]))])
    if "radiance_ratio" in states[0]["params"]:
        params["radiance_ratio"] = states[0]["params"]["radiance_ratio"]
    alive = torch.arange(cap, device=dev) < total
    return {"params": params, "alive": alive,
            "stats": init_stats(cap, device=dev)}


def knn_regularization_loss(params, alive=None, k: int = 8):
    """get_knn_loss (gaussian_model.py:577-592): the variance of albedo and
    of roughness over each point's k nearest neighbours, averaged; rows
    from ``alive.sum()`` on are padding.  Returns (albedo, roughness)."""
    from svgir_tpu_torch.ops.knn import knn

    n_valid = None if alive is None else alive.sum()
    _, idx = knn(params["xyz"], k=k, n_valid=n_valid)
    albedo = get_base_color(params)[idx]                       # [N, k, 12]
    rough = get_roughness(params)[idx]
    return (albedo.var(dim=1, correction=0).mean(),
            rough.var(dim=1, correction=0).mean())


# ---------------------------------------------------------------------------
# exchange with svgir_tpu (numpy at the boundary)
# ---------------------------------------------------------------------------

def params_from_jax(np_params: Mapping[str, Any],
                    device="cuda") -> Dict[str, torch.Tensor]:
    """Parameter dict of the JAX state (values as numpy arrays, e.g. from
    ``jax.device_get``) -> the same keys as float32 tensors on ``device``.
    Covers the stage-2 groups too, the 0-d ``radiance_ratio`` included."""
    return {k: torch.as_tensor(np.array(v, np.float32), device=device)
            for k, v in np_params.items()}


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Inverse of ``params_from_jax``: tensors -> numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


# ---------------------------------------------------------------------------
# visibility fine-tuning (gaussian_model.py:397-432)
# ---------------------------------------------------------------------------

GRID_FROM = 4096   # surfels from which the bake and visibility use the grid


def finetune_visibility(state, *, iterations: int = 1000, lr: float = 1e-2,
                        directions: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None,
                        use_grid: Optional[bool] = None,
                        log_every: int = 0):
    """Fit the per-surfel visibility SH (degree 3, 16 coefficients, one
    channel) to ray-traced visibility (``GaussianModel.finetune_visibility``).

    Per iteration: one direction per surfel, flipped into its geometric
    normal's hemisphere, origins offset by 0.05 d; the target is the traced
    visibility (``trace_visibility`` semantics, no gradient), the
    prediction clamp(eval_sh + 0.5, 0, 1); masked L1 over the alive rows,
    Adam at ``lr`` on visibility_dc / visibility_rest only.  The raw
    directions (standard normal, before normalising) are ``directions``
    [iterations, N, 3], or drawn from ``generator`` on the state's device.
    The grid tracer runs from 4,096 alive surfels (``use_grid`` forces
    either), its grid chosen from the alive surfels and its steps covering
    the diagonal of all rows' bounding box.  Only the alive rows are traced
    and only the alive surfels tested: a dead row's target reaches no
    gradient and a dead surfel accepts no ray.  Returns the updated state."""
    from svgir_tpu_torch.ops import grid_tracer, tracing
    from svgir_tpu_torch.train import optim
    from svgir_tpu_torch.utils.sh import eval_sh

    params = state["params"]
    alive = state["alive"]
    xyz = params["xyz"]
    n = xyz.shape[0]
    rows = torch.nonzero(alive)[:, 0]
    geo = tracing.build_surfel_geometry(
        xyz[rows], get_scaling(params)[rows], get_rotation(params)[rows],
        get_opacity(params)[rows, 0])
    normal = get_geo_normal(params)
    if use_grid is None:
        use_grid = rows.shape[0] >= GRID_FROM
    if use_grid:
        grid = grid_tracer.build_grid_auto(geo, res=grid_tracer.auto_res(geo))
        m_np = xyz.detach().cpu().numpy()
        diag = float(np.linalg.norm(m_np.max(0) - m_np.min(0))) + 1e-3
        n_steps = grid_tracer._concrete_n_steps(grid, diag)

    vis = {"visibility_dc": params["visibility_dc"],
           "visibility_rest": params["visibility_rest"]}
    opt_state = optim.adam_init(vis)
    lrs = {"visibility_dc": lr, "visibility_rest": lr}
    denom = torch.clamp(alive.sum(), min=1)
    for it in range(iterations):
        raw = directions[it] if directions is not None else torch.randn(
            n, 3, generator=generator, device=xyz.device)
        d = normalize(raw.to(xyz.device))
        flip = (d * normal).sum(-1, keepdim=True) < 0
        d = torch.where(flip, -d, d)
        o = xyz[rows] + 0.05 * d[rows]
        with torch.no_grad():
            if use_grid:
                tr = grid_tracer.trace_visibility_grid(
                    geo, grid, o, d[rows], t_max=diag, n_steps=n_steps)
            else:
                tr = tracing.trace_visibility(geo, o, d[rows])
        target = torch.ones(n, 1, device=xyz.device)
        target[rows] = tr["visibility"]                           # [N, 1]
        vp = {k: v.detach().requires_grad_(True) for k, v in vis.items()}
        sh = torch.cat([vp["visibility_dc"], vp["visibility_rest"]], 1)
        pred = torch.clamp(eval_sh(3, sh.transpose(1, 2), d) + 0.5, 0.0, 1.0)
        err = (target - pred).abs()
        loss = torch.where(alive[:, None], err,
                           torch.zeros_like(err)).sum() / denom
        grads = dict(zip(vp, torch.autograd.grad(loss, list(vp.values()))))
        vis, opt_state = optim.adam_step(
            {k: v.detach() for k, v in vp.items()}, grads, opt_state, lrs)
        if log_every and (it + 1) % log_every == 0:
            print(f"finetune_visibility {it + 1}/{iterations}: "
                  f"L1 {float(loss):.4f}", flush=True)
    return {**state, "params": {**params, **vis}}
