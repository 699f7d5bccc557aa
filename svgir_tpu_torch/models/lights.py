"""Light models: the learnable environment map of stage 2 and the fixed
HDR light of relighting.

Reference: ``scene/direct_light_map.py`` and ``svgir_tpu.models.lights``.
DirectLightMap: an H x 2H equirect map, softplus activation,
``grid_sample`` (align_corners) lookup x 2.0, its own Adam, a 2x bilinear
upsample of the map and its moments.  EnvLight (``scene/envmap.py``): a
fixed HDR map, downsampled to 32 x 64 for the lookups, no x2 factor.  Every
lookup is kernel B7 (``ops/env_lookup_pallas.py``), differentiable with
respect to the env only.  The spherical-gaussian, SH and gamma lights of
the reference (unused by its recipes) are here too.

Resizing follows ``jax.image.resize`` with its ``"linear"`` method: a
triangle kernel, widened by the scale when it downsamples (antialiasing),
weights renormalised where the kernel leaves the image, applied as two
small matrices (``_resize_weights``, ``resize_linear``).
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from svgir_tpu_torch.ops.env_lookup_pallas import bilinear_lookup
from svgir_tpu_torch.train import optim
from svgir_tpu_torch.utils.graphics import srgb_to_rgb
from svgir_tpu_torch.utils.sh import eval_sh


def _bilinear_lookup(img: torch.Tensor, u: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """align_corners bilinear sample of img [H, W, C] at pixel coordinates
    u, v [...] (u in [0, W-1], v in [0, H-1]) -> [..., C]."""
    shape = u.shape
    out = bilinear_lookup(img, u.reshape(-1), v.reshape(-1))
    return out.reshape(*shape, img.shape[2])


def equirect_grid_coords(dirs: torch.Tensor):
    """(qx, qy) grid coordinates in [-1, 1] of unit ``dirs`` [..., 3]
    (direct_light_map.py:70-83): phi = arccos(z) - 1e-6,
    theta = atan2(y, x), qx = -theta/pi, qy = phi/pi*2 - 1.  A bake
    stores them for its constant incident directions (``incident_qxy``)."""
    z = torch.clamp(dirs[..., 2], -1.0, 1.0)
    phi = torch.arccos(z) - 1e-6
    theta = torch.atan2(dirs[..., 1], dirs[..., 0])
    return -theta / math.pi, (phi / math.pi) * 2 - 1


def _equirect_query(dirs: torch.Tensor, h: int, w: int):
    """Pixel-coordinate equirect query (align_corners)."""
    qx, qy = equirect_grid_coords(dirs)
    return (qx + 1) * 0.5 * (w - 1), (qy + 1) * 0.5 * (h - 1)


def env_light_direct_qxy(state, qx: torch.Tensor,
                         qy: torch.Tensor) -> torch.Tensor:
    """``env_light_direct`` from precomputed grid coordinates; valid only
    for a light without a direction transform."""
    env = state["lookup"]
    h, w = env.shape[0], env.shape[1]
    return _bilinear_lookup(env, (qx + 1) * 0.5 * (w - 1),
                            (qy + 1) * 0.5 * (h - 1))


def env_activated(params) -> torch.Tensor:
    """softplus activation (direct_light_map.py:103-106): [H, W, 3]."""
    return F.softplus(params["env"])


def direct_light_qxy(params, qx: torch.Tensor,
                     qy: torch.Tensor) -> torch.Tensor:
    """``direct_light`` from precomputed grid coordinates."""
    env = env_activated(params)
    h, w = env.shape[0], env.shape[1]
    return _bilinear_lookup(env, (qx + 1) * 0.5 * (w - 1),
                            (qy + 1) * 0.5 * (h - 1)) * 2.0


def direct_light(params, dirs: torch.Tensor) -> torch.Tensor:
    """Radiance lookup x 2.0 (direct_light_map.py:70-83)."""
    env = env_activated(params)
    u, v = _equirect_query(dirs, env.shape[0], env.shape[1])
    return _bilinear_lookup(env, u, v) * 2.0


def direct_light_map_init(h: int = 128, light_init: float = 0.5, *,
                          generator: Optional[torch.Generator] = None,
                          device="cuda") -> Dict[str, Any]:
    """env ~ light_init * U[0, 1), shape [H, 2H, 3]
    (direct_light_map.py:11-16), with its Adam state.  The draw comes from
    ``generator`` (on ``device``)."""
    env = light_init * torch.rand(h, 2 * h, 3, generator=generator,
                                  device=device)
    params = {"env": env}
    return {"params": params, "opt": optim.adam_init(params)}


def direct_light_map_step(state: Dict, grads: Dict, env_lr: float) -> Dict:
    params, opt_state = optim.adam_step(state["params"], grads, state["opt"],
                                        {"env": env_lr})
    return {"params": params, "opt": opt_state}


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] float32 weights of ``jax.image.resize``'s linear
    method along one axis (``compute_weight_mat`` in jax/_src/image/
    scale.py): output sample i sits at input coordinate (i + 0.5) / scale
    - 0.5; a triangle kernel, widened by 1 / scale when downsampling;
    each column normalised to sum 1 (zero where the sum is below 1000
    float32 epsilons or the sample lies outside the input)."""
    scale = n_out / n_in
    inv = torch.tensor(1.0 / scale, dtype=torch.float32, device=device)
    kscale = torch.clamp(inv, min=1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * inv - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32,
                                        device=device)[:, None]).abs() / kscale
    w = torch.clamp(1 - x, min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_linear(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """img [H, W, C] resized to [h, w, C] as ``jax.image.resize(img, (h, w,
    C), "linear")`` (antialiased when downsampling): two small matrix
    products, rows then columns, in float32."""
    x = img.to(torch.float32)
    if h != x.shape[0]:
        wr = _resize_weights(x.shape[0], h, x.device)
        x = torch.einsum("hwc,ho->owc", x, wr)
    if w != x.shape[1]:
        wc = _resize_weights(x.shape[1], w, x.device)
        x = torch.einsum("hwc,wo->hoc", x, wc)
    return x


def direct_light_map_upsample(state: Dict) -> Dict:
    """Bilinear 2x upsample of the env and its Adam moments
    (direct_light_map.py:85-101); the step count carries over."""
    def up(x):
        return resize_linear(x, 2 * x.shape[0], 2 * x.shape[1])

    return {"params": {"env": up(state["params"]["env"])},
            "opt": {"m": {"env": up(state["opt"]["m"]["env"])},
                    "v": {"env": up(state["opt"]["v"]["env"])},
                    "step": state["opt"]["step"]}}


# ---------------------------------------------------------------------------
# EnvLight: a fixed HDR environment (relighting)
# ---------------------------------------------------------------------------

def load_hdr(path: str) -> np.ndarray:
    """A light map as float32 RGB [H, W, 3] (envmap.py:37-62), read by
    OpenCV: ``.hdr`` and ``.exr`` as the linear floats they store, a PNG
    divided by 255 when its largest value is past 1.5 and taken from sRGB
    to linear, other formats as stored.  (The JAX package reads through
    imageio, whose OpenCV plugin returns ``.hdr`` files as 8-bit values
    clipped at 1.0: ROADMAP hazard 10.)"""
    import cv2

    if path.lower().endswith(".exr"):
        os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise ValueError(f"{path}: OpenCV could not read the light map")
    img = np.asarray(img).astype(np.float32)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    img = np.ascontiguousarray(img[..., 2::-1])          # BGR(A) -> RGB
    if path.lower().endswith(".png"):
        img = img / 255.0 if img.max() > 1.5 else img
        img = srgb_to_rgb(torch.as_tensor(img)).numpy()
    return img


def env_light_init(envmap, scale: float = 1.0, lookup_res=(32, 64),
                   transform=None, device="cuda") -> Dict[str, Any]:
    """A fixed HDR light: the full map times ``scale`` and its lookup copy
    resized to ``lookup_res`` (envmap.py:63-71; 32 x 64 is the relighting
    evaluation's), on ``device``.  ``transform`` [3, 3] rotates the lookup
    directions."""
    full = torch.as_tensor(np.asarray(envmap, np.float32),
                           device=device) * scale
    small = resize_linear(full, *lookup_res)
    return {"envmap": full, "lookup": small.contiguous(),
            "transform": None if transform is None else torch.as_tensor(
                np.asarray(transform, np.float32), device=device)}


def env_light_direct(state: Dict, dirs: torch.Tensor) -> torch.Tensor:
    """Radiance of the fixed light along ``dirs`` [..., 3] from its lookup
    copy; no x2 factor (envmap.py)."""
    if state.get("transform") is not None:
        dirs = dirs @ state["transform"].T
    env = state["lookup"]
    u, v = _equirect_query(dirs, env.shape[0], env.shape[1])
    return _bilinear_lookup(env, u, v)


# ---------------------------------------------------------------------------
# Spherical-gaussian, SH and gamma lights (scene/direct_light_sg.py,
# scene/derect_light_sh.py, scene/gamma_trans.py: in the reference, unused
# by its recipes)
# ---------------------------------------------------------------------------

def direct_light_sg_init(num_sgs: int = 32, *,
                         generator: Optional[torch.Generator] = None,
                         device="cuda") -> Dict[str, Any]:
    """A learnable mixture of spherical gaussians: unit lobe axes, sharpness
    U[0, 2), amplitude U[0, 1) (both through softplus in the lookup); the
    draws come from ``generator``."""
    axis = torch.randn(num_sgs, 3, generator=generator, device=device)
    axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
    params = {
        "sg_axis": axis,
        "sg_sharpness": 2.0 * torch.rand(num_sgs, 1, generator=generator,
                                         device=device),
        "sg_amplitude": torch.rand(num_sgs, 3, generator=generator,
                                   device=device),
    }
    return {"params": params, "opt": optim.adam_init(params)}


def direct_light_sg(params, dirs: torch.Tensor) -> torch.Tensor:
    """Radiance = sum_i mu_i exp(lambda_i (axis_i . d - 1))."""
    axis = params["sg_axis"] / torch.linalg.norm(params["sg_axis"], dim=-1,
                                                 keepdim=True)
    lam = F.softplus(params["sg_sharpness"])
    mu = F.softplus(params["sg_amplitude"])
    cos = torch.einsum("...d,kd->...k", dirs, axis)          # [..., K]
    return torch.exp(lam[:, 0] * (cos - 1.0)) @ mu


def direct_light_sh_init(deg: int = 2, *,
                         generator: Optional[torch.Generator] = None,
                         device="cuda") -> Dict[str, Any]:
    """A learnable global SH environment, 0.1 N(0, 1) coefficients [3, K]."""
    k = (deg + 1) ** 2
    params = {"sh": 0.1 * torch.randn(3, k, generator=generator,
                                      device=device)}
    return {"params": params, "opt": optim.adam_init(params), "deg": deg}


def direct_light_sh(params, dirs: torch.Tensor, deg: int = 2) -> torch.Tensor:
    return torch.clamp(eval_sh(deg, params["sh"], dirs), min=0.0)


def gamma_correct(img: torch.Tensor, gamma_params=None) -> torch.Tensor:
    """img ** (1 / softplus(gamma)), or ** (1 / 2.2) without parameters
    (scene/gamma_trans.py)."""
    g = F.softplus(gamma_params["gamma"]) if gamma_params else 2.2
    return torch.pow(torch.clamp(img, min=1e-8), 1.0 / g)


def params_from_jax(np_params: Mapping[str, Any],
                    device="cuda") -> Dict[str, torch.Tensor]:
    """A ``svgir_tpu`` light's parameters (SG, SH, gamma; values as numpy
    arrays) -> tensors on ``device``."""
    return {k: torch.as_tensor(np.array(v, np.float32), device=device)
            for k, v in np_params.items()}


def env_light_from_jax(np_state: Mapping[str, Any],
                       device="cuda") -> Dict[str, Any]:
    """A ``svgir_tpu`` EnvLight state (numpy arrays) -> the same state as
    tensors on ``device``."""
    t = np_state.get("transform")
    return {"envmap": torch.as_tensor(np.array(np_state["envmap"],
                                               np.float32), device=device),
            "lookup": torch.as_tensor(np.array(np_state["lookup"],
                                               np.float32), device=device),
            "transform": None if t is None else torch.as_tensor(
                np.array(t, np.float32), device=device)}


def env_state_from_jax(np_state: Mapping[str, Any],
                       device="cuda") -> Dict[str, Any]:
    """A ``svgir_tpu`` DirectLightMap state (values as numpy arrays, e.g.
    from ``jax.device_get``) -> the same state as tensors on ``device``."""
    def tensors(d):
        return {k: torch.as_tensor(np.array(v, np.float32), device=device)
                for k, v in d.items()}
    opt = np_state["opt"]
    return {"params": tensors(np_state["params"]),
            "opt": {"m": tensors(opt["m"]), "v": tensors(opt["v"]),
                    "step": int(opt["step"])}}

