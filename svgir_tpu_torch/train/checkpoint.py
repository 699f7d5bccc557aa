"""Checkpoints and PLY interop, in the layouts of
``svgir_tpu.train.checkpoint`` so that either package reads the other's
files.

* Checkpoints: the state, optimizer, env-map and extra (the stage-2 bake)
  trees flattened into one ``.npz`` under ``/``-joined keys
  (``state/params/xyz``, ``opt/m/xyz``, ``opt/step``, ``env/params/env``,
  ``extra/radiance``) with the iteration under ``__iteration__``.
* PLY: the reference's column layout (construct_list_of_attributes,
  gaussian_model.py:825-884).  Like ``svgir_tpu``, ``load_model_ply``
  reads roughness from the ``roughness_*`` columns (the reference's
  load_ply reads the ``normal_*`` ones, gaussian_model.py:955-960).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from svgir_tpu_torch.data.ply import read_ply, write_ply
from svgir_tpu_torch.models import gaussians as G

# ---------------------------------------------------------------------------
# npz checkpoints
# ---------------------------------------------------------------------------


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}/{k}", out)
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree.detach().cpu().numpy()
    elif isinstance(tree, int):
        out[prefix] = np.int32(tree)     # Adam's step, int32 in svgir_tpu
    else:
        out[prefix] = np.asarray(tree)


def _unflatten(flat: Dict[str, np.ndarray], device) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.strip("/").split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if value.ndim == 0 and value.dtype.kind in "iu":
            node[parts[-1]] = int(value)
        else:
            node[parts[-1]] = torch.as_tensor(value, device=device)
    return tree


def save_checkpoint(path: str, iteration: int, state: Dict, opt_state: Dict,
                    env: Optional[Dict] = None,
                    extra: Optional[Dict] = None) -> None:
    flat: Dict[str, np.ndarray] = {"__iteration__": np.int64(iteration)}
    _flatten(state, "state", flat)
    _flatten(opt_state, "opt", flat)
    if env is not None:
        _flatten(env, "env", flat)
    if extra is not None:
        _flatten(extra, "extra", flat)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)


def load_checkpoint(path: str, device="cuda") -> Tuple[int, Dict]:
    """(iteration, tree) with every array a tensor on ``device`` and every
    0-d integer (Adam's step) a Python int."""
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    iteration = int(flat.pop("__iteration__"))
    return iteration, _unflatten(flat, device)


# ---------------------------------------------------------------------------
# reference-layout PLY
# ---------------------------------------------------------------------------

def save_model_ply(path: str, params: Dict, alive: Optional[torch.Tensor],
                   use_pbr: bool = False) -> None:
    """save_ply (gaussian_model.py:855-884): the raw (pre-activation)
    parameters of the alive rows; nx/ny/nz carry the geometric normal."""
    sel = alive.cpu().numpy() if alive is not None else slice(None)

    def np_(x):
        return x.detach().cpu().numpy()[sel].astype(np.float32)

    cols: Dict[str, np.ndarray] = {}
    xyz = np_(params["xyz"])
    n = len(xyz)
    for i, ax in enumerate("xyz"):
        cols[ax] = xyz[:, i]
    geo_n = np_(G.get_geo_normal(params))
    for i, ax in enumerate(["nx", "ny", "nz"]):
        cols[ax] = geo_n[:, i]

    def flat_sh(x):
        # explicit column count: reshape(n, -1) fails when n == 0
        x = np_(x).transpose(0, 2, 1)
        return x.reshape(n, x.shape[1] * x.shape[2])

    def add(prefix, arr):
        for i in range(arr.shape[1]):
            cols[f"{prefix}_{i}"] = arr[:, i]

    add("f_dc", flat_sh(params["shs_dc"]))
    add("f_rest", flat_sh(params["shs_rest"]))
    cols["opacity"] = np_(params["opacity"])[:, 0]
    add("scale", np_(params["scaling"]))
    add("rot", np_(params["rotation"]))
    if use_pbr:
        add("base_color", np_(params["base_color"]))
        add("normal", np_(params["normal"]))
        add("roughness", np_(params["roughness"]))
        for name in ("incidents_dc", "incidents_rest", "visibility_dc",
                     "visibility_rest"):
            add(name, flat_sh(params[name]))
    write_ply(path, cols)


def load_model_ply(path: str, sh_degree: int = 3,
                   capacity: Optional[int] = None, device="cuda") -> Dict:
    """load_ply (gaussian_model.py:891-1003) -> a padded model state on
    ``device``."""
    v = read_ply(path)
    n = len(v["x"])
    k = (sh_degree + 1) ** 2

    def grab(prefix, count):
        return np.stack([v[f"{prefix}_{i}"] for i in range(count)], -1)

    def sh(prefix, channels, count):
        # channel-major columns -> [n, count, channels]
        return grab(prefix, channels * count).reshape(
            n, channels, count).transpose(0, 2, 1)

    params = {
        "xyz": np.stack([v["x"], v["y"], v["z"]], -1),
        "shs_dc": sh("f_dc", 3, 1),
        "shs_rest": sh("f_rest", 3, k - 1),
        "opacity": v["opacity"][:, None],
        "scaling": grab("scale", 3),
        "rotation": grab("rot", 4),
    }
    if "base_color_0" in v:
        params.update({
            "base_color": grab("base_color", 12),
            "normal": grab("normal", 12),
            "roughness": grab("roughness", 4),
            "incidents_dc": sh("incidents_dc", 3, 1),
            "incidents_rest": sh("incidents_rest", 3, k - 1),
            "visibility_dc": sh("visibility_dc", 1, 1),
            "visibility_rest": sh("visibility_rest", 1, 15),
        })
    else:
        params["normal"] = np.stack([v["nx"], v["ny"], v["nz"]], -1)

    cap = capacity or G._round_capacity(n)

    def pad(x):
        out = torch.zeros((cap,) + x.shape[1:], dtype=torch.float32,
                          device=device)
        out[:n] = torch.as_tensor(np.ascontiguousarray(x, np.float32),
                                  device=device)
        return out

    alive = torch.zeros(cap, dtype=torch.bool, device=device)
    alive[:n] = True
    return {"params": {k2: pad(p) for k2, p in params.items()},
            "alive": alive, "stats": G.init_stats(cap, device=device)}
