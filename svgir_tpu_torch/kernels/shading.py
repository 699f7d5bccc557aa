"""Wrappers of stage 2's per-vertex shading kernels
(``svgir_shading_forward``, ``svgir_shading_backward`` in
``csrc/shading.cu``): ``ops.shading.shade_train`` on CUDA tensors.

One warp a row (surfel), lanes over the S samples, every sum over S by a
fixed shuffle tree: no atomics, no zero fill.  The backward writes every
gradient whole; a row whose cotangent is all zero gets zeros.
"""

from __future__ import annotations

import ctypes

import torch

from svgir_tpu_torch.kernels import LAUNCHES
from svgir_tpu_torch.kernels.build import check, entry, require, stream

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (base_color, roughness, normals, viewdirs, radiance, env_radiance,
#  visibility, incident_dirs, incident_areas, n, s, pbr, diffuse_light,
#  stream)
_FORWARD = (_P,) * 9 + (_L, _I) + (_P,) * 3
# (the same nine, d_pbr, d_diffuse_light, n, s, d_base_color, d_roughness,
#  d_normals, d_viewdirs, d_radiance, d_env_radiance, stream)
_BACKWARD = (_P,) * 11 + (_L, _I) + (_P,) * 7


def _check(base_color, roughness, normals, viewdirs, radiance, env_radiance,
           visibility, incident_dirs, incident_areas):
    n, s = radiance.shape[:2]
    require("base_color", base_color, torch.float32, (n, 12))
    require("roughness", roughness, torch.float32, (n, 4))
    require("normals", normals, torch.float32, (n, 4, 3))
    require("viewdirs", viewdirs, torch.float32, (n, 3))
    require("radiance", radiance, torch.float32, (n, s, 3))
    require("env_radiance", env_radiance, torch.float32, (n, s, 3))
    require("visibility", visibility, torch.float32, (n, s, 1))
    require("incident_dirs", incident_dirs, torch.float32, (n, s, 3))
    require("incident_areas", incident_areas, torch.float32, (n, s, 1))
    return n, s


def _ptrs(*ts):
    return [t.data_ptr() for t in ts]


def shading_forward(*ins):
    """The nine inputs of ``ops.shading.shade_train`` -> (pbr [N, 12],
    diffuse_light [N, 12])."""
    n, s = _check(*ins)
    pbr = ins[0].new_empty((n, 12))
    dl = ins[0].new_empty((n, 12))
    rc = entry("shading", "svgir_shading_forward", _FORWARD)(
        *_ptrs(*ins), n, s, pbr.data_ptr(), dl.data_ptr(), stream(pbr))
    check(rc, "svgir_shading_forward")
    LAUNCHES["shading_forward"] += 1
    return pbr, dl


def shading_backward(*args):
    """The nine inputs and the cotangents d_pbr, d_diffuse_light [N, 12] ->
    (d_base_color, d_roughness, d_normals, d_viewdirs, d_radiance,
    d_env_radiance), each shaped as its input."""
    ins, (d_pbr, d_dl) = args[:9], args[9:]
    n, s = _check(*ins)
    require("d_pbr", d_pbr, torch.float32, (n, 12))
    require("d_diffuse_light", d_dl, torch.float32, (n, 12))
    grads = [torch.empty_like(t) for t in ins[:6]]
    rc = entry("shading", "svgir_shading_backward", _BACKWARD)(
        *_ptrs(*ins, d_pbr, d_dl), n, s, *_ptrs(*grads), stream(d_pbr))
    check(rc, "svgir_shading_backward")
    LAUNCHES["shading_backward"] += 1
    return tuple(grads)
