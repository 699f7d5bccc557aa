"""Wrappers of the consistency loss's one-bounce kernels
(``svgir_consistency_forward``, ``svgir_consistency_backward`` in
``csrc/consistency.cu``): ``models.radiance.irradiance_sample`` on CUDA
tensors, reading the hit rows of the bake and the material in place.

One warp a query (surfel); queries whose hit is < 0 write 0 and, in the
backward, add nothing, nor do queries whose cotangent row is zero.  The
backward adds into zero-filled gradients with float32 atomics.
"""

from __future__ import annotations

import ctypes

import torch

from svgir_tpu_torch.kernels import LAUNCHES
from svgir_tpu_torch.kernels.build import check, entry, require, stream

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (dirs, hit_idx, uv, env_term, normals, albedo, roughness, pri_dir, hit,
#  m, n, s, irr, stream)
_FORWARD = (_P,) * 9 + (_L, _L, _I) + (_P,) * 2
# (the same nine, d_irr, m, n, s, d_env, d_albedo, d_roughness, stream)
_BACKWARD = (_P,) * 10 + (_L, _L, _I) + (_P,) * 4


def _check(dirs, hit_idx, uv, env_term, normals, albedo, roughness, pri_dir,
           hit):
    n, s = hit_idx.shape
    m = hit.shape[0]
    require("incident_dirs", dirs, torch.float32, (n, s, 3))
    require("hit_idx", hit_idx, torch.int32, (n, s))
    require("uv", uv, torch.float32, (n, s, 2))
    require("env_term", env_term, torch.float32, (n, s, 3))
    require("vertex_normals", normals, torch.float32, (n, 4, 3))
    require("vertex_albedo", albedo, torch.float32, (n, 4, 3))
    require("roughness", roughness, torch.float32, (n,))
    require("pri_dir", pri_dir, torch.float32, (m, 3))
    require("hit", hit, torch.int32, (m,))
    return m, n, s


def _ptrs(*ts):
    return [t.data_ptr() for t in ts]


def consistency_forward(dirs, hit_idx, uv, env_term, normals, albedo,
                        roughness, pri_dir, hit):
    """Bake rows dirs [N, S, 3], hit_idx [N, S] int32, uv [N, S, 2];
    env_term [N, S, 3], vertex normals and albedo [N, 4, 3], roughness
    [N]; queries pri_dir [M, 3], hit [M] int32 -> irradiance [M, 3]."""
    ins = (dirs, hit_idx, uv, env_term, normals, albedo, roughness, pri_dir,
           hit)
    m, n, s = _check(*ins)
    irr = env_term.new_empty((m, 3))
    rc = entry("consistency", "svgir_consistency_forward", _FORWARD)(
        *_ptrs(*ins), m, n, s, irr.data_ptr(), stream(env_term))
    check(rc, "svgir_consistency_forward")
    LAUNCHES["consistency_forward"] += 1
    return irr


def consistency_backward(dirs, hit_idx, uv, env_term, normals, albedo,
                         roughness, pri_dir, hit, d_irr):
    """The forward's inputs and the cotangent d_irr [M, 3] -> (d_env_term
    [N, S, 3], d_albedo [N, 4, 3], d_roughness [N])."""
    ins = (dirs, hit_idx, uv, env_term, normals, albedo, roughness, pri_dir,
           hit)
    m, n, s = _check(*ins)
    require("d_irr", d_irr, torch.float32, (m, 3))
    # the warps add into them
    d_env = torch.zeros_like(env_term)
    d_albedo = torch.zeros_like(albedo)
    d_rough = torch.zeros_like(roughness)
    rc = entry("consistency", "svgir_consistency_backward", _BACKWARD)(
        *_ptrs(*ins, d_irr), m, n, s, d_env.data_ptr(), d_albedo.data_ptr(),
        d_rough.data_ptr(), stream(env_term))
    check(rc, "svgir_consistency_backward")
    LAUNCHES["consistency_backward"] += 1
    return d_env, d_albedo, d_rough
