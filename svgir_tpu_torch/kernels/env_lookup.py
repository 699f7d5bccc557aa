"""Wrappers of the env-map lookup kernel B7 (``svgir_env_lookup_forward``,
``svgir_env_lookup_backward`` in ``csrc/env_lookup.cu``).

Both stage the whole env (or its gradient) in one block's shared memory,
so an env whose ``H*W*C*4`` bytes exceed what a block may opt in to is
refused here with a clear error, before anything is built or launched.
"""

from __future__ import annotations

import ctypes

import torch

from svgir_tpu_torch.kernels import LAUNCHES
from svgir_tpu_torch.kernels.build import check, library, require, stream

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

SMEM_OPT_IN_MAX = 232_448   # bytes of shared memory a Hopper block may use
THREADS = 1024              # threads per block (csrc/env_lookup.cu)


def _lib() -> ctypes.CDLL:
    lib = library("env_lookup")
    # (env, u, v, m, h, w, c, nblocks, out, stream)
    lib.svgir_env_lookup_forward.argtypes = [_P] * 3 + [_L] + [_I] * 4 + \
        [_P, _P]
    lib.svgir_env_lookup_forward.restype = _I
    # (u, v, g, m, h, w, c, nblocks, partial, d_env, stream)
    lib.svgir_env_lookup_backward.argtypes = [_P] * 3 + [_L] + [_I] * 4 + \
        [_P] * 3
    lib.svgir_env_lookup_backward.restype = _I
    return lib


def _check_env(h: int, w: int, c: int) -> None:
    if h < 2 or w < 2 or c < 1:
        raise ValueError(f"env of shape ({h}, {w}, {c}): the bilinear "
                         "lookup needs H >= 2, W >= 2 and C >= 1")
    nbytes = h * w * c * 4
    if nbytes > SMEM_OPT_IN_MAX:
        raise ValueError(
            f"env of shape ({h}, {w}, {c}) needs {nbytes} bytes of shared "
            f"memory, more than the {SMEM_OPT_IN_MAX} a block may opt in to")


def _nblocks(t: torch.Tensor, m: int) -> int:
    """Two blocks per SM at most: each block stages the env once."""
    sms = torch.cuda.get_device_properties(t.device).multi_processor_count
    return max(1, min(-(-m // THREADS), 2 * sms))


def env_lookup_forward(env, u, v):
    """env [H, W, C] f32, pixel coords u, v [M] f32 -> samples [M, C]."""
    h, w, c = env.shape
    m = u.shape[0]
    _check_env(h, w, c)
    require("env", env, torch.float32, (h, w, c))
    require("u", u, torch.float32, (m,))
    require("v", v, torch.float32, (m,))
    out = torch.empty(m, c, dtype=torch.float32, device=env.device)
    rc = _lib().svgir_env_lookup_forward(
        env.data_ptr(), u.data_ptr(), v.data_ptr(), m, h, w, c,
        _nblocks(env, m), out.data_ptr(), stream(env))
    check(rc, "svgir_env_lookup_forward")
    LAUNCHES["env_lookup_forward"] += 1
    return out


def env_lookup_backward(u, v, g, *, h: int, w: int):
    """Cotangents g [M, C] at pixel coords u, v [M] -> d_env [H, W, C]."""
    m, c = g.shape
    _check_env(h, w, c)
    require("u", u, torch.float32, (m,))
    require("v", v, torch.float32, (m,))
    require("g", g, torch.float32, (m, c))
    nb = _nblocks(g, m)
    partial = torch.empty(nb, h * w * c, dtype=torch.float32, device=g.device)
    d_env = torch.empty(h, w, c, dtype=torch.float32, device=g.device)
    rc = _lib().svgir_env_lookup_backward(
        u.data_ptr(), v.data_ptr(), g.data_ptr(), m, h, w, c, nb,
        partial.data_ptr(), d_env.data_ptr(), stream(g))
    check(rc, "svgir_env_lookup_backward")
    LAUNCHES["env_lookup_backward"] += 1
    return d_env
