"""Wrappers of the env-map lookup kernel B7 (``svgir_env_lookup_forward``,
``svgir_env_lookup_backward`` in ``csrc/env_lookup.cu``).

Both stage the whole env (or its gradient) in each block's shared memory
where its ``H*W*C*4`` bytes fit what a block may opt in to.  A larger env
(H >= 99 at W = 2H, C = 3: the reference's default H = 128 among them) is
read in place by the forward, and the backward adds into a zero-filled
``d_env`` in device memory with float atomics.
"""

from __future__ import annotations

import ctypes

import torch

from svgir_tpu_torch.kernels import LAUNCHES
from svgir_tpu_torch.kernels.build import (SMEM_OPT_IN_MAX, check, entry,
                                           require, sm_count, stream)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (env, u, v, m, h, w, c, nblocks, out, stream)
_FORWARD = (_P,) * 3 + (_L,) + (_I,) * 4 + (_P,) * 2
# (u, v, g, m, h, w, c, nblocks, partial, d_env, stream)
_BACKWARD = (_P,) * 3 + (_L,) + (_I,) * 4 + (_P,) * 3

# (threads per block, queries per thread, blocks per SM at most) of the
# forward and the backward (csrc/env_lookup.cu): each block stages the env
# (or sums into its own copy of d_env) once, where it fits
FWD_GRID = (512, 4, 2)
BWD_GRID = (1024, 1, 2)


def _check_env(h: int, w: int, c: int) -> None:
    if h < 2 or w < 2 or c < 1:
        raise ValueError(f"env of shape ({h}, {w}, {c}): the bilinear "
                         "lookup needs H >= 2, W >= 2 and C >= 1")


def staged(h: int, w: int, c: int) -> bool:
    """Whether the kernels stage the env in shared memory (else the
    forward reads it in place and the backward adds with atomics)."""
    return h * w * c * 4 <= SMEM_OPT_IN_MAX


def _nblocks(t: torch.Tensor, m: int, grid) -> int:
    threads, per_thread, per_sm = grid
    return max(1, min(-(-m // (threads * per_thread)),
                      per_sm * sm_count(t.device.index)))


def env_lookup_forward(env, u, v):
    """env [H, W, C] f32, pixel coords u, v [M] f32 -> samples [M, C]."""
    h, w, c = env.shape
    m = u.shape[0]
    _check_env(h, w, c)
    require("env", env, torch.float32, (h, w, c))
    require("u", u, torch.float32, (m,))
    require("v", v, torch.float32, (m,))
    out = env.new_empty((m, c))
    rc = entry("env_lookup", "svgir_env_lookup_forward", _FORWARD)(
        env.data_ptr(), u.data_ptr(), v.data_ptr(), m, h, w, c,
        _nblocks(env, m, FWD_GRID), out.data_ptr(), stream(env))
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
    nb = _nblocks(g, m, BWD_GRID)
    if staged(h, w, c):
        partial = torch.empty(nb, h * w * c, dtype=torch.float32,
                              device=g.device)
        d_env = torch.empty(h, w, c, dtype=torch.float32, device=g.device)
    else:   # no scratch: the queries add into d_env
        partial = None
        d_env = torch.zeros(h, w, c, dtype=torch.float32, device=g.device)
    rc = entry("env_lookup", "svgir_env_lookup_backward", _BACKWARD)(
        u.data_ptr(), v.data_ptr(), g.data_ptr(), m, h, w, c, nb,
        partial.data_ptr() if partial is not None else None,
        d_env.data_ptr(), stream(g))
    check(rc, "svgir_env_lookup_backward")
    LAUNCHES["env_lookup_backward"] += 1
    return d_env
