"""Wrappers of the env-map lookup kernel B7 (``svgir_env_lookup_forward``,
``svgir_env_lookup_backward`` in ``csrc/env_lookup.cu``).

The forward stages the whole env in each block's shared memory where its
``H*W*C*4`` bytes fit what a block may opt in to, and reads a larger env
(H >= 99 at W = 2H, C = 3: H = 128, the default argument of
``direct_light_map_init``, among them; the configuration's default is 16,
the training recipe's 32) in place.  The backward sums into copies of
``d_env`` in shared memory: a copy a warp where a block holds 8 or more,
else a copy a block, or slices of it where it does not fit
(``backward_plan``); either way the blocks add their sums into a
zero-filled ``d_env``.
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
# (u, v, g, m, h, w, c, nblocks, parts, part_floats, warps, d_env, stream)
_BACKWARD = (_P,) * 3 + (_L,) + (_I,) * 7 + (_P,) * 2

# (threads per block, queries per thread, blocks per SM at most) of the
# forward and the backward (csrc/env_lookup.cu): each block stages the env
# (or sums into its own copy of d_env) once, where it fits
FWD_GRID = (512, 4, 2)
BWD_GRID = (1024, 1, 2)
BWD_WARP_COPIES = 8      # copies of d_env (and a byte per texel) a block
                         # must hold to give each warp its own (else one
                         # copy a block, shared atomics)
BWD_WARPS_MAX = 16       # warps of a block that each hold a copy
BWD_WARP_QUERIES = 256   # a warp's window of queries (8 a lane)
SMEM_PER_SM = 233_472    # bytes of shared memory on an SM (228 KB)
SMEM_PER_BLOCK = 1_024   # of it reserved for each resident block


def _check_env(h: int, w: int, c: int) -> None:
    if h < 2 or w < 2 or c < 1:
        raise ValueError(f"env of shape ({h}, {w}, {c}): the bilinear "
                         "lookup needs H >= 2, W >= 2 and C >= 1")


def backward_plan(h: int, w: int, c: int, m: int, sms: int) -> dict:
    """How the backward holds d_env and sizes its grid, from the env's
    shape, the query count and the card's SM count (``csrc/env_lookup.cu``).

    d_env is cut into ``parts`` slices of ``part_floats`` floats (a
    multiple of 4).  Where a block holds ``BWD_WARP_COPIES`` copies or more
    (one part, each copy with a byte per texel), ``warps`` of its warps
    each hold one, one block an SM.  Else ``warps`` is 0 and each block of
    ``BWD_GRID`` threads holds one slice, ``blocks`` a multiple of
    ``parts`` (each group of ``parts`` blocks reads the same queries).
    ``smem`` is the bytes of shared memory a block takes, ``per_sm`` the
    blocks an SM holds."""
    hwc = h * w * c
    parts = -(-hwc * 4 // SMEM_OPT_IN_MAX)
    part_floats = -(-hwc // (4 * parts)) * 4
    per_warp = part_floats * 4 + -(-h * w // 16) * 16
    copies = SMEM_OPT_IN_MAX // per_warp
    if copies >= BWD_WARP_COPIES:
        warps = min(BWD_WARPS_MAX, copies)
        blocks = max(1, min(-(-m // (warps * BWD_WARP_QUERIES)), sms))
        return {"parts": 1, "part_floats": part_floats, "warps": warps,
                "blocks": blocks, "smem": warps * per_warp, "per_sm": 1}
    smem = part_floats * 4
    threads, per_thread, most = BWD_GRID
    per_sm = max(1, min(most, SMEM_PER_SM // (smem + SMEM_PER_BLOCK)))
    groups = max(1, -(-m // (threads * per_thread)))
    blocks = max(1, min(groups, per_sm * sms // parts)) * parts
    return {"parts": parts, "part_floats": part_floats, "warps": 0,
            "blocks": blocks, "smem": smem, "per_sm": per_sm}


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
    plan = backward_plan(h, w, c, m, sm_count(g.device.index))
    # the blocks add their sums into it
    d_env = torch.zeros(h, w, c, dtype=torch.float32, device=g.device)
    rc = entry("env_lookup", "svgir_env_lookup_backward", _BACKWARD)(
        u.data_ptr(), v.data_ptr(), g.data_ptr(), m, h, w, c, plan["blocks"],
        plan["parts"], plan["part_floats"], plan["warps"], d_env.data_ptr(),
        stream(g))
    check(rc, "svgir_env_lookup_backward")
    LAUNCHES["env_lookup_backward"] += 1
    return d_env
