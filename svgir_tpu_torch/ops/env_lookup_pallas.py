"""Env-map lookup B7: align_corners bilinear sample of an env [H, W, C] at M
pixel coordinates, and its gradient with respect to the env, each with its
plain PyTorch version.

Named after ``svgir_tpu/ops/env_lookup_pallas.py``, whose Pallas kernels
these replace.  On CUDA tensors the functions launch the hand-written
kernel (``csrc/env_lookup.cu``) at every M; on CPU tensors they run the
plain versions below, which gather the 2x2 taps and scatter the gradient
with ``index_add_``.

Edge semantics (``env_lookup_pallas.py:44-53``, ``lights._bilinear_lookup``):
the floor of a coordinate is clipped to [0, size-1] and its fraction to
[0, 1]; the first tap is the floor clamped to size-2, and when the floor
sat on the last row or column the second tap takes weight 1.  No gradient
reaches the coordinates: every caller looks up constant directions.
"""

from __future__ import annotations

import torch

from svgir_tpu_torch.kernels import env_lookup as K
from svgir_tpu_torch.ops.common import on_cuda
from svgir_tpu_torch.utils import profiling


def _taps(q: torch.Tensor, size: int):
    """First tap index [M] (int64) and second-tap weight [M] of pixel
    coordinates ``q`` along an axis of ``size`` samples."""
    q0 = torch.clamp(torch.floor(q), 0, size - 1)
    f = torch.clamp(q - q0, 0.0, 1.0)
    q0i = q0.long()
    s = torch.clamp(q0i, max=size - 2)
    return s, torch.where(q0i > s, torch.ones_like(f), f)


def env_lookup_forward_plain(env, u, v):
    """Plain version of the B7 forward: [M, C], rows blended first, then
    columns (the reference's contraction order)."""
    h, w, c = env.shape
    su, wu = _taps(u, w)
    sv, wv = _taps(v, h)
    e = env.reshape(h * w, c)
    base = sv * w + su
    wu, wv = wu[:, None], wv[:, None]
    r0 = (1 - wv) * e[base] + wv * e[base + w]
    r1 = (1 - wv) * e[base + 1] + wv * e[base + w + 1]
    return (1 - wu) * r0 + wu * r1


def env_lookup_backward_plain(u, v, g, *, h: int, w: int):
    """Plain version of the B7 backward: d_env [H, W, C] summed over all
    queries (``index_add_`` of each query's four weighted taps, each tap
    rounded in g's dtype).  The sum runs in float64 and is rounded once at
    the end: at the recipe's 33.5M queries a float32 running sum lay up to
    2e-5 of max |d_env| from exact on an H100, twice the kernel's
    tolerance, where the kernel's own sum stayed within 7e-7."""
    c = g.shape[1]
    su, wu = _taps(u, w)
    sv, wv = _taps(v, h)
    base = sv * w + su
    wu, wv = wu[:, None], wv[:, None]
    a0, a1 = (1 - wu) * g, wu * g
    d = torch.zeros(h * w, c, dtype=torch.float64, device=g.device)
    for idx, val in ((base, (1 - wv) * a0), (base + 1, (1 - wv) * a1),
                     (base + w, wv * a0), (base + w + 1, wv * a1)):
        d.index_add_(0, idx, val.double())
    return d.to(g.dtype).reshape(h, w, c)


def env_lookup_forward(env, u, v):
    """B7 forward: env [H, W, C], pixel coords u, v [M] -> [M, C]."""
    if on_cuda(env):
        return K.env_lookup_forward(env, u, v)
    return env_lookup_forward_plain(env, u, v)


def env_lookup_backward(u, v, g, *, h: int, w: int):
    """B7 backward: cotangents g [M, C] -> d_env [H, W, C]."""
    if on_cuda(g):
        return K.env_lookup_backward(u, v, g, h=h, w=w)
    return env_lookup_backward_plain(u, v, g, h=h, w=w)


class _Lookup(torch.autograd.Function):
    """Differentiable with respect to the env only (the Pallas
    ``custom_vjp``, ``env_lookup_pallas.py:155-172``)."""

    @staticmethod
    def forward(ctx, env, u, v):
        ctx.save_for_backward(u, v)
        ctx.hw = env.shape[:2]
        return env_lookup_forward(env, u, v)

    @staticmethod
    def backward(ctx, g):
        u, v = ctx.saved_tensors
        h, w = ctx.hw
        with profiling.span("svgir.env_lookup.bwd"):
            return (env_lookup_backward(u, v, g.contiguous(), h=h, w=w),
                    None, None)


def bilinear_lookup(env, u, v):
    """align_corners bilinear sample of env [H, W, C] at pixel coordinates
    u, v [M] -> [M, C]; gradients flow to ``env`` only."""
    return _Lookup.apply(env.contiguous(), u.detach().contiguous(),
                         v.detach().contiguous())
