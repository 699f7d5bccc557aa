"""Wrappers of the column copy kernels B9 (``svgir_pad_cols`` and
``svgir_slice_cols`` in ``csrc/cols.cu``): [M, kin] -> [M, kout] float32,
zero-padded or sliced, in row blocks.  B9's contract (``kin == kout``
returns the input, M a multiple of the block) is kept by the dispatch in
``ops/blend_pallas``; these launch the kernel on any other input (the
kernel itself refuses a wrong direction or M)."""

from __future__ import annotations

import ctypes

import torch

from svgir_tpu_torch.kernels import LAUNCHES
from svgir_tpu_torch.kernels.build import check, entry, require, stream

_P, _I = ctypes.c_void_p, ctypes.c_int
_COPY = (_P,) + (_I,) * 4 + (_P,) * 2   # (x, m, kin, kout, block, out, stream)


def _copy(name: str, x, kout: int, block: int):
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D [M, K], got shape {tuple(x.shape)}")
    m, kin = x.shape
    require("x", x, torch.float32, (m, kin))
    out = torch.empty(m, kout, dtype=torch.float32, device=x.device)
    rc = entry("cols", f"svgir_{name}", _COPY)(x.data_ptr(), m, kin, kout, block,
                              out.data_ptr(), stream(x))
    check(rc, f"svgir_{name}")
    LAUNCHES[name] += 1
    return out


def pad_cols(x, kout: int, *, block: int = 1024):
    """[M, kin] -> [M, kout] zero-padded (kin <= kout)."""
    return _copy("pad_cols", x, kout, block)


def slice_cols(x, kout: int, *, block: int = 1024):
    """[M, kin] -> [M, kout] column slice (kout <= kin)."""
    return _copy("slice_cols", x, kout, block)
