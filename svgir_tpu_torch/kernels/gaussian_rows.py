"""Wrapper of R1 (``svgir_gaussian_rows`` in ``csrc/gaussian_rows.cu``): the
per-Gaussian sums of per-instance rows over the binner's per-Gaussian
instance lists (``ops.binning.PaddedInstances.gauss_lists`` and
``raw_slot``)."""

from __future__ import annotations

import ctypes

import torch

from svgir_tpu_torch.kernels import LAUNCHES
from svgir_tpu_torch.kernels.build import check, entry, require, stream

_P, _I = ctypes.c_void_p, ctypes.c_int
# (d_inst, m, k, lists, raw_slot, r, n, out, stream)
_ROWS = (_P, _I, _I, _P, _P, _I, _I, _P, _P)


def gaussian_rows(d_inst, gauss_lists, raw_slot):
    """d_inst [M, K] f32, gauss_lists [N, 2] int32 (each Gaussian's first
    raw instance and count), raw_slot [R] int32 (each raw instance's slot)
    -> [N+1, K] f32.  Row g is the sum of d_inst's rows at the slots of g's
    list, added in list order; entries past R or with a slot >= M are
    skipped; row N is zero.  One device kernel, no atomics."""
    if d_inst.dim() != 2 or d_inst.shape[1] < 1:
        raise ValueError(f"d_inst must be [M, K] with K >= 1, got shape "
                         f"{tuple(d_inst.shape)}")
    m, k = d_inst.shape
    n, r = gauss_lists.shape[0], raw_slot.shape[0]
    require("d_inst", d_inst, torch.float32, (m, k))
    require("gauss_lists", gauss_lists, torch.int32, (n, 2))
    require("raw_slot", raw_slot, torch.int32, (r,))
    out = torch.empty(n + 1, k, dtype=torch.float32, device=d_inst.device)
    rc = entry("gaussian_rows", "svgir_gaussian_rows", _ROWS)(
        d_inst.data_ptr(), m, k, gauss_lists.data_ptr(), raw_slot.data_ptr(),
        r, n, out.data_ptr(), stream(d_inst))
    check(rc, "svgir_gaussian_rows")
    LAUNCHES["gaussian_rows"] += 1
    return out
