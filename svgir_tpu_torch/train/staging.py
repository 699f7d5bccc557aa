"""Device staging of the cameras' tensors.

The readers build cameras on the CPU.  ``stage_cameras`` moves each
camera's tensors to the training device once, as float32, before the loop,
so a step reads its ground truth from device memory instead of copying it
from the host (the reference keeps its images on the GPU for the same
reason, scene/cameras.py:38-57).

Staging raises before it moves anything when a CUDA device has less free
memory than the image-plane tensors take, and a failed transfer raises
too: cameras never stay behind on the host.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from svgir_tpu_torch.utils import profiling

FIELDS = ("image", "image_mask", "depth", "normal", "mono")
MATRICES = ("world_view", "full_proj", "camera_center", "prcppoint")


def _free_bytes(device: torch.device) -> Optional[int]:
    """Free memory of a CUDA device; None on the host, where the allocator
    itself refuses what does not fit."""
    if device.type != "cuda":
        return None
    return torch.cuda.mem_get_info(device)[0]


def _moves(a: torch.Tensor, device: torch.device) -> bool:
    return a.device != device or a.dtype != torch.float32


def stage_cameras(cams: Sequence, *, device="cuda") -> List:
    """Cameras with every tensor on ``device`` in float32.  Tensors already
    there in float32 are kept as they are."""
    device = torch.device(device)
    need = sum(getattr(c, f).numel() * 4 for c in cams for f in FIELDS
               if getattr(c, f) is not None
               and _moves(getattr(c, f), device))
    free = _free_bytes(device)
    if free is not None and need > free:
        raise MemoryError(
            f"staging {len(cams)} cameras needs {need / 1e6:.0f} MB on "
            f"{device}, which has {free / 1e6:.0f} MB free")
    staged = []
    for cam in cams:
        moved = {f: getattr(cam, f).to(device) for f in MATRICES}
        for f in FIELDS:
            a = getattr(cam, f)
            if a is not None:
                moved[f] = a.to(device=device, dtype=torch.float32)
        staged.append(dataclasses.replace(cam, **moved))
    if device.type == "cuda":
        profiling.synchronize(device)
    return staged
