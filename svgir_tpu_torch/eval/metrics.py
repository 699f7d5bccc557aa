"""Evaluation metrics: PSNR, SSIM, MSE, normal MAE and LPIPS.

Mirrors ``svgir_tpu.eval.metrics`` (eval_nvs.py:77-90,
eval_relighting_tensoIR.py:367-409, normal_eval.py:11-18).  Images are
[C, H, W] tensors or arrays in [0, 1]; a numpy operand goes to the other
operand's device.  Convolutions run in float32 (TF32 off).

LPIPS needs VGG16 weights converted to an ``.npz`` by
``tools/convert_lpips_weights.py``; none ship and none is downloaded.  The
file is the ``weights_path`` argument, else ``$SVGIR_LPIPS_WEIGHTS``, else
``lpips_vgg.npz`` at the repository root.  Without it ``lpips`` returns
None and ``lpips_status`` says why, for the metric tables to record.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from svgir_tpu_torch.utils import losses as L

_LPIPS_NETS: Dict[Tuple[str, str], object] = {}


def float32_convs():
    """A context in which cuDNN convolutions run in float32, not TF32."""
    return torch.backends.cudnn.flags(
        enabled=torch.backends.cudnn.enabled, allow_tf32=False)


def _as(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _pair(a, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both operands as float32 tensors on one device (a tensor's)."""
    dev = next((x.device for x in (a, b) if isinstance(x, torch.Tensor)),
               "cpu")
    return _as(a, dev), _as(b, dev)


def psnr(a, b) -> float:
    a, b = _pair(a, b)
    return float(L.psnr(a, b))


def ssim(a, b) -> float:
    a, b = _pair(a, b)
    with float32_convs():
        return float(L.ssim(a, b))


def mse(a, b) -> float:
    a, b = _pair(a, b)
    return float(torch.square(a - b).mean())


def normal_mae_deg(pred, gt, mask=None) -> float:
    """Mean angular error in degrees between unit normals [3, H, W]
    (normal_eval.py:11-18), over the pixels where mask [1, H, W] > 0.5
    when a mask is given."""
    pred, gt = _pair(pred, gt)
    cos = torch.clamp((pred * gt).sum(0), -1.0, 1.0)
    ang = torch.arccos(cos) * 180.0 / math.pi
    if mask is not None:
        m = _as(mask, pred.device)[0] > 0.5
        return float(torch.where(m, ang, torch.zeros_like(ang)).sum()
                     / torch.clamp(m.sum(), min=1))
    return float(ang.mean())


def lpips_weights_path(weights_path: Optional[str] = None) -> str:
    """The LPIPS weights file: the argument, else $SVGIR_LPIPS_WEIGHTS,
    else ``lpips_vgg.npz`` at the repository root (which may not exist)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return (weights_path or os.environ.get("SVGIR_LPIPS_WEIGHTS")
            or os.path.join(root, "lpips_vgg.npz"))


def lpips_status(weights_path: Optional[str] = None):
    """(available, note): ``note`` is the explanation the metric tables
    record when LPIPS cannot run, so that the column is never silently
    absent."""
    path = lpips_weights_path(weights_path)
    if os.path.exists(path):
        return True, None
    return False, (f"unavailable (no VGG weights at {path}; run "
                   "tools/convert_lpips_weights.py with torchvision "
                   "weights present, or set SVGIR_LPIPS_WEIGHTS)")


def lpips(a, b, weights_path: Optional[str] = None) -> Optional[float]:
    """LPIPS-vgg distance of two [3, H, W] images (``eval/lpips.py``), or
    None when no weights file exists (``lpips_status`` says where it was
    looked for).  A file that exists but does not load raises."""
    path = lpips_weights_path(weights_path)
    if not os.path.exists(path):
        return None
    a, b = _pair(a, b)
    key = (path, str(a.device))
    if key not in _LPIPS_NETS:
        from svgir_tpu_torch.eval.lpips import LPIPS
        _LPIPS_NETS[key] = LPIPS.from_npz(path, device=a.device)
    return float(_LPIPS_NETS[key](a, b)[0])


def image_metrics(pred, gt, mask=None) -> dict:
    return {"psnr": psnr(pred, gt), "ssim": ssim(pred, gt),
            "mse": mse(pred, gt)}
