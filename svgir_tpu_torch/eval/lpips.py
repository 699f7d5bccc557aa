"""LPIPS (vgg) in PyTorch, the twin of ``svgir_tpu.eval.lpips_jax``
(reference ``lpipsPyTorch/modules/lpips.py:1-37``, ``networks.py:36-120``,
``utils.py:6-8``).

Z-score both inputs with the LPIPS shift and scale, run the VGG16 feature
stack (``nn.Conv2d`` layers: no torchvision), tap the five ReLU outputs
relu1_2 / 2_2 / 3_3 / 4_3 / 5_3 (torchvision ``features`` indices 4, 9,
16, 23, 30), normalise each tap over its channels, square the difference,
weight it by the learned 1x1 head, average over space and sum over taps.

The weights are the ``.npz`` that ``tools/convert_lpips_weights.py`` writes
(keys ``required_keys()``), the same file ``svgir_tpu`` loads; none ships
and none is downloaded.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

# torchvision vgg16.features: the conv indices of the five tapped blocks
VGG16_BLOCKS: List[List[int]] = [
    [0, 2],            # conv3-64, conv64-64      -> tap relu1_2
    [5, 7],            # conv64-128, conv128-128  -> tap relu2_2
    [10, 12, 14],      # 3x conv...256            -> tap relu3_3
    [17, 19, 21],      # 3x conv...512            -> tap relu4_3
    [24, 26, 28],      # 3x conv512-512           -> tap relu5_3
]
N_CHANNELS = [64, 128, 256, 512, 512]

# BaseNet z-score buffers (networks.py:40-44)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def required_keys() -> List[str]:
    keys = []
    for blk in VGG16_BLOCKS:
        for idx in blk:
            keys += [f"conv{idx}/w", f"conv{idx}/b"]
    keys += [f"lin{k}" for k in range(5)]
    return keys


class LPIPS(nn.Module):
    """LPIPS-vgg distance of [C, H, W] or [N, C, H, W] images, passed as
    they are (the reference feeds [0, 1] renders, eval_nvs.py:81)."""

    def __init__(self, weights: Dict[str, np.ndarray]):
        super().__init__()
        missing = [k for k in required_keys() if k not in weights]
        if missing:
            raise ValueError(f"LPIPS weights missing keys: {missing[:4]}...")
        self.convs = nn.ModuleDict()
        for blk in VGG16_BLOCKS:
            for idx in blk:
                w = torch.as_tensor(np.asarray(weights[f"conv{idx}/w"],
                                               np.float32))
                conv = nn.Conv2d(w.shape[1], w.shape[0], 3, padding=1)
                with torch.no_grad():
                    conv.weight.copy_(w)
                    conv.bias.copy_(torch.as_tensor(np.asarray(
                        weights[f"conv{idx}/b"], np.float32)))
                self.convs[str(idx)] = conv
        for k in range(5):   # heads may come as [1, C, 1, 1] conv kernels
            self.register_buffer(f"lin{k}", torch.as_tensor(np.asarray(
                weights[f"lin{k}"], np.float32).reshape(-1)))
        self.register_buffer("shift", torch.as_tensor(_SHIFT))
        self.register_buffer("scale", torch.as_tensor(_SCALE))
        self.requires_grad_(False)

    @classmethod
    def from_npz(cls, path: str, device="cuda") -> "LPIPS":
        with np.load(path) as data:
            return cls({k: data[k] for k in data.files}).to(device)

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x [N, 3, H, W] -> the five channel-normalised taps."""
        x = (x - self.shift[None, :, None, None]) \
            / self.scale[None, :, None, None]
        taps = []
        for bi, blk in enumerate(VGG16_BLOCKS):
            if bi:
                x = F.max_pool2d(x, 2, 2)
            for idx in blk:
                x = F.relu(self.convs[str(idx)](x))
            norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
            taps.append(x / (norm + 1e-10))           # utils.py:6-8
        return taps

    @torch.no_grad()
    def forward(self, x, y) -> torch.Tensor:
        from svgir_tpu_torch.eval.metrics import float32_convs

        x = torch.as_tensor(x, dtype=torch.float32, device=self.shift.device)
        y = torch.as_tensor(y, dtype=torch.float32, device=self.shift.device)
        if x.dim() == 3:
            x, y = x[None], y[None]
        with float32_convs():
            fx, fy = self.features(x), self.features(y)
        total = 0.0
        for k, (a, b) in enumerate(zip(fx, fy)):
            d = torch.square(a - b)
            lin = getattr(self, f"lin{k}")[None, :, None, None]
            total = total + (d * lin).sum(1).mean((1, 2))
        return total                                          # [N]
