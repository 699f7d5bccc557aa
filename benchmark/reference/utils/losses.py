"""Image losses: L1, MSE, SSIM (single and paired), PSNR, cosine, mask
entropy, TV and the first- and second-order edge-aware smoothness.

Reference: ``utils/loss_utils.py`` and ``svgir_tpu.utils.losses``.  SSIM
runs in float32 (cuDNN's TF32 is switched off at package import); the
edge-aware losses use kornia's normalized Sobel kernels (3x3 / 8 for order
1; 5x5 / 64 and / 36 for order 2) with replicate padding.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs().mean()


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """utils/image_utils.py:32-37 (peak 1.0): per-channel MSE -> PSNR,
    averaged over channels."""
    c = img1.shape[0]
    mse = ((img1 - img2) ** 2).reshape(c, -1).mean(1)
    return (20 * torch.log10(1.0 / torch.sqrt(mse))).mean()


def _gaussian_1d(window_size: int, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2)
               / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _separable_blur(img: torch.Tensor, g1d: np.ndarray) -> torch.Tensor:
    """Zero-padded separable Gaussian blur of [C, H, W] (depthwise)."""
    c = img.shape[0]
    k = g1d.shape[0]
    g = torch.as_tensor(g1d, device=img.device, dtype=img.dtype)
    x = img[None]
    x = F.conv2d(x, g.view(1, 1, k, 1).expand(c, 1, k, 1), padding=(k // 2, 0),
                 groups=c)
    x = F.conv2d(x, g.view(1, 1, 1, k).expand(c, 1, 1, k), padding=(0, k // 2),
                 groups=c)
    return x[0]


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """Mean SSIM over a [C, H, W] pair (loss_utils.py:33-64): 11x11
    Gaussian window, sigma 1.5, zero padding."""
    c = img1.shape[0]
    stacked = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2])
    blurred = _separable_blur(stacked, _gaussian_1d(window_size))
    mu1, mu2 = blurred[0:c], blurred[c:2 * c]
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = blurred[2 * c:3 * c] - mu1_sq
    sigma2_sq = blurred[3 * c:4 * c] - mu2_sq
    sigma12 = blurred[4 * c:5 * c] - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean()


def ssim_pair(img1: torch.Tensor, img2: torch.Tensor, ref: torch.Tensor,
              window_size: int = 11):
    """(ssim(img1, ref), ssim(img2, ref)) from one stacked blur of eight
    quantities, sharing the reference image's window statistics."""
    c = img1.shape[0]
    stacked = torch.cat([img1, img2, ref, img1 * img1, img2 * img2,
                         ref * ref, img1 * ref, img2 * ref])
    b = _separable_blur(stacked, _gaussian_1d(window_size))
    mu1, mu2, mur = b[0:c], b[c:2 * c], b[2 * c:3 * c]
    e1, e2, er = b[3 * c:4 * c], b[4 * c:5 * c], b[5 * c:6 * c]
    e1r, e2r = b[6 * c:7 * c], b[7 * c:8 * c]
    c1, c2 = 0.01 ** 2, 0.03 ** 2

    def one(mu_a, e_a, e_ar):
        mu_ar = mu_a * mur
        sig_a = e_a - mu_a * mu_a
        sig_r = er - mur * mur
        sig_ar = e_ar - mu_ar
        return (((2 * mu_ar + c1) * (2 * sig_ar + c2)) /
                ((mu_a * mu_a + mur * mur + c1)
                 * (sig_a + sig_r + c2))).mean()

    return one(mu1, e1, e1r), one(mu2, e2, e2r)


_SOBEL_X = np.array([[-1., 0., 1.], [-2., 0., 2.], [-1., 0., 1.]],
                    np.float32) / 8.0
_SOBEL_XX = np.array([[-1., 0., 2., 0., -1.],
                      [-4., 0., 8., 0., -4.],
                      [-6., 0., 12., 0., -6.],
                      [-4., 0., 8., 0., -4.],
                      [-1., 0., 2., 0., -1.]], np.float32) / 64.0
_SOBEL_XY = np.array([[-1., -2., 0., 2., 1.],
                      [-2., -4., 0., 4., 2.],
                      [0., 0., 0., 0., 0.],
                      [2., 4., 0., -4., -2.],
                      [1., 2., 0., -2., -1.]], np.float32) / 36.0


def spatial_gradient(img: torch.Tensor, order: int = 1) -> torch.Tensor:
    """Normalized Sobel gradients with replicate padding: [C, H, W] ->
    [C, 2, H, W] (dx, dy) for order 1, [C, 3, H, W] (dxx, dxy, dyy) for
    order 2."""
    if order == 1:
        kerns, pad = [_SOBEL_X, _SOBEL_X.T], 1
    else:
        kerns, pad = [_SOBEL_XX, _SOBEL_XY, _SOBEL_XX.T], 2
    k = torch.as_tensor(np.stack(kerns), device=img.device, dtype=img.dtype)
    padded = F.pad(img[None], (pad,) * 4, mode="replicate")
    return F.conv2d(padded.transpose(0, 1), k[:, None])     # [C, G, H, W]


def first_order_edge_aware_loss(data: torch.Tensor,
                                img: torch.Tensor) -> torch.Tensor:
    """loss_utils.py:104-105."""
    g_data = spatial_gradient(data).abs()
    g_img = spatial_gradient(img).abs()
    return (g_data * torch.exp(-g_img)).sum(1).mean()


def second_order_edge_aware_loss(data: torch.Tensor,
                                 img: torch.Tensor) -> torch.Tensor:
    """loss_utils.py:101-102: |dxx|, |dyy| of ``data`` weighted by
    exp(-10 |d img|)."""
    g2 = spatial_gradient(data, 2).abs()[:, [0, 2]]
    g1 = spatial_gradient(img, 1).abs()
    return (g2 * torch.exp(-10 * g1)).sum(1).mean()


def tv_loss(x: torch.Tensor) -> torch.Tensor:
    """loss_utils.py:113-117 (mean squared neighbour difference)."""
    h_tv = ((x[..., 1:, :] - x[..., :-1, :]) ** 2).mean()
    w_tv = ((x[..., :, 1:] - x[..., :, :-1]) ** 2).mean()
    return h_tv + w_tv


def cos_loss(output: torch.Tensor, gt: torch.Tensor, thrsh: float = 0.0,
             weight=1) -> torch.Tensor:
    """loss_utils.py:119-121: mean (1 - cos) over the pixels whose cos is
    below cos(thrsh), as a masked mean."""
    cos = (output * gt * weight).sum(0)
    sel = cos < math.cos(thrsh)
    cnt = torch.clamp(sel.sum(), min=1)
    return torch.where(sel, 1 - cos, torch.zeros_like(cos)).sum() / cnt


def mask_entropy_loss(opacity: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy of rendered opacity vs mask (render.py:184-188)."""
    o = torch.clamp(opacity, 1e-6, 1 - 1e-6)
    return -(mask * torch.log(o) + (1 - mask) * torch.log(1 - o)).mean()
