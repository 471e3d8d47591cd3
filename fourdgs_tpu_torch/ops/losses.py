"""Photometric losses and image metrics: L1/L2, SSIM, MS-SSIM, PSNR
(counterpart: fourdgs_tpu/ops/losses.py).

Windowed SSIM with an 11x11 Gaussian window (sigma 1.5) and zero padding;
per-image PSNR. Images are (..., H, W, C) channels-last float32 in [0, 1],
as in the JAX package.

SSIM's variance terms are catastrophic cancellations (E[x^2] - mu^2 is
about 1e-3 on near-white images), so its depthwise convolutions run in full
float32: cuDNN convolutions default to TF32 (about three decimal digits)
on the card, and a global flag set elsewhere is no guarantee, so every
convolution here opens its own `cudnn.flags(allow_tf32=False)` scope (the
JAX package needs `Precision.HIGHEST` for the same reason).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return (pred - gt).abs().mean()


def l2_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return ((pred - gt) ** 2).mean()


def psnr(pred: torch.Tensor, gt: torch.Tensor,
         mask: torch.Tensor | None = None) -> torch.Tensor:
    """Per-image PSNR over the leading batch dim; (B, H, W, C) -> (B,)
    (mean over every pixel and channel of each image)."""
    if pred.dim() == 3:
        pred, gt = pred[None], gt[None]
        if mask is not None:
            mask = mask[None]
    b = pred.shape[0]
    diff2 = ((pred - gt) ** 2).reshape(b, -1)
    if mask is not None:
        m = (mask != 0).reshape(b, -1).to(diff2.dtype)
        mse = (diff2 * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1)
    else:
        mse = diff2.mean(dim=1)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))


def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    xs = np.arange(window_size)
    g = np.exp(-((xs - window_size // 2) ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


_WINDOWS: dict = {}


def _window(window_size: int, like: torch.Tensor) -> torch.Tensor:
    """The 2-D window on `like`'s device, made once per device and type:
    a copy from the host inside a step would cost a sync per step and
    cannot be captured in a CUDA graph."""
    key = (window_size, like.dtype, like.device)
    if key not in _WINDOWS:
        w1d = torch.from_numpy(_gaussian_window(window_size, 1.5)).to(like)
        _WINDOWS[key] = w1d[:, None] * w1d[None, :]
    return _WINDOWS[key]


def _depthwise_conv2d(img: torch.Tensor, window: torch.Tensor,
                      padding: int) -> torch.Tensor:
    """img (B, H, W, C), window (kh, kw) applied per channel, in full
    float32 (no TF32 on the card)."""
    c = img.shape[-1]
    x = img.permute(0, 3, 1, 2)                                # NCHW
    weight = window.expand(c, 1, *window.shape)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        y = F.conv2d(x, weight, padding=padding, groups=c)
    return y.permute(0, 2, 3, 1)


def _ssim_terms(img1, img2, window_size, padding):
    window = _window(window_size, img1)
    mu1 = _depthwise_conv2d(img1, window, padding)
    mu2 = _depthwise_conv2d(img2, window, padding)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _depthwise_conv2d(img1 * img1, window, padding) - mu1_sq
    sigma2_sq = _depthwise_conv2d(img2 * img2, window, padding) - mu2_sq
    sigma12 = _depthwise_conv2d(img1 * img2, window, padding) - mu1_mu2
    return mu1_sq, mu2_sq, mu1_mu2, sigma1_sq, sigma2_sq, sigma12


_C1, _C2 = 0.01 ** 2, 0.03 ** 2


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         size_average: bool = True) -> torch.Tensor:
    """Windowed SSIM with zero ('same') padding. Accepts (H, W, C) or
    (B, H, W, C)."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    mu1_sq, mu2_sq, mu1_mu2, s1, s2, s12 = _ssim_terms(
        img1, img2, window_size, window_size // 2)
    ssim_map = ((2 * mu1_mu2 + _C1) * (2 * s12 + _C2)) / (
        (mu1_sq + mu2_sq + _C1) * (s1 + s2 + _C2))
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))


_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _ssim_and_cs(img1, img2, window_size=11):
    """SSIM mean and contrast-sensitivity mean with valid padding."""
    mu1_sq, mu2_sq, mu1_mu2, s1, s2, s12 = _ssim_terms(img1, img2,
                                                       window_size, 0)
    cs_map = (2 * s12 + _C2) / (s1 + s2 + _C2)
    ssim_map = ((2 * mu1_mu2 + _C1) / (mu1_sq + mu2_sq + _C1)) * cs_map
    return ssim_map.mean(dim=(1, 2, 3)), cs_map.mean(dim=(1, 2, 3))


def _avg_pool2(img: torch.Tensor) -> torch.Tensor:
    """2x2 mean pool with stride 2 over (B, H, W, C), odd edges dropped."""
    return F.avg_pool2d(img.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def ms_ssim(img1: torch.Tensor, img2: torch.Tensor,
            levels: int = 5) -> torch.Tensor:
    """Multi-scale SSIM (Wang et al. 2003 weights), per image."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    weights = _MSSSIM_WEIGHTS[:levels]
    mcs = []
    val = None
    for i in range(levels):
        s, cs = _ssim_and_cs(img1, img2)
        if i == levels - 1:
            val = torch.clamp(s, min=0.0)
        else:
            mcs.append(torch.clamp(cs, min=0.0))
            img1, img2 = _avg_pool2(img1), _avg_pool2(img2)
    out = val ** weights[-1]
    for w, cs in zip(weights[:-1], mcs):
        out = out * cs ** w
    return out


def d_ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """D-SSIM = (1 - MS-SSIM) / 2."""
    return (1.0 - ms_ssim(img1, img2)) / 2.0
