"""Image primitives: pyramid size chain, separable 7-tap Gaussian blur,
bilinear resize (port of ``irotavg_tpu/ops/image.py``).

Contracts of the reference front end (src/ORBExtractor.cpp:1111,
1132-1157): chained INTER_LINEAR resizes with scale 1.2, and the 7x7
sigma=2 Gaussian blur with BORDER_REFLECT_101 padding before descriptor
sampling.  The blur is a plain separable 7-tap pass (torch ``'reflect'``
padding is REFLECT_101), not the reference's banded-matrix products.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def pyramid_sizes(h: int, w: int, n_levels: int, scale: float):
    """Per-level (h, w): round(orig * scale^-level)."""
    sizes = []
    for lv in range(n_levels):
        s = 1.0 / (scale ** lv)
        sizes.append((int(round(h * s)), int(round(w * s))))
    return sizes


def _gauss_kernel(ksize: int, sigma: float) -> np.ndarray:
    """OpenCV getGaussianKernel: exp(-x^2/(2 sigma^2)), normalised (f32)."""
    r = (ksize - 1) / 2.0
    x = np.arange(ksize) - r
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def pad_reflect101(img, pad: int):
    """BORDER_REFLECT_101 (``dcb|abcd|cba``) padding on both spatial axes
    of ``([B,] H, W)``.  Each axis must be longer than ``pad``: a single
    reflection cannot cover a wider pad, and this raises rather than fold
    the border twice."""
    h, w = img.shape[-2:]
    if pad >= h or pad >= w:
        raise ValueError(f"REFLECT_101 pad {pad} needs both axes longer "
                         f"than it; got {h}x{w}")
    x = F.pad(img.reshape(-1, 1, h, w), (pad,) * 4, mode="reflect")
    return x.reshape(img.shape[:-2] + x.shape[-2:])


def gaussian_blur7(img, sigma: float = 2.0):
    """7x7 separable Gaussian blur, BORDER_REFLECT_101; ``([B,] H, W)`` f32.

    Each pass is an explicit sum of seven shifted, weighted copies in tap
    order (no convolution library, whose algorithm choice would change the
    rounding from call to call), so a batch gives each image's unbatched
    result bit for bit."""
    k = _gauss_kernel(7, sigma).tolist()
    h, w = img.shape[-2:]
    x = pad_reflect101(img, 3)
    rows = sum(k[i] * x[..., :, i:i + w] for i in range(7))
    return sum(k[i] * rows[..., i:i + h, :] for i in range(7))


def resize_bilinear(img, out_h: int, out_w: int):
    """Bilinear resize with half-pixel alignment (cv::resize INTER_LINEAR:
    src = (dst + 0.5) * scale - 0.5, edge-clamped) of the last two axes
    of ``([B,] H, W)``."""
    h, w = img.shape[-2:]
    dev = img.device
    sy = h / out_h
    sx = w / out_w
    yy = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) * sy \
        - 0.5
    xx = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) * sx \
        - 0.5
    y0 = torch.clamp(torch.floor(yy), 0, h - 1)
    x0 = torch.clamp(torch.floor(xx), 0, w - 1)
    wy = torch.clamp(yy - y0, 0.0, 1.0)
    wx = torch.clamp(xx - x0, 0.0, 1.0)
    y0 = y0.long()
    x0 = x0.long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    row = img[..., y0, :] * (1.0 - wy)[:, None] + \
        img[..., y1, :] * wy[:, None]
    return row[..., x0] * (1.0 - wx)[None, :] + row[..., x1] * wx[None, :]
