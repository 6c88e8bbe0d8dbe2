"""SIFT feature extraction — the reference's alternative front end.

Port of ``irotavg_tpu/frontend/sift.py``.  The reference gates
`Frame::findFeatures` on a compile-time `USE_ORB` flag; with it off,
features come from `cv::xfeatures2d::SIFT::detectAndCompute`
(src/Frame.cpp:64-99), and the (dead) `findSIFTMatches` matcher consumes
the float descriptors (src/ViewGraph.cpp:694-722).  Plain PyTorch on the
extractor's device, as the reference is a plain XLA program:

* Gaussian scale space: per octave ``s+3`` separable blurs, each pass an
  explicit sum of shifted, weighted copies in tap order (no convolution
  library, so no TF32 and no algorithm choice changes the rounding); the
  DoG stack as slice differences.
* Keypoints: 26-neighbour extrema of the DoG stack, the contrast
  threshold and the 2x2-Hessian edge test as dense masks, then the
  per-octave top-K by |DoG| (a stable descending sort: equal scores keep
  the lower flat index first, as ``lax.top_k``), padded with a ``valid``
  mask so every frame has the same shapes.
* Orientation: the 36-bin Gaussian-weighted gradient histogram over a
  17x17 grid around each keypoint, its peak with parabolic refinement.
* Descriptor: the 4x4 spatial x 8 orientation-bin layout (128-d,
  L2-normalised, clamped at 0.2, renormalised) from bilinear samples of
  the octave's gradient fields on a rotated 16x16 grid.

The reference maps the per-keypoint work with ``vmap``; here every
keypoint's bilinear samples are one gather over a (K, 289) and a (K, 256)
sample grid, and the histograms one fixed-order segment sum each
(``ops/segment.py``: each bin adds its samples in sample order, as the
CPU's ``scatter_add`` does, so the card repeats from run to run).  SIFT
descriptors are float rows, so BoW place recognition (a vocabulary of
ORB words) does not apply to them, as in the reference.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from irotavg_tpu_torch.device import pick_device
from irotavg_tpu_torch.ops.image import pad_reflect101
from irotavg_tpu_torch.ops.segment import segment_plan, segment_sum

_PI = math.pi


@dataclasses.dataclass(frozen=True)
class SiftParams:
    """cv::xfeatures2d::SIFT::create() defaults (the reference passes
    no arguments at src/Frame.cpp:97)."""

    n_features: int = 2000          # capacity (OpenCV default 0 = unlimited)
    n_octave_layers: int = 3        # s
    contrast_threshold: float = 0.04
    edge_threshold: float = 10.0
    sigma: float = 1.6


def _gauss1d(sigma: float) -> np.ndarray:
    r = max(int(np.ceil(3.0 * sigma)), 1)
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _blur(img, k1d: np.ndarray):
    """Separable blur of (H, W) with REFLECT_101 borders: along W, then
    along H, each an explicit tap-order sum in f32."""
    k = k1d.tolist()
    n = len(k)
    r = (n - 1) // 2
    h, w = img.shape
    p = pad_reflect101(img, r)                      # (H + 2r, W + 2r)
    rows = sum(k[i] * p[:, i:i + w] for i in range(n))
    return sum(k[i] * rows[i:i + h, :] for i in range(n))


def _scale_space(img, params: SiftParams, n_octaves: int):
    """Per octave: gaussians (s+3, H, W) and dogs (s+2, H, W)."""
    s = params.n_octave_layers
    k = 2.0 ** (1.0 / s)
    # incremental blur amounts between successive scales
    sig_prev = params.sigma
    inc = []
    for i in range(1, s + 3):
        sig_total = params.sigma * k ** i
        inc.append(float(np.sqrt(sig_total ** 2 - sig_prev ** 2)))
        sig_prev = sig_total
    octaves = []
    base = _blur(img, _gauss1d(params.sigma))  # assume sigma_in ~ 0
    for _ in range(n_octaves):
        gauss = [base]
        for i in range(s + 2):
            gauss.append(_blur(gauss[-1], _gauss1d(inc[i])))
        g = torch.stack(gauss)                   # (s+3, H, W)
        octaves.append((g, g[1:] - g[:-1]))
        base = gauss[s][::2, ::2].contiguous()   # the 2x sigma image
        if base.shape[0] < 16 or base.shape[1] < 16:
            break
    return octaves


def _extrema_mask(dog, contrast_th: float, edge_th: float):
    """(s, H, W) bool for the middle DoG slices: 26-neighbour extremum,
    contrast and edge tests, off an 8 px border (neighbours wrap around,
    as ``jnp.roll`` does; the border mask hides the wrap)."""
    d = dog
    mid = d[1:-1]
    neigh_max = torch.full_like(mid, -float("inf"))
    neigh_min = torch.full_like(mid, float("inf"))
    for ds in (-1, 0, 1):
        sl = d[1 + ds: d.shape[0] - 1 + ds]
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if ds == 0 and dy == 0 and dx == 0:
                    continue
                sh = torch.roll(sl, (dy, dx), dims=(1, 2))
                neigh_max = torch.maximum(neigh_max, sh)
                neigh_min = torch.minimum(neigh_min, sh)
    is_ext = (mid > neigh_max) | (mid < neigh_min)
    is_ext &= torch.abs(mid) > contrast_th / 2.0  # OpenCV pre-threshold

    # edge rejection: 2x2 spatial Hessian trace^2/det < (r+1)^2/r
    dxx = (torch.roll(mid, -1, 2) + torch.roll(mid, 1, 2) - 2 * mid)
    dyy = (torch.roll(mid, -1, 1) + torch.roll(mid, 1, 1) - 2 * mid)
    dxy = (
        torch.roll(mid, (-1, -1), (1, 2)) + torch.roll(mid, (1, 1), (1, 2))
        - torch.roll(mid, (-1, 1), (1, 2)) - torch.roll(mid, (1, -1), (1, 2))
    ) * 0.25
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = edge_th
    is_ext &= (det > 0) & (tr * tr * r < (r + 1) ** 2 * det)

    h, w = mid.shape[1:]
    dev = mid.device
    yy = torch.arange(h, device=dev)[None, :, None]
    xx = torch.arange(w, device=dev)[None, None, :]
    b = 8
    is_ext &= (yy >= b) & (yy < h - b) & (xx >= b) & (xx < w - b)
    return is_ext


def _bilinear(fields, layer, y, x):
    """Sample the (L, H, W) stack at float (y, x) (each (K, S)) in the
    layer given per keypoint (K,), with clamping."""
    _, h, w = fields.shape
    flat = fields.reshape(-1)
    y = torch.clamp(y, 0.0, h - 1.001)
    x = torch.clamp(x, 0.0, w - 1.001)
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    fy = y - y0
    fx = x - x0
    i00 = (layer[:, None] * h + y0.long()) * w + x0.long()
    v00 = flat[i00]
    v01 = flat[i00 + 1]
    v10 = flat[i00 + w]
    v11 = flat[i00 + w + 1]
    return ((1 - fy) * (1 - fx) * v00 + (1 - fy) * fx * v01
            + fy * (1 - fx) * v10 + fy * fx * v11)


def _bin_sums(bins, vals, n_bins):
    """Per-row histograms ``(K, n_bins)`` of ``vals (K, S)`` into ``bins
    (K, S)``: each bin adds its samples in sample order, from 0.0 (a
    segment sum with a plan built for this call)."""
    K = bins.shape[0]
    rows = torch.arange(K, device=bins.device)[:, None] * n_bins
    plan = segment_plan(rows + bins, K * n_bins)
    return segment_sum(vals.reshape(-1), plan).view(K, n_bins)


def _orientation(gx, gy, layer, y, x, sigma):
    """36-bin Gaussian-weighted gradient histogram peak (radians), per
    keypoint; ``y, x, sigma`` are (K,)."""
    r = 8
    dev = y.device
    g = torch.arange(-r, r + 1, dtype=torch.float32, device=dev)
    dy = g[:, None].expand(2 * r + 1, 2 * r + 1).reshape(-1)
    dx = g[None, :].expand(2 * r + 1, 2 * r + 1).reshape(-1)
    sy = y[:, None] + dy
    sx = x[:, None] + dx
    vx = _bilinear(gx, layer, sy, sx)
    vy = _bilinear(gy, layer, sy, sx)
    mag = torch.sqrt(vx * vx + vy * vy)
    wgt = torch.exp(-(dy ** 2 + dx ** 2)
                    / (2.0 * (1.5 * sigma[:, None]) ** 2))
    ang = torch.atan2(vy, vx)                       # [-pi, pi]
    bins = torch.floor((ang + _PI) / (2 * _PI) * 36).long()
    bins = torch.clamp(bins, 0, 35)
    hist = _bin_sums(bins, mag * wgt, 36)
    # circular smoothing, then the peak with parabolic interpolation
    hist = (torch.roll(hist, 1, 1) + hist + torch.roll(hist, -1, 1)) / 3.0
    p = torch.argmax(hist, dim=1, keepdim=True)     # first maximum
    l_ = hist.gather(1, torch.remainder(p - 1, 36))[:, 0]
    c = hist.gather(1, p)[:, 0]
    rr = hist.gather(1, torch.remainder(p + 1, 36))[:, 0]
    denom = l_ - 2 * c + rr
    off = torch.where(torch.abs(denom) > 1e-12, 0.5 * (l_ - rr) / denom,
                      torch.zeros_like(denom))
    return (p[:, 0] + off + 0.5) / 36.0 * 2 * _PI - _PI


def _descriptor(gx, gy, layer, y, x, sigma, theta):
    """128-d SIFT descriptors: 16x16 rotated samples -> 4x4x8 bins, per
    keypoint; ``y, x, sigma, theta`` are (K,)."""
    d, nbins = 4, 8
    dev = y.device
    width = (3.0 * sigma)[:, None]          # histogram cell width (px)
    g = torch.arange(16, dtype=torch.float32, device=dev)
    ii = g[:, None].expand(16, 16).reshape(-1)
    jj = g[None, :].expand(16, 16).reshape(-1)
    u = (ii - 7.5) / 4.0                    # cell units, [-1.875, 1.875]
    v = (jj - 7.5) / 4.0
    ct, st = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    sy = y[:, None] + width * (u * ct + v * st)
    sx = x[:, None] + width * (-u * st + v * ct)
    vx = _bilinear(gx, layer, sy, sx)
    vy = _bilinear(gy, layer, sy, sx)
    mag = torch.sqrt(vx * vx + vy * vy)
    wgt = torch.exp(-(u * u + v * v) / (2 * (0.5 * d) ** 2))
    ang = torch.atan2(vy, vx) - theta[:, None]
    obin = torch.floor(torch.remainder(ang, 2 * _PI) / (2 * _PI) * nbins)
    obin = torch.clamp(obin.long(), 0, nbins - 1)
    sb_i = torch.clamp(torch.floor(ii / 4).long(), 0, d - 1)
    sb_j = torch.clamp(torch.floor(jj / 4).long(), 0, d - 1)
    flat = (sb_i * d + sb_j) * nbins + obin
    desc = _bin_sums(flat, mag * wgt, d * d * nbins)
    nrm = torch.linalg.vector_norm(desc, dim=1, keepdim=True) + 1e-12
    desc = torch.clamp(desc / nrm, 0.0, 0.2)
    return desc / (torch.linalg.vector_norm(desc, dim=1, keepdim=True)
                   + 1e-12)


def _extract_octave(g, dog, params: SiftParams, budget: int):
    """Top-``budget`` keypoints of one octave (octave-local coords)."""
    s = params.n_octave_layers
    mask = _extrema_mask(dog, params.contrast_threshold,
                         params.edge_threshold)      # (s, H, W)
    score = torch.where(mask, torch.abs(dog[1:-1]),
                        torch.full_like(mask, -float("inf"),
                                        dtype=torch.float32))
    h, w = score.shape[1:]
    flat = score.reshape(-1)
    top_val, top_idx = torch.sort(flat, descending=True, stable=True)
    top_val, top_idx = top_val[:budget], top_idx[:budget]
    valid = torch.isfinite(top_val)
    li = top_idx // (h * w)                  # DoG layer 0..s-1
    yy = (top_idx % (h * w)) // w
    xx = top_idx % w
    yf = yy.to(torch.float32)
    xf = xx.to(torch.float32)

    k = 2.0 ** (1.0 / s)
    sig_layer = params.sigma * k ** (li.to(torch.float32) + 1.0)

    # gradient fields of gaussian layers 1..s (a keypoint of DoG layer l
    # reads gaussian layer l + 1)
    gl = g[1:s + 1]
    gxs = (torch.roll(gl, -1, 2) - torch.roll(gl, 1, 2)) * 0.5
    gys = (torch.roll(gl, -1, 1) - torch.roll(gl, 1, 1)) * 0.5
    theta = _orientation(gxs, gys, li, yf, xf, sig_layer)
    desc = _descriptor(gxs, gys, li, yf, xf, sig_layer, theta)
    resp = torch.where(valid, top_val, torch.zeros_like(top_val))
    return {"x": xf, "y": yf, "sigma": sig_layer, "angle": theta,
            "response": resp, "desc": desc, "valid": valid}


def _octave_budgets(n_features: int, n_octaves: int) -> list[int]:
    """Geometric split (most features live in the finest octave)."""
    raw = [n_features * 0.5 ** o for o in range(n_octaves)]
    tot = sum(raw)
    b = [max(int(round(n_features * r / tot)), 8) for r in raw]
    b[0] += n_features - sum(b)
    return b


def extract(img, params: SiftParams, n_octaves: int) -> dict:
    """SIFT features of one (H, W) f32 image in [0, 1]."""
    budgets = _octave_budgets(params.n_features, n_octaves)
    outs = []
    for o, (g, dog) in enumerate(_scale_space(img, params, n_octaves)):
        out = _extract_octave(g, dog, params, budgets[o])
        sc = float(2.0 ** o)
        out["x0"] = out["x"] * sc
        out["y0"] = out["y"] * sc
        out["octave"] = torch.full(out["x"].shape, o, dtype=torch.int32,
                                   device=img.device)
        out["size"] = out.pop("sigma") * sc * 2.0
        outs.append(out)
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


class SIFTExtractor:
    """Functional counterpart of cv::xfeatures2d::SIFT (src/Frame.cpp:97).

    Returns the same dict layout as :class:`ORBExtractor` — ``x0, y0,
    octave, size, angle, response, valid`` (plus the octave-local ``x,
    y``) — with ``desc`` as (N, 128) f32 rows instead of packed 256-bit
    words, on ``device`` (the card unless ``device="cpu"``).
    """

    def __init__(self, n_features: int = 2000, n_octave_layers: int = 3,
                 contrast_threshold: float = 0.04,
                 edge_threshold: float = 10.0, sigma: float = 1.6,
                 n_octaves: int = 4, device=None):
        self.params = SiftParams(
            n_features=n_features, n_octave_layers=n_octave_layers,
            contrast_threshold=contrast_threshold,
            edge_threshold=edge_threshold, sigma=sigma,
        )
        self.n_octaves = n_octaves
        self.device = pick_device(device)

    @property
    def capacity(self) -> int:
        return sum(_octave_budgets(self.params.n_features, self.n_octaves))

    def __call__(self, image) -> dict:
        """Features of one (H, W) gray or (H, W, 3) RGB image, given as a
        numpy array or a tensor on any device."""
        img = image if torch.is_tensor(image) else \
            torch.from_numpy(np.ascontiguousarray(image))
        img = img.to(self.device, torch.float32)
        if img.ndim == 3:
            img = (0.299 * img[..., 0] + 0.587 * img[..., 1]
                   + 0.114 * img[..., 2])
        img = img / 255.0
        h, w = img.shape
        n_oct = min(self.n_octaves,
                    max(int(np.log2(min(h, w) / 16.0)), 1))
        return extract(img, self.params, n_oct)
