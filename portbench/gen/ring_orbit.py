"""KITTI-shaped frames of a camera orbiting inside a ring of textured panels.

The scene is ``chip_smoke.py``'s ring world (``_ring_world``): three
concentric rings of textured panels facing the centre (a far wall at 16 m
and two sparser foreground rings), each panel's texture blurred noise with
rectangles and discs.  Every random number is drawn with numpy from the
seed in the recipe's order; the textures and the frames are then drawn on
``device`` in f64 with PyTorch, the frames by the recipe's painter's rule
(visible panels far to near by their mean depth, bilinear texture samples,
a grey background of 90).

The camera orbits the ring's centre at ``radius(k) = r0 - shrink * k /
frames_per_lap`` with yaw ``2*pi*k/frames_per_lap``,
so every lap revisits the last one's places from ``shrink`` metres further
in.  The renderer returns the frames as host uint8 arrays and the scene as
the reference needs it: each panel's corners and each frame's world-to-camera
rotation and centre.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

TEX_SIZE = 512
BACKGROUND = 90.0
# (radius, panels, fill, height, heights of the panel centres) per ring
RINGS = ((16.0, 14, 1.04, 8.0, (0.0,)),
         (11.0, 9, 0.42, 3.4, (-1.6, 1.8)),
         (7.5, 7, 0.30, 2.2, (1.2, -1.0, 0.2)))


@dataclasses.dataclass
class Scene:
    corners: np.ndarray      # (P, 4, 3) panel corners, world frame
    R: np.ndarray            # (F, 3, 3) world -> camera rotations
    C: np.ndarray            # (F, 3) camera centres, world frame
    K: np.ndarray            # (3, 3) intrinsics
    width: int
    height: int


def seed_rng(seed: int) -> np.random.Generator:
    """numpy's generator for any whole-number seed (negative ones too)."""
    return np.random.default_rng(int(seed) & (2 ** 64 - 1))


def _texture_draws(rng, size):
    """The recipe's random numbers for one texture, in its order."""
    noise = rng.integers(60, 200, (size, size))
    rects = []
    for _ in range(150):
        x0, y0 = rng.integers(10, size - 30, 2)
        w, h = rng.integers(6, 40, 2)
        rects.append((int(x0), int(y0), int(w), int(h),
                      int(rng.integers(0, 255))))
    discs = []
    for _ in range(100):
        cx, cy = rng.integers(15, size - 15, 2)
        r = rng.integers(3, 14)
        discs.append((int(cx), int(cy), int(r), int(rng.integers(0, 255))))
    return noise, rects, discs


def _blur(img, sigma):
    """Separable Gaussian blur with replicated edges, the taps summed in
    the recipe's order (f64)."""
    r = int(3 * sigma + 0.5)
    x = np.arange(-r, r + 1)
    k = np.exp(-x * x / (2 * sigma * sigma))
    k /= k.sum()
    h, w = img.shape
    p = torch.nn.functional.pad(img[None, None], (r, r, r, r),
                                mode="replicate")[0, 0]
    acc = 0
    for i in range(2 * r + 1):
        acc = acc + float(k[i]) * p[:, i:i + w]
    out = 0
    for i in range(2 * r + 1):
        out = out + float(k[i]) * acc[i:i + h]
    return out


def _texture(draws, size, device):
    noise, rects, discs = draws
    tex = _blur(torch.as_tensor(noise, dtype=torch.float64, device=device),
                1.2)
    for x0, y0, w, h, v in rects:
        tex[y0:y0 + h + 1, x0:x0 + w + 1] = v
    ax = torch.arange(size, device=device)
    for cx, cy, r, v in discs:
        y0, y1 = max(cy - r, 0), min(cy + r + 1, size)
        x0, x1 = max(cx - r, 0), min(cx + r + 1, size)
        yy = ax[y0:y1, None]
        xx = ax[None, x0:x1]
        inside = (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r
        tex[y0:y1, x0:x1][inside] = float(v)
    return torch.clamp(tex, 0, 255).to(torch.float32)


def ring_world(rng, device):
    """Panel corners ``(P, 4, 3)`` and textures ``(P, S, S)`` f32."""
    corners, textures = [], []
    for radius, n_panels, fill, height, y0s in RINGS:
        span = 2 * np.pi * radius / n_panels * fill
        for p in range(n_panels):
            phi = 2 * np.pi * (p + (radius * 7 % 1.0)) / n_panels
            c = np.array([radius * np.sin(phi), y0s[p % len(y0s)],
                          radius * np.cos(phi)])
            tvec = np.array([np.cos(phi), 0.0, -np.sin(phi)]) * span / 2
            up = np.array([0.0, height / 2, 0.0])
            corners.append(np.stack([c - tvec - up, c + tvec - up,
                                     c + tvec + up, c - tvec + up]))
            textures.append(_texture(_texture_draws(rng, TEX_SIZE),
                                     TEX_SIZE, device))
    return np.stack(corners), torch.stack(textures)


def orbit(n_frames, frames_per_lap, r0, shrink_per_lap):
    """World-to-camera rotations ``(F, 3, 3)`` and centres ``(F, 3)``."""
    R, C = [], []
    for k in range(n_frames):
        phi = 2 * np.pi * k / frames_per_lap
        radius = r0 - shrink_per_lap * k / frames_per_lap
        C.append([radius * np.sin(phi), 0.0, radius * np.cos(phi)])
        c, s = np.cos(-phi), np.sin(-phi)
        R.append([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    return np.asarray(R), np.asarray(C)


def _texture_to_image(corners, R, t, K, tw, th):
    """Homographies ``(F, P, 3, 3)`` from texture pixels to image pixels:
    texture (0, 0), (tw, 0), (tw, th), (0, th) land on the panel's four
    corners, as the recipe's four-point fit puts them."""
    c0 = corners[:, 0]
    a = (corners[:, 1] - c0) / tw
    b = (corners[:, 3] - c0) / th
    cols = np.stack([a, b, c0], -1)                       # (P, 3, 3)
    cam = np.einsum("fij,pjk->fpik", R, cols)
    cam[..., 2] += t[:, None, :]
    return np.einsum("ij,fpjk->fpik", K, cam)


def render(corners, textures, R, C, K, width, height, *, batch=16,
           noise=None):
    """Frames ``(F, height, width)`` uint8 on the textures' device.
    ``noise``: ``(sigma, torch.Generator)`` for sensor noise, Gaussian
    grey levels added to each pixel before rounding, or None."""
    dev = textures.device
    P, th, tw = textures.shape
    t = -np.einsum("fij,fj->fi", R, C)
    cam = np.einsum("fij,pkj->fpki", R, corners) + t[:, None, None, :]
    proj = np.einsum("ij,fpkj->fpki", K, cam)
    proj = proj[..., :2] / proj[..., 2:3]
    drawn = ((cam[..., 2] > 0.5).all(-1)
             & ~(np.abs(proj) > 8 * max(width, height)).any((-2, -1)))
    # painter's rank: far to near by mean depth; the nearest painted last
    depth = cam[..., 2].mean(-1)
    rank = np.argsort(np.argsort(-depth, axis=1, kind="stable"), axis=1)
    Hinv = np.linalg.inv(_texture_to_image(corners, R, t, K, tw, th))
    tex = textures.reshape(P, -1)
    ys = torch.arange(height, dtype=torch.float64, device=dev)[:, None]
    xs = torch.arange(width, dtype=torch.float64, device=dev)[None, :]
    out = []
    for lo in range(0, len(R), batch):
        hi = min(lo + batch, len(R))
        H = torch.as_tensor(Hinv[lo:hi], device=dev)      # (B, P, 3, 3)
        canvas = torch.full((hi - lo, height, width), BACKGROUND,
                            dtype=torch.float32, device=dev)
        best = torch.full((hi - lo, height, width), -1, dtype=torch.int64,
                          device=dev)
        for p in range(P):
            on = torch.as_tensor(drawn[lo:hi, p], device=dev)[:, None, None]
            rk = torch.as_tensor(rank[lo:hi, p], device=dev)[:, None, None]
            h = H[:, p, :, :, None, None]
            qx = h[:, 0, 0] * xs + h[:, 0, 1] * ys + h[:, 0, 2]
            qy = h[:, 1, 0] * xs + h[:, 1, 1] * ys + h[:, 1, 2]
            qz = h[:, 2, 0] * xs + h[:, 2, 1] * ys + h[:, 2, 2]
            u = qx / qz
            v = qy / qz
            inside = (on & (u >= 0) & (u <= tw - 1) & (v >= 0)
                      & (v <= th - 1) & (rk > best))
            ui = torch.clamp(torch.floor(u), 0, tw - 2)
            vi = torch.clamp(torch.floor(v), 0, th - 2)
            fu = torch.clamp(u - ui, 0, 1)
            fv = torch.clamp(v - vi, 0, 1)
            idx = (vi * tw + ui).to(torch.int64)
            tp = tex[p].to(torch.float64)
            t00, t01 = tp[idx], tp[idx + 1]
            t10, t11 = tp[idx + tw], tp[idx + tw + 1]
            val = ((1 - fv) * ((1 - fu) * t00 + fu * t01)
                   + fv * ((1 - fu) * t10 + fu * t11))
            canvas = torch.where(inside, val.to(torch.float32), canvas)
            best = torch.where(inside, rk, best)
        if noise is not None:
            sigma, gen = noise
            canvas = canvas + sigma * torch.randn(
                canvas.shape, generator=gen, device=dev, dtype=torch.float32)
        out.append(torch.clamp(torch.round(canvas), 0, 255).to(torch.uint8))
    return torch.cat(out)


def generate(traffic: dict, config: dict, seed: int, n_frames: int, device):
    """Frames (list of host uint8 arrays) and the :class:`Scene` of one
    run: ``traffic`` gives the orbit (``frames_per_lap``, ``radius_m``,
    ``shrink_per_lap_m``), ``config`` the camera (``width``, ``height``,
    ``fx``, ``fy``, ``cx``, ``cy``).

    The world's textures come from ``seed``, or, where the traffic names a
    ``world_seed``, from that: one world for every run, so that a seed
    does not change the work a window holds; such traffic draws sensor
    noise of ``noise_sigma`` grey levels from ``seed`` instead (a
    ``torch.Generator`` on ``device``)."""
    cam = config["camera"]
    K = np.array([[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]],
                  [0, 0, 1.0]])
    world = traffic.get("world_seed")
    rng = seed_rng(seed if world is None else world)
    corners, textures = ring_world(rng, device)
    R, C = orbit(n_frames, traffic["frames_per_lap"], traffic["radius_m"],
                 traffic["shrink_per_lap_m"])
    noise = None
    if traffic.get("noise_sigma"):
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed) & (2 ** 63 - 1))
        noise = (float(traffic["noise_sigma"]), gen)
    frames = render(corners, textures, R, C, K, cam["width"], cam["height"],
                    noise=noise)
    host = frames.cpu().numpy()
    return ([host[k] for k in range(len(host))],
            Scene(corners=corners, R=R, C=C, K=K, width=cam["width"],
                  height=cam["height"]))
