"""Batched look-ahead feature extraction for the sequential CLI loop.

Port of ``irotavg_tpu/frontend/prefetch.py``.  The incremental engine
consumes frames one at a time, but a recorded sequence's images are all
known ahead of the cursor: :class:`FramePrefetcher` extracts ``batch``
frames in one batched pyramid (:func:`frontend.orb.extract_batch`, also
stage 1 of ``pipeline/offline.py``), undistorts their keypoints on the
device when the camera has distortion, assigns their vocabulary words in
one tree descent and one fetch (``Vocabulary.transform_batch``), and
hands the engine :class:`Frame` objects whose tensors are views of the
batch's.  Each frame equals the one the per-image constructor builds, so
the CLI's decisions do not depend on the batch width.

The batch holding frame ``i`` is extracted when ``frame(i)`` first needs
it; the next batch is not dispatched ahead.  On one CUDA stream a batch
queued early only waits in front of the engine's own work, and the CLI
synchronises the device after each frame to time its stages.
"""

from __future__ import annotations

import numpy as np
import torch

from irotavg_tpu_torch.frontend.frame import Frame

UNDISTORT_ITERS = 5


def _undistort(x, y, dist):
    """Iterative undistortion of f32 pixel coordinates on their device:
    the fixed-point scheme of ``Camera.undistort_points`` /
    cv::undistortPoints (src/Frame.cpp:102-139), in f32 with
    ``UNDISTORT_ITERS`` iterations.  ``dist`` is :func:`_dist_tuple`'s."""
    fx, fy, cx, cy, k1, k2, p1, p2 = dist
    xd = (x - cx) / fx
    yd = (y - cy) / fy
    xu, yu = xd, yd
    for _ in range(UNDISTORT_ITERS):
        r2 = xu * xu + yu * yu
        k_radial = 1.0 + k1 * r2 + k2 * r2 * r2
        dx = 2 * p1 * xu * yu + p2 * (r2 + 2 * xu * xu)
        dy = p1 * (r2 + 2 * yu * yu) + 2 * p2 * xu * yu
        xu = (xd - dx) / k_radial
        yu = (yd - dy) / k_radial
    return (xu * fx + cx).to(torch.float32), (yu * fy + cy).to(torch.float32)


def _dist_tuple(camera):
    if camera is None or not camera.has_distortion:
        return None
    return tuple(float(v) for v in (camera.fx, camera.fy, camera.cx,
                                    camera.cy, camera.k1, camera.k2,
                                    camera.p1, camera.p2))


def _load(image) -> np.ndarray:
    """An image, or a callable returning one (lazy disk loading)."""
    return np.asarray(image() if callable(image) else image)


def _stack(images, lo: int, hi: int, batch: int) -> np.ndarray:
    """Images ``lo:hi`` stacked, the tail padded to ``batch`` with copies
    of the last image (every batch has one shape)."""
    imgs = np.stack([_load(images[i]) for i in range(lo, hi)])
    if hi - lo < batch:
        imgs = np.concatenate(
            [imgs, np.repeat(imgs[-1:], batch - (hi - lo), axis=0)])
    return imgs


def sample_descriptors(images, extractor, *, batch: int = 8,
                       cap: int = 400, stride: int = 1):
    """Valid descriptors of every ``stride``-th image, at most ``cap`` per
    image, from the batched extractor (vocabulary training samplers).
    Returns a list of ``(n_i, 8)`` uint32 arrays."""
    sel = list(range(0, len(images), stride))
    out = []
    for lo in range(0, len(sel), batch):
        ids = sel[lo:lo + batch]
        ext = extractor.extract_batch(
            _stack([images[i] for i in ids], 0, len(ids), batch))
        desc = ext["desc"][:len(ids)].cpu().numpy().view(np.uint32)
        valid = ext["valid"][:len(ids)].cpu().numpy()
        out.extend(np.ascontiguousarray(d[v][:cap])
                   for d, v in zip(desc, valid))
    return out


class FramePrefetcher:
    """Batched extraction over a recorded image sequence.

    ``images`` is a sequence of arrays or callables returning arrays.
    ``frame(i)`` returns the :class:`Frame` for image ``i`` (id ``i``);
    the batch holding ``i`` is extracted, undistorted and (with
    ``vocab``) assigned its words on first need, and each frame is handed
    out once.
    """

    def __init__(self, images, extractor, camera, *, batch: int = 8,
                 vocab=None):
        self.images = images
        self.extractor = extractor
        self.camera = camera
        self.batch = int(batch)
        self.vocab = vocab
        self._cache: dict[int, tuple] = {}   # frame id -> (out, bow_nid)

    def _dispatch(self, lo: int) -> None:
        hi = min(lo + self.batch, len(self.images))
        out = self.extractor.extract_batch(
            _stack(self.images, lo, hi, self.batch))
        dist = _dist_tuple(self.camera)
        if dist is not None:
            out["xu"], out["yu"] = _undistort(out["x0"], out["y0"], dist)
        bows = [None] * (hi - lo)
        if self.vocab is not None:
            bows = self.vocab.transform_batch(out["desc"][:hi - lo],
                                              out["valid"][:hi - lo])
        for k in range(hi - lo):
            self._cache[lo + k] = ({n: v[k] for n, v in out.items()},
                                   bows[k])

    def frame(self, i: int) -> Frame:
        if i not in self._cache:
            self._dispatch(i - i % self.batch)
        out, bow_nid = self._cache.pop(i)
        return Frame.from_extracted(i, out, self.camera, bow_nid=bow_nid)

    def __len__(self) -> int:
        return len(self.images)

    def __iter__(self):
        for i in range(len(self.images)):
            yield self.frame(i)
