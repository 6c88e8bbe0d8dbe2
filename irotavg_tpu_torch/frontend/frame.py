"""Frame — per-image feature bundle of fixed-capacity tensors + mask.

Port of ``irotavg_tpu/frontend/frame.py`` (constructor path).  The
reference's ctor pipeline (extract -> undistort -> BoW;
src/Frame.hpp:54-64) runs as: extractor call -> (host) undistortion when
k1 != 0 -> vocabulary transform when a vocabulary is given.  Feature
tensors live on the extractor's device, where the matchers and geometry
read them; host (numpy) mirrors are fetched together, lazily, the first
time host code reads any of them.  There is no ±1 descriptor expansion:
the matcher kernel reads the (N, 8) int32 words.  The extractor decides
the descriptor type: (N, 8) int32 words for ORB, (N, 128) f32 rows for
SIFT (``frontend/sift.py``), which BoW does not apply to.
"""

from __future__ import annotations

import numpy as np
import torch

from irotavg_tpu_torch.device import pick_device
from irotavg_tpu_torch.frontend.camera import Camera

# feature tensors, in extractor-output order (+ undistorted coordinates)
FIELDS = ("x", "y", "octave", "angle", "response", "size", "desc", "valid")
_LAZY = FIELDS + ("xu", "yu")
# device dtypes of the feature tensors other than ``desc`` (int32 bit
# patterns, or f32 rows for SIFT: :func:`_desc_host`)
_DTYPES = {"x": torch.float32, "y": torch.float32, "xu": torch.float32,
           "yu": torch.float32, "octave": torch.int32,
           "angle": torch.float32, "response": torch.float32,
           "size": torch.float32, "valid": torch.bool}


def _desc_host(desc) -> np.ndarray:
    """Host descriptors as the device holds them: f32 rows stay f32, binary
    words (uint32 or int32) become int32 bit patterns."""
    desc = np.ascontiguousarray(desc)
    if desc.dtype.kind == "f":
        return desc.astype(np.float32)
    return desc.view(np.int32)


class Frame:
    """Feature bundle for one image.

    Attributes (N = extractor capacity, masked by ``valid``), each a lazy
    host mirror of the device tensor :meth:`dev` returns: ``x, y`` level-0
    keypoint coords; ``xu, yu`` undistorted coords; ``octave``; ``angle``
    (radians); ``response``; ``size``; ``desc`` (N, 8) int32 words (ORB)
    or (N, 128) f32 rows (SIFT); ``valid``.  ``bow`` (word id -> weight
    dict) and ``feat_nodes`` ((N,) int32 host array of vocabulary node
    ids, also on the device as ``dev("feat_nodes")``) are filled by
    :meth:`compute_bow`, else None.  ``image`` holds the raw pixels (host
    numpy) when built with ``keep_image=True`` (for
    ``utils/viz.plot_matches``), else None.
    """

    def __init__(self, frame_id: int, image, extractor, camera: Camera,
                 vocab=None, keep_image: bool = False):
        self.id = frame_id
        self.camera = camera
        # the reference keeps the image (Frame::getImage,
        # src/Frame.cpp:141-160) for its match plots; here only on request
        self.image = np.asarray(image) if keep_image else None
        self._attach(extractor(image), camera)
        if vocab is not None:
            self.compute_bow(vocab)

    @classmethod
    def from_extracted(cls, frame_id: int, out: dict, camera: Camera,
                       vocab=None, bow_nid=None) -> "Frame":
        """A Frame from an extractor-style dict of tensors (``x0, y0`` or
        ``x, y``, optionally ``xu, yu``), e.g. one frame's views of a
        batched extraction (``frontend/prefetch.py``).  ``bow_nid`` is an
        optional precomputed ``(bow, feat_nodes)``; without it, ``vocab``
        (when given) is applied with :meth:`compute_bow`."""
        self = cls.__new__(cls)
        self.id = frame_id
        self.camera = camera
        self.image = None
        self._attach(out, camera)
        if bow_nid is not None:
            self._set_bow(*bow_nid)
        elif vocab is not None:
            self.compute_bow(vocab)
        return self

    @classmethod
    def restore(cls, frame_id: int, camera: Camera, arrays: dict, bow=None,
                feat_nodes=None, device=None) -> "Frame":
        """Rebuild a Frame from checkpointed host arrays without
        re-extraction: ``arrays`` holds x, y, xu, yu, octave, angle,
        response, size, desc ((N, 8) words, uint32 or int32, or (N, 128)
        f32 SIFT rows), valid and optionally cell.  The feature tensors go
        onto ``device`` (the card unless ``device="cpu"``); the host
        mirrors are the given arrays."""
        dev = pick_device(device)
        self = cls.__new__(cls)
        self.id = frame_id
        self.camera = camera
        self.image = None
        self._host = {k: np.array(v) for k, v in arrays.items()}
        self._host["desc"] = _desc_host(self._host["desc"])
        self._device = {k: torch.as_tensor(self._host[k], dtype=_DTYPES[k],
                                           device=dev) for k in _DTYPES}
        self._device["desc"] = torch.as_tensor(self._host["desc"],
                                               device=dev)
        self.bow = bow
        self.feat_nodes = None
        if feat_nodes is not None:
            self._set_bow(bow, feat_nodes)
        return self

    def _attach(self, out: dict, camera: Camera) -> None:
        self._device = {
            "x": out.get("x0", out["x"]), "y": out.get("y0", out["y"]),
            "octave": out["octave"], "angle": out["angle"],
            "response": out["response"], "size": out["size"],
            "desc": out["desc"], "valid": out["valid"],
        }
        self._host = None
        self.bow = None
        self.feat_nodes = None
        if "xu" in out:
            self._device["xu"], self._device["yu"] = out["xu"], out["yu"]
        elif camera.has_distortion:
            # host math (f64), uploaded once for the matchers
            h = self._fetch_host()
            xu, yu = camera.undistort_points(h["x"], h["y"])
            h["xu"], h["yu"] = xu, yu
            dev = self._device["x"].device
            self._device["xu"] = torch.as_tensor(xu, dtype=torch.float32,
                                                 device=dev)
            self._device["yu"] = torch.as_tensor(yu, dtype=torch.float32,
                                                 device=dev)
        else:
            self._device["xu"] = self._device["x"]
            self._device["yu"] = self._device["y"]

    def _fetch_host(self) -> dict:
        """All host mirrors, fetched together once."""
        if self._host is None:
            self._host = {k: v.cpu().numpy() for k, v in self._device.items()}
        return self._host

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        if name in _LAZY:
            return self._fetch_host()[name]
        if name == "cell":
            cell = np.stack(self.camera.grid_cell(self.xu, self.yu), axis=1)
            self._fetch_host()["cell"] = cell
            return cell
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}")

    @property
    def capacity(self) -> int:
        """Feature-slot count N (shape only — no transfer)."""
        return int(self._device["valid"].shape[0])

    @property
    def device(self) -> torch.device:
        return self._device["valid"].device

    def dev(self, name: str):
        """Device tensor of a feature array."""
        return self._device[name]

    @property
    def n_valid(self) -> int:
        """Number of valid feature slots."""
        return int(np.asarray(self.valid).sum())

    def compute_bow(self, vocab, levelsup: int = 4) -> None:
        """Vocabulary transform (src/Frame.cpp:263-274,
        ORB_VOCAB_LEVELS=4).  ORB words only: a vocabulary of binary words
        does not apply to SIFT's float rows (the reference's vocabulary is
        meaningful with USE_ORB=1 only)."""
        if self.dev("desc").is_floating_point():
            raise ValueError("a binary-word vocabulary does not apply to "
                             "float (SIFT) descriptors")
        self._set_bow(*vocab.transform(self.dev("desc"), self.dev("valid"),
                                       levelsup=levelsup))

    def _set_bow(self, bow: dict, feat_nodes) -> None:
        self.bow = bow
        self.feat_nodes = np.asarray(feat_nodes, np.int32)
        self._device["feat_nodes"] = torch.as_tensor(self.feat_nodes,
                                                     device=self.device)
