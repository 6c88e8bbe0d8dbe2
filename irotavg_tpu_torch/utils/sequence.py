"""Image-sequence loading (port of ``irotavg_tpu/utils/sequence.py``;
the reference's SequenceLoader, src/SequenceLoader.cpp:30-50).

``SequenceLoader`` is the reference's class unchanged.  ``load_gray``
reads binary PGM (``P5``, 8-bit) with numpy alone, and other formats
through PIL where PIL is installed.
"""

from __future__ import annotations

import os

import numpy as np


class SequenceLoader:
    """Sorted (timestamp, path) iteration over a directory of images."""

    def __init__(self, path: str, im_ext: str = ".png",
                 timestamp_offset: int = 0):
        frames: list[tuple[int, str]] = []
        for name in os.listdir(path):
            full = os.path.join(path, name)
            stem, ext = os.path.splitext(name)
            if not os.path.isfile(full) or ext != im_ext:
                continue
            digits = stem[timestamp_offset:]
            # std::stoi semantics: parse the leading integer run
            num = ""
            for ch in digits:
                if ch.isdigit() or (ch in "+-" and not num):
                    num += ch
                else:
                    break
            if not num or num in "+-":
                raise ValueError(
                    f"no timestamp in filename {name!r} at offset "
                    f"{timestamp_offset}")
            frames.append((int(num), full))
        frames.sort()
        self._frames = frames

    def __len__(self) -> int:
        return len(self._frames)

    def __iter__(self):
        return iter(self._frames)

    def __getitem__(self, i):
        return self._frames[i]


def _pgm_tokens(data: bytes, count: int):
    """The first ``count`` header tokens of a PNM file and the offset of
    the byte after the single whitespace that ends the header."""
    tokens, i = [], 0
    while len(tokens) < count:
        while data[i:i + 1].isspace():
            i += 1
        if data[i:i + 1] == b"#":
            while data[i:i + 1] not in (b"\n", b"\r", b""):
                i += 1
            continue
        j = i
        while j < len(data) and not data[j:j + 1].isspace():
            j += 1
        tokens.append(data[i:j])
        i = j
    return tokens, i + 1


def read_pgm(path: str) -> np.ndarray:
    """Binary 8-bit PGM (``P5``) -> (H, W) uint8."""
    with open(path, "rb") as fh:
        data = fh.read()
    (magic, w, h, maxval), off = _pgm_tokens(data, 4)
    w, h, maxval = int(w), int(h), int(maxval)
    if magic != b"P5" or maxval > 255:
        raise ValueError(f"{path}: only 8-bit binary PGM (P5) is supported")
    img = np.frombuffer(data, np.uint8, count=w * h, offset=off)
    return img.reshape(h, w).copy()


def write_pgm(path: str, img: np.ndarray) -> None:
    """(H, W) uint8 -> binary PGM (``P5``)."""
    img = np.ascontiguousarray(img, np.uint8)
    with open(path, "wb") as fh:
        fh.write(b"P5\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        fh.write(img.tobytes())


def load_gray(path: str) -> np.ndarray:
    """Read an image file as grayscale uint8 (H, W): PGM with numpy,
    anything else through PIL."""
    if path.lower().endswith(".pgm"):
        return read_pgm(path)
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f"reading {path!r} needs PIL, which is not installed; convert "
            "the sequence to binary PGM (--image_ext .pgm)") from e
    with Image.open(path) as im:
        return np.asarray(im.convert("L"), np.uint8)
