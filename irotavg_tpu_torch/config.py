# Copied from irotavg_tpu/config.py (numpy only; deduplicate once irotavg_tpu imports lazily),
# less LoopClosureConfig's three cascade constants, which live beside the
# cascade in placerec/database.py.
"""Typed configuration for the whole pipeline.

The reference scatters behavioural constants across the tree (window sizes
and match minima at src/IRotAvg.cpp:158-161, loop-closure minimum 150 at
src/IRotAvg.cpp:312, consistency threshold 7 at src/ViewGraph.hpp:99,
TH_LOW=50 / 30-bin histogram at src/ViewGraph.cpp:32-33, keyframe gate 5 px
at src/ViewGraph.cpp:1071, solver settings at src/ViewGraph.cpp:1402-1415)
and reads camera/ORB settings from ORB-SLAM-compatible YAML
(src/IRotAvg.cpp:44-90).  Here everything lives in one typed config tree,
with a loader for the same YAML files so existing ORB-SLAM / iRotAvg
configs (e.g. the KITTI yamls) work unchanged.
"""

from __future__ import annotations

import dataclasses
import re


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """`Camera.*` YAML keys (src/IRotAvg.cpp:57-75)."""

    fx: float = 0.0
    fy: float = 0.0
    cx: float = 0.0
    cy: float = 0.0
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0


@dataclasses.dataclass(frozen=True)
class ORBConfig:
    """`ORBextractor.*` YAML keys (src/IRotAvg.cpp:81-89)."""

    n_features: int = 2000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7


@dataclasses.dataclass(frozen=True)
class MatchingConfig:
    """Matching constants (src/ViewGraph.cpp:32-33, 125-569)."""

    th_low: int = 50               # Hamming acceptance threshold
    histo_length: int = 30         # orientation histogram bins
    nn_ratio: float = 0.9          # best/second-best ratio
    local_rad_init: float = 45.0   # adaptive radius start (ViewGraph.hpp:134)
    keyframe_gate_px: float = 5.0  # reject frame when local_rad < this


@dataclasses.dataclass(frozen=True)
class LoopClosureConfig:
    """Loop-closure settings (src/ViewGraph.hpp:99, src/IRotAvg.cpp:295-353);
    the engine and the offline pipeline read the consistency threshold
    from here (``placerec/loop.py``)."""

    enabled: bool = True
    min_matches: int = 150                 # src/IRotAvg.cpp:312
    covisibility_consistency_th: int = 7   # src/ViewGraph.hpp:99


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Rotation-averaging settings (src/ViewGraph.cpp:1402-1415 for the
    incremental path; ral/test.cpp:254-271 for the batch CLI defaults)."""

    cost: str = "Geman-McClure"
    sigma_deg: float = 5.0
    l1_iters: int = 100
    irls_iters: int = 100
    change_th: float = 1e-3


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level engine constants (src/IRotAvg.cpp:158-161, 250, 371-378)."""

    camera: CameraConfig = CameraConfig()
    orb: ORBConfig = ORBConfig()
    matching: MatchingConfig = MatchingConfig()
    loop: LoopClosureConfig = LoopClosureConfig()
    solver: SolverConfig = SolverConfig()
    vg_win_size: int = 4
    rotavg_win_size: int = 10
    vg_min_matches: int = 100
    sampling_step: int = 1
    global_win_size: int = 5_000_000   # "global" solve (src/IRotAvg.cpp:374)
    save_every: int = 5                # checkpoint cadence (src/IRotAvg.cpp:385)
    gt_fix_every: int = 20             # GT anchoring cadence (src/IRotAvg.cpp:361)


_NUM = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$")


def read_opencv_yaml(path: str) -> dict:
    """Parse an OpenCV `cv::FileStorage` YAML file into a flat dict.

    ORB-SLAM configs start with a ``%YAML:1.0`` directive that standard
    YAML parsers reject, and only use flat ``Key.Sub: value`` scalars, so a
    tolerant line parser is both simpler and more compatible than pyyaml.
    """
    out: dict[str, object] = {}
    with open(path) as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line or line.startswith("%") or line.startswith("---"):
                continue
            if ":" not in line:
                continue
            key, _, val = line.partition(":")
            key, val = key.strip(), val.strip().strip('"')
            if not val:
                continue
            if _NUM.match(val):
                fval = float(val)
                out[key] = int(fval) if fval == int(fval) and "." not in val \
                    and "e" not in val.lower() else fval
            else:
                out[key] = val
    return out


def load_settings(path: str) -> tuple[CameraConfig, ORBConfig]:
    """Load ORB-SLAM-compatible settings (the reference's `config()`,
    src/IRotAvg.cpp:44-90): camera intrinsics/distortion + the five ORB
    extractor parameters."""
    s = read_opencv_yaml(path)
    cam = CameraConfig(
        fx=float(s.get("Camera.fx", 0.0)),
        fy=float(s.get("Camera.fy", 0.0)),
        cx=float(s.get("Camera.cx", 0.0)),
        cy=float(s.get("Camera.cy", 0.0)),
        k1=float(s.get("Camera.k1", 0.0)),
        k2=float(s.get("Camera.k2", 0.0)),
        p1=float(s.get("Camera.p1", 0.0)),
        p2=float(s.get("Camera.p2", 0.0)),
    )
    orb = ORBConfig(
        n_features=int(s.get("ORBextractor.nFeatures", 2000)),
        scale_factor=float(s.get("ORBextractor.scaleFactor", 1.2)),
        n_levels=int(s.get("ORBextractor.nLevels", 8)),
        ini_th_fast=int(s.get("ORBextractor.iniThFAST", 20)),
        min_th_fast=int(s.get("ORBextractor.minThFAST", 7)),
    )
    return cam, orb
