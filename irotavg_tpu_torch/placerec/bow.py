# Copied verbatim from irotavg_tpu/placerec/bow.py (numpy only; deduplicate once irotavg_tpu imports lazily).
"""BoW vector scoring — the six DBoW2 similarity measures.

Parity with ScoringObject.{h,cpp}: each scorer runs a sorted-merge over
the two sparse vectors' common words.  The ORB-SLAM configuration is L1
on L1-normalised vectors: ``s = 1 - 0.5 * sum |v_i - w_i|``, computed
over common words as ``-0.5 * sum(|v_i - w_i| - |v_i| - |w_i|)``
(ScoringObject.cpp:23-68).
"""

from __future__ import annotations

import numpy as np


def _common(v1: dict, v2: dict):
    ks = v1.keys() & v2.keys()
    a = np.array([v1[k] for k in ks])
    b = np.array([v2[k] for k in ks])
    return a, b


def bow_score(v1: dict, v2: dict, scoring: str = "L1") -> float:
    """Similarity of two sparse BoW dicts (word_id -> weight)."""
    if not v1 or not v2:
        return 0.0
    a, b = _common(v1, v2)
    if scoring == "L1":
        return float(-0.5 * np.sum(np.abs(a - b) - np.abs(a) - np.abs(b)))
    if scoring == "L2":
        s = float(np.sum(a * b))
        return float(np.sqrt(1.0 - np.sqrt(max(1.0 - s, 0.0)))) if s < 1 else 1.0
    if scoring == "CHI_SQUARE":
        den = a + b
        ok = den > 0
        return float(np.sum((a[ok] * b[ok]) / den[ok]) * 2.0)
    if scoring == "KL":
        # KL needs the full support of v1; words absent from v2 use LOG_EPS
        LOG_EPS = np.log(np.finfo(np.float64).eps)
        s = 0.0
        for k, vi in v1.items():
            if vi > 0:
                wi = v2.get(k, 0.0)
                s += vi * ((np.log(vi) - np.log(wi)) if wi > 0
                           else (np.log(vi) - LOG_EPS))
        return float(s)
    if scoring == "BHATTACHARYYA":
        return float(np.sum(np.sqrt(a * b)))
    if scoring == "DOT_PRODUCT":
        return float(np.sum(a * b))
    raise ValueError(f"unknown scoring {scoring!r}")
