"""Descriptor matchers as masked best-2 reductions."""

from irotavg_tpu_torch.matching.matchers import (  # noqa: F401
    TH_LOW,
    match_by_bow,
    match_epipolar,
    match_locally,
    match_sift,
    matches_to_pairs,
    rotation_consistency_filter,
)
