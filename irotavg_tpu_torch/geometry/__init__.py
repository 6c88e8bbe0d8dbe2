"""Two-view geometry: essential RANSAC, pose recovery, fused loops."""
