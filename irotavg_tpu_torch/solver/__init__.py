"""Rotation-averaging solver: L1-RA then IRLS on a dense graph Laplacian."""
