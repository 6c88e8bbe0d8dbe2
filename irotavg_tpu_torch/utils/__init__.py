"""Sequence loading and per-stage timing."""
