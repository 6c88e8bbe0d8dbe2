"""Descriptor matchers as masked best-2 reductions."""
