"""Image, FAST, orientation, BRIEF and matcher operations."""
