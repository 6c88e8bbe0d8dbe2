"""Command-line applications."""
