"""View-graph engine and the incremental windowed solver."""
