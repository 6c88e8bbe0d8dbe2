"""Build-and-bind wrappers for the hand-written CUDA kernels in csrc/."""
