"""irotavg_tpu_torch — the PyTorch/CUDA port of irotavg_tpu.

Same module map as ``irotavg_tpu`` (the JAX reference, which stays as it
is): ``so3``, ``solver/``, ``engine/``, ``ops/``, ``matching/``,
``geometry/``, ``frontend/``, ``app/``, ``utils/``.  Plain tensor code is
PyTorch; the one TPU kernel of the reference (the fused best-2 Hamming
matcher, ``irotavg_tpu/ops/match_pallas.py``) is a hand-written CUDA
kernel under ``csrc/``, built at first use by ``kernels/``.

Nothing here imports JAX.  Submodules are imported explicitly; this file
imports nothing so that ``import irotavg_tpu_torch.config`` stays cheap.
"""

__version__ = "0.1.0"
