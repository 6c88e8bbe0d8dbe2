"""Device selection and the port's numeric policy.

* The device is the CUDA card unless the caller asks for the CPU
  (``device="cpu"``); without a card the default raises instead of
  falling back.  Every function of the port takes an explicit
  ``device=`` (or follows the device of its tensor arguments) — there is
  no hidden global device.
* TF32 is off for matmuls and convolutions: the epipolar gate and the
  Sampson residuals need full f32 products (the reference runs its
  einsums at ``Precision.HIGHEST``).
* The rotation solver runs in f64 (``SOLVER_DTYPE``); the H100 has native
  FP64, so the reference's f32 default for large solves is not carried.
* Random draws are the JAX package's own: its threefry key tree derived
  on the host (``prng.py``: ``key``, ``split``, ``fold_in``), and
  RANSAC's samples mapped from those keys by the hypotheses kernel on
  the card (``csrc/ransac_hyp.cu``) or by ``ops/draw.py`` on the CPU, so
  both devices draw the numbers the JAX CLIs draw.  No global RNG state
  and no ``torch.Generator`` is involved.
"""

from __future__ import annotations

import torch

SOLVER_DTYPE = torch.float64


def set_numeric_policy() -> None:
    """Full-precision f32 products on the card (no TF32 anywhere)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


set_numeric_policy()


def pick_device(name=None) -> torch.device:
    """``name`` (a string or ``torch.device``) if given, else CUDA.  Raises
    ``RuntimeError`` for a CUDA device when no card is available: the CPU
    runs only when asked for with ``device="cpu"``."""
    dev = torch.device("cuda" if name is None else name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} asked for, but torch.cuda.is_available() "
            f"is False; pass device=\"cpu\" (CLI: --device cpu) to run on "
            f"the CPU")
    return dev

