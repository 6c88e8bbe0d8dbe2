"""Device selection and the port's numeric policy.

* The device is CUDA when a card is present, the CPU otherwise; every
  function of the port takes an explicit ``device=`` (or follows the
  device of its tensor arguments) — there is no hidden global device.
* TF32 is off for matmuls and convolutions: the epipolar gate and the
  Sampson residuals need full f32 products (the reference runs its
  einsums at ``Precision.HIGHEST``).
* The rotation solver runs in f64 (``SOLVER_DTYPE``); the H100 has native
  FP64, so the reference's f32 default for large solves is not carried.
* Random draws come from explicit ``torch.Generator`` objects
  (:func:`make_generator`), never from global RNG state.
"""

from __future__ import annotations

import torch

SOLVER_DTYPE = torch.float64


def set_numeric_policy() -> None:
    """Full-precision f32 products on the card (no TF32 anywhere)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


set_numeric_policy()


def pick_device(name: str | None = None) -> torch.device:
    """``name`` if given, else CUDA when available, else the CPU."""
    if name is not None:
        return torch.device(name)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def make_generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with the 32-bit ``seed``."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed) & 0xFFFFFFFF)
    return g
