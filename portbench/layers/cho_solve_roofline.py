"""kernels: the dense normal-equation solves' share of their roofline, in
%: the least time the card needs for the factorisations and solves at the
graph's size (``roofline/cho_solve.py``) over the device time of every
operation inside each call (assembly, factorisation, solves, the rescue),
for IRLS's ``laplacian_cho_solve`` and L1-RA's Newton systems
(``_newton_dx``), summed over the window (device trace)."""

from pbkit import spec
from pbkit.trace import roofline_pct

WRAP = {"cho_solve": (["irotavg_tpu_torch.solver.irls:laplacian_cho_solve",
                       "irotavg_tpu_torch.solver.l1ra:_newton_dx"], True)}


def read(r):
    if r.device is None:
        return None
    return roofline_pct(r.device, r.tracer, "cho_solve",
                        spec.roofline("cho_solve").least_s)
