"""Rotation-averaging solver: L1-RA then IRLS on the graph Laplacian
(dense Cholesky or matrix-free CG), the spanning-tree initialisation and
the problem-file IO."""

from irotavg_tpu_torch.solver.graph import RotationGraph  # noqa: F401
from irotavg_tpu_torch.solver.init import init_mst  # noqa: F401
from irotavg_tpu_torch.solver.io import (  # noqa: F401
    read_problem, write_solution,
)
from irotavg_tpu_torch.solver.irls import Cost, irls  # noqa: F401
from irotavg_tpu_torch.solver.l1ra import l1ra  # noqa: F401
