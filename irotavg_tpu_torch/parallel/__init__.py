"""Distributed rotation averaging over ``torch.distributed`` (port of
``irotavg_tpu/parallel``).

The scaling axis is graph parallelism: the view graph's edges are split
in contiguous blocks over the ranks, the absolute rotations (nodes) are
replicated, and the normal-equation partials are summed with one
``all_reduce`` per CG matvec.  ``scaling_probe`` times a fixed-work solve
over several world sizes.
"""

from irotavg_tpu_torch.parallel.sharded import (  # noqa: F401
    GRAPH_AXIS,
    GraphMesh,
    init_multihost,
    make_graph_mesh,
    shard_graph,
    sharded_irls,
    sharded_irls_step,
    sharded_ravg_pipeline,
)
