"""The ``(dp, tp)`` mesh for serving (port of thewhisper_tpu's
``parallel/``): the mesh and its sharding rules (``mesh``), the processes
of its ranks (``launch``), rank 0's engine mirrored by the others
(``follow``) and the multi-rank dry run (``dryrun``)."""

from thewhisper_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    batch_rows,
    make_mesh,
    param_pspecs,
    replicated,
    shard_params,
)
