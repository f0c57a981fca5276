"""Distributed execution: the in-process shard mesh, the sharding rules,
the pipeline schedule and the mesh-aware stencil decomposition.

* :mod:`repro_torch.dist.mesh` — :class:`ShardMesh`, the port's
  counterpart of ``jax.sharding.Mesh``: one process, every shard on a
  torch device from a list (by default the cards present, in turn).
* :mod:`repro_torch.dist.process` — :class:`ProcessMesh`: one process a
  shard over a ``torch.distributed`` group (NCCL between cards, gloo on
  the CPU or on a shared card), the stencil's halos as point-to-point
  messages, and the reference's collectives along a mesh axis on this
  rank's tensor (``ppermute``, ``all_gather``, ``psum``).
* :mod:`repro_torch.dist.sharding` — logical-axis -> mesh-axis rule
  tables, the tree/state/batch spec builders the launchers use, and the
  layouts on either mesh (``lay_out``, ``Sharded``, ``shard_call``).
* :mod:`repro_torch.dist.pipeline` — microbatched pipeline-parallel
  schedule, in one process or one rank a stage.
* :mod:`repro_torch.dist.stencil` — depth-``t`` halo exchange running any
  :class:`~repro_torch.core.stencil.StencilSpec` per shard (the paper's
  §VII multi-card decomposition; entry point
  :func:`repro_torch.engine.run_distributed`).

The reference's ``repro.dist._compat`` has no counterpart: it only moves
``shard_map`` between jax versions.
"""
from repro_torch.dist import pipeline, sharding  # noqa: F401
from repro_torch.dist.mesh import ShardMesh  # noqa: F401
from repro_torch.dist.process import (  # noqa: F401
    ProcessMesh,
    all_gather,
    ppermute,
    psum,
)
from repro_torch.dist.sharding import (  # noqa: F401
    ACT_RULES,
    DEFAULT_RULES,
    batch_shardings,
    constrain,
    pspec_for,
    replicated,
    state_shardings,
    tree_shardings,
    use_mesh,
)
from repro_torch.dist.stencil import (  # noqa: F401
    extended_shard_shape,
    make_phase_steps,
    make_sharded_step,
    masked_block,
    resolve_axes,
    run_sharded,
)
