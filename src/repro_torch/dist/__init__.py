"""Distributed execution: the in-process shard mesh and the mesh-aware
stencil decomposition.

* :mod:`repro_torch.dist.mesh` — :class:`ShardMesh`, the port's
  counterpart of ``jax.sharding.Mesh``: one process, every shard on a
  torch device from a list.
* :mod:`repro_torch.dist.stencil` — depth-``t`` halo exchange running any
  :class:`~repro_torch.core.stencil.StencilSpec` per shard (the paper's
  §VII multi-card decomposition; entry point
  :func:`repro_torch.engine.run_distributed`).

The reference's sharding rules and pipeline schedule (``repro.dist.
sharding``, ``repro.dist.pipeline``) serve the sharded LM and are not
ported yet.
"""
from repro_torch.dist.mesh import ShardMesh  # noqa: F401
from repro_torch.dist.stencil import (  # noqa: F401
    extended_shard_shape,
    make_phase_steps,
    make_sharded_step,
    masked_block,
    resolve_axes,
    run_sharded,
)
