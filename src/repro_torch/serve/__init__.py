"""Serving on the port (twin of ``repro.serve``).

* :mod:`repro_torch.serve.engine` — waves of batched prefill and decode
  for the LM families (:class:`~repro_torch.serve.engine.ServeEngine`).
* :mod:`repro_torch.serve.solve` — the stencil analogue: admit concurrent
  solve requests, bucket compatible ones, advance each bucket's slots
  through one batched K1 launch a block, and evict converged solves on
  their residual (:class:`~repro_torch.serve.solve.SolveServer`).
"""
from repro_torch.serve.engine import Request, ServeEngine  # noqa: F401
from repro_torch.serve.solve import (  # noqa: F401
    BucketKey,
    SolveProgress,
    SolveRejected,
    SolveRequest,
    SolveServer,
)
