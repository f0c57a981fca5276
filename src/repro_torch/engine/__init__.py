"""Spec-driven stencil execution engine, on PyTorch and CUDA.

The twin of ``repro.engine``: any 2-D
:class:`~repro_torch.core.stencil.StencilSpec` runs under the paper's
execution policies —

    ``shifted``  (§IV initial)  ·  ``rowchunk`` (§VI optimized)
    ``dbuf``     (Table I double buffering)  ·  ``temporal`` (beyond paper)

Typical use::

    from repro_torch import engine
    from repro_torch.core.stencil import laplace_2d_9pt, make_laplace_problem

    u = make_laplace_problem(1024, 9216)          # on the card
    u1 = engine.run(u, laplace_2d_9pt(), policy="auto", iters=100)

Layers: ``device`` (hardware models), ``plan`` (tile/window/temporal-depth
planning, cached per device), ``schedule`` (how ``iters`` sweeps become
fused blocks), ``policies`` (the CUDA kernels and their plain versions),
``dispatch`` (registry + run/step).
"""
from repro_torch.engine.device import (  # noqa: F401
    DeviceModel,
    available_devices,
    detect,
    device_registry,
    get_device,
    register_device,
)
from repro_torch.engine.plan import (  # noqa: F401
    DEFAULT_BM,
    DEFAULT_T,
    ExecutionPlan,
    PlanError,
    pick_bm,
    plan_cache_clear,
    plan_cache_info,
    plan_for,
)
from repro_torch.engine.policies import (  # noqa: F401
    DBUF_VARIANTS,
    LAUNCHES,
    ROWCHUNK_VARIANTS,
    TEMPORAL_VARIANTS,
    launch_shifted_views,
    reset_launch_counts,
    shifted_views,
    stencil_dbuf,
    stencil_dbuf_plain,
    stencil_rowchunk,
    stencil_rowchunk_plain,
    stencil_shifted,
    stencil_shifted_plain,
    stencil_temporal,
    stencil_temporal_plain,
)
from repro_torch.engine.schedule import (  # noqa: F401
    DEFAULT_REMAINDER_POLICY,
    SweepSchedule,
    build_schedule,
    effective_depth,
)
from repro_torch.engine.dispatch import (  # noqa: F401
    Policy,
    available_policies,
    get_policy,
    register_policy,
    registry,
    residual_for,
    resolve_auto,
    run,
    run_batched,
    run_converged,
    step,
)
