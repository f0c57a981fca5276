"""Backend lowering + functional simulation for the stencil engine.

The bridge from budget-gated Pallas kernels to genuinely backend-aware
execution: any ``StencilSpec x ExecutionPlan`` lowers to an explicit
Tensix-style three-kernel program (reader / compute / writer over named
circular buffers of device-native tiles — :mod:`repro_torch.backends.ir`,
:mod:`repro_torch.backends.lower`) and runs on a functional simulator with a
NoC/DRAM step model (:mod:`repro_torch.backends.sim`), producing the numeric
result *and* per-kernel cycle/byte counters that
:mod:`repro_torch.backends.report` turns into GPt/s and energy. Every future
backend (Mosaic-GPU, real tt-metal) targets the same IR.

The port's copy of ``repro.backends``: the same IR, lowering, verifier
gate and simulator over torch tensors, the simulation on the input
tensor's device. Typical use::

    from repro_torch import backends
    res = backends.simulate(u, policy="rowchunk", iters=100,
                            device="grayskull_e150")
    print(backends.report.summarize(res))
    print(res.programs[0].describe())   # the IR, human-readable
"""
from repro_torch.backends import report  # noqa: F401
from repro_torch.backends.ir import (  # noqa: F401
    BackendError,
    CBOverflowError,
    CBUnderflowError,
    CircularBuffer,
    LocalSweeps,
    ReadBlock,
    TapCombine,
    TapReduce,
    TensixProgram,
    Tilize,
    Untilize,
    WriteBlock,
    tilize,
    untilize,
)
from repro_torch.backends.lower import (  # noqa: F401
    LoweringError,
    lower,
    lower_plan,
    lowerable_policies,
    make_copy_program,
)
from repro_torch.backends.sim import (  # noqa: F401
    KernelCounters,
    SimCounters,
    SimResult,
    simulate,
    simulate_program,
)
