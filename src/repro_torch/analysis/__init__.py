"""Static checks of the port (twin of ``repro.analysis``): structured
diagnostics, schedule feasibility, the static verifier of Tensix programs
(:mod:`repro_torch.analysis.verify`) and its cross-product sweep
(:mod:`repro_torch.analysis.sweep`, ``python -m repro_torch.analysis``)."""
from repro_torch.analysis.diagnostics import (  # noqa: F401
    CODES,
    SEVERITIES,
    Diagnostic,
    Report,
    budget_message,
    error,
    info,
    warning,
)
from repro_torch.analysis.feasibility import (  # noqa: F401
    check_bucket,
    check_schedule,
)
from repro_torch.analysis.verify import (  # noqa: F401
    CBBounds,
    MAX_ITERATIONS,
    occupancy_bounds,
    raise_if_rejected,
    verify_program,
)
from repro_torch.analysis.sweep import Cell, run_sweep  # noqa: F401
