"""Static checks of the port (twin of ``repro.analysis``): structured
diagnostics and schedule feasibility. The Tensix verifier and its sweep
come with the backends (ROADMAP Queue 1, E1)."""
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
