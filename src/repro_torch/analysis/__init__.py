"""Diagnostics shared by the port's planner (stdlib only)."""
from repro_torch.analysis.diagnostics import budget_message  # noqa: F401
