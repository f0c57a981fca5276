"""Serving on the port (twin of ``repro.serve``): LM generation so far."""
