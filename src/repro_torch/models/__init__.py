"""Models of the port (twin of ``repro.models``): the dense decoder LM and
mamba2."""
