"""Kernel build and loading for the port (``kernels.build``)."""
