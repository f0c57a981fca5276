"""Stencil specs and the plain PyTorch oracle."""
from repro_torch.core.stencil import (StencilSpec,  # noqa: F401
                                      advection_1d_3pt, advection_2d_3pt,
                                      apply_stencil, jacobi_2d_5pt,
                                      laplace_2d_9pt, make_laplace_problem)
