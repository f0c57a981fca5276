"""repro_torch: the PyTorch and CUDA port of ``repro`` for NVIDIA Hopper.

It mirrors ``repro``'s module paths and public names. It imports ``torch``
and never ``jax``, and nothing of the ``repro`` package. Entry points run
on the card unless the caller asks for the CPU; the policy functions
follow the device of the tensor they are given, launching the hand-written
CUDA kernels (``repro_torch/csrc``) on a CUDA tensor and the plain PyTorch
versions on a CPU tensor.
"""

__version__ = "0.1.0"
