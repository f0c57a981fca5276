"""Carrying state between the JAX package and the port.

A stencil system has no weights: its state is the spec and the ringed
grid. Both cross as plain data, so the port never imports ``repro`` or
``jax``:

* :func:`spec_from_fields` reads any object with ``.offsets`` and
  ``.weights`` (a ``repro.core.stencil.StencilSpec``, for one).
* :func:`grid_from_numpy` / :func:`grid_to_numpy` move a grid through
  numpy. numpy has no native bfloat16: a JAX bf16 array arrives as an
  ``ml_dtypes`` array, which is widened to f32 (exact) and then narrowed
  to ``torch.bfloat16`` (exact again), so both packages start from the
  same bits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.stencil import StencilSpec, require_device


def spec_from_fields(spec) -> StencilSpec:
    """A port :class:`StencilSpec` with ``spec``'s offsets and weights."""
    return StencilSpec(
        offsets=tuple(tuple(int(c) for c in off) for off in spec.offsets),
        weights=tuple(float(w) for w in spec.weights))


def grid_from_numpy(a, *, device="cuda") -> torch.Tensor:
    """A numpy (or numpy-convertible) grid as a tensor on ``device``."""
    a = np.asarray(a)
    dev = require_device(device)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=dev, dtype=torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def grid_to_numpy(u: torch.Tensor) -> np.ndarray:
    """``u`` on the host as numpy; bfloat16 comes back widened to f32."""
    u = u.detach().cpu()
    if u.dtype == torch.bfloat16:
        u = u.to(torch.float32)
    return u.numpy()
