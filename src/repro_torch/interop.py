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

An LM's state is its parameter tree. :func:`lm_params_from_jax` takes a
JAX LM's tree (``DecoderLM``, ``MambaLM`` or ``HybridLM``) as numpy
arrays and loads it into the port's model for the config's family: the
stacked ``layers`` leaves with their leading ``n_layers`` axis, or a
hybrid's ``groups`` leaves stacked ``(n_groups, period, ...)`` and
``tail`` leaves ``(n_tail, ...)``, plus the unstacked rest (``embedding``,
``ln_f``, the VLM's ``vision_proj``, the hybrid's ``shared_*``); MLA's
projections (``q_down``, ``q_norm``, ..., ``wo``) ride in ``layers`` under
``attn`` as GQA's do. Both store f32, so the load is exact.
:func:`load_params` loads one module from a nested dict.
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


def _flatten(tree, prefix=""):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _flatten(val, name + ".")
        else:
            yield name, val


def _load_flat(module: torch.nn.Module, flat: dict) -> torch.nn.Module:
    named = dict(module.named_parameters())
    if set(flat) != set(named):
        raise KeyError(f"parameter names differ: missing "
                       f"{sorted(set(named) - set(flat))}, unknown "
                       f"{sorted(set(flat) - set(named))}")
    with torch.no_grad():
        for name, arr in flat.items():
            arr = np.asarray(arr)
            if arr.dtype.name == "bfloat16":
                arr = arr.astype(np.float32)
            p = named[name]
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {arr.shape} != "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.tensor(arr))  # copies: jax arrays are read-only
    return module


def load_params(module: torch.nn.Module, tree: dict) -> torch.nn.Module:
    """Copy the nested dict ``tree`` of arrays into ``module``'s parameters
    of the same dotted names; every parameter must be given, with its
    shape."""
    return _load_flat(module, dict(_flatten(tree)))


def _stacked_axes(cfg) -> dict:
    """The JAX tree's stacked subtrees for ``cfg``: key -> (names of the
    leading axes, their lengths)."""
    if cfg.family == "hybrid":
        period = cfg.hybrid_period
        return {"groups": ("(n_groups, hybrid_period)",
                           (cfg.n_layers // period, period)),
                "tail": ("n_tail", (cfg.n_layers % period,))}
    return {"layers": ("n_layers", (cfg.n_layers,))}


def lm_params_from_jax(params: dict, cfg, *, device="cuda"):
    """The port's model for ``cfg`` holding the JAX parameter tree
    ``params`` (numpy leaves; stacked subtrees as the module note says)."""
    from repro_torch.models.registry import build_model
    stacked = _stacked_axes(cfg)
    flat = dict(_flatten({k: v for k, v in params.items()
                          if k not in stacked}))
    for key, (what, lead) in stacked.items():
        for name, arr in _flatten(params.get(key, {})):
            if tuple(arr.shape[:len(lead)]) != lead:
                raise ValueError(f"{key}.{name}: leading axes "
                                 f"{tuple(arr.shape[:len(lead)])} != {what} "
                                 f"{lead}")
            for idx in np.ndindex(*lead):
                flat[".".join((key, *map(str, idx), name))] = arr[idx]
    return _load_flat(build_model(cfg, device=require_device(device)), flat)
