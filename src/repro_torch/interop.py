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
JAX model's tree (``DecoderLM``, ``MambaLM``, ``HybridLM`` or
``EncoderModel``) as numpy arrays and loads it into the port's model for
the config's family: the stacked ``layers`` leaves with their leading
``n_layers`` axis (MoE's expert slabs ``(L, E, d, f)`` among them), or a
hybrid's ``groups`` leaves stacked ``(n_groups, period, ...)`` and
``tail`` leaves ``(n_tail, ...)``, plus the unstacked rest (``embedding``,
``ln_f``, the VLM's ``vision_proj``, the hybrid's ``shared_*``, the
encoder's ``feature_proj`` and ``head``); MLA's projections (``q_down``,
``q_norm``, ..., ``wo``) ride in ``layers`` under ``attn`` as GQA's do.
A bf16 leaf arrives as ``ml_dtypes`` and is widened to f32 and narrowed
to the parameter's dtype: both exact. :func:`load_params` loads one
module from a nested dict. :func:`train_state_from_jax` carries a whole
train state, parameters and the optimizer's ``(step, mu, nu)``, so a
JAX run can continue in the port.
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
            p = named[name]
            if tuple(np.shape(arr)) != tuple(p.shape):
                raise ValueError(f"{name}: shape {np.shape(arr)} != "
                                 f"{tuple(p.shape)}")
            p.copy_(_tensor(arr, p.dtype, p.device))  # copies: jax arrays are read-only
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


def port_names(tree: dict, cfg) -> dict:
    """The JAX model tree ``tree`` (parameters, or an optimizer moment of
    their structure) flattened to the port's parameter names, the
    stacked subtrees split per layer."""
    stacked = _stacked_axes(cfg)
    flat = dict(_flatten({k: v for k, v in tree.items()
                          if k not in stacked}))
    for key, (what, lead) in stacked.items():
        for name, arr in _flatten(tree.get(key, {})):
            if tuple(arr.shape[:len(lead)]) != lead:
                raise ValueError(f"{key}.{name}: leading axes "
                                 f"{tuple(arr.shape[:len(lead)])} != {what} "
                                 f"{lead}")
            for idx in np.ndindex(*lead):
                flat[".".join((key, *map(str, idx), name))] = arr[idx]
    return flat


def _flatten_axes(tree, prefix=""):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _flatten_axes(val, name + ".")
        else:
            yield name, tuple(val)


def port_axes(specs: dict, cfg) -> dict:
    """The JAX model's logical-axes tree ``specs`` (the second result of
    its ``init``) under the port's parameter names, as
    ``model.logical_axes()`` gives them: a stacked leaf's leading axes
    (``("layers",)``, a hybrid's ``("groups", None)``) are checked and
    dropped, and the rest holds for each layer."""
    stacked = _stacked_axes(cfg)
    flat = dict(_flatten_axes({k: v for k, v in specs.items()
                               if k not in stacked}))
    lead_axes = {"layers": ("layers",), "groups": ("groups", None),
                 "tail": ("layers",)}
    for key, (_, lead) in stacked.items():
        for name, axes in _flatten_axes(specs.get(key, {})):
            want = lead_axes[key]
            if axes[:len(want)] != want:
                raise ValueError(f"{key}.{name}: axes {axes} do not start "
                                 f"with {want}")
            for idx in np.ndindex(*lead):
                flat[".".join((key, *map(str, idx), name))] = \
                    axes[len(want):]
    return flat


def lm_params_from_jax(params: dict, cfg, *, device="cuda"):
    """The port's model for ``cfg`` holding the JAX parameter tree
    ``params`` (numpy leaves; stacked subtrees as the module note says)."""
    from repro_torch.models.registry import build_model
    model = build_model(cfg, device=require_device(device))
    return _load_flat(model, port_names(params, cfg))


def _tensor(arr, dtype: torch.dtype, device) -> torch.Tensor:
    """A copy of ``arr`` (bf16 widened to f32 first: exact) in ``dtype``
    on ``device``."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return torch.tensor(arr).to(device=device, dtype=dtype)


def train_state_from_jax(state, cfg, *, device="cuda"):
    """``(model, TrainState)`` in the port from a JAX ``TrainState`` of
    numpy leaves (``params``, ``opt_state = OptState(step, mu, nu)``).

    The port's state holds the model's own parameters (see
    ``train.trainstep``); ``mu`` and ``nu`` (``None`` for lion and sgd)
    are keyed by the port's parameter names, in the JAX moments' own
    dtype.
    """
    from repro_torch.train.optimizer import OptState
    from repro_torch.train.trainstep import TrainState
    params, opt = state
    model = lm_params_from_jax(params, cfg, device=device)
    named = dict(model.named_parameters())

    def moments(tree):
        if tree is None:
            return None
        flat = port_names(tree, cfg)
        if set(flat) != set(named):
            raise KeyError("optimizer moments and parameters differ in "
                           "names")
        return {name: _tensor(arr, torch.bfloat16
                              if np.asarray(arr).dtype.name == "bfloat16"
                              else torch.float32, model.device)
                for name, arr in flat.items()}

    step = torch.tensor(int(np.asarray(opt.step)), dtype=torch.int32,
                        device=model.device)
    return model, TrainState(named, OptState(step, moments(opt.mu),
                                             moments(opt.nu)))
