"""Per-(arch x shape) execution knobs for the production meshes (twin of
``repro.launch.tuning``).

The baseline policy applies everywhere, then the per-cell overrides of
the reference (each cites the reference's iteration that set it). The
knobs' dtypes stay names (``"float32"``, ``"bfloat16"``), as the
reference's; :func:`torch_dtype` turns one into a torch dtype.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.shapes import SHAPES
from repro_torch.dist.sharding import axis_sizes
from repro_torch.models.base import ModelConfig


def dp_size(mesh) -> int:
    shape = axis_sizes(mesh)
    return shape.get("data", 1) * shape.get("pod", 1)


# (arch, shape) -> knob overrides, the reference's.
OVERRIDES: dict[tuple[str, str], dict] = {
    # The reference's §Perf P5/P6: the 235B MoE cell is memory- and
    # FSDP-regather-bound; bf16 accumulation halves the grad buffer.
    ("qwen3-moe-235b-a22b", "train_4k"): {
        "accum_dtype": "bfloat16", "moments_dtype": "bfloat16"},
}

_KNOBS = ("accum_steps", "donate_state", "accum_dtype", "moments_dtype")


@dataclasses.dataclass(frozen=True)
class CellKnobs:
    accum_steps: int = 1
    donate_state: bool = True
    accum_dtype: str = "float32"
    moments_dtype: str = "float32"


def torch_dtype(name: str) -> torch.dtype:
    """``"float32"`` -> ``torch.float32``, ``"bfloat16"`` -> ...; a name
    that is not a torch dtype raises."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"{name!r} is not a torch dtype")
    return dtype


def tuned(cfg: ModelConfig, shape: str, mesh) -> tuple[ModelConfig, CellKnobs]:
    """Apply the execution policy for this cell to the model config."""
    cell = SHAPES[shape]
    upd: dict = {}
    knobs = CellKnobs()

    if cell.kind == "train":
        upd["remat"] = "full"
        upd["attn_chunk"] = 1024
        # accumulate until the per-device microbatch is 1
        accum = max(1, cell.global_batch // dp_size(mesh))
        knobs = CellKnobs(accum_steps=accum)
    else:
        # inference: bf16 weights, no remat
        upd["remat"] = "none"
        upd["param_dtype"] = torch.bfloat16
        upd["attn_chunk"] = 1024

    over = OVERRIDES.get((cfg.name, shape), {})
    upd.update({k: v for k, v in over.items() if k not in _KNOBS})
    knob_over = {k: v for k, v in over.items() if k in _KNOBS}
    if knob_over:
        knobs = dataclasses.replace(knobs, **knob_over)
    return dataclasses.replace(cfg, **upd), knobs
