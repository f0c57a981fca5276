"""Assigned input-shape cells and each cell's input specs (twin of
``repro.configs.shapes``).

``decode_*`` / ``long_*`` cells run one serving step (one token against a
KV/state cache of ``seq_len``), not a train step; skips follow the
reference's arch-applicability rules and are reported, not silently
dropped. Where the reference returns ``jax.ShapeDtypeStruct`` stand-ins,
:func:`input_specs` returns tensors on the ``meta`` device of the same
shape and dtype: they hold no storage, and the dry run feeds them to a
model made on ``meta``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

_FULL_ATTN = ("dense", "moe", "vlm")


def cell_supported(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """(supported, reason-if-not)."""
    cell = SHAPES[shape]
    if cfg.family == "encoder" and cell.kind == "decode":
        return False, "encoder-only arch has no autoregressive decode step"
    if shape == "long_500k" and cfg.family in _FULL_ATTN:
        return False, ("500k decode needs sub-quadratic attention / O(1) "
                       "state; full-attention KV cache is out of scope")
    if shape == "long_500k" and cfg.family == "encoder":
        return False, "encoder-only arch has no autoregressive decode step"
    return True, ""


def input_specs(cfg: ModelConfig, shape: str) -> dict:
    """``meta`` stand-ins for every model input of this cell.

    For train/prefill the dict feeds the model directly; decode cells get
    their cache from ``model.init_cache`` on ``meta`` in the launcher.
    """
    return cell_input_specs(cfg, SHAPES[shape])


def cell_input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """:func:`input_specs` for any cell (a cut batch, a shorter sequence)."""
    b, s = cell.global_batch, cell.seq_len

    def sds(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    i32 = torch.int32
    if cfg.family == "encoder":
        specs = {"features": sds((b, s, cfg.audio_feat_dim), torch.bfloat16)}
        if cell.kind == "train":
            specs["labels"] = sds((b, s), i32)
        return specs

    if cell.kind == "decode":
        return {"tokens": sds((b, 1), i32)}

    if cfg.family == "vlm":
        n_img = cfg.vlm_image_tokens
        text = s - n_img
        specs = {
            "tokens": sds((b, text), i32),
            "image_embeds": sds((b, n_img, cfg.vlm_vision_dim),
                                torch.bfloat16),
        }
        if cell.kind == "train":
            specs["labels"] = sds((b, text), i32)
        return specs

    specs = {"tokens": sds((b, s), i32)}
    if cell.kind == "train":
        specs["labels"] = sds((b, s), i32)
    return specs
