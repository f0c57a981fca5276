"""Architecture registry: ``--arch <id>`` resolves here.

Every arch of the reference is listed; qwen3-moe-235b-a22b's full
config fits no single card (its module says where it runs).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.shapes import (  # noqa: F401
    SHAPES, ShapeCell, cell_supported, input_specs)

ARCHS = {
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
}


def _module(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; one of {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[name])


def get_config(name: str):
    return _module(name).config()


def get_smoke_config(name: str):
    return _module(name).smoke()


def all_cells():
    """Every (arch, shape) pair with its supported/skip status."""
    out = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES:
            ok, why = cell_supported(cfg, shape)
            out.append((arch, shape, ok, why))
    return out
